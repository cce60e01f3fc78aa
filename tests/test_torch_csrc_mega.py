"""CPU rehearsal of the whole-path surface kernels' lane code
(``csrc/mega_path.cuh``): the merged loop's coherent walk (K1c) against the
per-sample loop with its separate shadow walks (K1b).

g++ compiles ``mega_path.cuh`` under the shim of
``tests/test_torch_csrc_tracking.py`` (plus ``make_float4``), without fused
multiply-adds. A host program runs, per pixel lane,

* the per-sample loop over ``bounce`` (``start_sample``, then ``bounce``
  until the path ends: the nearest walk, then each light sample's shadow
  walk over the blocks copy of the table, stopping at its first blocker),
  the reference every walk is held to;
* the per-sample loop of ``mega_spp`` (K1b) for a "warp" of 32 lanes: each
  sample a whole path by K1a's single-path lane (``pass_rays`` / walk /
  ``path_end``, each vertex's last shadow ray deferred into the next walk),
  the warp's vote ending the sample, on the staged walk and on the culled
  walk;
* the merged loop of ``mega_spp_persistent`` (``k1c_begin``, one walk of
  the lane's path ray and pending shadow ray, ``k1c_end``) for a "warp" of
  32 lanes in lockstep, whose votes are a loop over them, with each of its
  walks: every row by the whole pair test with the blocks bits as words
  (as a table staged whole in shared memory is walked), every row plane
  first with the bits as bytes (the culled walk's row test, without its
  boxes), and, on a table the kernel culls (``FusedScene.culls``), the
  chunk table's culled walk (``culled_pair_walk`` over
  ``kernels.chunk_boxes``' boxes, plane first);

and holds the merged loop's and K1b's radiance sums and rejection counts
bitwise the ``bounce`` loop's on every pixel, and both against the plain version
``megakernel.mega_spp_plain`` inside ``chip_smoke.py``'s K1 gates (pixels
beyond rtol 1e-4 / atol 1e-5 at most max(1, 2e-4 N), the mean within 1e-3,
reject counts equal; glibc's ``sinf`` / ``cosf`` are not PyTorch's).

Scenes: the Cornell box (uniform and cosine sampling, NEE "all" with one
light), a room of four lights facing in under "all" (every vertex walks
three shadow rays inline and defers the fourth), the 64-light room facing
in under "one" and "power" (one group, culled), and a sphere mesh of two
groups. The shadow rays the merged loop walks are also counted, against
``chip_smoke.py``'s ray log, which marks them for the culled bound. Both
loops also render the frame of ``tests/test_oracle.py``'s ``GIOracle``
(depth-2 GI on the Cornell box, 16x12, 2 spp) within its own tolerance.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_csrc_tracking import CSRC, SHIM
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.geometry import kernels
from xraytracer_tpu_torch.integrators import megakernel as mk
from xraytracer_tpu_torch.math import from_rows
from xraytracer_tpu_torch.scene.builder import SceneBuilder, scene_statics
from xraytracer_tpu_torch.scene.presets import build_cornell_box, cornell_camera

torch.set_num_threads(1)

# chip_smoke.py's gates for the whole-path kernels against their plain versions
K1_RTOL, K1_ATOL = 1e-4, 1e-5
K1_PIXEL_DIFF_SHARE = 2e-4
MEAN_BAND_KERNEL_VS_PLAIN = 1e-3

W, H = 16, 12
N_SPP = 6

WALK_WORDS, WALK_BYTES, WALK_CULLED = 0, 1, 2

HOST = r"""
#include "mega_path.cuh"
using namespace xrt;

// a warp of 32 lanes run one after the other; a vote is the OR of theirs
struct HostWarp {
  static constexpr int LANES = 32;
  SweepRay path[32], shadow[32];
  bool vote(bool p) { return p; }
};

// ic: t_total, n_lights, max_depth, nee, le0, cosine, nee_kind
static MegaScene scene_from(const float* coef, const float* coef_blocks,
                            const float* rec, const uint8_t* blocks,
                            const float* boxes, const float* center,
                            const float* lights, const float* pick_cdf,
                            const int* ic) {
  MegaScene S;
  S.coef = (const float4*)coef;
  S.coef_blocks = (const float4*)coef_blocks;
  S.tri_rec = (const float4*)rec;
  S.blocks = blocks;
  S.boxes = (const float4*)boxes;
  S.center = center;
  S.lights = lights;
  S.pick_cdf = pick_cdf;
  S.t_total = ic[0];
  S.n_lights = ic[1];
  S.max_depth = ic[2];
  S.nee = ic[3];
  S.le0 = ic[4];
  S.cosine = ic[5];
  S.nee_kind = ic[6];
  return S;
}

#define SCENE_PARAMS const float *coef, const float *coef_blocks,            \
    const float *rec, const uint8_t *blocks, const float *boxes,             \
    const float *centre, const float *lights, const float *pick_cdf,         \
    const int *ic
#define SCENE_ARGS coef, coef_blocks, rec, blocks, boxes, centre, lights,    \
    pick_cdf, ic

extern "C" {
// megakernel.cu's preparation: the coefficient rows, and the blocks copy
void rh_coeffs(int t_total, const float* v0, const float* e1, const float* e2,
               const uint8_t* valid, const uint8_t* blocks,
               const float* center, float* coef, float* coef_blocks) {
  const float3 c = make_float3(center[0], center[1], center[2]);
  float4* f4 = (float4*)coef;
  float4* g4 = (float4*)coef_blocks;
  for (int j = 0; j < t_total; ++j) {
    const TriCoeffs z = zero_coeffs();
    TriCoeffs f = z;
    if (valid[j])
      f = tri_coeffs(sub3(load3(v0, j), c), load3(e1, j), load3(e2, j));
    const TriCoeffs g = blocks[j] ? f : z;
    f4[4 * j] = f.f0; f4[4 * j + 1] = f.f1; f4[4 * j + 2] = f.f2;
    f4[4 * j + 3] = f.f3;
    g4[4 * j] = g.f0; g4[4 * j + 1] = g.f1; g4[4 * j + 2] = g.f2;
    g4[4 * j + 3] = g.f3;
  }
}

// mega_spp_kernel's lane loop
void rh_spp(int s0, int n_spp, const int32_t* pixfold, const float* px,
            const float* py, int n, const float* cam16, unsigned cam_site,
            SCENE_PARAMS, float* out_sum, int32_t* out_rej) {
  const MegaScene S = scene_from(SCENE_ARGS);
  const MegaCamera C = camera_from(cam16, cam_site);
  const float3 center = ld3(S.center);
  NoGrad ng;
  for (int i = 0; i < n; ++i) {
    float3 acc = make_float3(0.f, 0.f, 0.f);
    int rej = 0;
    Path p;
    for (int s = 0; s < n_spp; ++s) {
      start_sample(C, (uint32_t)pixfold[i], px[i], py[i], (uint32_t)(s0 + s), p);
      while (p.act && p.it < S.max_depth) bounce(S, center, p, ng);
      add_sample(p.L, acc, rej);
    }
    out_sum[3 * i] = acc.x;
    out_sum[3 * i + 1] = acc.y;
    out_sum[3 * i + 2] = acc.z;
    out_rej[i] = rej;
  }
}

// mega_spp_persistent_kernel's lanes, a warp of 32 at a time; walk 0: the
// whole pair test, the blocks bits as 32-bit words (``words``); 1: plane
// first, the bits as bytes; 2: the culled walk. ``out_shadows``: the
// shadow rays the walks took (a lane's pending one at a pass)
void rh_spp_merged(int walk, int s0, int n_spp, const int32_t* pixfold,
                   const float* px, const float* py, int n, const float* cam16,
                   unsigned cam_site, SCENE_PARAMS, const uint32_t* words,
                   float* out_sum, int32_t* out_rej, int* out_passes,
                   int* out_shadows) {
  const MegaScene S = scene_from(SCENE_ARGS);
  const MegaCamera C = camera_from(cam16, cam_site);
  const float3 center = ld3(S.center);
  const int T = S.t_total;
  const long long limit = (long long)n_spp * (S.max_depth + 1) + 1;
  int passes = 0, shadows = 0;
  for (int w0 = 0; w0 < n; w0 += 32) {
    HostWarp w;
    K1cLane l[32];
    for (int i = 0; i < 32; ++i) {
      const int r = w0 + i;
      const bool live = r < n;
      k1c_init(l[i], live, live ? (uint32_t)pixfold[r] : 0u,
               live ? px[r] : 0.f, live ? py[r] : 0.f, n_spp);
    }
    for (long long guard = 0; guard < limit; ++guard) {
      bool any = false;
      for (int i = 0; i < 32; ++i)
        any |= k1c_begin(C, center, s0, n_spp, l[i], w.path[i], w.shadow[i]);
      if (!w.vote(any)) break;
      ++passes;
      for (int i = 0; i < 32; ++i) shadows += w.shadow[i].done ? 0 : 1;
      if (walk == 2) {
        culled_pair_walk(w, S.boxes, PlainRows{S.coef}, ByteBits{S.blocks}, T);
      } else {
        for (int i = 0; i < 32; ++i) {
          SweepRay& a = w.path[i];
          SweepRay& s = w.shadow[i];
          if (walk == 0)
            test_pair_rows<false>(PlainRows{S.coef}, WordBits{words}, 0, T, a,
                                  s, !a.done, !s.done);
          else
            test_pair_rows<true>(PlainRows{S.coef}, ByteBits{S.blocks}, 0, T,
                                 a, s, !a.done, !s.done);
        }
      }
      for (int i = 0; i < 32; ++i)
        k1c_end(S, center, l[i], w.path[i].best_i, w.shadow[i].best_i >= 0,
                PlainRows{S.tri_rec});
    }
    for (int i = 0; i < 32 && w0 + i < n; ++i) {
      out_sum[3 * (w0 + i)] = l[i].acc.x;
      out_sum[3 * (w0 + i) + 1] = l[i].acc.y;
      out_sum[3 * (w0 + i) + 2] = l[i].acc.z;
      out_rej[w0 + i] = l[i].rej;
    }
  }
  *out_passes = passes;
  *out_shadows = shadows;
}

// mega_spp_kernel's lanes, a warp of 32 at a time: per sample, K1a's
// single-path lane (megakernel.cu's single_path) from each lane's camera
// ray, a pass at a time, until the warp's vote ends the sample, each
// vertex's last shadow ray deferred into the next walk; walk 0: every row
// by the whole pair test, the bits as words, the other shadow rays walked
// at once over the same rows (a table staged whole); 2: the culled walk,
// the other shadow rays walked at once over the blocks copy.
// ``out_passes``: the passes the warps took
void rh_spp_single(int walk, int s0, int n_spp, const int32_t* pixfold,
                   const float* px, const float* py, int n, const float* cam16,
                   unsigned cam_site, SCENE_PARAMS, const uint32_t* words,
                   float* out_sum, int32_t* out_rej, int* out_passes) {
  const MegaScene S = scene_from(SCENE_ARGS);
  const MegaCamera C = camera_from(cam16, cam_site);
  const float3 center = ld3(S.center);
  const int T = S.t_total;
  NoGrad ng;
  int passes = 0;
  for (int w0 = 0; w0 < n; w0 += 32) {
    HostWarp w;
    Path p[32];
    Pending pend[32];
    float3 acc[32];
    int rej[32];
    for (int i = 0; i < 32; ++i) {
      acc[i] = make_float3(0.f, 0.f, 0.f);
      rej[i] = 0;
    }
    for (int s = 0; s < n_spp; ++s) {
      for (int i = 0; i < 32; ++i) {
        const int r = w0 + i;
        const bool live = r < n;
        start_sample(C, live ? (uint32_t)pixfold[r] : 0u, live ? px[r] : 0.f,
                     live ? py[r] : 0.f, (uint32_t)(s0 + s), p[i]);
        p[i].act = live;
        pend[i].on = false;
      }
      for (int pass = 0; pass <= S.max_depth; ++pass) {
        bool any = false;
        for (int i = 0; i < 32; ++i)
          any |= pass_rays(center, p[i], pend[i], w.path[i], w.shadow[i]);
        if (!w.vote(any)) break;
        ++passes;
        if (walk == 2)
          culled_pair_walk(w, S.boxes, PlainRows{S.coef}, ByteBits{S.blocks}, T);
        else
          for (int i = 0; i < 32; ++i)
            test_pair_rows<false>(PlainRows{S.coef}, WordBits{words}, 0, T,
                                  w.path[i], w.shadow[i], !w.path[i].done,
                                  !w.shadow[i].done);
        for (int i = 0; i < 32; ++i) {
          const int row = w.path[i].best_i;
          const bool blocked = w.shadow[i].best_i >= 0;
          if (walk == 2)
            path_end<true>(S, center, p[i], pend[i], ng, row, blocked,
                           PlainRows{S.tri_rec}, GlobalShadow{S});
          else
            path_end<true>(S, center, p[i], pend[i], ng, row, blocked,
                           PlainRows{S.tri_rec},
                           RowsShadow<PlainRows, WordBits>{PlainRows{S.coef},
                                                           WordBits{words}, T});
        }
      }
      for (int i = 0; i < 32; ++i) add_sample(p[i].L, acc[i], rej[i]);
    }
    for (int i = 0; i < 32 && w0 + i < n; ++i) {
      out_sum[3 * (w0 + i)] = acc[i].x;
      out_sum[3 * (w0 + i) + 1] = acc[i].y;
      out_sum[3 * (w0 + i) + 2] = acc[i].z;
      out_rej[w0 + i] = rej[i];
    }
  }
  *out_passes = passes;
}
}
"""

_P = ctypes.c_void_p
_I = ctypes.c_int
_FC = ctypes.POINTER(ctypes.c_float)
_SCENE = [_P] * 9
_VIEW = [_I, _I, _P, _P, _P, _I, _FC, ctypes.c_uint]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ not found: the CUDA headers cannot be rehearsed on the host")
    tmp = tmp_path_factory.mktemp("mega_rehearsal")
    (tmp / "cuda_runtime.h").write_text(
        SHIM + "inline float4 make_float4(float x, float y, float z, float w) "
               "{ return {x, y, z, w}; }\n")
    (tmp / "lanes.cpp").write_text(HOST)
    out = tmp / "libmega_rehearsal.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{tmp}", f"-I{os.path.abspath(CSRC)}", "-o", str(out),
         str(tmp / "lanes.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    h = ctypes.CDLL(str(out))
    h.rh_coeffs.argtypes = [_I] + [_P] * 8
    h.rh_spp.argtypes = _VIEW + _SCENE + [_P, _P]
    h.rh_spp_merged.argtypes = [_I] + _VIEW + _SCENE + [_P] * 5
    h.rh_spp_single.argtypes = [_I] + _VIEW + _SCENE + [_P] * 4
    for fn in (h.rh_coeffs, h.rh_spp, h.rh_spp_merged, h.rh_spp_single):
        fn.restype = None
    return h


# --------------------------------------------------------------------------
# scenes
# --------------------------------------------------------------------------
def _room(n_side):
    """The many-light room of chip_smoke.py (floor and back wall facing the
    ceiling's n_side x n_side quad lights of skewed powers)."""
    b = SceneBuilder()
    white = b.add_lambert((0.7, 0.7, 0.7))
    quads = []
    for k, (v0, v1, v2, v3) in enumerate((
        ((0, 0, 0), (556, 0, 0), (556, 0, 559), (0, 0, 559)),
        ((0, 0, 559), (556, 0, 559), (556, 548, 559), (0, 548, 559)),
        ((0, 548, 0), (556, 548, 0), (556, 548, 559), (0, 548, 559)),
    )):
        if k < 2:
            v1, v3 = v3, v1
        quads.append(np.asarray([[v0, v1, v2], [v0, v2, v3]], np.float32))
    b.add_mesh(np.concatenate(quads, axis=0), material=white)
    rng = np.random.default_rng(11)
    step = 480.0 / n_side
    for i in range(n_side):
        for j in range(n_side):
            x0, z0 = 40.0 + i * step, 40.0 + j * step
            power = float(rng.uniform(0.5, 40.0))
            b.add_quad_light((x0, 547.0, z0), (x0 + step / 2, 547.0, z0),
                             (x0, 547.0, z0 + step / 2), (power,) * 3)
    return b.build("cpu"), cornell_camera()


def _sphere():
    """A lat-long sphere mesh over a floor under a quad light: 640 rows, two
    groups of the chunk table."""
    b = SceneBuilder()
    white = b.add_lambert((0.8, 0.8, 0.8))
    b.add_sphere_mesh((0.0, 0.0, 0.0), 1.0, 24, 12, material=white)
    floor = np.asarray([[[-4, -1, -4], [4, -1, -4], [4, -1, 4]],
                        [[-4, -1, -4], [4, -1, 4], [-4, -1, 4]]], np.float32)
    b.add_mesh(floor, material=white)
    b.add_quad_light((-1.0, 3.0, -1.0), (1.0, 3.0, -1.0), (-1.0, 3.0, 1.0),
                     (10.0, 10.0, 10.0))
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 0.6, 4.0, 1)
    return b.build("cpu"), dict(c2w=c2w, fov_deg=45.0)


def _cornell():
    return build_cornell_box().build("cpu"), cornell_camera()


SCENES = {
    # name: (scene factory, max_depth, cosine, nee_mode)
    "cornell uniform": (_cornell, 3, False, "all"),
    "cornell cosine": (_cornell, 3, True, "all"),
    "4 lights, all": (lambda: _room(2), 3, True, "all"),
    "64 lights, one": (lambda: _room(8), 3, True, "one"),
    "64 lights, power": (lambda: _room(8), 3, False, "power"),
    "sphere, two groups": (_sphere, 3, True, "all"),
}


def _ptr(x):
    return x.data_ptr() if x is not None else None


class Case:
    """A scene's fused tables, view and host-side copies of what the
    launchers prepare on the card."""

    def __init__(self, lib, name, w=W, h=H, depth=None):
        factory, scene_depth, cosine, nee_mode = SCENES[name]
        depth = scene_depth if depth is None else depth
        tables, camk = factory()
        self.tables, self.camk = tables, camk
        st = scene_statics(tables)
        cam = PinholeCamera.make(w / h, device="cpu", **camk)
        opts = dict(max_depth=depth, cosine_sampling=cosine, nee_mode=nee_mode)
        self.fs = mk._bake(tables, st, depth, True, True, cosine, nee_mode=nee_mode)
        assert self.fs is not None, name
        self.view = mk.try_make_fused_spp_render(
            tables, st, cam, w, h, 0, nee=True, force=True, **opts).view
        t_total = tables.tri_v0.shape[0]
        self.t_total = t_total
        center = kernels._center(tables.tri_v0)
        self.center = center
        self.coef = torch.empty((t_total, 16))
        self.coef_blocks = torch.empty((t_total, 16))
        lib.rh_coeffs(t_total, _ptr(tables.tri_v0), _ptr(tables.tri_e1),
                      _ptr(tables.tri_e2), _ptr(self.fs.valid), _ptr(self.fs.blocks),
                      _ptr(center), _ptr(self.coef), _ptr(self.coef_blocks))
        self.rec = tables.tri_rec.contiguous()
        self.n_groups = -(-(-(-t_total // kernels.SWEEP_CHUNK)) // kernels.SWEEP_GROUP)
        # the chunk table, also for a table the kernels stage, so that the
        # culled walk can be rehearsed on every scene
        self.boxes, _ = kernels.chunk_boxes(tables.tri_v0, tables.tri_e1,
                                            tables.tri_e2, self.fs.valid, center)
        blocks = self.fs.blocks.numpy().astype(np.uint64)
        pad = np.zeros(-(-t_total // 32) * 32, np.uint64)
        pad[:t_total] = blocks
        self.words = torch.as_tensor(
            (pad.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(axis=1)
            .astype(np.uint32).view(np.int32))
        fs = self.fs
        self.ic = (ctypes.c_int * 7)(t_total, fs.n_lights, fs.max_depth, int(fs.nee),
                                     int(fs.le0), int(fs.cosine),
                                     mk.NEE_KINDS[fs.nee_mode])

    def view_args(self, n_spp=N_SPP):
        v = self.view
        cam = (ctypes.c_float * 16)(*[float(c) for c in v.cam])
        return (0, n_spp, _ptr(v.pixfold_bits), _ptr(v.px), _ptr(v.py), v.n, cam,
                v.cam_site)

    def scene_args(self):
        fs = self.fs
        return (_ptr(self.coef), _ptr(self.coef_blocks), _ptr(self.rec),
                _ptr(fs.blocks), _ptr(self.boxes), _ptr(self.center),
                _ptr(fs.lights), _ptr(fs.pick_cdf), self.ic)

    def per_sample(self, lib, n_spp=N_SPP):
        n = self.view.n
        acc, rej = torch.empty((n, 3)), torch.empty((n,), dtype=torch.int32)
        lib.rh_spp(*self.view_args(n_spp), *self.scene_args(), _ptr(acc), _ptr(rej))
        return acc, rej

    def merged(self, lib, walk, n_spp=N_SPP):
        n = self.view.n
        acc, rej = torch.empty((n, 3)), torch.empty((n,), dtype=torch.int32)
        passes, shadows = ctypes.c_int(), ctypes.c_int()
        lib.rh_spp_merged(walk, *self.view_args(n_spp), *self.scene_args(),
                          _ptr(self.words),
                          _ptr(acc), _ptr(rej), ctypes.byref(passes), ctypes.byref(shadows))
        return acc, rej, passes.value, shadows.value

    def single(self, lib, walk, n_spp=N_SPP):
        n = self.view.n
        acc, rej = torch.empty((n, 3)), torch.empty((n,), dtype=torch.int32)
        passes = ctypes.c_int()
        lib.rh_spp_single(walk, *self.view_args(n_spp), *self.scene_args(),
                          _ptr(self.words), _ptr(acc), _ptr(rej), ctypes.byref(passes))
        return acc, rej, passes.value


_CASES = {}


def _case(lib, name):
    if name not in _CASES:
        _CASES[name] = Case(lib, name)
    return _CASES[name]


def _within_k1_gates(what, got, rej, ref, rej_ref):
    n = ref.shape[0]
    assert torch.isfinite(got).all(), what
    beyond = ((got - ref).abs() > K1_ATOL + K1_RTOL * ref.abs()).any(dim=-1)
    assert int(beyond.sum()) <= max(1, K1_PIXEL_DIFF_SHARE * n), (
        f"{what}: {int(beyond.sum())} of {n} pixels beyond the K1 gate, "
        f"max abs {float((got - ref).abs().max())}")
    mean, mean_ref = float(got.mean()), float(ref.mean())
    assert abs(mean - mean_ref) <= MEAN_BAND_KERNEL_VS_PLAIN * abs(mean_ref), what
    assert int(rej.sum()) == int(rej_ref.sum()), what


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(SCENES))
def test_merged_loop_bitwise_per_sample_loop(lib, name):
    """Every walk of the merged loop gives the per-sample loop's sums and
    rejection counts bit for bit, pixel by pixel."""
    case = _case(lib, name)
    ref, ref_rej = case.per_sample(lib)
    assert float(ref.sum()) > 0.0, name
    walks = [WALK_WORDS, WALK_BYTES] + ([WALK_CULLED] if case.fs.culls else [])
    for walk in walks:
        got, rej, passes, _ = case.merged(lib, walk)
        assert torch.equal(got, ref), (
            f"{name}, walk {walk}: {int((got != ref).any(dim=-1).sum())} pixels differ")
        assert torch.equal(rej, ref_rej), (name, walk)
        # every sample takes at least one pass, the last one's shadow ray one more
        assert N_SPP <= passes // -(-case.view.n // 32) <= N_SPP * case.fs.max_depth + 1


@pytest.mark.parametrize("name", list(SCENES))
def test_spp_kernel_lane_bitwise_bounce_loop(lib, name):
    """``mega_spp``'s lane (a sample at a time, each a whole path by K1a's
    single-path lane, the warp's vote ending each sample) gives the sums
    and rejection counts of the per-sample ``bounce`` loop bit for bit, on
    the staged walk and on the culled walk (which the kernel takes for a
    table over 64 rows; here on every scene, so that deferred shadow rays
    meet blockers, as in the Cornell box)."""
    case = _case(lib, name)
    ref, ref_rej = case.per_sample(lib)
    warps = -(-case.view.n // 32)
    for walk in (WALK_WORDS, WALK_CULLED):
        got, rej, passes = case.single(lib, walk)
        assert torch.equal(got, ref), (
            f"{name}, walk {walk}: {int((got != ref).any(dim=-1).sum())} pixels differ")
        assert torch.equal(rej, ref_rej), (name, walk)
        # a sample takes at least one pass a warp, and at most a pass a
        # bounce and one for its last shadow ray
        assert N_SPP * warps <= passes <= N_SPP * warps * (case.fs.max_depth + 1)


@pytest.mark.parametrize("name", list(SCENES))
def test_loops_within_k1_gates_of_plain(lib, name):
    """The per-sample loop and the merged loop against ``mega_spp_plain`` (the
    wavefront integrator over the plain sweep, sample by sample) inside the
    K1 gates of chip_smoke.py."""
    case = _case(lib, name)
    ref, ref_rej = mk.mega_spp_plain(case.fs, case.view, 0, N_SPP)
    got, rej = case.per_sample(lib)
    _within_k1_gates(f"{name}, per-sample loop", got, rej, ref, ref_rej)
    walk = WALK_CULLED if case.fs.culls else WALK_WORDS
    got, rej, _, _ = case.merged(lib, walk)
    _within_k1_gates(f"{name}, merged loop", got, rej, ref, ref_rej)


def test_cases_reach_every_branch(lib):
    """The scenes put the merged loop's parts to work: the staged walk, the
    culled walk on tables of one and of two groups, several lights under
    "all" (inline shadow walks before the deferred one), and the pick
    modes."""
    sphere, room = _case(lib, "sphere, two groups"), _case(lib, "64 lights, power")
    assert sphere.n_groups == 2 and sphere.fs.culls
    assert room.n_groups == 1 and room.fs.culls and room.fs.n_lights == 64
    assert _case(lib, "4 lights, all").fs.n_lights == 4
    assert not _case(lib, "cornell uniform").fs.culls


def test_stage_rows_match_the_launcher():
    """The tables the wrapper passes a chunk table for are those the K1c
    launcher does not stage: one constant on both sides."""
    with open(os.path.join(CSRC, "megakernel.cu")) as f:
        rows = re.search(r"constexpr int MEGA_STAGE_ROWS = (\d+);", f.read())
    assert rows is not None
    assert int(rows.group(1)) == mk.MEGA_STAGE_ROWS


@pytest.mark.parametrize("variant", ["at_once", "at_once_l1"])
def test_k1b_probe_edits_apply_to_the_source(variant):
    """``chip_smoke.py --k1b-probe`` builds megakernel.cu with exact edits
    of its text: each edit's text occurs once in the source, so the probe
    builds the design it names."""
    import chip_smoke

    with open(os.path.join(CSRC, "megakernel.cu")) as f:
        text = f.read()
    for old, new in chip_smoke.K1B_PROBE_EDITS[variant]:
        assert text.count(old) == 1, (variant, old)
        text = text.replace(old, new)
    assert "single_path<WALK, WALK == WALK_CULLED>(S, center, p, ng, smem);" in text


@pytest.mark.parametrize("name", list(SCENES))
def test_ray_log_marks_the_shadow_rays_the_merged_loop_walks(lib, name):
    """chip_smoke.py's culled bound counts the shadow rays the kernel walks
    by ``MegaRayLog``'s mask over the plain version's light samples; on
    these scenes the mask of each vertex's last light (the one the merged
    loop defers into its coherent walk) marks as many rays as the merged
    loop walks."""
    import chip_smoke

    case = _case(lib, name)
    *_, walked = case.merged(lib, WALK_WORDS)
    with chip_smoke.MegaRayLog(case.fs.max_depth) as log:
        mk.mega_spp_plain(case.fs, case.view, 0, N_SPP)
    marked = sum(int(shadows[-1][3].sum()) for path in log.paths
                 for _, _, shadows in path if shadows)
    assert walked > 0, name
    assert marked == walked, (name, marked, walked)


def test_gi_depth2_matches_oracle(lib):
    """K1's lane code renders GIOracle's frame (depth-2 GI with NEE,
    roulette and cosine bounces on the Cornell box, seed 0) by the
    per-sample loop and by the merged loop with each of its walks, at the
    oracle's own 16x12, 2 spp and tolerance (the port of
    ``test_oracle.py::test_gi_depth2_matches_oracle``)."""
    from test_oracle import GIOracle
    from test_oracle import H as OH, SPP as OSPP, W as OW

    case = Case(lib, "cornell cosine", w=OW, h=OH, depth=2)
    oracle = GIOracle(case.tables, case.camk, OW, OH, seed=0)
    expect = np.zeros((OH, OW, 3))
    for py in range(OH):
        for px in range(OW):
            for s in range(OSPP):
                expect[py, px] += oracle.gi(px, py, s)
    expect /= OSPP
    assert expect.mean() > 1e-3
    per_sample, _ = case.per_sample(lib, OSPP)
    renders = [per_sample] + [case.merged(lib, walk, OSPP)[0]
                              for walk in (WALK_WORDS, WALK_BYTES)]
    for got in renders:
        np.testing.assert_allclose(got.reshape(OH, OW, 3).numpy() / OSPP, expect,
                                   rtol=1e-3, atol=2e-4)
