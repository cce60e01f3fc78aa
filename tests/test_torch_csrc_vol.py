"""CPU rehearsal of the whole-path homogeneous volume kernels' lane code
(``csrc/vol_path.cuh``): K6c's merged loop against K6b's per-sample loop,
both over the work order, against the plain version and the numpy oracle.

g++ compiles ``vol_path.cuh`` under the shim of
``tests/test_torch_csrc_tracking.py``, without fused multiply-adds
(``-ffp-contract=off``). A host program runs

* K6a's lane (``vol_bounce`` until the path ends) on given rays;
* K6b's lanes (``vol_pixel_per_sample``): slot i of the work order carries
  the pixel of view lane ``order[i]`` and writes that view lane's sum;
* K6c's lanes over the same order, as ``vol_megakernel.cu`` runs them: a
  warp of 32 slots in lockstep, each pass every lane whose pixel is not
  done running one pass of the merged loop (``vol_lane_pass``).

It holds the merged loop's sums and rejection counts bitwise the
per-sample loop's on every pixel, every view lane written exactly once, both
loops against ``vol_megakernel.vol_spp_plain`` inside ``chip_smoke.py``'s K1
gates (glibc's ``expf`` / ``logf`` / ``sinf`` / ``cosf`` are not PyTorch's),
the achromatic box without NEE at depth 3 against ``VPTOracle`` at its own
16x12, 2 spp, rtol 1e-3 / atol 2e-4, and the work order as a permutation of
the view lanes, longest chord first, on a frame whose width is not a
multiple of 32.

Cases: the vpt box under the spectral-MIS, achromatic and uniform channel
picks, each with and without next-event estimation, and a box of g = 0.6
(the Henyey-Greenstein branch of the scattered direction).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_oracle import VPTOracle
from test_torch_csrc_tracking import CSRC, SHIM
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.integrators import megakernel as mk
from xraytracer_tpu_torch.integrators import vol_megakernel as vm
from xraytracer_tpu_torch.scene import presets
from xraytracer_tpu_torch.scene.builder import scene_statics

torch.set_num_threads(1)

# chip_smoke.py's gates for the whole-path kernels against their plain versions
K1_RTOL, K1_ATOL = 1e-4, 1e-5
K1_PIXEL_DIFF_SHARE = 2e-4
MEAN_BAND_KERNEL_VS_PLAIN = 1e-3

W, H = 16, 12
DEPTH = 10       # the vpt preset's depth
N_SPP = 8

HOST = r"""
#include "vol_path.cuh"
using namespace xrt;

extern "C" {
// K6a's lane on each ray
void rh_vol_path(const float* o, const float* d, const int32_t* keys, int n,
                 const float* fc, const int* ic, float* out) {
  const VolScene S = vol_scene_from(fc, ic);
  for (int i = 0; i < n; ++i) {
    VolPath p;
    start_path(p);
    p.key = (uint32_t)keys[i];
    p.o = load3(o, i);
    p.d = load3(d, i);
    while (p.act && p.it < S.n_iterations) vol_bounce(S, p);
    out[3 * i] = p.L.x;
    out[3 * i + 1] = p.L.y;
    out[3 * i + 2] = p.L.z;
  }
}

// K6b's lanes: slot i carries the pixel of view lane order[i]
void rh_vol_spp(int s0, int n_spp, const int32_t* pixfold, const float* px,
                const float* py, const int32_t* order, int n,
                const float* cam16, unsigned cam_site, const float* fc,
                const int* ic, float* out_sum, int32_t* out_rej) {
  const VolScene S = vol_scene_from(fc, ic);
  const MegaCamera C = camera_from(cam16, cam_site);
  for (int i = 0; i < n; ++i) {
    const int j = order[i];
    float3 acc;
    int rej;
    vol_pixel_per_sample(S, C, (uint32_t)pixfold[j], px[j], py[j], s0, n_spp,
                         acc, rej);
    out_sum[3 * j] = acc.x;
    out_sum[3 * j + 1] = acc.y;
    out_sum[3 * j + 2] = acc.z;
    out_rej[j] = rej;
  }
}

// K6c's lanes over the work order, a warp of 32 slots at a time in lockstep:
// each pass, every lane whose pixel is not done runs one pass of the merged
// loop (``vol_lane_pass``); ``out_writes`` counts the writes per view lane,
// ``out_passes`` the warps' passes
void rh_vol_merged(int s0, int n_spp, const int32_t* pixfold, const float* px,
                   const float* py, const int32_t* order, int n,
                   const float* cam16, unsigned cam_site, const float* fc,
                   const int* ic, float* out_sum, int32_t* out_rej,
                   int32_t* out_writes, long long* out_passes) {
  const VolScene S = vol_scene_from(fc, ic);
  const MegaCamera C = camera_from(cam16, cam_site);
  const long long limit = vol_pass_limit(S, n_spp);
  long long passes = 0;
  for (int w0 = 0; w0 < n; w0 += 32) {
    VolLane l[32];
    for (int q = 0; q < 32 && w0 + q < n; ++q) {
      const int j = order[w0 + q];
      vol_lane_init(l[q], (uint32_t)pixfold[j], px[j], py[j]);
    }
    for (;;) {
      bool any = false;
      for (int q = 0; q < 32 && w0 + q < n; ++q) {
        if (vol_lane_done(l[q], n_spp, limit)) continue;
        vol_lane_pass(S, C, s0, l[q]);
        any = true;
      }
      if (!any) break;
      ++passes;
    }
    for (int q = 0; q < 32 && w0 + q < n; ++q) {
      const int j = order[w0 + q];
      out_sum[3 * j] = l[q].acc.x;
      out_sum[3 * j + 1] = l[q].acc.y;
      out_sum[3 * j + 2] = l[q].acc.z;
      out_rej[j] = l[q].rej;
      out_writes[j] += 1;
    }
  }
  *out_passes = passes;
}
}
"""

_P = ctypes.c_void_p
_I = ctypes.c_int
_FC = ctypes.POINTER(ctypes.c_float)
_IC = ctypes.POINTER(ctypes.c_int)
_VIEW = [_I, _I, _P, _P, _P, _P, _I, _FC, ctypes.c_uint, _FC, _IC]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ not found: the CUDA headers cannot be rehearsed on the host")
    tmp = tmp_path_factory.mktemp("vol_rehearsal")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    (tmp / "lanes.cpp").write_text(HOST)
    out = tmp / "libvol_rehearsal.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{tmp}", f"-I{os.path.abspath(CSRC)}", "-o", str(out),
         str(tmp / "lanes.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    h = ctypes.CDLL(str(out))
    h.rh_vol_path.argtypes = [_P, _P, _P, _I, _FC, _IC, _P]
    h.rh_vol_spp.argtypes = _VIEW + [_P, _P]
    h.rh_vol_merged.argtypes = _VIEW + [_P, _P, _P, _P]
    for fn in (h.rh_vol_path, h.rh_vol_spp, h.rh_vol_merged):
        fn.restype = None
    return h


# --------------------------------------------------------------------------
# scenes
# --------------------------------------------------------------------------
CASES = {
    # name: (variant, g, nee)
    "mis": ("mis", 0.0, False),
    "mis nee": ("mis", 0.0, True),
    "achromatic": ("achromatic", 0.0, False),
    "achromatic nee": ("achromatic", 0.0, True),
    "nomis": ("nomis", 0.0, False),
    "nomis nee": ("nomis", 0.0, True),
    "g=0.6 nee": ("mis", 0.6, True),
}


def _ptr(x):
    return x.data_ptr()


class Case:
    """A scene's launch constants, a view of w x h pixels and its work
    order."""

    def __init__(self, variant, g, nee, w=W, h=H, depth=DEPTH):
        tables = presets.build_vpt_scene(variant, g).build("cpu")
        st = scene_statics(tables)
        cam = PinholeCamera.make(w / h, device="cpu", **presets.preset_vpt("cpu")[1])
        self.vc = vm._vol_consts(tables, st, depth, nee, None, None)
        assert self.vc is not None
        self.view = vm.try_make_fused_volume_spp_render(
            tables, st, cam, w, h, 0, depth, nee=nee, force=True).view
        self.order = vm.work_order(self.vc, self.view)

    def view_args(self, n_spp):
        v = self.view
        cam = (ctypes.c_float * 16)(*[float(c) for c in v.cam])
        return (0, n_spp, _ptr(v.pixfold_bits), _ptr(v.px), _ptr(v.py),
                _ptr(self.order), v.n, cam, v.cam_site, self.vc.fc, self.vc.ic)

    def per_sample(self, lib, n_spp=N_SPP):
        n = self.view.n
        acc, rej = torch.zeros((n, 3)), torch.zeros((n,), dtype=torch.int32)
        lib.rh_vol_spp(*self.view_args(n_spp), _ptr(acc), _ptr(rej))
        return acc, rej

    def merged(self, lib, n_spp=N_SPP):
        n = self.view.n
        acc, rej = torch.zeros((n, 3)), torch.zeros((n,), dtype=torch.int32)
        writes = torch.zeros((n,), dtype=torch.int32)
        passes = ctypes.c_longlong()
        lib.rh_vol_merged(*self.view_args(n_spp), _ptr(acc), _ptr(rej), _ptr(writes),
                          ctypes.byref(passes))
        return acc, rej, writes, passes.value


_CASES = {}


def _case(name):
    if name not in _CASES:
        _CASES[name] = Case(*CASES[name])
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
@pytest.mark.parametrize("name", list(CASES))
def test_merged_loop_bitwise_per_sample_loop(lib, name):
    """K6c's merged loop gives K6b's sums and rejection counts bit for bit,
    pixel by pixel, over the work order, each view lane written once."""
    case = _case(name)
    ref, ref_rej = case.per_sample(lib)
    assert float(ref.sum()) > 0.0, name
    got, rej, writes, passes = case.merged(lib)
    assert torch.equal(writes, torch.ones_like(writes)), name
    warps = -(-case.view.n // 32)
    # a warp takes at least one pass per sample, and at most the guard's bound
    assert N_SPP * warps <= passes <= warps * (N_SPP * (case.vc.n_iterations + 1) + 1)
    assert torch.equal(got, ref), (
        f"{name}: {int((got != ref).any(dim=-1).sum())} pixels differ")
    assert torch.equal(rej, ref_rej), name


@pytest.mark.parametrize("name", list(CASES))
def test_loops_within_k1_gates_of_plain(lib, name):
    """The per-sample loop and the merged loop against
    ``vol_spp_plain`` (the wavefront volume integrator over the plain sweep,
    sample by sample) inside the K1 gates of chip_smoke.py; K6a's lane
    against ``vol_path_plain`` on the camera rays of sample 0."""
    case = _case(name)
    ref, ref_rej = vm.vol_spp_plain(case.vc, case.view, 0, N_SPP)
    got, rej = case.per_sample(lib)
    _within_k1_gates(f"{name}, per-sample loop", got, rej, ref, ref_rej)
    got, rej, _, _ = case.merged(lib)
    _within_k1_gates(f"{name}, merged loop", got, rej, ref, ref_rej)
    keys, o, d = mk._camera_rays_plain(case.view, 0)
    ref = vm.vol_path_plain(case.vc, o, d, keys)
    got = torch.empty_like(ref)
    k32 = mk._i32_bits(keys)
    lib.rh_vol_path(_ptr(o), _ptr(d), _ptr(k32), o.shape[0], case.vc.fc, case.vc.ic,
                    _ptr(got))
    _within_k1_gates(f"{name}, vol_path", got, torch.zeros(1), ref, torch.zeros(1))


def test_achromatic_box_matches_oracle(lib):
    """The achromatic box without NEE at depth 3, by both loops, against the
    independent scalar oracle of ``tests/test_oracle.py`` at its own 16x12,
    2 spp and tolerance."""
    from test_oracle import H as OH, SPP as OSPP, W as OW

    case = Case("achromatic", 0.0, False, w=OW, h=OH, depth=3)
    oracle = VPTOracle(presets.build_vpt_scene("achromatic").build("cpu"),
                       presets.preset_vpt("cpu")[1], OW, OH, seed=0)
    expect = np.zeros((OH, OW, 3))
    for py in range(OH):
        for px in range(OW):
            for s in range(OSPP):
                expect[py, px] += oracle.vpt(px, py, s)
    expect /= OSPP
    assert expect.mean() > 1e-3
    per_sample, _ = case.per_sample(lib, OSPP)
    merged, _, _, _ = case.merged(lib, OSPP)
    for got in (per_sample, merged):
        np.testing.assert_allclose(got.reshape(OH, OW, 3).numpy() / OSPP, expect,
                                   rtol=1e-3, atol=2e-4)


def test_work_order_covers_every_lane_once(lib):
    """On a frame whose width is not a multiple of 32 the work order is a
    permutation of the view lanes, longest chord through the medium first,
    and the merged loop over it writes every view lane once, bitwise the
    per-sample loop and inside the K1 gates of the plain version."""
    case = Case("mis", 0.0, True, w=23, h=13)
    n = case.view.n
    order = case.order.to(torch.int64)
    assert order.dtype == torch.int64 and case.order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    cost = vm.reach_cost(case.vc, case.view)
    n_long = int((cost > 0).sum())
    assert 0 < n_long < n
    assert bool((cost[order[1:]] <= cost[order[:-1]]).all())
    ref, ref_rej = case.per_sample(lib)
    got, rej, writes, _ = case.merged(lib)
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(got, ref) and torch.equal(rej, ref_rej)
    ref_plain, rej_plain = vm.vol_spp_plain(case.vc, case.view, 0, N_SPP)
    _within_k1_gates("23x13 frame, merged loop", got, rej, ref_plain, rej_plain)
