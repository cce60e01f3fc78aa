"""CPU rehearsal of the triangle sweeps' culled walk (``csrc/sweep.cuh``) and
of the chunk table it walks.

g++ compiles ``sweep.cuh`` under the shim of
``tests/test_torch_csrc_tracking.py`` (plus ``make_float4``), without fused
multiply-adds. A host program runs the sweeps as ``csrc/sweep.cu`` does,
with a warp of 32 real lanes whose votes are a loop over them, and loads
with ctypes. On every case, per lane:

* the culled walk (``warp_walk``: groups, then chunks, of the chunk table,
  visited only when some lane of the warp wants them) is bitwise the
  brute-force walk over every row in (t, idx, u, v) and in the any-hit
  sweep's blocked flag;
* both match the plain versions ``kernels.sweep_nearest_plain`` /
  ``occluded_anyhit_plain`` inside ``chip_smoke.py``'s gates (idx
  mismatches outside the tie band and blocked flags that differ: at most
  max(1, 1e-4 N); t, u, v on lanes that agree, widened by ``GRAZING_ULPS``
  = 4 ulps of |o - v0| / |cos| for rays that start on a surface);
* the host table (``row_box`` / ``finish_box`` over each chunk) is bitwise
  ``kernels.chunk_boxes_plain``, whose chunk rows agree with the JAX
  package's ``_build_chunk_aabbs`` (a plain ``jnp`` function) to 1e-6
  relative: the box is exact, its padding 1e-4 x extent + 1e-6 may round
  once more or less where XLA contracts the multiply-add.

Cases: a Morton-sorted sphere mesh (2,448 triangles with a floor and a quad
light, camera rays in Z-order, cosine bounce rays, shadow rays to the light
with the light's rows masked out of ``blocks``), rays that run in the faces
of chunk boxes, axis-parallel directions (with -0.0 components), one
triangle in two chunks (the first row must win the exact tie), planes
stacked back to front one per chunk (each nearer chunk enters within 7% of
the running best, so the prune must keep it), a ragged table of two groups
with an all-invalid chunk inside each, a chunk of small triangles far from
the table's centroid (inside the padding condition of ``csrc/sweep.cu``),
an empty table, parked lanes (t_max <= 0).
"""

import ctypes
import os
import shutil
import subprocess
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_csrc_tracking import CSRC, SHIM
from xraytracer_tpu.geometry.pallas_kernels import _build_chunk_aabbs
from xraytracer_tpu_torch.geometry import kernels
from xraytracer_tpu_torch.renderer import _morton_argsort
from xraytracer_tpu_torch.scene.builder import SceneBuilder

torch.set_num_threads(1)

# chip_smoke.py's gates for the sweeps against their plain versions
IDX_MISMATCH_SHARE = 1e-4
TIE_BAND = 2.0 ** -15
T_RTOL, T_ATOL = 1e-4, 1e-5
UV_RTOL, UV_ATOL = 2e-3, 1e-4
GRAZING_ULPS = 4
BLOCKED_MISMATCH_SHARE = 1e-4
# chunk rows against the JAX package's _build_chunk_aabbs
JAX_BOX_RTOL = 1e-6
# the "far small chunk" case: its distance from the table's centroid
FAR_X = 10.0

NEAREST, ANYHIT = 0, 2

HOST = r"""
#include "sweep.cuh"
using namespace xrt;

// a warp of 32 lanes run one after the other; a vote is the OR of theirs
struct HostWarp {
  static constexpr int LANES = 32;
  SweepRay ray[32];
  const float4* coef;
  bool vote(bool p) { return p; }
  void fetch(int, int) {}
  const float4* rows(int c, int, bool) { return coef + (size_t)c * SWEEP_CHUNK * 4; }
  void release() {}
};

template <int MODE>
static void sweep(int culled, int n, const float* o, const float* d,
                  const float* t_max, const float* center, int t_total,
                  const float* boxes, const float4* coef, const float* v0,
                  const float* e1, const float* e2, float* out_t,
                  int* out_idx, float* out_u, float* out_v) {
  const float3 c = make_float3(center[0], center[1], center[2]);
  for (int w0 = 0; w0 < n; w0 += 32) {
    HostWarp w;
    w.coef = coef;
    for (int i = 0; i < 32; ++i) {
      const int r = w0 + i;
      const bool live = r < n;
      float3 oi = make_float3(0.f, 0.f, 0.f), di = oi;
      float tm = 0.f;
      if (live) {
        oi = load3(o, r);
        di = load3(d, r);
        if (MODE == ANYHIT) tm = t_max[r];
      }
      w.ray[i] = sweep_ray<MODE>(oi, di, c, live, tm);
      if (!culled) brute_walk<MODE>(w.ray[i], coef, t_total);
    }
    if (culled) warp_walk<MODE>(w, (const float4*)boxes, t_total);
    for (int i = 0; i < 32 && w0 + i < n; ++i) {
      const int r = w0 + i, b = w.ray[i].best_i;
      float t = INF_T, u = 0.f, v = 0.f;
      if (MODE != ANYHIT && b >= 0)
        winner_tuv(load3(o, r), load3(d, r), load3(v0, b), load3(e1, b),
                   load3(e2, b), t, u, v);
      out_idx[r] = b;
      out_t[r] = t;
      out_u[r] = u;
      out_v[r] = v;
    }
  }
}

extern "C" {
void rh_layout(int* chunk, int* group) {
  *chunk = SWEEP_CHUNK;
  *group = SWEEP_GROUP;
}

// the chunk table as csrc/sweep.cu's chunk_boxes builds it, a host loop in
// place of the block's reduction
void rh_table(int t_total, const float* v0, const float* e1, const float* e2,
              const uint8_t* mask, const float* center, float* boxes,
              float* coef) {
  const int n_chunks = (t_total + SWEEP_CHUNK - 1) / SWEEP_CHUNK;
  const int n_groups = (n_chunks + SWEEP_GROUP - 1) / SWEEP_GROUP;
  const float3 c = make_float3(center[0], center[1], center[2]);
  float4* cf = (float4*)coef;
  for (int ch = 0; ch < n_chunks; ++ch) {
    Box b = empty_box();
    bool valid = false;
    for (int k = 0; k < SWEEP_CHUNK; ++k) {
      const int j = ch * SWEEP_CHUNK + k;
      TriCoeffs f = zero_coeffs();
      if (j < t_total && mask[j]) {
        const float3 p = sub3(load3(v0, j), c);
        f = tri_coeffs(p, load3(e1, j), load3(e2, j));
        b = join(b, row_box(p, load3(e1, j), load3(e2, j)));
        valid = true;
      }
      cf[4 * j] = f.f0;
      cf[4 * j + 1] = f.f1;
      cf[4 * j + 2] = f.f2;
      cf[4 * j + 3] = f.f3;
    }
    finish_box(b, valid, boxes + ch * BOX_STRIDE);
  }
  for (int g = 0; g < n_groups; ++g) {
    Box gb = empty_box();
    float gv = 0.f;
    for (int ch = g * SWEEP_GROUP; ch < n_chunks && ch < (g + 1) * SWEEP_GROUP; ++ch) {
      const float* r = boxes + ch * BOX_STRIDE;
      gb = join(gb, Box{make_float3(r[0], r[1], r[2]), make_float3(r[3], r[4], r[5])});
      gv = std::max(gv, r[BOX_VALID]);
    }
    float* out = boxes + (n_chunks + g) * BOX_STRIDE;
    const float row[8] = {gb.lo.x, gb.lo.y, gb.lo.z, gb.hi.x, gb.hi.y, gb.hi.z, gv, 0.f};
    for (int k = 0; k < 8; ++k) out[k] = row[k];
  }
}

void rh_sweep(int mode, int culled, int n, const float* o, const float* d,
              const float* t_max, const float* center, int t_total,
              const float* boxes, const float* coef, const float* v0,
              const float* e1, const float* e2, float* out_t, int* out_idx,
              float* out_u, float* out_v) {
  if (mode == ANYHIT)
    sweep<ANYHIT>(culled, n, o, d, t_max, center, t_total, boxes,
                  (const float4*)coef, v0, e1, e2, out_t, out_idx, out_u, out_v);
  else
    sweep<NEAREST>(culled, n, o, d, t_max, center, t_total, boxes,
                   (const float4*)coef, v0, e1, e2, out_t, out_idx, out_u, out_v);
}
}
"""

_P = ctypes.c_void_p
_I = ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ not found: the CUDA headers cannot be rehearsed on the host")
    tmp = tmp_path_factory.mktemp("sweep_rehearsal")
    (tmp / "cuda_runtime.h").write_text(
        SHIM + "inline float4 make_float4(float x, float y, float z, float w) "
               "{ return {x, y, z, w}; }\n")
    (tmp / "lanes.cpp").write_text(HOST)
    out = tmp / "libsweep_rehearsal.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{tmp}", f"-I{os.path.abspath(CSRC)}", "-o", str(out),
         str(tmp / "lanes.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    h = ctypes.CDLL(str(out))
    h.rh_layout.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    h.rh_table.argtypes = [_I] + [_P] * 7
    h.rh_sweep.argtypes = [_I, _I, _I] + [_P] * 4 + [_I] + [_P] * 9
    for fn in (h.rh_layout, h.rh_table, h.rh_sweep):
        fn.restype = None
    return h


def _layout(lib):
    chunk, group = ctypes.c_int(), ctypes.c_int()
    lib.rh_layout(ctypes.byref(chunk), ctypes.byref(group))
    return chunk.value, group.value


def _ptr(x):
    return x.data_ptr()


def host_table(lib, v0, e1, e2, mask, center):
    chunk, group = _layout(lib)
    t_total = v0.shape[0]
    n_chunks = -(-t_total // chunk)
    n_groups = -(-n_chunks // group)
    boxes = torch.zeros((n_chunks + n_groups, 8))
    coef = torch.zeros((n_chunks * chunk, 16))
    mask8 = mask.to(torch.uint8).contiguous()
    lib.rh_table(t_total, _ptr(v0), _ptr(e1), _ptr(e2), _ptr(mask8), _ptr(center),
                 _ptr(boxes), _ptr(coef))
    return boxes, coef


def host_sweep(lib, mode, culled, o, d, t_max, table):
    n = o.shape[0]
    out_t = torch.empty(n)
    out_u = torch.empty(n)
    out_v = torch.empty(n)
    out_i = torch.empty(n, dtype=torch.int32)
    lib.rh_sweep(mode, int(culled), n, _ptr(o), _ptr(d), _ptr(t_max), _ptr(table.center),
                 table.v0.shape[0], _ptr(table.boxes), _ptr(table.coef), _ptr(table.v0),
                 _ptr(table.e1), _ptr(table.e2), _ptr(out_t), _ptr(out_i), _ptr(out_u),
                 _ptr(out_v))
    return out_t, out_i, out_u, out_v


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------
def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32))


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _table(v0, e1, e2, mask, lib):
    v0, e1, e2 = (_t(x) for x in (v0, e1, e2))
    mask = torch.as_tensor(np.asarray(mask, bool))
    center = kernels._center(v0)
    boxes, coef = host_table(lib, v0, e1, e2, mask, center)
    return SimpleNamespace(v0=v0, e1=e1, e2=e2, mask=mask, center=center,
                           boxes=boxes, coef=coef)


def _sphere_scene():
    """The mesh scene of bench_mesh.py at 34x36 (2,448 triangles, Morton
    sorted by the builder), its floor and its quad light."""
    b = SceneBuilder()
    white = b.add_lambert((0.8, 0.8, 0.8))
    b.add_sphere_mesh((0.0, 0.0, 0.0), 1.0, 34, 36, material=white)
    floor = np.asarray([[[-4, -1, -4], [4, -1, -4], [4, -1, 4]],
                        [[-4, -1, -4], [4, -1, 4], [-4, -1, 4]]], np.float32)
    b.add_mesh(floor, material=white)
    b.add_quad_light((-1.0, 3.0, -1.0), (1.0, 3.0, -1.0), (-1.0, 3.0, 1.0),
                     (10.0, 10.0, 10.0))
    return b.build("cpu")


def _sphere_rays(tables, lib):
    """Camera rays of a 64x48 view in Z-order, the cosine bounce rays of
    their hits and the shadow rays from the hits to the light, both from
    1e-4 above the hit."""
    w, h = 64, 48
    ids = _morton_argsort(w, h, torch.device("cpu")).numpy()
    x = (ids % w + 0.5) / w * 2 - 1
    y = 1 - (ids // w + 0.5) / h * 2
    tan = np.tan(np.radians(22.5))
    d = _unit(np.stack([x * tan * w / h, y * tan, -np.ones_like(x)], -1))
    o = np.tile(np.float32([0.0, 0.6, 4.0]), (w * h, 1))
    valid = (tables.tri_obj >= 0).numpy()
    light = tables.obj_light[torch.clamp(tables.tri_obj, min=0).long()].numpy()
    tab = _table(tables.tri_v0, tables.tri_e1, tables.tri_e2, valid, lib)
    blocks = _table(tables.tri_v0, tables.tri_e1, tables.tri_e2,
                    valid & (light < 0), lib)
    t, idx, _, _ = kernels.sweep_nearest_plain(_t(o), _t(d), tab.v0, tab.e1, tab.e2,
                                               tab.mask)
    hit = (idx >= 0).numpy()
    p = (o + t.numpy()[:, None] * d)[hit]
    n = np.cross(tab.e1.numpy()[idx.numpy()[hit]], tab.e2.numpy()[idx.numpy()[hit]])
    n = _unit(n * np.sign(-(n * d[hit]).sum(-1, keepdims=True)))
    # lifted off the surface: a re-hit of the own triangle at t ~ 1e-7 is
    # decided by rounding, differently in the plain version's sums
    p = (p + 1e-4 * n).astype(np.float32)
    rng = np.random.default_rng(7)
    b = _unit(rng.normal(size=n.shape))
    b = _unit(n + b)                       # cosine-like around the normal
    lp = np.float32([-1.0, 3.0, -1.0]) + rng.uniform(0, 2, (len(p), 1)) * np.float32(
        [1, 0, 0]) + rng.uniform(0, 2, (len(p), 1)) * np.float32([0, 0, 1])
    sd = lp - p
    dist = np.linalg.norm(sd, axis=-1)
    t_max = (dist * (1 - 1e-4)).astype(np.float32)
    t_max[::7] = 0.0                         # parked lanes
    return tab, blocks, dict(
        camera=(o, d, None), bounce=(p, b, None),
        shadow=(p, _unit(sd), t_max))


def _random_table(t_total, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-scale, scale, (t_total, 3)).astype(np.float32)
    e1 = rng.uniform(-1.5, 1.5, (t_total, 3)).astype(np.float32)
    e2 = rng.uniform(-1.5, 1.5, (t_total, 3)).astype(np.float32)
    return v0, e1, e2


def _random_rays(n, seed, scale=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    return o, _unit(rng.normal(size=(n, 3)))


def _cases(lib):
    """{name: (nearest table, blocking table, o, d, t_max or None)}."""
    tables = _sphere_scene()
    tab, blocks, rays = _sphere_rays(tables, lib)
    cases = {f"sphere {k}": (tab, blocks, *v) for k, v in rays.items()}

    # rays in the faces of chunk boxes: origins on a box's lo / hi planes,
    # directions with a zero component across that axis
    v0, e1, e2 = _random_table(700, seed=3)
    mask = np.ones(700, bool)
    graze = _table(v0, e1, e2, mask, lib)
    bx = graze.boxes.numpy()
    c = graze.center.numpy()
    rng = np.random.default_rng(4)
    o, d = [], []
    for ch in range(-(-700 // _layout(lib)[0])):
        for k in range(3):
            for side in (0, 3):
                for _ in range(12):
                    p = rng.uniform(bx[ch, :3], bx[ch, 3:6]) + c
                    p[k] = bx[ch, k + side] + c[k]
                    dd = rng.normal(size=3)
                    dd[k] = 0.0 if rng.uniform() < 0.5 else -0.0
                    o.append(p)
                    d.append(dd)
    o, d = np.float32(o), _unit(np.float32(d))
    cases["box faces"] = (graze, graze, o, d, rng.uniform(0.0, 12.0, len(o)))

    # axis-parallel directions, with -0.0 components
    o, _ = _random_rays(600, seed=5)
    axes = np.float32([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                       [0, 0, -1], [-0.0, -0.0, 1], [0, -0.0, -1]])
    d = axes[np.arange(600) % len(axes)]
    cases["axis-parallel"] = (graze, graze, o, d, np.full(600, 20.0, np.float32))

    # one triangle in two chunks: rows 5 and 200 are the same triangle
    v0, e1, e2 = _random_table(300, seed=6)
    for a in (v0, e1, e2):
        a[200] = a[5]
    dup = _table(v0, e1, e2, np.ones(300, bool), lib)
    rng = np.random.default_rng(8)
    bary = rng.uniform(0.05, 0.45, (256, 2)).astype(np.float32)
    target = v0[5] + bary[:, :1] * e1[5] + bary[:, 1:] * e2[5]
    nrm = _unit(np.cross(e1[5], e2[5]))
    # from 0.05 above or below, tilted: no other row lies in between
    tilt = _unit(nrm + 0.3 * rng.normal(size=(256, 3)))
    o = target + tilt * np.where(np.arange(256)[:, None] % 2, 0.05, -0.05)
    cases["duplicate triangle"] = (dup, dup, o, _unit(target - o),
                                   np.full(256, 30.0, np.float32))

    # a ragged table of two groups (T = (group + 3) x chunk + 61) with an
    # all-invalid chunk inside each group, valid chunks on both sides
    chunk, group = _layout(lib)
    t_total = (group + 3) * chunk + 61
    v0, e1, e2 = _random_table(t_total, seed=9)
    mask = np.ones(t_total, bool)
    mask[chunk:2 * chunk] = False
    mask[(group + 1) * chunk:(group + 2) * chunk] = False
    mask[-3:] = False
    rag = _table(v0, e1, e2, mask, lib)
    o, d = _random_rays(777, seed=10)
    t_max = np.random.default_rng(11).uniform(-1.0, 9.0, 777).astype(np.float32)
    t_max[::9] = 0.0
    cases["ragged, an invalid chunk"] = (rag, rag, o, d, t_max)

    # layers back to front: chunk k is a plane of one chunk of triangles at
    # distance 10 - 0.1 k from the rays' origins, so the nearest hit is in
    # the last chunk and every chunk enters within 7% of the running best
    # (the prune must keep each nearer chunk); t_max among the layers for
    # the any-hit sweep
    cols = chunk // 8             # 4 x cols quads = one chunk of triangles
    lv0, le1, le2 = [], [], []
    for k in range(8):
        z = -(10.0 - 0.1 * k)
        for i in range(cols):
            for j in range(4):
                x, y, hx, hy = -1 + 2 * i / cols, -1 + j / 2, 2 / cols, 0.5
                lv0 += [(x, y, z), (x + hx, y + hy, z)]
                le1 += [(hx, 0, 0), (-hx, 0, 0)]
                le2 += [(0, hy, 0), (0, -hy, 0)]
    layers = _table(np.float32(lv0), np.float32(le1), np.float32(le2),
                    np.ones(len(lv0), bool), lib)
    rng = np.random.default_rng(13)
    d = _unit(np.concatenate([rng.uniform(-0.08, 0.08, (512, 2)),
                              -np.ones((512, 1))], 1).astype(np.float32))
    o = np.zeros((512, 3), np.float32)
    t_max = rng.uniform(9.2, 10.5, 512).astype(np.float32)
    cases["layers back to front"] = (layers, layers, o, d, t_max)

    # a chunk of small triangles far from the table's centroid, as far as
    # the padding condition of csrc/sweep.cu allows: FAR_X from it, its
    # triangles ~1e-3 in size, padded by over 1e-6 against half an ulp of
    # 4.8e-7 there; rays
    # aimed inside its triangles from 1e-3 to 10 away, and rays that run in
    # the planes of its box's faces
    v0, e1, e2 = _random_table((group + 8) * chunk, seed=14, scale=1.0)
    e1 *= 0.2
    e2 *= 0.2
    rng = np.random.default_rng(15)
    rows = slice(5 * chunk, 6 * chunk)
    v0[rows] = np.float32([FAR_X, 0, 0]) + rng.uniform(-1e-3, 1e-3, (chunk, 3))
    e1[rows] = rng.uniform(-1e-3, 1e-3, (chunk, 3))
    e2[rows] = rng.uniform(-1e-3, 1e-3, (chunk, 3))
    far = _table(v0, e1, e2, np.ones(len(v0), bool), lib)
    bx = far.boxes.numpy()[5]
    c = far.center.numpy()
    fo, fd = [], []
    for i in range(5 * chunk, 6 * chunk):
        for a, b in rng.uniform(0.1, 0.4, (8, 2)):
            p = v0[i] + a * e1[i] + b * e2[i]
            src = p + rng.normal(size=3) * 10.0 ** rng.uniform(-3, 1)
            fo.append(src)
            fd.append(p - src)
    for k in range(3):
        for side in (0, 3):
            for _ in range(200):
                p = rng.uniform(bx[:3], bx[3:6]) + c
                p[k] = bx[k + side] + c[k]
                dd = rng.normal(size=3)
                dd[k] = 0.0
                fo.append(p - 3.0 * dd)
                fd.append(dd)
    cases["far small chunk"] = (far, far, np.float32(fo), _unit(np.float32(fd)),
                                np.full(len(fo), 20.0, np.float32))

    # an empty table
    empty = _table(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)),
                   np.zeros(0, bool), lib)
    cases["T = 0"] = (empty, empty, o[:100], d[:100], t_max[:100])
    return cases


@pytest.fixture(scope="module")
def cases(lib):
    return _cases(lib)


CASE_NAMES = ["sphere camera", "sphere bounce", "sphere shadow", "box faces",
              "axis-parallel", "duplicate triangle", "layers back to front",
              "ragged, an invalid chunk", "far small chunk", "T = 0"]


def _t_max(o, t_max):
    if t_max is None:
        return torch.full((o.shape[0],), 100.0)
    return _t(t_max)


# --------------------------------------------------------------------------
# the chunk table
# --------------------------------------------------------------------------
def test_layout_matches_kernels_module(lib):
    assert _layout(lib) == (kernels.SWEEP_CHUNK, kernels.SWEEP_GROUP)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_host_table_is_chunk_boxes_plain(cases, name):
    for tab in cases[name][:2]:
        boxes, coef = kernels.chunk_boxes_plain(tab.v0, tab.e1, tab.e2, tab.mask,
                                                tab.center)
        assert torch.equal(boxes, tab.boxes)
        np.testing.assert_allclose(coef.numpy(), tab.coef.numpy(), rtol=1e-6, atol=1e-6)
        assert not coef[tab.v0.shape[0]:].any()         # rows padding the last chunk
        assert not coef[:tab.v0.shape[0]][~tab.mask].any()  # masked rows


@pytest.mark.parametrize("t_total,invalid", [(3 * 128, ()), (5 * 128 + 61, (128, 256)),
                                             (17 * 128, (0, 128 * 17))])
def test_chunk_boxes_plain_matches_jax(t_total, invalid):
    v0, e1, e2 = _random_table(t_total, seed=t_total, scale=30.0)
    mask = np.ones(t_total, bool)
    mask[slice(*invalid) if invalid else slice(0)] = False
    mask[-2:] = False
    center = kernels._center(_t(v0))
    boxes, _ = kernels.chunk_boxes_plain(_t(v0), _t(e1), _t(e2), torch.as_tensor(mask),
                                         center)
    n_chunks = -(-t_total // kernels.SWEEP_CHUNK)
    # the JAX builder takes whole chunks: pad with invalid rows
    extra = n_chunks * kernels.SWEEP_CHUNK - t_total
    pad = lambda a: np.concatenate([a, np.zeros((extra, 3), np.float32)])
    vc = pad(v0 - center.numpy())
    ref = np.asarray(_build_chunk_aabbs(
        jnp.asarray(vc), jnp.asarray(pad(e1)), jnp.asarray(pad(e2)),
        jnp.asarray(np.concatenate([mask, np.zeros(extra, bool)])), kernels.SWEEP_CHUNK))
    got = boxes[:n_chunks].numpy()
    np.testing.assert_allclose(got, ref, rtol=JAX_BOX_RTOL, atol=0)
    assert (got[:, 6] == mask_any(mask, n_chunks)).all()
    # the group rows: union of the chunk rows, valid iff one chunk is
    g = boxes[n_chunks:].numpy()
    for k in range(g.shape[0]):
        part = got[k * kernels.SWEEP_GROUP:(k + 1) * kernels.SWEEP_GROUP]
        np.testing.assert_array_equal(g[k, :3], part[:, :3].min(0))
        np.testing.assert_array_equal(g[k, 3:6], part[:, 3:6].max(0))
        assert g[k, 6] == part[:, 6].max()


def mask_any(mask, n_chunks):
    m = np.concatenate([mask, np.zeros(n_chunks * kernels.SWEEP_CHUNK - len(mask), bool)])
    return m.reshape(n_chunks, -1).any(1)


def test_chunk_boxes_on_cpu_is_the_plain_version():
    v0, e1, e2 = (_t(a) for a in _random_table(200, seed=12))
    mask = torch.ones(200, dtype=torch.bool)
    before = kernels.PLAIN_CALLS["chunk_boxes"]
    boxes, coef = kernels.chunk_boxes(v0, e1, e2, mask, kernels._center(v0))
    assert kernels.PLAIN_CALLS["chunk_boxes"] == before + 1
    n_chunks = -(-200 // kernels.SWEEP_CHUNK)
    assert boxes.shape == (n_chunks + 1, 8)
    assert coef.shape == (n_chunks * kernels.SWEEP_CHUNK, 16)
    empty = torch.zeros((0, 3))
    boxes, coef = kernels.chunk_boxes(empty, empty, empty, torch.zeros(0, dtype=torch.bool),
                                      torch.zeros(3))
    assert boxes.shape == (0, 8) and coef.shape == (0, 16)


# --------------------------------------------------------------------------
# the walk
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def walks(lib, cases):
    """{(case, mode): (culled, brute, plain, inputs)} for the nearest-hit
    sweep on the valid mask and the any-hit sweep on the blocking mask."""
    out = {}
    for name, (tab, blocks, o, d, t_max) in cases.items():
        o, d = _t(o), _t(d)
        tm = _t_max(o, t_max)
        for mode, table in ((NEAREST, tab), (ANYHIT, blocks)):
            culled = host_sweep(lib, mode, True, o, d, tm, table)
            brute = host_sweep(lib, mode, False, o, d, tm, table)
            if mode == NEAREST:
                plain = kernels.sweep_nearest_plain(o, d, table.v0, table.e1, table.e2,
                                                    table.mask)
            else:
                plain = kernels.occluded_anyhit_plain(o, d, table.v0, table.e1, table.e2,
                                                      table.mask, tm)
            out[name, mode] = (culled, brute, plain, (o, d, tm, table))
    return out


@pytest.mark.parametrize("mode", [NEAREST, ANYHIT], ids=["nearest", "anyhit"])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_culled_walk_is_brute_force_walk(walks, name, mode):
    culled, brute, _, _ = walks[name, mode]
    for a, b in zip(culled, brute):
        assert torch.equal(a, b)


def _grazing_slack(o, d, v0, e1, e2, idx):
    ix = torch.clamp(idx, min=0).long()
    ng = torch.linalg.cross(e1[ix], e2[ix])
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
    cos = torch.abs((d * ng).sum(-1)) / torch.clamp(norm(d) * norm(ng), min=1e-30)
    slack_t = GRAZING_ULPS * 2.0 ** -23 * norm(o - v0[ix]) / torch.clamp(cos, min=1e-12)
    edge = torch.clamp(torch.minimum(norm(e1[ix]), norm(e2[ix])), min=1e-30)
    return slack_t, slack_t / edge


@pytest.mark.parametrize("name", CASE_NAMES)
def test_walks_match_plain_nearest(walks, name):
    culled, _, (pt, pi, pu, pv), (o, d, _, table) = walks[name, NEAREST]
    kt, ki, ku, kv = culled
    n = kt.shape[0]
    mism = ki != pi
    both = (ki >= 0) & (pi >= 0)
    rel = torch.abs(kt - pt) / torch.clamp(torch.abs(pt), min=1e-9)
    outside = mism & ~(both & (rel < TIE_BAND))
    assert int(outside.sum()) <= max(1, IDX_MISMATCH_SHARE * n)
    agree = both & ~mism
    if table.v0.shape[0] == 0:
        assert not (ki >= 0).any() and not (pi >= 0).any()
        return
    st, suv = _grazing_slack(o, d, table.v0, table.e1, table.e2, pi)
    for got, ref, rtol, atol, slack in ((kt, pt, T_RTOL, T_ATOL, st),
                                        (ku, pu, UV_RTOL, UV_ATOL, suv),
                                        (kv, pv, UV_RTOL, UV_ATOL, suv)):
        lim = atol + rtol * torch.abs(ref) + slack
        assert not ((torch.abs(got - ref) > lim) & agree).any()
    miss = ki < 0
    assert bool((kt[miss] > 3.0e38).all()) and not ku[miss].any() and not kv[miss].any()
    assert int((ki >= 0).sum()) > 0


@pytest.mark.parametrize("name", CASE_NAMES)
def test_walks_match_plain_anyhit(walks, name):
    culled, _, blocked, (_, _, tm, _) = walks[name, ANYHIT]
    got = culled[1] >= 0
    n = got.shape[0]
    assert int((got != blocked).sum()) <= max(1, BLOCKED_MISMATCH_SHARE * n)
    assert not got[tm <= 0].any()


def test_far_small_chunk_meets_the_padding_condition(cases):
    """The "far small chunk" case lies inside the condition under which the
    culled walk is the brute-force walk (csrc/sweep.cu): its chunk's
    padding survives rounding at its coordinates, so its box is wider than
    its vertices' on every side."""
    tab = cases["far small chunk"][0]
    chunk = kernels.SWEEP_CHUNK
    p = (tab.v0 - tab.center)[5 * chunk:6 * chunk]
    verts = torch.cat([p, p + tab.e1[5 * chunk:6 * chunk], p + tab.e2[5 * chunk:6 * chunk]])
    box = tab.boxes[5]
    assert float(box[0]) > FAR_X - 1.0
    assert (box[:3] < verts.amin(0)).all() and (box[3:6] > verts.amax(0)).all()


def test_duplicate_triangle_keeps_the_first_row(walks):
    culled, _, _, _ = walks["duplicate triangle", NEAREST]
    idx = culled[1]
    assert int((idx == 5).sum()) > 240 and not (idx == 200).any()


def test_culling_skips_work(lib, cases):
    """The cases reach the skips: the lanes of a warp of the sphere's
    camera rays enter fewer than a quarter of the chunk boxes (the slab
    test replayed in numpy over the chunk table, without the prune)."""
    tab = cases["sphere camera"][0]
    o, d = (_t(x) for x in cases["sphere camera"][2:4])
    chunk, group = _layout(lib)
    n_chunks = -(-tab.v0.shape[0] // chunk)
    bx = tab.boxes.numpy()[:n_chunks]
    oc = o.numpy() - tab.center.numpy()
    dd = d.numpy()
    inv = 1.0 / np.where(np.abs(dd) < 1e-12, np.copysign(1e-12, dd), dd)
    with np.errstate(over="ignore"):  # the empty boxes' 3e38 x 1e12
        ta = (bx[None, :, 0:3] - oc[:, None]) * inv[:, None]
        tb = (bx[None, :, 3:6] - oc[:, None]) * inv[:, None]
    tmin = np.minimum(ta, tb).max(-1)
    tmax = np.maximum(ta, tb).min(-1)
    hit_box = (tmax >= tmin) & (tmax > 0) & (bx[None, :, 6] > 0)
    per_warp = hit_box.reshape(-1, 32, n_chunks).any(1).sum(1)
    assert per_warp.mean() < 0.25 * n_chunks
