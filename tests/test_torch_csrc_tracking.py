"""CPU rehearsal of the heterogeneous tracking core and the whole-path
heterogeneous lane loops of ``xraytracer_tpu_torch/csrc``.

The CUDA headers ``media.cuh`` (the supergrid walk, delta tracking, ratio
tracking) and ``het_path.cuh`` (one volume path cut into phases, the
per-lane loops of K9) hold no kernel launch, so g++ compiles them under a
small shim of the CUDA built-ins (``cuda_runtime.h`` below), without fused
multiply-adds (``-ffp-contract=off``, which is what ``XM`` / ``XA`` keep nvcc
from doing on the card). A small host program loops over the lanes and is
loaded with ctypes. Per lane, on the ``tests/data/cloud_32.npz`` grid:

* ``track_sample`` / ``track_transmittance`` against ``media.py``'s plain
  loops: the decisions (``t``, ``scattered``, ``scat_step``) bitwise, the
  weights at ``chip_smoke.py``'s ``TRACK_W_*`` tolerances;
* K9c's merged loop (``het_spp_persistent_lane``), whose warp votes are
  answered at random by 31 pretended lanes so that its chains of candidates
  are held and taken up again at arbitrary turns, against K9b's iteration
  loop (``het_spp_lane``) in the same library: bitwise;
* both against ``het_megakernel.het_spp_plain`` at 1e-6 relative (glibc's
  ``expf`` / ``logf`` / ``cosf`` differ from PyTorch's in the last bit).

The inputs include lanes whose first candidate lands exactly on a run of
equal optical-depth edges (a draw of 0 at a ray's start in empty
supercells, or at the end of a span that is all empty or of length 0,
where the transmittance takes the tail with ``sig_n = 0``), lanes that cross
empty supercells, and a medium whose global majorant is 1000 times its
need, so that candidates fall within ``RAY_EPS x majorant`` of a segment's
end and the walk's whole depth is read ahead of the cursor.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from xraytracer_tpu_torch import media_kernels as mk_media
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.integrators import het_megakernel as hk
from xraytracer_tpu_torch.math import from_rows
from xraytracer_tpu_torch.sampling import rng
from xraytracer_tpu_torch.scene import presets
from xraytracer_tpu_torch.scene.builder import scene_statics

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(__file__), "..", "xraytracer_tpu_torch", "csrc")
CLOUD = os.path.join(os.path.dirname(__file__), "data", "cloud_32.npz")

# chip_smoke.py's tolerances for the tracking weights (same decisions, the
# weights' exp / log / divisions of two math libraries)
TRACK_W_RTOL, TRACK_W_ATOL = 1e-4, 1e-6
SPP_RTOL = 1e-6   # whole paths against the plain version, relative to the largest sum
N_TRACK = 384
W, H = 12, 9

SHIM = r"""
// host shim of the CUDA built-ins that the csrc headers use
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <algorithm>
#define __device__
#define __forceinline__ inline
#define __shared__ static
struct float3 { float x, y, z; };
struct float4 { float x, y, z, w; };
struct uint3 { unsigned x, y, z; };
static uint3 threadIdx;  // lanes run one after the other: one frame column
inline float3 make_float3(float x, float y, float z) { return {x, y, z}; }
inline float __ldg(const float* p) { return *p; }
inline float4 __ldg(const float4* p) { return *p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float atomicAdd(float* p, float v) { const float o = *p; *p = o + v; return o; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// a warp of 32 lanes, of which this one is lane 0; the other 31 vote at
// random, an eighth or seven eighths of them for, so that the merged
// loop's chains are held and taken up again at arbitrary turns
inline unsigned __activemask() { return 0xFFFFFFFFu; }
inline unsigned __ballot_sync(unsigned mask, bool pred) {
  static unsigned x = 12345u;
  x = x * 1664525u + 1013904223u;
  const unsigned a = x >> 1, b = x * 2654435761u, c = b * 2246822519u;
  const unsigned others = (x >> 31) ? (a & b & c) : (a | b | c);
  return (others & mask & ~1u) | (pred ? 1u : 0u);
}
using std::max;
using std::min;
"""

HOST_LOOPS = r"""
#include "het_path.cuh"
using namespace xrt;
extern "C" {
void rh_track_sample(int n, const float* o, const float* d, const float* t0,
                     const float* t1, const float* tp, const int32_t* keys,
                     unsigned site, const float* fc, const int* ic,
                     const float* density, const float* packed,
                     const float* super, float* out_t, float* out_w,
                     int32_t* out_scat, int32_t* out_step) {
  const MediaGrid G = grid_from(fc, ic, density, packed, super);
  for (int i = 0; i < n; ++i) {
    const float tpv[3] = {tp[3 * i], tp[3 * i + 1], tp[3 * i + 2]};
    const TrackResult R = track_sample(G, load3(o, i), load3(d, i), t0[i],
                                       t1[i], tpv, (uint32_t)keys[i], site);
    out_t[i] = R.t;
    for (int c = 0; c < 3; ++c) out_w[3 * i + c] = R.w[c];
    out_scat[i] = R.scattered;
    out_step[i] = R.scat_step;
  }
}
void rh_track_transmittance(int n, const float* p1, const float* p2,
                            const int32_t* keys, unsigned site,
                            const float* fc, const int* ic,
                            const float* density, const float* packed,
                            const float* super, float* out_tr) {
  const MediaGrid G = grid_from(fc, ic, density, packed, super);
  for (int i = 0; i < n; ++i)
    track_transmittance(G, load3(p1, i), load3(p2, i), (uint32_t)keys[i], site,
                        out_tr + 3 * i);
}
void rh_het_spp(int merged, int s0, int n_spp, const int32_t* pixfold,
                const float* px, const float* py, int n, const float* cam16,
                unsigned cam_site, const float* fc, const int* ic,
                const float* mfc, const int* mic, const float* density,
                const float* packed, const float* super, float* out_sum,
                int32_t* out_rej) {
  const HetScene S = het_scene_from(fc, ic);
  const MediaGrid G = grid_from(mfc, mic, density, packed, super);
  const MegaCamera C = camera_from(cam16, cam_site);
  for (int i = 0; i < n; ++i) {
    float3 acc = make_float3(0.f, 0.f, 0.f);
    int rej = 0;
    if (merged)
      het_spp_persistent_lane(S, G, C, s0, n_spp, (uint32_t)pixfold[i], px[i],
                              py[i], acc, rej);
    else
      het_spp_lane(S, G, C, s0, n_spp, (uint32_t)pixfold[i], px[i], py[i],
                   acc, rej);
    out_sum[3 * i + 0] = acc.x;
    out_sum[3 * i + 1] = acc.y;
    out_sum[3 * i + 2] = acc.z;
    out_rej[i] = rej;
  }
}
}
"""

_P = ctypes.c_void_p
_FC = ctypes.POINTER(ctypes.c_float)
_IC = ctypes.POINTER(ctypes.c_int)
_GRID = [_FC, _IC, _P, _P, _P]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ not found: the CUDA headers cannot be rehearsed on the host")
    tmp = tmp_path_factory.mktemp("csrc_rehearsal")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    (tmp / "lanes.cpp").write_text(HOST_LOOPS)
    out = tmp / "librehearsal.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{tmp}", f"-I{os.path.abspath(CSRC)}", "-o", str(out),
         str(tmp / "lanes.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    h = ctypes.CDLL(str(out))
    h.rh_track_sample.argtypes = [ctypes.c_int] + [_P] * 6 + [ctypes.c_uint] + _GRID + [_P] * 4
    h.rh_track_transmittance.argtypes = [ctypes.c_int] + [_P] * 3 + [ctypes.c_uint] + _GRID + [_P]
    h.rh_het_spp.argtypes = ([ctypes.c_int] * 3 + [_P] * 3 + [ctypes.c_int, _FC, ctypes.c_uint,
                             _FC, _IC] + _GRID + [_P, _P])
    for fn in (h.rh_track_sample, h.rh_track_transmittance, h.rh_het_spp):
        fn.restype = None
    return h


def _cloud_tables(sigma_a, sigma_s, majorant_scale=1.0, **light):
    density = np.load(CLOUD)["density"]
    tables = presets.build_volume_scene(
        density=density, absorption=(sigma_a,) * 3, scattering=sigma_s,
        **light).build("cpu")
    if majorant_scale != 1.0:
        tables = tables._replace(med_majorant=tables.med_majorant * majorant_scale)
    return tables


# (sigma_a, sigma_s per channel, global majorant scale)
MEDIA = {
    "thin": (0.02, (0.06, 0.05, 0.04), 1.0),
    "dense": (0.5, (0.5, 0.45, 0.4), 1.0),
    "loose_majorant": (0.5, (0.5, 0.45, 0.4), 1000.0),
}


def _pcg_inverse(out):
    """x with pcg(x) == out (the port's 32-bit PCG output is a bijection)."""
    m = 0xFFFFFFFF
    w = out ^ (out >> 22)
    y = (w * pow(277803737, -1, 2 ** 32)) & m
    r = (y >> 28) + 4
    s = y
    for _ in range(8):
        s = y ^ (s >> r)
    return ((s - 2891336453) * pow(747796405, -1, 2 ** 32)) & m


def _key_drawing_zero(site):
    """A path key whose draw at ``site`` is exactly 0.0."""
    x = _pcg_inverse(7)
    return (x - site * 0x9E3779B9) & 0xFFFFFFFF


def test_pcg_inverse():
    keys = [_key_drawing_zero(s) for s in (0, 17, 1 << 16)]
    for k, s in zip(keys, (0, 17, 1 << 16)):
        u = rng.uniform1(torch.tensor([k], dtype=torch.int64), s)
        assert float(u[0]) == 0.0


def _rays(n, seed):
    """Rays at the cloud box from outside and from inside, with their box
    spans; every eighth lane draws 0 for its first distance."""
    g = np.random.default_rng(seed)
    lo = np.float32([-165.0, -110.0, -160.0])
    hi = np.float32([165.0, 110.0, 160.0])
    o = g.uniform(lo * 1.6, hi * 1.6, (n, 3)).astype(np.float32)
    o[n // 2:] = g.uniform(lo * 0.9, hi * 0.9, (n - n // 2, 3))
    target = g.uniform(lo * 0.5, hi * 0.5, (n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    with np.errstate(divide="ignore"):
        ta = (lo[None] - o) / d
        tb = (hi[None] - o) / d
    t0 = np.maximum(np.minimum(ta, tb).max(axis=1), 0.0).astype(np.float32)
    t1 = np.maximum(ta, tb).min(axis=1).astype(np.float32)
    t1[::29] = t0[::29]                 # zero-length spans
    return o, d, t0, t1


def _ptr(x):
    return x.data_ptr()


def test_track_sample_matches_plain(lib):
    """Delta tracking per lane against media.py's loop: decisions bitwise."""
    site = 16 + 3 * (1 << 16)
    for label, (sa, ss, scale) in MEDIA.items():
        tables = _cloud_tables(sa, ss, scale)
        hm = mk_media.het_medium(tables, 256)
        o, d, t0, t1 = _rays(N_TRACK, seed=3)
        g = np.random.default_rng(4)
        keys = g.integers(0, 2 ** 32, N_TRACK, dtype=np.int64)
        keys[::8] = _key_drawing_zero(site + 1)       # u_dist = 0 at step 0
        tp = g.uniform(0.2, 1.5, (N_TRACK, 3)).astype(np.float32)
        to = [torch.from_numpy(np.ascontiguousarray(x)) for x in (o, d, t0, t1, tp)]
        kt = torch.from_numpy(keys)
        ref_t, ref_w, ref_s, ref_k = mk_media.track_sample_plain(
            hm, *to, kt, site, torch.ones(N_TRACK, dtype=torch.bool))
        out_t = torch.empty(N_TRACK)
        out_w = torch.empty((N_TRACK, 3))
        out_s = torch.empty(N_TRACK, dtype=torch.int32)
        out_k = torch.empty(N_TRACK, dtype=torch.int32)
        k32 = mk_media._i32_bits(kt)
        lib.rh_track_sample(N_TRACK, *[_ptr(x) for x in to], _ptr(k32), site,
                            *hm.grid_args(), _ptr(out_t), _ptr(out_w), _ptr(out_s),
                            _ptr(out_k))
        assert torch.equal(out_s.bool(), ref_s), label
        assert torch.equal(out_k, ref_k), label
        assert torch.equal(out_t, ref_t), label
        np.testing.assert_allclose(out_w.numpy(), ref_w.numpy(), rtol=TRACK_W_RTOL,
                                   atol=TRACK_W_ATOL, err_msg=label)
        # the inputs reach what they are for: scatters, escapes, zero weights
        assert 0 < int(ref_s.sum()) < N_TRACK, label
        assert int(ref_k.max()) > 2, label


def test_track_transmittance_matches_plain(lib):
    """Ratio tracking per lane against media.py's loop, spans through the
    cloud, spans that are all empty or of length 0, a draw of 0 at step 0."""
    site = 41 + (1 << 16)
    for label, (sa, ss, scale) in MEDIA.items():
        tables = _cloud_tables(sa, ss, scale)
        hm = mk_media.het_medium(tables, 256)
        o, d, t0, t1 = _rays(N_TRACK, seed=5)
        p1 = (o + t0[:, None] * d).astype(np.float32)
        p2 = (o + t1[:, None] * d).astype(np.float32)
        p2[1::16] = p1[1::16]                            # length 0
        p1[2::16] = np.float32([-164.0, -109.0, -159.0])   # a corner: empty
        p2[2::16] = np.float32([-150.0, -109.0, -159.0])
        g = np.random.default_rng(6)
        keys = g.integers(0, 2 ** 32, N_TRACK, dtype=np.int64)
        keys[::4] = _key_drawing_zero(site)                # u = 0 at step 0
        tp1, tp2 = torch.from_numpy(p1), torch.from_numpy(p2)
        kt = torch.from_numpy(keys)
        ref = mk_media.track_transmittance_plain(
            hm, tp1, tp2, kt, site, torch.ones(N_TRACK, dtype=torch.bool))
        out = torch.empty((N_TRACK, 3))
        k32 = mk_media._i32_bits(kt)
        lib.rh_track_transmittance(N_TRACK, _ptr(tp1), _ptr(tp2), _ptr(k32), site,
                                   *hm.grid_args(), _ptr(out))
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=TRACK_W_RTOL,
                                   atol=TRACK_W_ATOL, err_msg=label)
        # zero (the tail's sig_n = 0 at a length-0 span), one (empty spans)
        # and values in between all occur
        r = ref[:, 0]
        assert bool((r == 0).any()) and bool((r == 1).any()), label
        assert bool(((r > 0) & (r < 1)).any()), label


def _camera():
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 70.0, 550.0, 1)
    return PinholeCamera.make(W / H, c2w=c2w, fov_deg=60.0, device="cpu")


@pytest.mark.parametrize("case", ["thin_nee", "dense_nee", "thin"])
def test_het_spp_lanes(lib, case):
    """K9c's state machine against K9b's iteration loop (bitwise) and both
    against the plain version, on whole paths of a few samples."""
    label, nee, depth, n_spp = {"thin_nee": ("thin", True, 6, 3),
                                "dense_nee": ("dense", True, 8, 2),
                                "thin": ("thin", False, 12, 4)}[case]
    sa, ss, scale = MEDIA[label]
    if not nee:  # chains of null collisions, whose weights reach the light
        scale = 8.0
    # without next-event estimation a path must hit the light: a large one
    # behind the cloud, seen through it
    light = {} if nee else dict(light_center=(0.0, 0.0, -330.0), light_radius=160.0)
    tables = _cloud_tables(sa, ss, scale, **light)
    st = scene_statics(tables)
    hc = hk._het_consts(tables, st, depth, nee, None, None)
    assert hc is not None
    view = hk.try_make_fused_het_spp_render(tables, st, _camera(), W, H, 0, depth,
                                            nee=nee, force=True).view
    n = view.n
    cam = (ctypes.c_float * 16)(*[float(c) for c in view.cam])
    got = {}
    for merged in (0, 1):
        out = torch.empty((n, 3))
        rej = torch.empty(n, dtype=torch.int32)
        lib.rh_het_spp(merged, 0, n_spp, _ptr(view.pixfold_bits), _ptr(view.px),
                       _ptr(view.py), n, cam, view.cam_site, hc.fc, hc.ic,
                       *hc.hm.grid_args(), _ptr(out), _ptr(rej))
        got[merged] = out, rej
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])
    ref, ref_rej = hk.het_spp_plain(hc, view, 0, n_spp)
    assert torch.equal(got[1][1], ref_rej.to(torch.int32))
    scale_ = float(ref.abs().max())
    assert scale_ > 0.0
    np.testing.assert_allclose(got[1][0].numpy(), ref.numpy(), rtol=0,
                               atol=SPP_RTOL * scale_)
