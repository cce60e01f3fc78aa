"""CPU rehearsal of the analytic volume-gradient kernel (K10,
``het_grad_path``) and of the corner table of a live grid
(``pack_corners``), from ``xraytracer_tpu_torch/csrc``.

g++ compiles ``het_path.cuh`` under the shim of
``tests/test_torch_csrc_tracking.py`` (``atomicAdd`` an add), without
fused multiply-adds. A host program runs K10's lanes as
``het_megakernel.cu`` does, one after the other, on the 16^3 cloud of
``tests/test_het_grad_kernel.py`` at 16x12, depth 3:

* pass B's radiance bitwise pass A's (``het_path_lane``, same library) on
  the live grid's corner table, and pass A there bitwise pass A on the
  dense grid; both within 1e-6 of ``het_path_plain`` (glibc's ``expf`` /
  ``logf`` against PyTorch's);
* the Le planes and the gradient grid, on the corner table and by corner
  loads, against ``het_grad_path_plain`` (autograd on the same draws) at
  ``chip_smoke.py``'s gates, with the shadow rays' transmittance events
  taken both from the lane's buffer and by a second walk;
* ``corner_row`` over every cell of ``tests/data/cloud_32.npz`` bitwise the
  scene builder's corner table.

And, through the plain versions, ``step.step_pair``'s one launch per pass
over both streams' 2N lanes against the two streams replayed apart.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from test_torch_csrc_tracking import CLOUD, CSRC, SHIM
from xraytracer_tpu_torch import media
from xraytracer_tpu_torch import media_kernels as mk_media
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.integrators import het_megakernel as hk
from xraytracer_tpu_torch.math import from_rows
from xraytracer_tpu_torch.renderer import CAMERA_SITE, pixel_grid
from xraytracer_tpu_torch.sampling import path_keys, uniform2
from xraytracer_tpu_torch.scene import presets
from xraytracer_tpu_torch.scene.builder import scene_statics

torch.set_num_threads(1)

W, H, DEPTH, MAX_STEPS = 16, 12, 3, 32
# chip_smoke.py's gates for K10 against its plain version: the grid at
# rtol 5e-3 / atol 5e-4 x its largest cell (events summed in another
# order), Le at rtol 5e-3 / atol 1e-8
GRID_RTOL, GRID_ATOL_REL = 5e-3, 5e-4
LE_RTOL, LE_ATOL = 5e-3, 1e-8
IMG_RTOL = 1e-6   # against the plain version, relative to the largest value
# the transmittance events a lane of K10 keeps (csrc/het_path.cuh)
TR_EVENTS = int(re.search(r"constexpr int TR_EVENTS = (\d+);",
                          open(os.path.join(CSRC, "het_path.cuh")).read()).group(1))

HOST_LOOPS = r"""
#include <vector>
#include "het_path.cuh"
using namespace xrt;
extern "C" {
void rh_het_path(const float* o, const float* d, const int32_t* keys, int n,
                 const float* fc, const int* ic, const float* mfc,
                 const int* mic, const float* density, const float* packed,
                 const float* super, float* out) {
  const HetScene S = het_scene_from(fc, ic);
  const MediaGrid G = grid_from(mfc, mic, density, packed, super);
  NoReplay none;
  for (int i = 0; i < n; ++i) {
    threadIdx.x = i % 128;
    const float3 L = het_path_lane(S, G, (uint32_t)keys[i], load3(o, i),
                                   load3(d, i), none);
    out[3 * i + 0] = L.x;
    out[3 * i + 1] = L.y;
    out[3 * i + 2] = L.z;
  }
}
// het_megakernel.cu's het_grad_path_kernel, lane after lane
void rh_het_grad_path(const float* o, const float* d, const int32_t* keys,
                      const float* img, const float* rfac, int n,
                      const float* fc, const int* ic, const float* mfc,
                      const int* mic, const float* density,
                      const float* packed, const float* super, float* out,
                      float* dE, float* grad) {
  const HetScene S = het_scene_from(fc, ic);
  const MediaGrid G = grid_from(mfc, mic, density, packed, super);
  for (int i = 0; i < n; ++i) {
    threadIdx.x = i % 128;
    const float im[3] = {img[3 * i], img[3 * i + 1], img[3 * i + 2]};
    const float rf[3] = {rfac[3 * i], rfac[3 * i + 1], rfac[3 * i + 2]};
    const float3 L = het_grad_lane(S, G, (uint32_t)keys[i], load3(o, i),
                                   load3(d, i), im, rf, dE, i, n, grad);
    out[3 * i + 0] = L.x;
    out[3 * i + 1] = L.y;
    out[3 * i + 2] = L.z;
  }
}
void rh_pack_corners(const float* g, int nx, int ny, int nz, float* out) {
  for (int cell = 0; cell < nx * ny * nz; ++cell)
    corner_row(g, nx, ny, nz, cell, out + 8 * cell);
}
}
"""

_P = ctypes.c_void_p
_I = ctypes.c_int
_FC = ctypes.POINTER(ctypes.c_float)
_IC = ctypes.POINTER(ctypes.c_int)
_GRID = [_FC, _IC, _P, _P, _P]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ not found: the CUDA headers cannot be rehearsed on the host")
    tmp = tmp_path_factory.mktemp("csrc_grad_rehearsal")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    (tmp / "grad.cpp").write_text(HOST_LOOPS)
    out = tmp / "libgrad.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         f"-I{tmp}", f"-I{os.path.abspath(CSRC)}", "-o", str(out), str(tmp / "grad.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    h = ctypes.CDLL(str(out))
    h.rh_het_path.argtypes = [_P, _P, _P, _I, _FC, _IC] + _GRID + [_P]
    h.rh_het_grad_path.argtypes = [_P] * 5 + [_I, _FC, _IC] + _GRID + [_P] * 3
    h.rh_pack_corners.argtypes = [_P, _I, _I, _I, _P]
    for fn in (h.rh_het_path, h.rh_het_grad_path, h.rh_pack_corners):
        fn.restype = None
    return h


def _cloud_case(majorant_scale, max_steps):
    """The 16^3 cloud (its majorants scaled), its grad-sampling
    constants, one sample's camera rays and keys, and the plain version's
    pass A and pass B."""
    g = np.zeros((16, 16, 16), np.float32)
    g[3:13, 3:13, 3:13] = np.random.default_rng(7).uniform(0.3, 1.0, (10, 10, 10))
    tables = presets.build_volume_scene(
        res=g.shape, density=g, absorption=(0.02, 0.03, 0.04),
        scattering=(0.10, 0.08, 0.06), le=25.0, light_center=(0.0, 400.0, 0.0),
    ).build("cpu")
    tables = tables._replace(grid_super=tables.grid_super * majorant_scale,
                             med_majorant=tables.med_majorant * majorant_scale)
    hc = hk._het_consts(tables, scene_statics(tables), DEPTH, True, max_steps, None,
                        grad_sampling=True)
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 60.0, 520.0, 1)
    cam = PinholeCamera.make(W / H, c2w=c2w, fov_deg=60.0, device="cpu")
    ids, xy = pixel_grid(W, H, device="cpu")
    keys = path_keys(0, ids, 0)
    rays = cam.sample_rays((xy + uniform2(keys, CAMERA_SITE)) / torch.tensor([float(W), float(H)]))
    o, d = rays.o.contiguous(), rays.d.contiguous()
    grid = torch.from_numpy(g)
    # the plain transmittance loops' active lanes at each step: a lane
    # active at step TR_EVENTS + 1 has more events than K10's buffer holds
    walks, track = [], media._track_transmittance

    def counted(*a, candidates=None, **k):
        walks.append([])
        return track(*a, candidates=walks[-1], **k)

    media._track_transmittance = counted
    try:
        img = hk.het_path_plain(hc, o, d, keys, density=grid)
    finally:
        media._track_transmittance = track
    rfac = (2.0 * (img - (img * 0.7 + 0.01)) / (img.shape[0] * 3)).contiguous()
    ref = hk.het_grad_path_plain(hc, o, d, keys, img, rfac, grid)
    return dict(hc=hc, o=o, d=d, keys=keys, grid=grid, img=img, rfac=rfac, ref=ref,
                packed=mk_media.pack_corners(grid), tables=tables, cam=cam, ids=ids, xy=xy,
                shadow_lanes=sum(w[0] for w in walks if w),
                over_buffer=sum(w[TR_EVENTS + 1] for w in walks if len(w) > TR_EVENTS + 1))


@pytest.fixture(scope="module")
def cloud():
    return _cloud_case(1.0, MAX_STEPS)


@pytest.fixture(scope="module")
def loose_cloud():
    """The same cloud under 4x its majorants and a step bound past
    the event buffer's: shadow rays with more events than a lane keeps."""
    return _cloud_case(4.0, 2 * TR_EVENTS)


def _ptr(x):
    return x.data_ptr()


def _pass_a(lib, c, packed):
    n = c["o"].shape[0]
    out = torch.empty((n, 3))
    k32 = mk_media._i32_bits(c["keys"])
    lib.rh_het_path(_ptr(c["o"]), _ptr(c["d"]), _ptr(k32), n, c["hc"].fc, c["hc"].ic,
                    *c["hc"].hm.grid_args(c["grid"], packed), _ptr(out))
    return out


def test_pass_a_on_the_corner_table(lib, cloud):
    """K9a's lane on the live grid's corner table: bitwise the same lane on
    the dense grid, and the plain version's image within float rounding."""
    packed = _pass_a(lib, cloud, cloud["packed"])
    dense = _pass_a(lib, cloud, None)
    assert torch.equal(packed, dense)
    scale = float(cloud["img"].abs().max())
    assert scale > 0.0
    np.testing.assert_allclose(packed.numpy(), cloud["img"].numpy(), rtol=0,
                               atol=IMG_RTOL * scale)


@pytest.mark.parametrize("table", [True, False], ids=["corner_table", "corner_loads"])
@pytest.mark.parametrize("medium", ["cloud", "loose_cloud"])
def test_grad_lane_matches_plain(lib, request, medium, table):
    """K10's lanes, on the live grid's corner table and by eight corner
    loads, against the plain version (autograd); the shadow rays' events
    from the lane's buffer (every walk of the cloud) and by a second walk
    (some of the loose cloud's)."""
    c = request.getfixturevalue(medium)
    assert c["shadow_lanes"] > 0
    assert (c["over_buffer"] > 0) == (medium == "loose_cloud")
    n = c["o"].shape[0]
    n_l = int(c["hc"].ic[1])
    img_a = _pass_a(lib, c, c["packed"])
    out = torch.empty((n, 3))
    planes = torch.full((3 * n_l, n), float("nan"))
    grad = torch.zeros_like(c["grid"])
    k32 = mk_media._i32_bits(c["keys"])
    lib.rh_het_grad_path(_ptr(c["o"]), _ptr(c["d"]), _ptr(k32), _ptr(img_a),
                         _ptr(c["rfac"]), n, c["hc"].fc, c["hc"].ic,
                         *c["hc"].hm.grid_args(c["grid"], c["packed"] if table else None),
                         _ptr(out), _ptr(planes), _ptr(grad))
    assert torch.equal(out, img_a)      # pass B's radiance is pass A's
    _, gle_ref, grad_ref = c["ref"]
    gle = planes.view(3, n_l, n).permute(2, 0, 1)
    np.testing.assert_allclose(gle.numpy(), gle_ref.numpy(), rtol=LE_RTOL, atol=LE_ATOL)
    scale = float(grad_ref.abs().max())
    assert scale > 0.0 and int((grad_ref != 0).sum()) > 500
    np.testing.assert_allclose(grad.numpy(), grad_ref.numpy(), rtol=GRID_RTOL,
                               atol=GRID_ATOL_REL * scale)


def test_corner_row_is_the_builders_table(lib):
    """pack_corners' cell function over every cell of the 32^3 cloud:
    bitwise the scene builder's corner table (and so its plain version)."""
    density = np.load(CLOUD)["density"]
    tables = presets.build_volume_scene(density=density).build("cpu")
    g = tables.grid_density.contiguous()
    out = torch.empty((g.numel(), 8))
    lib.rh_pack_corners(_ptr(g), *g.shape, _ptr(out))
    assert torch.equal(out, tables.grid_packed)
    assert torch.equal(mk_media.pack_corners_plain(g), tables.grid_packed)


def test_step_pair_is_the_two_replays(cloud):
    """``step_pair`` renders and replays its two streams (seed 0 sample 4,
    seed 7919 sample 5) as one batch of 2N lanes: its loss and d loss / d Le
    agree with the two streams replayed apart within 1e-6 relative, its
    grid at ``test_torch_diff_volume.py``'s rtol 1e-4 / atol 1e-5 x the
    largest cell (the same events summed in another order)."""
    c = cloud
    tables, cam, ids, xy, grid = c["tables"], c["cam"], c["ids"], c["xy"], c["grid"]
    step = hk.try_make_fused_het_value_and_grad(
        tables, scene_statics(tables), cam, W, H, DEPTH, nee=True, max_steps=MAX_STEPS,
        force=True)
    hc = step.het_consts
    n = W * H
    runs = []
    for seed, sample in ((0, 4), (7919, 5)):
        keys = path_keys(seed, ids, sample)
        rays = cam.sample_rays((xy + uniform2(keys, CAMERA_SITE)) / torch.tensor([float(W), float(H)]))
        o, d = rays.o.contiguous(), rays.d.contiguous()
        runs.append((o, d, keys, hk.het_path(hc, o, d, keys, density=grid)))
    target = runs[0][3] * 0.6 + 0.02
    (a, b) = (r[3] for r in runs)
    loss = torch.mean((a - target) * (b - target))
    g_grid = g_le = 0.0
    for (o, d, keys, img), rfac in zip(runs, ((b - target) / (n * 3), (a - target) / (n * 3))):
        _, gle, gg = hk.het_grad_path(hc, o, d, keys, img, rfac.contiguous(), grid)
        g_grid = g_grid + gg
        g_le = g_le + torch.einsum("nc,ncl->lc", rfac, gle)
    hk.reset_counts()
    aux = {}
    got_loss, got = step.step_pair({"grid_density": grid, "al_le": tables.al_le}, ids, xy,
                                   target, 4, 5, aux=aux)
    assert hk.counts()["het_path"]["plain_calls"] == 1
    assert hk.counts()["het_grad_path"]["plain_calls"] == 1
    assert torch.equal(aux["img"], a) and torch.equal(aux["img_b"], b)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-6)
    np.testing.assert_allclose(got["al_le"][:1].numpy(), g_le.numpy(), rtol=1e-6)
    scale = float(g_grid.abs().max())
    assert scale > 0.0
    np.testing.assert_allclose(got["grid_density"].numpy(), g_grid.numpy(), rtol=1e-4,
                               atol=1e-5 * scale)
