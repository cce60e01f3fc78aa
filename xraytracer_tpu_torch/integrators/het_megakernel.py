"""Whole-path HETEROGENEOUS volume kernels: CUDA kernels, their wrappers,
their plain PyTorch versions, and the factories that route a scene to them.

Counterpart of the forward half of
``xraytracer_tpu/integrators/het_megakernel.py``: the reference's cloud
workloads (``Src/examples/volume.cpp``, ``nee.cpp``: a density-grid box and
emissive sphere lights, no triangles), the whole path in one launch instead
of the wavefront loop's ``2 * max_depth + 2`` iterations of separate
launches. Three kernels, one device function for an iteration in
``csrc/het_megakernel.cu``:

* ``het_path`` replaces the kernel of ``try_make_fused_het_path_integrator``
  (over ``_het_trace_body``): rays and path keys in, radiance out.
* ``het_spp`` replaces ``try_make_fused_het_spp_render(persistent=False)``
  (``megakernel.py::_mega_spp_kernel``): per pixel a loop over a chunk of
  samples, each with its key, its jittered pinhole ray, its path and the
  NaN / Inf / negative rejection.
* ``het_spp_persistent`` replaces the same with ``persistent=True``
  (``_mega_spp_persistent_kernel`` over ``_make_het_iteration``; the default
  and so the route of the ``nee`` and ``volume`` presets): the sample loop
  merged into the iteration loop, so a lane whose path has ended starts its
  next sample at once.

An eligible scene (``_eligible_het``: no triangles, exactly one box carrying
the scene's one heterogeneous medium, every sphere purely emissive, at most
16 lights, all spheres, depth 1..128) travels by value with every launch
(``HetConsts``); the grid, its corner rows and the supergrid stay in device
memory, read by pointer as the tracking kernels read them
(``media_kernels.HetMedium``). ``het_pack`` and its size gate have no
counterpart. Nothing is compiled per scene. What bounds the kernels on the
card and what the design does about it is noted at the top of
``csrc/het_megakernel.cu``.

``grad_sampling`` (roulette off, uniform channel pick) reaches the kernels
as a launch flag, so the fused route renders the estimator it was asked for
(the JAX package's routing drops the flag there).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and counts the launch in
``LAUNCHES``. A wrapper runs the plain version only for tensors that lie on
the CPU (counted in ``PLAIN_CALLS``); for a CUDA tensor it launches the
kernel or raises. ``try_make_*`` return None for a scene that does not
qualify and for tables on the CPU unless ``force=True`` (the tests' way to
the plain versions).

The plain versions are the port's own wavefront volume integrator
(``integrators/volume.py`` with ``fused="never"``: the host-side tracking
loops of ``media.py``) over the plain matmul-form sweep, with a host loop
over samples and the camera ray of the kernels' formulas, so they reach no
kernel on either device.

The analytic volume gradient (the backward half of the JAX module):

* ``het_grad_path`` replaces the kernel of
  ``try_make_fused_het_value_and_grad`` (over ``_make_het_grad_iteration``
  and ``media_pallas.py::track_sample_grad`` / ``track_transmittance_grad``):
  pass B of a two-pass gradient. Pass A is ``het_path`` under
  ``grad_sampling`` (roulette off, uniform channel pick); pass B replays
  the same draws and adds, per tracking event, residual x the lane's
  contribution suffix x the closed-form ∂log factor / ∂density into a dense
  float32 gradient grid by ``atomicAdd`` of the eight trilinear corners
  (a shadow ray's events kept in the lane until its transmittance is
  known), and writes the per-lane ∂img/∂Le planes. Its plain version is
  ``torch.autograd`` through the wavefront route with ``differentiable``,
  ``score_terms`` and ``grad_sampling`` on the same rays and keys.
* ``try_make_fused_het_value_and_grad`` builds ``step`` and
  ``step.step_pair`` (the two-sample product loss, both streams in one
  launch of each pass) over the two passes, which read a live grid of
  more than ``media_kernels.PACK_MIN`` cells through its corner table
  (``media_kernels.pack_corners``, once per call).
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import media_kernels
from ..camera import PinholeCamera
from ..geometry import Rays
from ..geometry import kernels as sweeps
from ..media import default_max_steps
from ..scene.tables import AL_SPHERE, MED_HETEROGENEOUS
from . import megakernel as mk
from .vol_megakernel import _plain_paths, _spp_plain

KERNEL_NAMES = ("het_path", "het_spp", "het_spp_persistent", "het_grad_path")

# launches of each kernel, and calls of each plain version, since the last
# ``reset_counts()``: plain ints, bumped exactly where a wrapper launches
# its kernel (resp. where a plain version runs) and nowhere else
LAUNCHES = {name: 0 for name in KERNEL_NAMES}
PLAIN_CALLS = {name: 0 for name in KERNEL_NAMES}

MAX_LIGHTS = 16    # and at most as many spheres
MAX_DEPTH = 128
_SPHERE_STRIDE, _LIGHT_STRIDE = 5, 7   # floats per row, csrc/het_megakernel.cu

_MASK = 0xFFFFFFFF
_P = ctypes.c_void_p
_I = ctypes.c_int
_FC = ctypes.POINTER(ctypes.c_float)
_IC = ctypes.POINTER(ctypes.c_int)
_GRID = [_FC, _IC, _P, _P, _P]   # media grid: fc, ic, density, packed, super
_SPP_ARGTYPES = [_I, _I, _P, _P, _P, _I, _FC, ctypes.c_uint, _FC, _IC] + _GRID + [_P, _P, _P]
_ARGTYPES = {
    # o, d, keys, n, scene (fc, ic), grid, out, stream
    "het_path": [_P, _P, _P, _I, _FC, _IC] + _GRID + [_P, _P],
    # s0, n_spp, pixfold, px, py, n, cam16, cam_site, scene, grid, sum, rej,
    # stream
    "het_spp": _SPP_ARGTYPES,
    "het_spp_persistent": _SPP_ARGTYPES,
    # o, d, keys, img, rfac, n, scene (fc, ic), grid, out img, out dE, grad
    # grid, stream
    "het_grad_path": [_P] * 5 + [_I, _FC, _IC] + _GRID + [_P] * 4,
}


def _bind(lib):
    """Declare the launchers' C signatures on a loaded library."""
    if not getattr(lib, "_xrt_bound", False):
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib._xrt_bound = True
    return lib


def _lib():
    from .._build import load

    return _bind(load("het_megakernel"))


def _launch(name, args):
    rc = getattr(_lib(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")


def reset_counts():
    """Set every kernel's launch count and plain-version count to 0."""
    for name in KERNEL_NAMES:
        LAUNCHES[name] = 0
        PLAIN_CALLS[name] = 0


def counts():
    """``{kernel: {"launches": n, "plain_calls": m}}`` since the last reset."""
    return {
        name: {"launches": LAUNCHES[name], "plain_calls": PLAIN_CALLS[name]}
        for name in KERNEL_NAMES
    }


# --------------------------------------------------------------------------
# scene side: eligibility and the constants a launch carries
# --------------------------------------------------------------------------
def _eligible_het(scene, statics, max_depth):
    """Eligibility read from the concrete tables: no triangles, exactly ONE
    medium, heterogeneous, carried by the only box; every sphere purely
    emissive (a light, no material, no medium); at most 16 lights, all
    spheres, and at most 16 spheres; depth 1..128. Returns (spheres, box,
    lights, medium row) as dicts of numpy rows, or None."""
    a = {k: getattr(scene, k).cpu().numpy() for k in (
        "tri_obj", "sph_obj", "box_obj", "al_type", "med_type", "obj_light",
        "obj_medium", "obj_mat", "sph_center", "sph_radius", "box_min",
        "box_max", "al_center", "al_radius", "al_le")}
    if max_depth < 1 or max_depth > MAX_DEPTH:
        return None
    if (a["tri_obj"] >= 0).any() or (a["med_type"] >= 0).sum() != 1:
        return None
    boxes = np.flatnonzero(a["box_obj"] >= 0)
    if boxes.size != 1:
        return None
    mrow = a["obj_medium"][a["box_obj"][boxes[0]]]
    if mrow < 0 or a["med_type"][mrow] != MED_HETEROGENEOUS:
        return None
    spheres = []
    for s in np.flatnonzero(a["sph_obj"] >= 0):
        obj = a["sph_obj"][s]
        if a["obj_light"][obj] < 0 or a["obj_mat"][obj] >= 0 or a["obj_medium"][obj] >= 0:
            return None                 # a sphere that is not only an emitter
        spheres.append(dict(center=a["sph_center"][s], radius=a["sph_radius"][s],
                            lrow=int(a["obj_light"][obj])))
    n_lights = statics["n_area_lights"]
    if n_lights > MAX_LIGHTS or len(spheres) > MAX_LIGHTS:
        return None
    lights = []
    for i in range(n_lights):
        if a["al_type"][i] != AL_SPHERE:
            return None
        lights.append(dict(center=a["al_center"][i], radius=a["al_radius"][i],
                           le=a["al_le"][i]))
    box = dict(lo=a["box_min"][boxes[0]], hi=a["box_max"][boxes[0]])
    return spheres, box, lights, int(mrow)


@dataclass
class HetConsts:
    """What one launch needs of a scene, resolved once: the options, the
    two host arrays of ``csrc/het_megakernel.cu::het_scene_from`` and the
    medium (``media_kernels.HetMedium``: its host arrays and grid tables)."""

    scene: object
    statics: dict
    max_depth: int
    nee: bool
    max_steps: int
    n_iterations: int
    grad_sampling: bool
    hm: object   # media_kernels.HetMedium
    fc: object   # ctypes float array
    ic: object   # ctypes int array
    _plain = None   # {with_stats: integrate}, built on first use

    @property
    def device(self):
        return self.scene.tri_v0.device

    def plain_integrate(self, with_stats=False):
        """The wavefront volume integrator with the same options, host-side
        tracking loops and the plain matmul-form sweep: the plain version of
        a whole path. With ``with_stats`` it returns ``(radiance,
        per-iteration counters)``."""
        if self._plain is None:
            self._plain = {}
        if with_stats not in self._plain:
            self._plain[with_stats] = _wavefront_integrator(
                self, self.scene, with_stats=with_stats)
        return self._plain[with_stats]


def _het_consts(scene, statics, max_depth, nee, max_steps, n_iterations,
                grad_sampling=False):
    """Eligibility check, then the ``HetConsts`` of these options, or None."""
    from .volume import _nee_site_layout

    el = _eligible_het(scene, statics, max_depth)
    if el is None:
        return None
    spheres, box, lights, mrow = el
    if max_steps is None:
        max_steps = default_max_steps(scene)
    hm = media_kernels.het_medium(scene, max_steps, chan_uniform=grad_sampling)
    pick, light_site, tr_site = _nee_site_layout(max_steps)
    if n_iterations is None:
        n_iterations = 2 * max_depth + 2
    f32 = np.float32
    fc = np.zeros((MAX_LIGHTS * (_SPHERE_STRIDE + _LIGHT_STRIDE) + 8,), f32)
    for k, s in enumerate(spheres):
        row = fc[k * _SPHERE_STRIDE:(k + 1) * _SPHERE_STRIDE]
        row[0:3], row[3], row[4] = s["center"], s["radius"], s["lrow"]
    rest = fc[MAX_LIGHTS * _SPHERE_STRIDE:]
    for k, li in enumerate(lights):
        row = rest[k * _LIGHT_STRIDE:(k + 1) * _LIGHT_STRIDE]
        row[0:3], row[3], row[4:7] = li["center"], li["radius"], li["le"]
    m = rest[MAX_LIGHTS * _LIGHT_STRIDE:]
    m[0:3], m[3:6] = box["lo"], box["hi"]
    m[6] = scene.med_g.cpu().numpy()[mrow]
    # the plain version multiplies by the Python float 1 / n, rounded to f32
    m[7] = f32(1.0 / len(lights)) if lights else f32(0.0)
    ic = [len(spheres), len(lights), int(max_depth), int(n_iterations),
          int(bool(nee)), int(bool(grad_sampling)), int(pick), int(light_site),
          int(tr_site)]
    return HetConsts(
        scene=scene, statics=statics, max_depth=int(max_depth), nee=bool(nee),
        max_steps=int(max_steps), n_iterations=int(n_iterations),
        grad_sampling=bool(grad_sampling), hm=hm,
        fc=(ctypes.c_float * fc.size)(*[float(v) for v in fc]),
        ic=(ctypes.c_int * len(ic))(*ic),
    )


# --------------------------------------------------------------------------
# K9a: rays and keys in, radiance out
# --------------------------------------------------------------------------
def _live_scene(hc, density):
    """The scene with a live density grid: ``grid_density`` replaced and the
    corner table by a one-row sentinel, so that every lookup reads the live
    grid (``media.density_lookup``)."""
    s = hc.scene
    return s._replace(grid_density=density,
                      grid_packed=torch.zeros((1, 8), dtype=torch.float32,
                                              device=density.device))


def _wavefront_integrator(hc, scene, **kw):
    """The wavefront volume integrator of ``hc``'s options on ``scene``, host
    tracking loops over the matmul-form sweep."""
    from ..geometry.intersect import intersect_triangles_mm
    from .volume import make_volume_integrator

    return make_volume_integrator(
        scene, hc.statics, hc.max_depth, nee=hc.nee, max_steps=hc.max_steps,
        tri_fn=intersect_triangles_mm, n_iterations=hc.n_iterations,
        fused="never", grad_sampling=hc.grad_sampling, **kw,
    )


def het_path_plain(hc, o, d, keys, stats=None, density=None):
    """Plain PyTorch version of ``het_path``: the wavefront volume
    integrator of the same options. Returns (N, 3). A dict passed as
    ``stats`` receives the per-iteration counters of these paths."""
    PLAIN_CALLS["het_path"] += 1
    keys = keys.to(torch.int64) & _MASK
    if density is None:
        return _plain_paths(hc, o, d, keys, stats)
    if stats is not None:
        raise ValueError("het_path_plain: no counters with a live grid")
    return _wavefront_integrator(hc, _live_scene(hc, density))(Rays(o=o, d=d), keys)


def het_path(hc, o, d, keys, density=None, packed=None):
    """Radiance of one whole heterogeneous volume path per ray. ``o, d``
    (N, 3) f32; ``keys`` (N,) path keys (uint32 values held in int64, or
    their bits as int32). ``density``: a live (nx, ny, nz) f32 grid read in
    place of the scene's (the gradient route's pass A), through its corner
    table ``packed`` (``media_kernels.pack_corners``) when given, else by
    eight corner loads; both give the same radiance. Returns (N, 3) f32."""
    if not o.is_cuda:   # the corner table holds the grid's own values
        return het_path_plain(hc, o, d, keys, density=density)
    dev = o.device
    n = o.shape[0]
    sweeps._check("o", o, torch.float32, (n, 3), dev)
    sweeps._check("d", d, torch.float32, (n, 3), dev)
    keys = media_kernels._key_bits(keys, n, dev)
    media_kernels._check_grid(hc.hm, dev)
    if density is not None:
        media_kernels._check_live_grid(hc.hm, density, dev, packed)
    elif packed is not None:
        raise ValueError("het_path: a corner table needs its live grid")
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("het_path", (
            o.data_ptr(), d.data_ptr(), keys.data_ptr(), n, hc.fc, hc.ic,
            *hc.hm.grid_args(density, packed), out.data_ptr(), sweeps._stream(),
        ))
    LAUNCHES["het_path"] += 1
    return out


# --------------------------------------------------------------------------
# K9b, K9c: a chunk of samples per pixel
# --------------------------------------------------------------------------
def het_spp_plain(hc, view, s0, n_spp, stats=None, batch=1):
    """Plain PyTorch version of ``het_spp``: a host loop over the samples,
    ``batch`` of them at a time through the plain whole path (the sums are
    still taken sample by sample, in order). Returns (sum (N, 3), rejects
    (N,)). A dict passed as ``stats`` receives the per-iteration counters."""
    PLAIN_CALLS["het_spp"] += 1
    return _spp_plain(hc, view, s0, n_spp, stats, batch)


def het_spp_persistent_plain(hc, view, s0, n_spp, stats=None, batch=1):
    """Plain PyTorch version of ``het_spp_persistent``: the merged loop
    changes the schedule, not the function, so it is ``het_spp_plain``'s
    computation."""
    PLAIN_CALLS["het_spp_persistent"] += 1
    return _spp_plain(hc, view, s0, n_spp, stats, batch)


def _het_spp_launch(name, hc, view, s0, n_spp):
    dev = view.px.device
    n = view.n
    sweeps._check("pixfold", view.pixfold_bits, torch.int32, (n,), dev)
    sweeps._check("px", view.px, torch.float32, (n,), dev)
    sweeps._check("py", view.py, torch.float32, (n,), dev)
    media_kernels._check_grid(hc.hm, dev)
    s0, n_spp = int(s0), int(n_spp)
    if s0 < 0 or n_spp < 0 or s0 + n_spp >= 2 ** 31:
        raise ValueError(f"sample range [{s0}, {s0 + n_spp}) out of int32")
    cam = (ctypes.c_float * 16)(*[float(c) for c in view.cam])
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rej = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(name, (
            s0, n_spp, view.pixfold_bits.data_ptr(), view.px.data_ptr(),
            view.py.data_ptr(), n, cam, view.cam_site, hc.fc, hc.ic,
            *hc.hm.grid_args(), out.data_ptr(), rej.data_ptr(),
            sweeps._stream(),
        ))
    LAUNCHES[name] += 1
    return out, rej


def het_spp(hc, view, s0, n_spp):
    """Samples ``s0 .. s0 + n_spp - 1`` of every pixel lane of ``view``
    (``megakernel.RenderView``), one sample after the other per lane.
    Returns the radiance sums (N, 3) f32 and the rejected-sample counts
    (N,) int32."""
    if not view.px.is_cuda:
        return het_spp_plain(hc, view, s0, n_spp)
    return _het_spp_launch("het_spp", hc, view, s0, n_spp)


def het_spp_persistent(hc, view, s0, n_spp):
    """``het_spp`` with the sample loop and the iteration loop merged (a
    lane starts its next sample as soon as its path ends); the same sums."""
    if not view.px.is_cuda:
        return het_spp_persistent_plain(hc, view, s0, n_spp)
    return _het_spp_launch("het_spp_persistent", hc, view, s0, n_spp)


# --------------------------------------------------------------------------
# factories
# --------------------------------------------------------------------------
def try_make_fused_het_path_integrator(
    scene, statics, max_depth, nee=False, max_steps=None, n_iterations=None,
    force=False, grad_sampling=False,
):
    """``integrate(rays, keys)`` through ``het_path`` if the scene qualifies
    (a cloud box + emissive spheres), else None. Tables on the CPU qualify
    only with ``force`` (``integrate`` then runs the plain version)."""
    if not force and not scene.tri_v0.is_cuda:
        return None
    hc = _het_consts(scene, statics, max_depth, nee, max_steps, n_iterations,
                     grad_sampling)
    if hc is None:
        return None

    def integrate(rays, keys):
        if rays.o.device != hc.device:
            raise ValueError(f"rays on {rays.o.device}, scene on {hc.device}")
        return het_path(hc, rays.o.contiguous(), rays.d.contiguous(), keys)

    return integrate


def try_make_fused_het_spp_render(
    scene, statics, camera, width, height, seed, max_depth, nee=False,
    max_steps=None, n_iterations=None, force=False, pixel_order="raster",
    persistent=True, grad_sampling=False, mesh=None,
):
    """``render_chunk(s0, n_spp) -> (radiance_sum (N, 3), n_rejected)``
    running a whole chunk of samples in one launch (see
    ``megakernel.make_spp_render``; ``mesh``: this rank's block of the
    lanes), or None if the scene or the camera does
    not qualify. ``persistent=True`` (default) merges the sample loop into
    the path loop: the same image, and a lane whose path ends early (most
    of them: camera rays that miss the cloud, roulette) starts its next
    sample instead of waiting for the longest path of its warp."""
    if not force and not scene.tri_v0.is_cuda:
        return None
    if not isinstance(camera, PinholeCamera):
        return None
    hc = _het_consts(scene, statics, max_depth, nee, max_steps, n_iterations,
                     grad_sampling)
    if hc is None:
        return None
    kernel = het_spp_persistent if persistent else het_spp
    return mk.make_spp_render(
        lambda view, s0, n_spp: kernel(hc, view, s0, n_spp),
        camera, width, height, seed, pixel_order=pixel_order, mesh=mesh,
    )


# --------------------------------------------------------------------------
# K10: the analytic volume gradient, pass B
# --------------------------------------------------------------------------
def _n_lights(hc):
    return int(hc.ic[1])


def het_grad_path_plain(hc, o, d, keys, img, rfac, density, le_planes=True):
    """Plain PyTorch version of ``het_grad_path``: ``torch.autograd``
    through the wavefront route with ``differentiable``, ``score_terms`` and
    ``grad_sampling`` on the same rays and keys. The gradient grid is the
    backward pass of sum(rfac * img) w.r.t. the grid; the Le planes are
    forward-mode derivatives along each light's emission (radiance is
    linear in Le and channel by channel, so one direction per light gives
    its three planes). ``img`` (pass A's image) is not read: autograd keeps
    its own. Returns (img (N, 3), gle (N, 3, L), grad grid) as the kernel
    does; gle is None unless ``le_planes`` (which costs one forward-mode
    pass per light)."""
    PLAIN_CALLS["het_grad_path"] += 1
    keys = keys.to(torch.int64) & _MASK
    rays = Rays(o=o, d=d)
    base = hc.scene.al_le

    def render(grid, le):
        scene = _live_scene(hc, grid)._replace(al_le=le)
        integrate = _wavefront_integrator(hc, scene, differentiable=True,
                                          score_terms=True)
        return integrate(rays, keys)

    with torch.enable_grad():
        leaf = density.detach().clone().requires_grad_(True)
        img_b = render(leaf, base)
        grad = None
        if img_b.requires_grad:   # else no lane reached the grid
            (grad,) = torch.autograd.grad((rfac.detach() * img_b).sum(), leaf,
                                          allow_unused=True)
    if grad is None:
        grad = torch.zeros_like(leaf)
    if not le_planes:
        return img_b.detach(), None, grad
    n, n_l = o.shape[0], _n_lights(hc)
    gle = torch.zeros((n, 3, n_l), dtype=torch.float32, device=o.device)
    grid = density.detach()
    for li in range(n_l):
        t = torch.zeros_like(base)
        t[li] = 1.0
        _, tan = torch.func.jvp(lambda le: render(grid, le), (base,), (t,))
        gle[:, :, li] = tan
    return img_b.detach(), gle, grad


def het_grad_path(hc, o, d, keys, img, rfac, density, le_planes=True, packed=None):
    """Pass B of the analytic gradient of a loss of the radiance of one
    whole path per ray: replays ``het_path``'s draws under
    ``grad_sampling`` (``hc`` must be built with it) on the live grid
    ``density`` and accumulates sum over lanes and channels of
    ``rfac * ∂img/∂density`` into a gradient grid of the grid's shape.
    ``img`` (N, 3) is pass A's radiance of the same rays, keys and grid (the
    suffix the replay starts from); ``rfac`` (N, 3) the loss's derivative
    w.r.t. it. Returns (img (N, 3), the radiance pass B recomputed;
    gle (N, 3, L), gle[:, c, l] = ∂img_c/∂al_le[l, c] at the build-time
    emission, or None unless ``le_planes``; the gradient grid (nx, ny,
    nz)). ``packed``: ``density``'s corner table, read in place of eight
    corner loads per lookup (the same values). The grid is summed with
    atomic adds, so its last bits vary from run to run."""
    if not hc.grad_sampling:
        raise ValueError("het_grad_path: the constants must be built with grad_sampling")
    if not o.is_cuda:
        return het_grad_path_plain(hc, o, d, keys, img, rfac, density, le_planes)
    dev = o.device
    n = o.shape[0]
    f32 = torch.float32
    sweeps._check("o", o, f32, (n, 3), dev)
    sweeps._check("d", d, f32, (n, 3), dev)
    sweeps._check("img", img, f32, (n, 3), dev)
    sweeps._check("rfac", rfac, f32, (n, 3), dev)
    keys = media_kernels._key_bits(keys, n, dev)
    media_kernels._check_grid(hc.hm, dev)
    media_kernels._check_live_grid(hc.hm, density, dev, packed)
    n_l = _n_lights(hc)
    out_img = torch.empty((n, 3), dtype=f32, device=dev)
    planes = torch.empty((3 * n_l, n), dtype=f32, device=dev)
    grad = torch.zeros(density.shape, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        _launch("het_grad_path", (
            o.data_ptr(), d.data_ptr(), keys.data_ptr(), img.data_ptr(),
            rfac.data_ptr(), n, hc.fc, hc.ic, *hc.hm.grid_args(density, packed),
            out_img.data_ptr(), planes.data_ptr(), grad.data_ptr(),
            sweeps._stream(),
        ))
    LAUNCHES["het_grad_path"] += 1
    gle = planes.view(3, n_l, n).permute(2, 0, 1) if le_planes else None
    return out_img, gle, grad


def try_make_fused_het_value_and_grad(
    tables, statics, camera, width, height, max_depth, nee=True,
    max_steps=None, n_iterations=None, seed=0, force=False,
):
    """ANALYTIC value and gradient of the L2 image loss for the
    heterogeneous whole path (the volume counterpart of
    ``diff.try_make_fast_value_and_grad``), two passes per step: pass A
    renders the image with the grad-sampling estimator (``het_path``,
    roulette off, uniform channel pick), pass B (``het_grad_path``) replays
    the same draws and accumulates the density gradient and the per-lane
    ∂img/∂Le. The gradients are those of ``torch.autograd`` through
    ``make_volume_integrator(differentiable=True, score_terms=True,
    grad_sampling=True)`` on the same draws, up to float32 summation order.
    Each call first packs the live grid into its corner table
    (``media_kernels.pack_corners``, one table per step function, reused),
    so that both passes read one row per lookup; grids of at most
    ``media_kernels.PACK_MIN`` cells (faster by corner loads) and grids
    past the builder's gate are read by corner loads.

    Returns ``step(params, pixel_ids, pixel_xy, target, sample_idx) ->
    (loss, grads)`` for ``params`` keys "grid_density" and "al_le", and
    ``step.step_pair(params, pixel_ids, pixel_xy, target, sample_a,
    sample_b)``: the two-sample product loss mean((a - t) (b - t)) over two
    independent renders (streams ``seed`` and ``seed + 7919``), an unbiased
    surrogate for (E img - t)^2 that lacks the Var(img) term a plain L2 on
    one noisy render drives down by emptying the grid; both streams go
    through one pass-A and one pass-B launch over their 2N lanes, replayed
    with crossed residuals; ``step.render(grid, pixel_ids, pixel_xy,
    sample_idx)`` is pass A alone. A dict passed as ``aux`` receives the
    rendered images ("img", and "img_b" of the second stream).
    ``grid_density`` is LIVE: each call
    reads the tensor it is given. Le is the build-time value: "al_le"
    gradients are taken there, and a new Le needs a new step. The active
    set and the majorants stay as built (keep the densities below the grid
    the scene was built with). Returns None when ``_het_consts(...,
    grad_sampling=True)`` refuses the scene or the camera is not a pinhole,
    and for tables on the CPU unless ``force`` (which runs the plain
    versions)."""
    from ..renderer import CAMERA_SITE
    from ..sampling import path_keys, uniform2

    if not force and not tables.tri_v0.is_cuda:
        return None
    if not isinstance(camera, PinholeCamera):
        return None
    hc = _het_consts(tables, statics, max_depth, nee, max_steps, n_iterations,
                     grad_sampling=True)
    if hc is None:
        return None
    n_l = _n_lights(hc)
    dev = tables.tri_v0.device
    wh = torch.tensor([float(width), float(height)], device=dev)
    n_cells = tables.grid_density.numel()
    table = (torch.empty((n_cells, 8), dtype=torch.float32, device=dev)
             if media_kernels.PACK_MIN < n_cells <= media_kernels.PACK_GATE else None)

    def camera_rays(seed_, pixel_ids, pixel_xy, sample):
        keys = path_keys(seed_, pixel_ids, sample)
        u = uniform2(keys, CAMERA_SITE)
        rays = camera.sample_rays((pixel_xy + u) / wh)
        return rays.o, rays.d, keys

    def live_grid(grid):
        """The live grid and its corner table (None outside the gates)."""
        grid = grid.detach().contiguous()
        packed = None if table is None else media_kernels.pack_corners(grid, out=table)
        return grid, packed

    def passes(params, grid, packed, o, d, keys, rfac_of):
        """Pass A over the lanes (o, d, keys), the loss and the residual
        from ``rfac_of(img)``, then pass B: (img, loss, grads)."""
        o, d = o.contiguous(), d.contiguous()
        img = het_path(hc, o, d, keys, density=grid, packed=packed)
        loss, rfac = rfac_of(img)
        le = "al_le" in params
        _, gle, g_grid = het_grad_path(hc, o, d, keys, img, rfac.contiguous(), grid,
                                       le_planes=le, packed=packed)
        out = {}
        if "grid_density" in params:
            out["grid_density"] = g_grid
        if le:
            out["al_le"] = torch.zeros_like(params["al_le"])
            out["al_le"][:n_l] = torch.einsum("nc,ncl->lc", rfac, gle)
        return img, loss, out

    @torch.no_grad()
    def step(params, pixel_ids, pixel_xy, target, sample_idx, aux=None):
        grid, packed = live_grid(params.get("grid_density", tables.grid_density))
        o, d, keys = camera_rays(seed, pixel_ids, pixel_xy, sample_idx)
        n = keys.shape[0]

        def rfac_of(img):
            return torch.mean((img - target) ** 2), 2.0 * (img - target) / (n * 3)

        img, loss, grads = passes(params, grid, packed, o, d, keys, rfac_of)
        if aux is not None:
            aux["img"] = img
        return loss, grads

    @torch.no_grad()
    def step_pair(params, pixel_ids, pixel_xy, target, sample_a, sample_b,
                  aux=None):
        grid, packed = live_grid(params.get("grid_density", tables.grid_density))
        a = camera_rays(seed, pixel_ids, pixel_xy, sample_a)
        b = camera_rays(seed + 7919, pixel_ids, pixel_xy, sample_b)
        n = a[2].shape[0]

        def rfac_of(img):
            # lanes [0, n) are stream a, [n, 2n) stream b: each replays with
            # the other's residual
            img_a, img_b = img[:n], img[n:]
            loss = torch.mean((img_a - target) * (img_b - target))
            return loss, torch.cat([img_b - target, img_a - target]) / (n * 3)

        img, loss, grads = passes(params, grid, packed,
                                  *(torch.cat([x, y]) for x, y in zip(a, b)),
                                  rfac_of)
        if aux is not None:
            aux["img"], aux["img_b"] = img[:n], img[n:]
        return loss, grads

    @torch.no_grad()
    def render_image(grid, pixel_ids, pixel_xy, sample_idx):
        """Pass A alone: the grad-sampling image of ``grid`` (stream
        ``seed``), as ``step`` renders it."""
        grid, packed = live_grid(grid)
        o, d, keys = camera_rays(seed, pixel_ids, pixel_xy, sample_idx)
        return het_path(hc, o.contiguous(), d.contiguous(), keys, density=grid,
                        packed=packed)

    step.n_lights = n_l
    step.het_consts = hc
    step.step_pair = step_pair
    step.render = render_image
    return step
