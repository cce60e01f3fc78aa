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
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import media_kernels
from ..camera import PinholeCamera
from ..geometry import kernels as sweeps
from ..media import default_max_steps
from ..scene.tables import AL_SPHERE, MED_HETEROGENEOUS
from . import megakernel as mk
from .vol_megakernel import _plain_paths, _spp_plain

KERNEL_NAMES = ("het_path", "het_spp", "het_spp_persistent")

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
            from ..geometry.intersect import intersect_triangles_mm
            from .volume import make_volume_integrator

            self._plain[with_stats] = make_volume_integrator(
                self.scene, self.statics, self.max_depth, nee=self.nee,
                max_steps=self.max_steps, tri_fn=intersect_triangles_mm,
                n_iterations=self.n_iterations, fused="never",
                with_stats=with_stats, grad_sampling=self.grad_sampling,
            )
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
def het_path_plain(hc, o, d, keys, stats=None):
    """Plain PyTorch version of ``het_path``: the wavefront volume
    integrator of the same options. Returns (N, 3). A dict passed as
    ``stats`` receives the per-iteration counters of these paths."""
    PLAIN_CALLS["het_path"] += 1
    return _plain_paths(hc, o, d, keys.to(torch.int64) & _MASK, stats)


def het_path(hc, o, d, keys):
    """Radiance of one whole heterogeneous volume path per ray. ``o, d``
    (N, 3) f32; ``keys`` (N,) path keys (uint32 values held in int64, or
    their bits as int32). Returns (N, 3) f32."""
    if not o.is_cuda:
        return het_path_plain(hc, o, d, keys)
    dev = o.device
    n = o.shape[0]
    sweeps._check("o", o, torch.float32, (n, 3), dev)
    sweeps._check("d", d, torch.float32, (n, 3), dev)
    keys = media_kernels._key_bits(keys, n, dev)
    media_kernels._check_grid(hc.hm, dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("het_path", (
            o.data_ptr(), d.data_ptr(), keys.data_ptr(), n, hc.fc, hc.ic,
            *hc.hm.grid_args(), out.data_ptr(), sweeps._stream(),
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
    persistent=True, grad_sampling=False,
):
    """``render_chunk(s0, n_spp) -> (radiance_sum (N, 3), n_rejected)``
    running a whole chunk of samples in one launch (see
    ``megakernel.make_spp_render``), or None if the scene or the camera does
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
        camera, width, height, seed, pixel_order=pixel_order,
    )
