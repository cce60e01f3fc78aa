"""Whole-path HOMOGENEOUS volume kernels: CUDA kernels, their wrappers, their
plain PyTorch versions, and the factories that route a scene to them.

Counterpart of ``xraytracer_tpu/integrators/vol_megakernel.py``. Three
kernels, one device function for an iteration in ``csrc/vol_megakernel.cu``:

* ``vol_path`` replaces the kernel of ``try_make_fused_volume_integrator``
  (over ``_vol_trace_body``): rays and path keys in, radiance out, one
  thread per ray; it reads the keys as the caller holds them (uint32 values
  in int64, or their int32 bits), so its wrapper converts nothing.
* ``vol_spp`` replaces ``try_make_fused_volume_spp_render(persistent=False)``
  (``megakernel.py::_mega_spp_kernel`` over ``_vol_trace_body``): per pixel
  a loop over a chunk of samples, each with its key, its jittered pinhole
  ray, its path and the NaN / Inf / negative rejection.
* ``vol_spp_persistent`` replaces the same with ``persistent=True``
  (``_mega_spp_persistent_kernel`` over ``_make_vol_iteration``; the default
  and so the ``vpt`` preset's route): the sample loop merged into the
  iteration loop, so a lane whose path has ended starts its next sample at
  once. Depth-100 paths run 202 iterations; their tail is what the
  per-sample loop makes every lane of a warp wait for.

An eligible scene (``_eligible_volume``: at most 8 flat triangles, exactly
one homogeneous medium box, no spheres, at most 4 flat area lights, depth
1..64) is small enough to travel by value with every launch (``VolConsts``),
so nothing is compiled per scene and no table lies in device memory. What
bounds the kernels on the card and what the design does about it is noted
at the top of ``csrc/vol_megakernel.cu``; the lane code is
``csrc/vol_path.cuh``. The two spp kernels take the lanes of a view in a
work order (``work_order``: the pixels with the longest chord through the
medium first, made by the render on its first call) and write each
lane's sum to its own slot, so their outputs stay in the view's lane order
and do not depend on the order.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and counts the launch in
``LAUNCHES``. A wrapper runs the plain version only for tensors that lie on
the CPU (counted in ``PLAIN_CALLS``); for a CUDA tensor it launches the
kernel or raises. ``try_make_*`` return None for a scene that does not
qualify and for tables on the CPU unless ``force=True`` (the tests' way to
the plain versions).

The plain versions are the port's own wavefront volume integrator
(``integrators/volume.py`` with ``fused="never"``) over the plain
matmul-form sweep, with a host loop over samples and the camera ray of the
kernels' formulas, so they reach no kernel on either device.
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..camera import PinholeCamera
from ..geometry import Rays
from ..geometry import kernels as sweeps
from ..media import default_max_steps
from ..scene.tables import MED_HETEROGENEOUS
from . import megakernel as mk

KERNEL_NAMES = ("vol_path", "vol_spp", "vol_spp_persistent")

# launches of each kernel, and calls of each plain version, since the last
# ``reset_counts()``: plain ints, bumped exactly where a wrapper launches
# its kernel (resp. where a plain version runs) and nowhere else
LAUNCHES = {name: 0 for name in KERNEL_NAMES}
PLAIN_CALLS = {name: 0 for name in KERNEL_NAMES}

MAX_TRIANGLES = 8
MAX_LIGHTS = 4
MAX_DEPTH = 64
_TRI_STRIDE, _LIGHT_STRIDE = 14, 16   # floats per row, csrc/vol_path.cuh
_K_EPS = 1.1920928955078125e-07       # constants.K_EPS

_MASK = 0xFFFFFFFF
_P = ctypes.c_void_p
_I = ctypes.c_int
_FC = ctypes.POINTER(ctypes.c_float)
_IC = ctypes.POINTER(ctypes.c_int)
_SPP_ARGTYPES = [_I, _I, _P, _P, _P, _I, _FC, ctypes.c_uint, _FC, _IC, _P, _P, _P, _P]
_ARGTYPES = {
    # o, d, keys, keys' stride in int32 words, n, scene (fc, ic), out, stream
    "vol_path": [_P, _P, _P, _I, _I, _FC, _IC, _P, _P],
    # s0, n_spp, pixfold, px, py, n, cam16, cam_site, scene, work order,
    # sum, rej, stream
    "vol_spp": _SPP_ARGTYPES,
    "vol_spp_persistent": _SPP_ARGTYPES,
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

    return _bind(load("vol_megakernel"))


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
def _eligible_volume(scene, statics, max_depth):
    """Eligibility read from the concrete tables: <= 8 triangles with flat
    normals, exactly ONE homogeneous medium box, no spheres, <= 4 flat area
    lights, depth 1..64. Returns (tris, box, lights) as dicts of numpy
    rows, or None."""
    a = {k: getattr(scene, k).cpu().numpy() for k in (
        "tri_obj", "sph_obj", "box_obj", "al_type", "med_type", "obj_light",
        "obj_medium", "obj_mat", "mat_type", "tri_n0", "tri_n1", "tri_n2",
        "tri_v0", "tri_e1", "tri_e2", "box_min", "box_max", "med_g",
        "med_sigma_a", "med_sigma_s", "al_v0", "al_e1", "al_e2", "al_ng",
        "al_le")}
    if max_depth < 1 or max_depth > MAX_DEPTH:
        return None
    if (a["sph_obj"] >= 0).any():
        return None
    real = np.flatnonzero(a["tri_obj"] >= 0)
    if real.size > MAX_TRIANGLES:
        return None
    tris = []
    for r in real:
        n0 = a["tri_n0"][r]
        if not (np.allclose(n0, a["tri_n1"][r]) and np.allclose(n0, a["tri_n2"][r])):
            return None                 # smooth normals: the wavefront route
        obj = a["tri_obj"][r]
        mat = a["obj_mat"][obj]
        tris.append(dict(
            v0=a["tri_v0"][r], e1=a["tri_e1"][r], e2=a["tri_e2"][r], ns=n0,
            lrow=int(a["obj_light"][obj]),
            mtype=int(a["mat_type"][mat]) if mat >= 0 else -1,
        ))
    boxes = np.flatnonzero(a["box_obj"] >= 0)
    if boxes.size != 1:
        return None
    mrow = a["obj_medium"][a["box_obj"][boxes[0]]]
    if mrow < 0 or a["med_type"][mrow] == MED_HETEROGENEOUS or a["med_type"][mrow] < 0:
        return None
    box = dict(
        lo=a["box_min"][boxes[0]], hi=a["box_max"][boxes[0]],
        mtype=int(a["med_type"][mrow]), g=float(a["med_g"][mrow]),
        sigma_a=a["med_sigma_a"][mrow], sigma_s=a["med_sigma_s"][mrow],
    )
    n_lights = statics["n_area_lights"]
    if n_lights > MAX_LIGHTS:
        return None
    lights = []
    for i in range(n_lights):
        if a["al_type"][i] not in (0, 1):
            return None
        lights.append(dict(
            type=int(a["al_type"][i]), v0=a["al_v0"][i], e1=a["al_e1"][i],
            e2=a["al_e2"][i], ng=a["al_ng"][i], le=a["al_le"][i],
        ))
    return tris, box, lights


@dataclass
class VolConsts:
    """What one launch needs of a scene, resolved once: the options and the
    two host arrays the launchers read (``csrc/vol_megakernel.cu::
    scene_from``)."""

    scene: object
    statics: dict
    max_depth: int
    nee: bool
    max_steps: int
    n_iterations: int
    fc: object   # ctypes float array
    ic: object   # ctypes int array
    _plain = None   # {with_stats: integrate}, built on first use

    @property
    def device(self):
        return self.scene.tri_v0.device

    def plain_integrate(self, with_stats=False):
        """The wavefront volume integrator with the same options over the
        plain matmul-form sweep: the plain version of a whole path. With
        ``with_stats`` it returns ``(radiance, per-iteration counters)``."""
        if self._plain is None:
            self._plain = {}
        if with_stats not in self._plain:
            from ..geometry.intersect import intersect_triangles_mm
            from .volume import make_volume_integrator

            self._plain[with_stats] = make_volume_integrator(
                self.scene, self.statics, self.max_depth, nee=self.nee,
                max_steps=self.max_steps, tri_fn=intersect_triangles_mm,
                n_iterations=self.n_iterations, fused="never",
                with_stats=with_stats,
            )
        return self._plain[with_stats]


def _vol_consts(scene, statics, max_depth, nee, max_steps, n_iterations):
    """Eligibility check, then the ``VolConsts`` of these options, or None."""
    from .volume import _nee_site_layout

    el = _eligible_volume(scene, statics, max_depth)
    if el is None:
        return None
    tris, box, lights = el
    if max_steps is None:
        max_steps = default_max_steps(scene)
    pick, light_site, _tr = _nee_site_layout(max_steps)
    if n_iterations is None:
        n_iterations = 2 * max_depth + 2
    f32 = np.float32
    fc = np.zeros(
        (MAX_TRIANGLES * _TRI_STRIDE + 19 + MAX_LIGHTS * _LIGHT_STRIDE,), f32)
    for k, t in enumerate(tris):
        row = fc[k * _TRI_STRIDE:(k + 1) * _TRI_STRIDE]
        row[0:3], row[3:6], row[6:9], row[9:12] = t["v0"], t["e1"], t["e2"], t["ns"]
        row[12], row[13] = t["lrow"], t["mtype"]
    m = fc[MAX_TRIANGLES * _TRI_STRIDE:]
    sa, ss = box["sigma_a"].astype(f32), box["sigma_s"].astype(f32)
    st = sa + ss
    m[0:3], m[3:6], m[6] = box["lo"], box["hi"], box["g"]
    m[7:10], m[10:13], m[13:16] = sa, ss, st
    m[16:19] = ss / np.where(st == 0.0, f32(1.0), st)
    for k, li in enumerate(lights):
        row = m[19 + k * _LIGHT_STRIDE:19 + (k + 1) * _LIGHT_STRIDE]
        row[0] = li["type"]
        row[1:4], row[4:7], row[7:10] = li["v0"], li["e1"], li["e2"]
        row[10:13], row[13:16] = li["ng"], li["le"]
    ic = [len(tris), len(lights), box["mtype"], int(max_depth),
          int(n_iterations), int(bool(nee) and len(lights) > 0),
          int(pick), int(light_site)]
    return VolConsts(
        scene=scene, statics=statics, max_depth=int(max_depth), nee=bool(nee),
        max_steps=int(max_steps), n_iterations=int(n_iterations),
        fc=(ctypes.c_float * fc.size)(*[float(v) for v in fc]),
        ic=(ctypes.c_int * len(ic))(*ic),
    )


# --------------------------------------------------------------------------
# K6, first launcher: rays and keys in, radiance out
# --------------------------------------------------------------------------
def _plain_paths(vc, o, d, keys, stats):
    """One plain whole volume path per ray; ``stats`` (a dict or None)
    collects the per-iteration counters, summed over calls."""
    out = vc.plain_integrate(stats is not None)(Rays(o=o, d=d), keys)
    if stats is None:
        return out
    rad, counters = out
    for k, v in counters.items():
        stats[k] = stats[k] + v if k in stats else v
    return rad


def vol_path_plain(vc, o, d, keys, stats=None):
    """Plain PyTorch version of ``vol_path``: the wavefront volume
    integrator of the same options. Returns (N, 3). A dict passed as
    ``stats`` receives the per-iteration counters of these paths."""
    PLAIN_CALLS["vol_path"] += 1
    return _plain_paths(vc, o, d, keys.to(torch.int64) & _MASK, stats)


def vol_path(vc, o, d, keys):
    """Radiance of one whole volume path per ray. ``o, d`` (N, 3) f32;
    ``keys`` (N,) path keys (uint32 values held in int64, or their bits as
    int32). Returns (N, 3) f32."""
    if not o.is_cuda:
        return vol_path_plain(vc, o, d, keys)
    dev = o.device
    n = o.shape[0]
    sweeps._check("o", o, torch.float32, (n, 3), dev)
    sweeps._check("d", d, torch.float32, (n, 3), dev)
    # the kernel reads int32 bits, or the low word of each int64 value
    stride = 2 if keys.dtype == torch.int64 else 1
    sweeps._check("keys", keys, torch.int64 if stride == 2 else torch.int32, (n,), dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("vol_path", (
            o.data_ptr(), d.data_ptr(), keys.data_ptr(), stride, n, vc.fc, vc.ic,
            out.data_ptr(), sweeps._stream(),
        ))
    LAUNCHES["vol_path"] += 1
    return out


# --------------------------------------------------------------------------
# K6, second and third launcher: a chunk of samples per pixel
# --------------------------------------------------------------------------
def _spp_plain(vc, view, s0, n_spp, stats=None, batch=1):
    dev = view.px.device
    acc = torch.zeros((view.n, 3), dtype=torch.float32, device=dev)
    rej = torch.zeros((view.n,), dtype=torch.int32, device=dev)
    end = int(s0) + int(n_spp)
    for b0 in range(int(s0), end, int(batch)):
        # ``batch`` samples of every lane go through the plain path as one
        # wavefront; the sums are still taken sample by sample, in order
        rays = [mk._camera_rays_plain(view, s)
                for s in range(b0, min(b0 + int(batch), end))]
        keys, o, d = (torch.cat([r[i] for r in rays]) for i in range(3))
        rads = _plain_paths(vc, o, d, keys, stats).reshape(len(rays), view.n, 3)
        for rad in rads:
            bad = (~torch.isfinite(rad) | (rad < 0.0)).any(dim=-1)
            acc += torch.where(bad[:, None], torch.zeros_like(rad), rad)
            rej += bad.to(torch.int32)
    return acc, rej


def vol_spp_plain(vc, view, s0, n_spp, stats=None, batch=1):
    """Plain PyTorch version of ``vol_spp``: a host loop over the samples,
    ``batch`` of them at a time through the plain whole path. Returns (sum
    (N, 3), rejects (N,)). A dict passed as ``stats`` receives the
    per-iteration counters."""
    PLAIN_CALLS["vol_spp"] += 1
    return _spp_plain(vc, view, s0, n_spp, stats, batch)


def vol_spp_persistent_plain(vc, view, s0, n_spp, stats=None, batch=1):
    """Plain PyTorch version of ``vol_spp_persistent``: the merged loop
    changes the schedule, not the function, so it is ``vol_spp_plain``'s
    computation."""
    PLAIN_CALLS["vol_spp_persistent"] += 1
    return _spp_plain(vc, view, s0, n_spp, stats, batch)


def work_order(vc, view):
    """(N,) int32, the order in which the spp kernels take the lanes of
    ``view``: by ``reach_cost``, longest chord through the medium first (the
    longest work in the first waves of blocks, the short pixels filling the
    last), the pixels that cannot reach the medium last, ties in lane order. A
    permutation, so every lane is taken once; each lane's sum is still
    written to its own slot, so results come back in the view's lane order.
    A caller that renders one view more than once makes it once and passes
    it to ``vol_spp`` / ``vol_spp_persistent``."""
    cost = reach_cost(vc, view)
    return torch.sort(cost, descending=True, stable=True).indices.to(torch.int32)


def _vol_spp_launch(name, vc, view, s0, n_spp, order=None):
    """Launch ``name`` on the lanes of ``view`` taken in ``order`` (int32, a
    permutation of the lanes; default ``work_order``)."""
    dev = view.px.device
    n = view.n
    sweeps._check("pixfold", view.pixfold_bits, torch.int32, (n,), dev)
    sweeps._check("px", view.px, torch.float32, (n,), dev)
    sweeps._check("py", view.py, torch.float32, (n,), dev)
    s0, n_spp = int(s0), int(n_spp)
    if s0 < 0 or n_spp < 0 or s0 + n_spp >= 2 ** 31:
        raise ValueError(f"sample range [{s0}, {s0 + n_spp}) out of int32")
    cam = (ctypes.c_float * 16)(*[float(c) for c in view.cam])
    if order is None:
        order = work_order(vc, view)
    sweeps._check("order", order, torch.int32, (n,), dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rej = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(name, (
            s0, n_spp, view.pixfold_bits.data_ptr(), view.px.data_ptr(),
            view.py.data_ptr(), n, cam, view.cam_site, vc.fc, vc.ic,
            order.data_ptr(), out.data_ptr(), rej.data_ptr(), sweeps._stream(),
        ))
    LAUNCHES[name] += 1
    return out, rej


def vol_spp(vc, view, s0, n_spp, order=None):
    """Samples ``s0 .. s0 + n_spp - 1`` of every pixel lane of ``view``
    (``megakernel.RenderView``), one sample after the other per lane, the
    lanes taken in ``order`` (default: ``work_order``, made anew). Returns
    the radiance sums (N, 3) f32 and the rejected-sample counts (N,) int32,
    in the view's lane order."""
    if not view.px.is_cuda:
        return vol_spp_plain(vc, view, s0, n_spp)
    return _vol_spp_launch("vol_spp", vc, view, s0, n_spp, order)


def vol_spp_persistent(vc, view, s0, n_spp, order=None):
    """``vol_spp`` with the sample loop and the iteration loop merged (a
    lane starts its next sample as soon as its path ends). Same results up
    to the compiler's contraction of multiply-adds in two separately
    compiled loops."""
    if not view.px.is_cuda:
        return vol_spp_persistent_plain(vc, view, s0, n_spp)
    return _vol_spp_launch("vol_spp_persistent", vc, view, s0, n_spp, order)


def reach_cost(vc, view):
    """(N,) f32 per lane of ``view``: the longest chord through the medium
    box of the pixel's four corner camera rays, counted only where a ray
    enters the box before it meets a triangle (a triangle ends a path at
    once: an emitter, or a surface without medium); 0 for a pixel none of
    whose corner rays reaches the medium. A pixel's paths are long where its
    chord is, and only the work order depends on it."""
    dev = view.px.device
    fc = np.frombuffer(vc.fc, dtype=np.float32)
    tri = fc[:MAX_TRIANGLES * _TRI_STRIDE].reshape(MAX_TRIANGLES, -1)[:int(vc.ic[0])]
    box = fc[MAX_TRIANGLES * _TRI_STRIDE:]
    lo, hi = (torch.as_tensor(box[k:k + 3], device=dev) for k in (0, 3))
    m = torch.as_tensor(view.cam[:9].reshape(3, 3), device=dev)
    scale, soa, inv_w, inv_h = (float(c) for c in view.cam[12:16])
    origin = torch.as_tensor(view.cam[9:12].copy(), device=dev)
    # the four corners of every pixel at once: (4, N)
    cx = torch.tensor([0.0, 1.0, 0.0, 1.0], device=dev)[:, None]
    cy = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)[:, None]
    nx = (2.0 * (view.px + cx) * inv_w - 1.0) * scale
    ny = (1.0 - 2.0 * (view.py + cy) * inv_h) * soa
    d = nx[..., None] * m[0] + ny[..., None] * m[1] - m[2]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    ta, tb = (lo - origin) * inv, (hi - origin) * inv
    b0 = torch.minimum(ta, tb).amax(dim=-1).clamp_min(0.0)
    b1 = torch.maximum(ta, tb).amin(dim=-1)
    reach = (b0 <= b1) & (b1 > 0.0)
    for row in tri:  # a triangle at or before the box entry ends the path there
        v0, e1, e2 = (torch.as_tensor(row[k:k + 3], device=dev) for k in (0, 3, 6))
        pv = torch.linalg.cross(d, e2.expand_as(d))
        det = pv @ e1
        tv = origin - v0
        qv = torch.linalg.cross(tv, e1)
        u, v, t = (pv @ tv) / det, (d @ qv) / det, (e2 @ qv) / det
        hit = (det.abs() >= _K_EPS) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > _K_EPS)
        reach &= ~(hit & (t <= b0))
    return torch.where(reach, b1 - b0, torch.zeros_like(b0)).amax(dim=0)


# --------------------------------------------------------------------------
# factories
# --------------------------------------------------------------------------
def try_make_fused_volume_integrator(
    scene, statics, max_depth, nee=False, max_steps=None, n_iterations=None,
    force=False,
):
    """``integrate(rays, keys)`` through ``vol_path`` if the scene qualifies
    (one homogeneous box + a few flat triangles), else None. Tables on the
    CPU qualify only with ``force`` (``integrate`` then runs the plain
    version)."""
    if not force and not scene.tri_v0.is_cuda:
        return None
    vc = _vol_consts(scene, statics, max_depth, nee, max_steps, n_iterations)
    if vc is None:
        return None

    def integrate(rays, keys):
        if rays.o.device != vc.device:
            raise ValueError(f"rays on {rays.o.device}, scene on {vc.device}")
        return vol_path(vc, rays.o.contiguous(), rays.d.contiguous(), keys)

    return integrate


def try_make_fused_volume_spp_render(
    scene, statics, camera, width, height, seed, max_depth, nee=False,
    max_steps=None, n_iterations=None, force=False, pixel_order="raster",
    persistent=True, mesh=None,
):
    """``render_chunk(s0, n_spp) -> (radiance_sum (N, 3), n_rejected)``
    running a whole chunk of samples in one launch (see
    ``megakernel.make_spp_render``; ``mesh``: this rank's block of the
    lanes, whose work order is made over the block's own lanes), or None if
    the scene or the camera does not qualify. ``persistent=True`` (default) merges the sample loop into
    the path loop: the same image, and what deep configurations need (depth
    100 = 202-iteration paths whose tail the per-sample loop pays per
    sample)."""
    if not force and not scene.tri_v0.is_cuda:
        return None
    if not isinstance(camera, PinholeCamera):
        return None
    vc = _vol_consts(scene, statics, max_depth, nee, max_steps, n_iterations)
    if vc is None:
        return None
    kernel = vol_spp_persistent if persistent else vol_spp
    order = None  # the view's work order, made on the first render

    def launch(view, s0, n_spp):
        nonlocal order
        if order is None and view.px.is_cuda:
            order = work_order(vc, view)
        return kernel(vc, view, s0, n_spp, order)

    return mk.make_spp_render(
        launch, camera, width, height, seed, pixel_order=pixel_order,
        mesh=mesh,
    )
