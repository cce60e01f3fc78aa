"""Whole-path surface kernels: CUDA kernels, their wrappers, their plain
PyTorch versions, and the factories that route a scene to them.

Counterpart of ``xraytracer_tpu/integrators/megakernel.py``. Four kernels,
one device function for a bounce in ``csrc/megakernel.cu``:

* ``mega_path`` replaces ``_mega_kernel`` (through
  ``try_make_fused_path_integrator``): rays and path keys in, radiance out.
* ``mega_spp`` replaces ``_mega_spp_kernel`` (through
  ``try_make_fused_spp_render(persistent=False)``): per pixel a loop over a
  chunk of samples, each with its key, its jittered pinhole ray, its path
  and the NaN / Inf / negative rejection; radiance sums and reject counts
  out.
* ``mega_spp_persistent`` replaces ``_mega_spp_persistent_kernel`` with
  ``_make_surface_iteration`` (``persistent=True``, the default and so the
  main path): the same render with the sample loop and the bounce loop
  merged, so a lane whose path has ended starts its next sample at once;
  its sums are ``mega_spp``'s bit for bit.
* ``mega_grad_path`` replaces ``_mega_grad_kernel`` (through
  ``try_make_fused_grad_path``, the analytic route of
  ``diff.try_make_fast_value_and_grad``): ``mega_path`` plus each lane's
  Jacobians of radiance w.r.t. the material albedos and the light
  emissions, accumulated in the forward pass; ``tri_rec`` and ``al_le`` are
  live per call.

Nothing is compiled per scene: lights go into a device table, the camera
and the flags are launch arguments (``FusedScene``, ``RenderView``). What
the Pallas kernels did only for the TPU (feature matmul, packed key,
one-hot record matmul, 8 x 512 tiles) has no counterpart here. Their
per-chunk culling does, in every kernel: a table of more than
``MEGA_STAGE_ROWS`` = 64 rows is walked over the sweeps' chunk table
(``kernels._chunk_table`` under the ``valid`` mask, built once per table,
so a render of such a table adds one ``chunk_boxes`` launch), a smaller
one (the Cornell box's 40 rows) whole from shared memory. Each pass walks
a lane's path ray and, in ``mega_spp_persistent`` (and in ``mega_path``
and ``mega_spp`` on a culled table), the shadow ray of its previous
vertex, in one walk; what bounds the kernels on the card and what the
design does about it is noted at the top of ``csrc/megakernel.cu`` and
``csrc/mega_path.cuh``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and counts the launch in
``LAUNCHES``. A wrapper runs the plain version only for tensors that lie on
the CPU (counted in ``PLAIN_CALLS``); for a CUDA tensor it launches the
kernel or raises.

Routing. ``try_make_*`` return None for a scene ``_eligible`` refuses
(spheres, boxes, a non-Lambert material, a light that is not flat, too
many lights, depth outside 1..8, more than 4096 table rows, a camera that
is no pinhole): the wavefront route then takes over, as in the JAX
package. They also return None for tables on the CPU unless ``force=True``,
which runs the plain versions (the tests' way in).

The plain versions are the port's own wavefront integrator over the plain
matmul-form sweep, with a host loop over samples and the camera ray of the
kernels' formulas, so they reach no kernel on either device; that of
``mega_grad_path`` differentiates it in forward mode (``torch.func.jvp``)
along every parameter direction.
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..camera import PinholeCamera
from ..geometry import Rays
from ..geometry import kernels as sweeps
from ..sampling import rng

KERNEL_NAMES = ("mega_path", "mega_spp", "mega_spp_persistent", "mega_grad_path")

# launches of each kernel, and calls of each plain version, since the last
# ``reset_counts()``: plain ints, bumped exactly where a wrapper launches
# its kernel (resp. where a plain version runs) and nowhere else
LAUNCHES = {name: 0 for name in KERNEL_NAMES}
PLAIN_CALLS = {name: 0 for name in KERNEL_NAMES}

TRI_CHUNK = 128       # table rows come in multiples of this above one chunk
MAX_TRIANGLES = 4096  # the JAX package's gate, kept as it is
MAX_DEPTH = 8
MAX_LIGHTS_ALL = 8    # "all": one shadow test per light and vertex
MAX_LIGHTS_PICK = 64  # "one" / "power": one shadow test per vertex
MAX_GRAD_MATS = 8     # materials the gradient kernel carries (csrc/mega_grad.cuh)
# mega_spp_persistent, mega_path and mega_grad_path stage a table of at most
# this many rows (two chunks) whole into shared memory and cull a larger one
# over its chunk table; csrc/megakernel.cu's MEGA_STAGE_ROWS must equal it,
# and says where the line was measured
MEGA_STAGE_ROWS = 64
LIGHT_STRIDE = 20     # floats per light-table row (csrc/megakernel.cu)
NEE_KINDS = {"all": 0, "one": 1, "power": 2}

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9

_P = ctypes.c_void_p
_I = ctypes.c_int
_SCENE_ARGTYPES = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _P]
_SPP_ARGTYPES = (
    [_I, _I, _P, _P, _P, _I, ctypes.POINTER(ctypes.c_float), ctypes.c_uint]
    + _SCENE_ARGTYPES + [_P, _P, _P]
)
_ARGTYPES = {
    # o, d, keys, n, scene..., out, stream
    "mega_path": [_P, _P, _P, _I] + _SCENE_ARGTYPES + [_P, _P],
    # s0, n_spp, pixfold, px, py, n, cam16, cam_site, scene..., sum, rej, stream
    "mega_spp": _SPP_ARGTYPES,
    "mega_spp_persistent": _SPP_ARGTYPES,
    # o, d, keys, n, scene..., obj_mat, n_obj, n_mats, out planes, stream
    "mega_grad_path": [_P, _P, _P, _I] + _SCENE_ARGTYPES + [_P, _I, _I, _P, _P],
}


def _bind(lib):
    """Declare the launchers' C signatures on a loaded megakernel library."""
    if not getattr(lib, "_xrt_bound", False):
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib._xrt_bound = True
    return lib


def _lib():
    from .._build import load

    return _bind(load("megakernel"))


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


def _i32_bits(x):
    """uint32 values held in int64 (the port's RNG states) -> the same 32
    bits as an int32 tensor, which is what the kernels read."""
    x = x.to(torch.int64) & _MASK
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32).contiguous()


# --------------------------------------------------------------------------
# scene side: eligibility and the tables a launch needs
# --------------------------------------------------------------------------
def _eligible(scene, statics, max_depth, max_lights=MAX_LIGHTS_ALL):
    """Eligibility for the whole-path kernels, read from the concrete
    tables; returns the list of flat area lights (dicts of numpy rows) or
    None."""
    tri_obj = scene.tri_obj.cpu().numpy()
    if max_depth < 1 or max_depth > MAX_DEPTH:
        return None
    t_total = tri_obj.shape[0]
    tc = t_total if t_total <= TRI_CHUNK else TRI_CHUNK
    if t_total == 0 or t_total % tc or tc % 8:
        return None
    if t_total > MAX_TRIANGLES:
        return None
    if bool((scene.sph_obj >= 0).any()) or bool((scene.box_obj >= 0).any()):
        return None
    # every object's material must be Lambert (or absent)
    obj_mat = scene.obj_mat.cpu().numpy()
    mat_type = scene.mat_type.cpu().numpy()
    mats = obj_mat[np.unique(tri_obj[tri_obj >= 0])]
    mats = mats[mats >= 0]
    if mats.size and (mat_type[mats] != 0).any():
        return None
    # every area light flat (triangle = 0, quad = 1)
    n_lights = statics["n_area_lights"]
    al = {k: getattr(scene, "al_" + k).cpu().numpy()
          for k in ("type", "v0", "e1", "e2", "ng", "le")}
    lights = []
    for i in range(n_lights):
        if al["type"][i] not in (0, 1):
            return None
        lights.append({k: al[k][i] for k in al})
    if n_lights > max_lights:
        return None
    return lights


@dataclass
class FusedScene:
    """What one launch needs of a scene, resolved once: the flags, the light
    table and the masks on the scene's device, and scratch for the triangle
    coefficients the launchers compute first."""

    scene: object
    statics: dict
    max_depth: int
    nee: bool
    le0: bool
    cosine: bool
    nee_mode: str
    pick_weights: object   # the caller's, or None for the tables' power
    n_lights: int
    lights: torch.Tensor   # (max(n_lights, 1), LIGHT_STRIDE) f32
    pick_cdf: torch.Tensor  # (n_lights + 1,) f32
    valid: torch.Tensor    # (T,) uint8
    blocks: torch.Tensor   # (T,) uint8
    coef: torch.Tensor = None
    coef_blocks: torch.Tensor = None
    _plain = None          # {with_stats: integrate}, built on first use

    @property
    def device(self):
        return self.scene.tri_v0.device

    @property
    def culls(self):
        """Whether the kernels walk this table over its chunk table (more
        than ``MEGA_STAGE_ROWS`` rows) rather than staging it."""
        return self.scene.tri_v0.shape[0] > MEGA_STAGE_ROWS

    def scene_args(self, tri_rec=None):
        """The launchers' scene arguments, in the order of the C interface;
        ``tri_rec`` in place of the scene's record table; the chunk table's
        boxes where the table is culled (every launcher culls by them)."""
        s = self.scene
        rec = s.tri_rec if tri_rec is None else tri_rec
        t_total = s.tri_v0.shape[0]
        if self.coef is None:
            shape = (t_total, 16)
            self.coef = torch.empty(shape, dtype=torch.float32, device=self.device)
            self.coef_blocks = torch.empty_like(self.coef)
        return (
            s.tri_v0.data_ptr(), s.tri_e1.data_ptr(), s.tri_e2.data_ptr(),
            self.valid.data_ptr(), self.blocks.data_ptr(), t_total,
            sweeps._center(s.tri_v0).data_ptr(),
            self.coef.data_ptr(), self.coef_blocks.data_ptr(),
            rec.data_ptr(), self.lights.data_ptr(),
            self.pick_cdf.data_ptr(), self.n_lights, self.max_depth,
            int(self.nee), int(self.le0), int(self.cosine),
            NEE_KINDS[self.nee_mode], self.boxes(),
        )

    def boxes(self):
        """Pointer to the boxes of the table's chunk table (the sweeps'
        ``kernels._chunk_table`` under the ``valid`` mask, built once per
        table), which the culled walks use; None for a table the kernels
        stage (``culls``)."""
        s = self.scene
        if not self.culls:
            return None
        boxes, _ = sweeps._chunk_table(s.tri_v0, s.tri_e1, s.tri_e2, self.valid)
        return boxes.data_ptr()

    def plain_integrate(self, with_stats=False):
        """The wavefront integrator with the same options over the plain
        matmul-form sweep: the plain version of a whole path. With
        ``with_stats`` it returns ``(radiance, per-bounce counters)``."""
        if self._plain is None:
            self._plain = {}
        if with_stats not in self._plain:
            from ..geometry.intersect import intersect_triangles_mm
            from .surface import make_path_integrator

            self._plain[with_stats] = make_path_integrator(
                self.scene, self.statics, self.max_depth, nee=self.nee,
                le_depth0_only=self.le0, cosine_sampling=self.cosine,
                tri_fn=intersect_triangles_mm, nee_mode=self.nee_mode,
                pick_weights=self.pick_weights, fused="never",
                with_stats=with_stats,
            )
        return self._plain[with_stats]


def _bake(scene, statics, max_depth, nee, le0, cosine, nee_mode="all",
          pick_weights=None):
    """Eligibility check, then the ``FusedScene`` of these options, or None."""
    if nee_mode not in NEE_KINDS:
        return None
    max_lights = MAX_LIGHTS_ALL if nee_mode == "all" else MAX_LIGHTS_PICK
    lights = _eligible(scene, statics, max_depth, max_lights=max_lights)
    if lights is None:
        return None
    n_lights = len(lights)
    if nee and n_lights == 0:
        nee = False
    table = np.zeros((max(n_lights, 1), LIGHT_STRIDE), np.float32)
    for i, li in enumerate(lights):
        table[i, 0] = li["type"]
        for col, k in ((1, "v0"), (4, "e1"), (7, "e2"), (10, "ng"), (13, "le")):
            table[i, col:col + 3] = li[k]
    cdf = np.zeros((n_lights + 1,), np.float32)
    if nee and nee_mode == "power":
        from ..lights import light_power_weights
        from ..sampling import DiscreteDistribution1D

        w = (np.asarray(pick_weights) if pick_weights is not None
             else light_power_weights(scene))[:n_lights]
        dist = DiscreteDistribution1D(w)
        table[:n_lights, 16] = dist.pmf.numpy()
        cdf = dist.cdf.numpy()
    elif n_lights:
        table[:n_lights, 16] = np.float32(1.0 / n_lights)
    dev = scene.tri_v0.device
    valid = scene.tri_obj >= 0
    tri_light = scene.obj_light[torch.clamp(scene.tri_obj, min=0).to(torch.int64)]
    blocks = valid & (tri_light < 0)
    return FusedScene(
        scene=scene, statics=statics, max_depth=int(max_depth), nee=bool(nee),
        le0=bool(le0), cosine=bool(cosine), nee_mode=nee_mode,
        pick_weights=pick_weights, n_lights=n_lights,
        lights=torch.as_tensor(table).to(dev),
        pick_cdf=torch.as_tensor(np.ascontiguousarray(cdf, np.float32)).to(dev),
        valid=valid.to(torch.uint8).contiguous(),
        blocks=blocks.to(torch.uint8).contiguous(),
    )


def _check_scene(fs, dev):
    s = fs.scene
    t_total = s.tri_v0.shape[0]
    f32 = torch.float32
    for name, shape in (("tri_v0", (t_total, 3)), ("tri_e1", (t_total, 3)),
                        ("tri_e2", (t_total, 3)), ("tri_rec", (t_total, 32))):
        sweeps._check(name, getattr(s, name), f32, shape, dev)
    if s.tri_rec.data_ptr() % 16:
        raise ValueError("tri_rec: must be 16-byte aligned")
    sweeps._check("lights", fs.lights, f32,
                  (max(fs.n_lights, 1), LIGHT_STRIDE), dev)
    sweeps._check("pick_cdf", fs.pick_cdf, f32, (fs.n_lights + 1,), dev)


# --------------------------------------------------------------------------
# K1a: rays and keys in, radiance out
# --------------------------------------------------------------------------
def _plain_paths(fs, o, d, keys, stats):
    """One plain whole path per ray; ``stats`` (a dict or None) collects the
    per-bounce counters, summed over calls."""
    out = fs.plain_integrate(stats is not None)(Rays(o=o, d=d), keys)
    if stats is None:
        return out
    rad, counters = out
    for k, v in counters.items():
        stats[k] = stats[k] + v if k in stats else v
    return rad


def mega_path_plain(fs, o, d, keys, stats=None):
    """Plain PyTorch version of ``mega_path``: the wavefront integrator of
    the same options over the plain sweep. Returns (N, 3). A dict passed as
    ``stats`` receives the per-bounce ray counters of these paths."""
    PLAIN_CALLS["mega_path"] += 1
    return _plain_paths(fs, o, d, keys.to(torch.int64) & _MASK, stats)


def mega_path(fs, o, d, keys):
    """Radiance of one whole path per ray. ``o, d`` (N, 3) f32; ``keys``
    (N,) path keys (uint32 values held in int64, or their bits as int32).
    Returns (N, 3) f32."""
    if not o.is_cuda:
        return mega_path_plain(fs, o, d, keys)
    dev = o.device
    n = o.shape[0]
    sweeps._check("o", o, torch.float32, (n, 3), dev)
    sweeps._check("d", d, torch.float32, (n, 3), dev)
    if keys.dtype != torch.int32:
        sweeps._check("keys", keys, torch.int64, (n,), dev)
        keys = _i32_bits(keys)
    sweeps._check("keys", keys, torch.int32, (n,), dev)
    _check_scene(fs, dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("mega_path", (
            o.data_ptr(), d.data_ptr(), keys.data_ptr(), n,
            *fs.scene_args(), out.data_ptr(), sweeps._stream(),
        ))
    LAUNCHES["mega_path"] += 1
    return out


# --------------------------------------------------------------------------
# K1b, K1c: a chunk of samples per pixel
# --------------------------------------------------------------------------
@dataclass
class RenderView:
    """Camera constants and per-lane pixel data of one (camera, resolution,
    seed, lane order): what the spp kernels take besides the scene."""

    n: int
    cam: np.ndarray          # (16,) f32: rotation (9), origin (3), scale,
    #                          scale / aspect, 1 / width, 1 / height
    cam_site: int            # (camera site * GOLDEN) mod 2^32
    pixfold: torch.Tensor    # (N,) int64, pcg(pcg(seed) + pixel id)
    pixfold_bits: torch.Tensor  # (N,) int32, the same bits
    px: torch.Tensor         # (N,) f32
    py: torch.Tensor         # (N,) f32


def _camera_rays_plain(view, s):
    """Path keys and jittered pinhole rays of sample ``s`` for every lane,
    by the kernels' formulas (constants rounded to float32 on the host,
    multiplication by 1 / width)."""
    keys = rng._pcg((view.pixfold + (int(s) & _MASK)) & _MASK)
    x1 = rng._pcg((keys + view.cam_site) & _MASK)
    x2 = rng._pcg(x1)
    m = [float(c) for c in view.cam[:9]]
    scale, soa, inv_w, inv_h = (float(c) for c in view.cam[12:16])
    uvx = (view.px + rng._to_unit_float(x1)) * inv_w
    uvy = (view.py + rng._to_unit_float(x2)) * inv_h
    nx = (2.0 * uvx - 1.0) * scale
    ny = (1.0 - 2.0 * uvy) * soa
    dxw = nx * m[0] + ny * m[3] - m[6]
    dyw = nx * m[1] + ny * m[4] - m[7]
    dzw = nx * m[2] + ny * m[5] - m[8]
    inv = 1.0 / torch.sqrt(dxw * dxw + dyw * dyw + dzw * dzw)
    d = torch.stack([dxw * inv, dyw * inv, dzw * inv], dim=-1)
    o = torch.as_tensor(view.cam[9:12].copy()).to(d.device).expand(d.shape)
    return keys, o.contiguous(), d


def _spp_plain(fs, view, s0, n_spp, stats=None):
    dev = view.px.device
    acc = torch.zeros((view.n, 3), dtype=torch.float32, device=dev)
    rej = torch.zeros((view.n,), dtype=torch.int32, device=dev)
    for s in range(int(s0), int(s0) + int(n_spp)):
        keys, o, d = _camera_rays_plain(view, s)
        rad = _plain_paths(fs, o, d, keys, stats)
        bad = (~torch.isfinite(rad) | (rad < 0.0)).any(dim=-1)
        acc += torch.where(bad[:, None], torch.zeros_like(rad), rad)
        rej += bad.to(torch.int32)
    return acc, rej


def mega_spp_plain(fs, view, s0, n_spp, stats=None):
    """Plain PyTorch version of ``mega_spp``: a host loop over the samples,
    each through the plain whole path. Returns (sum (N, 3), rejects (N,)).
    A dict passed as ``stats`` receives the per-bounce ray counters."""
    PLAIN_CALLS["mega_spp"] += 1
    return _spp_plain(fs, view, s0, n_spp, stats)


def mega_spp_persistent_plain(fs, view, s0, n_spp, stats=None):
    """Plain PyTorch version of ``mega_spp_persistent``: the merged loop
    changes the schedule, not the function, so it is ``mega_spp_plain``'s
    computation."""
    PLAIN_CALLS["mega_spp_persistent"] += 1
    return _spp_plain(fs, view, s0, n_spp, stats)


def _mega_spp_launch(name, fs, view, s0, n_spp):
    dev = view.px.device
    n = view.n
    sweeps._check("pixfold", view.pixfold_bits, torch.int32, (n,), dev)
    sweeps._check("px", view.px, torch.float32, (n,), dev)
    sweeps._check("py", view.py, torch.float32, (n,), dev)
    _check_scene(fs, dev)
    s0, n_spp = int(s0), int(n_spp)
    if s0 < 0 or n_spp < 0 or s0 + n_spp >= 2 ** 31:
        raise ValueError(f"sample range [{s0}, {s0 + n_spp}) out of int32")
    cam = (ctypes.c_float * 16)(*[float(c) for c in view.cam])
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    rej = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch(name, (
            s0, n_spp, view.pixfold_bits.data_ptr(), view.px.data_ptr(),
            view.py.data_ptr(), n, cam, view.cam_site,
            *fs.scene_args(),
            out.data_ptr(), rej.data_ptr(),
            sweeps._stream(),
        ))
    LAUNCHES[name] += 1
    return out, rej


def mega_spp(fs, view, s0, n_spp):
    """Samples ``s0 .. s0 + n_spp - 1`` of every pixel lane of ``view``, one
    sample after the other per lane. Returns the radiance sums (N, 3) f32
    and the rejected-sample counts (N,) int32."""
    if not view.px.is_cuda:
        return mega_spp_plain(fs, view, s0, n_spp)
    return _mega_spp_launch("mega_spp", fs, view, s0, n_spp)


def mega_spp_persistent(fs, view, s0, n_spp):
    """``mega_spp`` with the sample loop and the bounce loop merged (a lane
    starts its next sample as soon as its path ends), each pass one walk of
    the lane's path ray and its last light sample's shadow ray. Same sums
    and rejection counts (``csrc/mega_path.cuh`` says why they are bitwise
    equal)."""
    if not view.px.is_cuda:
        return mega_spp_persistent_plain(fs, view, s0, n_spp)
    return _mega_spp_launch("mega_spp_persistent", fs, view, s0, n_spp)


# --------------------------------------------------------------------------
# K5: radiance and its per-lane gradients w.r.t. albedo and emission
# --------------------------------------------------------------------------
@dataclass
class GradScene:
    """A ``FusedScene`` (its light table the gradient kernel's own: the Le
    columns are written per call) and what the Jacobians need: the object
    -> material map and the parameter counts."""

    fs: FusedScene
    obj_mat: torch.Tensor  # (O,) int32
    n_mats: int

    @property
    def n_planes(self):
        return 3 + 9 * self.n_mats + 3 * self.fs.n_lights


def _grad_inputs(gs, tri_rec, al_le):
    s = gs.fs.scene
    return (s.tri_rec if tri_rec is None else tri_rec,
            s.al_le if al_le is None else al_le)


def _split_planes(out, n_mats, n_lights):
    """(3 + 9M + 3L, N) plane-major -> views img (N, 3), galb (N, 3, 3, M),
    gle (N, 3, L)."""
    n = out.shape[1]
    img = out[:3].T
    galb = out[3:3 + 9 * n_mats].T.reshape(n, 3, 3, n_mats)
    gle = out[3 + 9 * n_mats:].T.reshape(n, 3, n_lights)
    return img, galb, gle


def mega_grad_path_plain(gs, o, d, keys, tri_rec=None, al_le=None):
    """Plain PyTorch version of ``mega_grad_path``: ``torch.func.jvp`` of the
    wavefront integrator of the same options, over the matmul sweep, along
    each of the 3M + 3L parameter directions. The albedo of a table row is
    its record's columns 29-31 plus the tangent of its material (through
    ``obj_mat``), the emission ``al_le`` plus its tangent, so every lane's
    ∂img/∂θ is what autodiff defines for the same draws, independently of
    the kernel's recursion. Returns (img, galb, gle) as the kernel does."""
    from ..geometry.intersect import intersect_triangles_mm
    from .surface import make_path_integrator

    PLAIN_CALLS["mega_grad_path"] += 1
    fs = gs.fs
    scene = fs.scene
    tri_rec, al_le = _grad_inputs(gs, tri_rec, al_le)
    n, m_n, l_n = o.shape[0], gs.n_mats, fs.n_lights
    dev = o.device
    tri_obj = scene.tri_obj.to(torch.int64)
    row_mat = torch.where(tri_obj >= 0,
                          gs.obj_mat.to(torch.int64)[torch.clamp(tri_obj, min=0)],
                          torch.full_like(tri_obj, -1))
    onehot = (row_mat[:, None] == torch.arange(m_n, device=dev)[None]).to(torch.float32)
    rays = Rays(o=o, d=d)
    keys = keys.to(torch.int64) & _MASK

    def render(d_alb, d_le):
        rec = torch.cat([tri_rec[:, :29], tri_rec[:, 29:32] + onehot @ d_alb], dim=1)
        sc = scene._replace(tri_rec=rec, al_le=al_le + d_le)
        integrate = make_path_integrator(
            sc, fs.statics, fs.max_depth, nee=fs.nee, le_depth0_only=fs.le0,
            cosine_sampling=fs.cosine, tri_fn=intersect_triangles_mm,
            nee_mode=fs.nee_mode, pick_weights=fs.pick_weights, fused="never",
        )
        return integrate(rays, keys)

    z_alb = torch.zeros((m_n, 3), dtype=torch.float32, device=dev)
    z_le = torch.zeros_like(al_le)
    out = torch.empty((gs.n_planes, n), dtype=torch.float32, device=dev)
    img, galb, gle = _split_planes(out, m_n, l_n)
    primal = None
    for m in range(m_n):
        for cc in range(3):
            t_alb = z_alb.clone()
            t_alb[m, cc] = 1.0
            primal, tan = torch.func.jvp(render, (z_alb, z_le), (t_alb, z_le))
            galb[:, :, cc, m] = tan
    for li in range(l_n):
        for c in range(3):
            t_le = z_le.clone()
            t_le[li, c] = 1.0
            primal, tan = torch.func.jvp(render, (z_alb, z_le), (z_alb, t_le))
            gle[:, c, li] = tan[:, c]
    img[:] = render(z_alb, z_le) if primal is None else primal
    return img, galb, gle


def mega_grad_path(gs, o, d, keys, tri_rec=None, al_le=None):
    """Radiance of one whole path per ray and its per-lane Jacobians:
    ``img`` (N, 3), ``galb[:, c, cc, m] = ∂img_c/∂mat_albedo[m, cc]``
    (N, 3, 3, M) and ``gle[:, c, l] = ∂img_c/∂al_le[l, c]`` (N, 3, L), as
    views of one (3 + 9M + 3L, N) plane-major output. ``tri_rec`` (T, 32)
    and ``al_le`` (>= L, 3) are live: None takes the scene's own."""
    if not o.is_cuda:
        return mega_grad_path_plain(gs, o, d, keys, tri_rec, al_le)
    fs = gs.fs
    dev = o.device
    n = o.shape[0]
    sweeps._check("o", o, torch.float32, (n, 3), dev)
    sweeps._check("d", d, torch.float32, (n, 3), dev)
    if keys.dtype != torch.int32:
        sweeps._check("keys", keys, torch.int64, (n,), dev)
        keys = _i32_bits(keys)
    sweeps._check("keys", keys, torch.int32, (n,), dev)
    _check_scene(fs, dev)
    tri_rec, al_le = _grad_inputs(gs, tri_rec, al_le)
    t_total = fs.scene.tri_v0.shape[0]
    sweeps._check("tri_rec", tri_rec, torch.float32, (t_total, 32), dev)
    if tri_rec.data_ptr() % 16:
        raise ValueError("tri_rec: must be 16-byte aligned")
    if al_le.dim() != 2 or al_le.shape[0] < fs.n_lights or al_le.shape[1] != 3:
        raise ValueError(f"al_le: shape {tuple(al_le.shape)}, expected (>= {fs.n_lights}, 3)")
    sweeps._check("obj_mat", gs.obj_mat, torch.int32, (gs.obj_mat.shape[0],), dev)
    if fs.n_lights:
        # the Le columns of the light table, from this call's emission
        fs.lights[:fs.n_lights, 13:16].copy_(al_le[:fs.n_lights].detach())
    out = torch.empty((gs.n_planes, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("mega_grad_path", (
            o.data_ptr(), d.data_ptr(), keys.data_ptr(), n,
            *fs.scene_args(tri_rec), gs.obj_mat.data_ptr(),
            gs.obj_mat.shape[0], gs.n_mats, out.data_ptr(), sweeps._stream(),
        ))
    LAUNCHES["mega_grad_path"] += 1
    return _split_planes(out, gs.n_mats, fs.n_lights)


# --------------------------------------------------------------------------
# factories
# --------------------------------------------------------------------------
def try_make_fused_path_integrator(
    scene, statics, max_depth, nee=True, le_depth0_only=None,
    cosine_sampling=False, force=False, nee_mode="all", pick_weights=None,
):
    """``integrate(rays, keys)`` through ``mega_path`` if the scene
    qualifies, else None. Tables on the CPU qualify only with ``force``
    (``integrate`` then runs the plain version)."""
    if not force and not scene.tri_v0.is_cuda:
        return None
    if le_depth0_only is None:
        le_depth0_only = nee
    fs = _bake(scene, statics, max_depth, nee, le_depth0_only,
               cosine_sampling, nee_mode=nee_mode, pick_weights=pick_weights)
    if fs is None:
        return None

    def integrate(rays, keys):
        if rays.o.device != fs.device:
            raise ValueError(f"rays on {rays.o.device}, scene on {fs.device}")
        return mega_path(fs, rays.o.contiguous(), rays.d.contiguous(), keys)

    return integrate


def try_make_fused_grad_path(
    scene, statics, max_depth, nee=True, le_depth0_only=None,
    cosine_sampling=False, force=False, nee_mode="all",
):
    """Analytic forward-pass gradients through ``mega_grad_path``:
    ``f(rays, keys, tri_rec=None, al_le=None) -> (img (N,3), galb
    (N,3,3,M), gle (N,3,L))`` with ``galb[:, c, cc, m] =
    ∂img_c/∂mat_albedo[m, cc]`` and ``gle[:, c, l] = ∂img_c/∂al_le[l, c]``:
    the gradient of the same realized estimator that autograd computes on
    the wavefront route, at forward cost. ``tri_rec`` (e.g. from
    ``rejoin_appearance`` after an albedo override) and ``al_le`` are live
    per call. ``f.n_mats`` and ``f.n_lights`` give M and L.

    None for a scene ``_eligible`` refuses or with more than
    ``MAX_GRAD_MATS`` materials, and for tables on the CPU unless ``force``
    (``f`` then runs the plain version). A power pick bakes its weights from
    the base tables, here and in the plain version."""
    if not force and not scene.tri_v0.is_cuda:
        return None
    if le_depth0_only is None:
        le_depth0_only = nee
    n_mats = int(scene.mat_albedo.shape[0])
    if n_mats > MAX_GRAD_MATS:
        return None
    pick_w = None
    if nee and nee_mode == "power" and statics["n_area_lights"] > 0:
        from ..lights import light_power_weights

        pick_w = light_power_weights(scene)
    fs = _bake(scene, statics, max_depth, nee, le_depth0_only,
               cosine_sampling, nee_mode=nee_mode, pick_weights=pick_w)
    if fs is None:
        return None
    gs = GradScene(fs=fs, obj_mat=scene.obj_mat.to(torch.int32).contiguous(),
                   n_mats=n_mats)

    def f(rays, keys, tri_rec=None, al_le=None):
        if rays.o.device != fs.device:
            raise ValueError(f"rays on {rays.o.device}, scene on {fs.device}")
        return mega_grad_path(gs, rays.o.contiguous(), rays.d.contiguous(),
                              keys, tri_rec, al_le)

    f.n_mats = n_mats
    f.n_lights = fs.n_lights
    f.grad_scene = gs
    return f


def try_make_fused_spp_render(
    scene, statics, camera, width, height, seed, max_depth, nee=True,
    le_depth0_only=None, cosine_sampling=False, force=False,
    pixel_order="raster", nee_mode="all", persistent=True, pick_weights=None,
    mesh=None,
):
    """``render_chunk(s0, n_spp) -> (radiance_sum (N, 3), n_rejected)``
    running a whole chunk of samples in one launch, or None if the scene or
    the camera does not qualify. Draws the per-sample stream of the
    wavefront route (pixfold = pcg(pcg(seed) + pixel id), key =
    pcg(pixfold + s)). ``mesh``: see ``make_spp_render``."""
    if not force and not scene.tri_v0.is_cuda:
        return None
    if not isinstance(camera, PinholeCamera):
        return None
    if le_depth0_only is None:
        le_depth0_only = nee
    fs = _bake(scene, statics, max_depth, nee, le_depth0_only,
               cosine_sampling, nee_mode=nee_mode, pick_weights=pick_weights)
    if fs is None:
        return None
    kernel = mega_spp_persistent if persistent else mega_spp
    return make_spp_render(
        lambda view, s0, n_spp: kernel(fs, view, s0, n_spp),
        camera, width, height, seed, pixel_order=pixel_order, mesh=mesh,
    )


def make_spp_render(launch, camera, width, height, seed, pixel_order="raster",
                    mesh=None):
    """Assemble ``render_chunk(s0, n_spp)`` around any whole-path spp kernel
    ``launch(view, s0, n_spp) -> (sums (N, 3), rejects (N,))``: the camera
    constants, rounded as the kernels expect them, the per-pixel PCG fold
    and the pixel coordinates in lane order.

    ``pixel_order``: "raster" or "morton", the lane traversal of
    ``renderer.pixel_grid``. Radiance comes back in LANE order;
    ``render_chunk.pixel_ids`` is the lane -> pixel-id map for assembly.
    A pixel's stream depends only on its id, so images are bitwise
    identical across orders. No lane padding is needed on the card, so
    ``render_chunk.n_pad`` is the lane count.

    ``mesh``: a ``parallel.PixelGroup``, the multi-GPU fused path. The view
    then holds only this rank's contiguous block of the lanes
    (``parallel.sharded_pixels``: pixfold, px and py sliced), the kernel runs
    on those lanes alone, and ``render_chunk.pixel_ids`` is the block's
    lane -> pixel-id map (``render_chunk.sharded`` is set). Each lane owns
    its pixel, so a block's sums are bitwise the single-device kernel's on
    the same pixels.
    """
    from ..renderer import CAMERA_SITE, pixel_grid

    dev = camera.c2w.device
    c2w = camera.c2w.cpu().numpy().astype(np.float32)
    scale = float(camera.scale)
    aspect = float(camera.aspect)
    cam = np.concatenate([
        c2w[:3, :3].reshape(-1), c2w[3, :3],
        # scale / aspect is divided in double and then rounded, like the
        # other three constants
        np.asarray([scale, scale / aspect, 1.0 / width, 1.0 / height]),
    ]).astype(np.float32)
    ids, pxy = pixel_grid(width, height, order=pixel_order, device=dev)
    if mesh is not None:
        from ..parallel import sharded_pixels

        blk = sharded_pixels(mesh, ids.shape[0])
        ids, pxy = ids[blk], pxy[blk]
    pixfold = rng._pcg((rng.base_key(seed) + rng._u32(ids)) & _MASK)
    n = ids.shape[0]
    view = RenderView(
        n=n, cam=cam, cam_site=(CAMERA_SITE * _GOLDEN) & _MASK,
        pixfold=pixfold, pixfold_bits=_i32_bits(pixfold),
        px=pxy[:, 0].contiguous(), py=pxy[:, 1].contiguous(),
    )

    def render_chunk(s0, n_spp):
        rad, rej = launch(view, s0, n_spp)
        return rad, rej.sum()

    render_chunk.n_pad = n
    render_chunk.sharded = mesh is not None
    render_chunk.pixel_ids = ids.cpu().numpy()
    render_chunk.pixel_order = pixel_order
    render_chunk.view = view
    return render_chunk
