"""The heterogeneous tracking kernels: CUDA kernels, their wrappers, their
plain PyTorch versions, and the factories the volume integrator calls.

Counterpart of ``xraytracer_tpu/media_pallas.py``. Two kernels over the
per-lane device functions of ``csrc/media.cuh``, launched from
``csrc/media.cu``:

* ``track_sample`` replaces ``media_pallas.py::_sample_kernel`` (through
  ``try_make_fused_het_sampler``): weighted delta tracking of every lane of
  a wavefront in one launch; out come the stopping point ``t``, the weight,
  ``scattered`` and ``scat_step``.
* ``track_transmittance`` replaces ``media_pallas.py::_transmittance_kernel``
  (through ``try_make_fused_het_transmittance``): ratio-tracked
  transmittance between two points per lane.

And one helper of the analytic volume gradient, which replaces no TPU
kernel: ``pack_corners`` makes the corner table of a LIVE density grid on
the device (the scene builder's packing, ``scene/builder.py``), so that the
gradient step's two passes read one 32-byte row per lookup, as the forward
kernels read the build-time table (for grids of more than ``PACK_MIN``
cells: a smaller grid is read faster by corner loads).

The JAX package's kernels read a bf16 brick table through one-hot matmuls
(the TPU's stand-in for a gather) and so sample the density field rounded to
bf16; these kernels load float32 corners from ``grid_packed`` (or
``grid_density``) and sample the field as it is. ``het_pack``, the brick
table and its size gates have no counterpart: eligibility is "one
heterogeneous medium with a grid".

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and counts the launch in
``LAUNCHES`` (an empty wavefront launches nothing and counts nothing). A wrapper runs the plain version only for tensors that lie on
the CPU (counted in ``PLAIN_CALLS``); for a CUDA tensor it launches the
kernel or raises. The plain versions are the tracking loops of ``media.py``
(``_track_sample``, ``_track_transmittance``), which the kernels follow
term by term.

The factories return None for a scene without exactly one heterogeneous
medium, and for tables on the CPU unless ``force=True`` (the tests' way to
the plain versions).
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import media
from .geometry import Rays
from .geometry import kernels as sweeps
from .integrators.megakernel import _i32_bits
from .scene.tables import MED_HETEROGENEOUS

KERNEL_NAMES = ("track_sample", "track_transmittance", "pack_corners")

# launches of each kernel, and calls of each plain version, since the last
# ``reset_counts()``: plain ints, bumped exactly where a wrapper launches
# its kernel (resp. where a plain version runs) and nowhere else
LAUNCHES = {name: 0 for name in KERNEL_NAMES}
PLAIN_CALLS = {name: 0 for name in KERNEL_NAMES}

_MASK = 0xFFFFFFFF
_P = ctypes.c_void_p
_I = ctypes.c_int
_FC = ctypes.POINTER(ctypes.c_float)
_IC = ctypes.POINTER(ctypes.c_int)
_GRID_ARGTYPES = [_FC, _IC, _P, _P, _P]
_ARGTYPES = {
    # o, d, t0, t1, tp, keys, mask, n, site, grid..., t, w, scat, step, stream
    "track_sample": [_P] * 7 + [_I, ctypes.c_uint] + _GRID_ARGTYPES + [_P] * 5,
    # p1, p2, keys, mask, n, site, grid..., tr, stream
    "track_transmittance": [_P] * 4 + [_I, ctypes.c_uint] + _GRID_ARGTYPES + [_P] * 2,
    # density, nx, ny, nz, out, stream
    "pack_corners": [_P, _I, _I, _I, _P, _P],
}

# the scene builder's size gate for the corner table (8 floats per cell):
# a larger grid is read by eight corner loads
PACK_GATE = 160 ** 3
# the gradient step functions pack a live grid only past this many cells.
# A small grid stays in L1 and its eight scattered loads are cheap, where its
# table is 8x the bytes: at 16^3 (16 KB) pass A read the table 26% slower
# than the dense grid and K10 2% slower; at 64^3 (1 MB) K10 read it 3-7%
# faster and both passes together 0-9% faster (H100, chip_smoke.py). The
# crossover between the two was not measured; the gate sits at 32^3, a
# 128 KB grid.
PACK_MIN = 32 ** 3


def _bind(lib):
    """Declare the launchers' C signatures on a loaded media library."""
    if not getattr(lib, "_xrt_bound", False):
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib._xrt_bound = True
    return lib


def _lib():
    from ._build import load

    return _bind(load("media"))


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


@dataclass
class HetMedium:
    """What one launch needs of the scene's heterogeneous medium, resolved
    once: the medium row, the constants in float32 as the plain version
    computes them, and the launch's host arrays."""

    scene: object
    row: int
    g: float
    max_steps: int
    chan_uniform: bool
    fc: object    # ctypes float array, csrc/media.cu::grid_from
    ic: object    # ctypes int array

    @property
    def device(self):
        return self.scene.grid_density.device

    def grid_args(self, density=None, packed=None):
        """The grid's launch arguments. ``density``: a live (nx, ny, nz)
        grid on the device, read in place of the scene's (whose corner
        table would be stale): through ``packed``, its corner table
        (``pack_corners``), or else by eight corner loads."""
        s = self.scene
        if density is None:
            return (self.fc, self.ic, s.grid_density.data_ptr(),
                    s.grid_packed.data_ptr(), s.grid_super.data_ptr())
        ic = (ctypes.c_int * len(self.ic))(*self.ic)
        ic[8] = int(packed is not None)   # use_packed
        rows = density if packed is None else packed
        return (self.fc, ic, density.data_ptr(), rows.data_ptr(),
                s.grid_super.data_ptr())

    def med(self, n):
        """The medium's row gathered for ``n`` lanes, as ``media`` takes it."""
        idx = torch.full((n,), self.row, dtype=torch.int32, device=self.device)
        return media.gather_medium(self.scene, idx)


def het_medium(tables, max_steps, chan_uniform=False):
    """The scene's one heterogeneous medium as a ``HetMedium``, or None when
    the scene has none or more than one (the wavefront loop's host-side
    tracking then serves it)."""
    med_type = tables.med_type.cpu().numpy()
    rows = np.flatnonzero(med_type == MED_HETEROGENEOUS)
    if rows.size != 1:
        return None
    row = int(rows[0])
    f32 = np.float32
    res = np.asarray(tables.grid_density.shape, f32)
    gmin = tables.grid_min.cpu().numpy().astype(f32)
    gmax = tables.grid_max.cpu().numpy().astype(f32)
    ext = gmax - gmin
    res_m1 = res - f32(1.0)
    scale = res_m1 / np.where(ext == 0.0, f32(1.0), ext)
    bs = tables.grid_super_bsize.cpu().numpy().astype(f32)
    nb = tables.grid_super_nb.cpu().numpy().astype(np.int32)
    sa = tables.med_sigma_a.cpu().numpy()[row].astype(f32)
    ss = tables.med_sigma_s.cpu().numpy()[row].astype(f32)
    st = sa + ss
    fc = np.concatenate([
        gmin, gmax, ext, res_m1, scale, bs, nb.astype(f32) - f32(1.0), sa, ss,
        st, [st.max(), tables.med_majorant.cpu().numpy()[row],
             tables.med_density_mult.cpu().numpy()[row]],
    ]).astype(f32)
    n_cells = int(np.prod(tables.grid_density.shape))
    use_packed = int(tables.grid_packed.shape[0] == n_cells)
    ic = [int(s) for s in tables.grid_density.shape] + [int(v) for v in nb] + [
        int(bool(chan_uniform)), int(max_steps), use_packed]
    return HetMedium(
        scene=tables, row=row, g=float(tables.med_g.cpu().numpy()[row]),
        max_steps=int(max_steps), chan_uniform=bool(chan_uniform),
        fc=(ctypes.c_float * len(fc))(*[float(v) for v in fc]),
        ic=(ctypes.c_int * len(ic))(*ic),
    )


def _check_grid(hm, dev):
    s = hm.scene
    f32 = torch.float32
    sweeps._check("grid_density", s.grid_density, f32, s.grid_density.shape, dev)
    sweeps._check("grid_packed", s.grid_packed, f32, s.grid_packed.shape, dev)
    sweeps._check("grid_super", s.grid_super, f32, s.grid_super.shape, dev)
    if s.grid_packed.data_ptr() % 32:
        raise ValueError("grid_packed: must be 32-byte aligned")
    if s.grid_density.numel() >= 2 ** 28:
        raise ValueError("grid_density: too many cells for the kernels' indexing")


def _check_live_grid(hm, density, dev, packed=None):
    """A live density grid: float32, the scene grid's shape, contiguous, on
    ``dev``; and its corner table, if given."""
    g = hm.scene.grid_density
    sweeps._check("grid_density (live)", density, torch.float32, g.shape, dev)
    if packed is not None:
        sweeps._check("corner table (live)", packed, torch.float32,
                      (density.numel(), 8), dev)
        if packed.data_ptr() % 32:
            raise ValueError("corner table (live): must be 32-byte aligned")


def _key_bits(keys, n, dev):
    if keys.dtype != torch.int32:
        sweeps._check("keys", keys, torch.int64, (n,), dev)
        keys = _i32_bits(keys)
    sweeps._check("keys", keys, torch.int32, (n,), dev)
    return keys


def _mask_bytes(mask, n, dev):
    sweeps._check("het_mask", mask, torch.bool, (n,), dev)
    return mask.view(torch.uint8)


def _site(site):
    if isinstance(site, bool) or not isinstance(site, int):
        raise TypeError(f"site must be a Python int, got {type(site).__name__}")
    return site & _MASK


# --------------------------------------------------------------------------
# K7: weighted delta tracking
# --------------------------------------------------------------------------
def track_sample_plain(hm, o, d, t0, t1, tp, keys, site, het_mask,
                       candidates=None):
    """Plain PyTorch version of ``track_sample``: ``media._track_sample``
    on the same inputs. Returns (t (N,), weight (N, 3), scattered (N,) bool,
    scat_step (N,) int32). A list passed as ``candidates`` receives the
    number of active lanes at each step of the loop."""
    PLAIN_CALLS["track_sample"] += 1
    n = o.shape[0]
    t, w, scattered, scat_step = media._track_sample(
        hm.scene, hm.med(n), Rays(o=o, d=d), t0, t1, tp,
        keys.to(torch.int64) & _MASK, _site(site), hm.max_steps,
        het_mask=het_mask, chan_uniform=hm.chan_uniform, candidates=candidates,
    )
    return t, w, scattered, scat_step.to(torch.int32)


def track_sample(hm, o, d, t0, t1, tp, keys, site, het_mask):
    """Weighted delta tracking of every lane through the medium span
    ``[t0, t1]`` of its ray. ``o, d, tp`` (N, 3) f32; ``t0, t1`` (N,) f32;
    ``keys`` (N,) path keys (uint32 values held in int64, or their bits as
    int32); ``site`` the first RNG site of the loop (a Python int);
    ``het_mask`` (N,) bool, false lanes pass through (t = t1 + RAY_EPS,
    weight 1). Returns (t, weight, scattered, scat_step)."""
    if not o.is_cuda:
        return track_sample_plain(hm, o, d, t0, t1, tp, keys, site, het_mask)
    dev = o.device
    n = o.shape[0]
    f32 = torch.float32
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("t0", t0, (n,)),
                           ("t1", t1, (n,)), ("tp", tp, (n, 3))):
        sweeps._check(name, x, f32, shape, dev)
    keys = _key_bits(keys, n, dev)
    mask8 = _mask_bytes(het_mask, n, dev)
    _check_grid(hm, dev)
    t = torch.empty((n,), dtype=f32, device=dev)
    w = torch.empty((n, 3), dtype=f32, device=dev)
    scat = torch.empty((n,), dtype=torch.uint8, device=dev)
    step = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:  # an empty wavefront: nothing to launch, nothing to count
        return t, w, scat.view(torch.bool), step
    with torch.cuda.device(dev):
        _launch("track_sample", (
            o.data_ptr(), d.data_ptr(), t0.data_ptr(), t1.data_ptr(),
            tp.data_ptr(), keys.data_ptr(), mask8.data_ptr(), n, _site(site),
            *hm.grid_args(), t.data_ptr(), w.data_ptr(), scat.data_ptr(),
            step.data_ptr(), sweeps._stream(),
        ))
    LAUNCHES["track_sample"] += 1
    return t, w, scat.view(torch.bool), step


# --------------------------------------------------------------------------
# K8: ratio-tracked transmittance
# --------------------------------------------------------------------------
def track_transmittance_plain(hm, p1, p2, keys, site, het_mask, candidates=None):
    """Plain PyTorch version of ``track_transmittance``:
    ``media._track_transmittance`` on the same inputs. Returns (N, 3)."""
    PLAIN_CALLS["track_transmittance"] += 1
    n = p1.shape[0]
    return media._track_transmittance(
        hm.scene, hm.med(n), p1, p2, keys.to(torch.int64) & _MASK, _site(site),
        hm.max_steps, het_mask, candidates=candidates,
    )


def track_transmittance(hm, p1, p2, keys, site, het_mask):
    """Ratio-tracked transmittance (N, 3) from ``p1`` to ``p2`` (N, 3) f32
    per lane; lanes with ``het_mask`` false get 1."""
    if not p1.is_cuda:
        return track_transmittance_plain(hm, p1, p2, keys, site, het_mask)
    dev = p1.device
    n = p1.shape[0]
    sweeps._check("p1", p1, torch.float32, (n, 3), dev)
    sweeps._check("p2", p2, torch.float32, (n, 3), dev)
    keys = _key_bits(keys, n, dev)
    mask8 = _mask_bytes(het_mask, n, dev)
    _check_grid(hm, dev)
    tr = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return tr
    with torch.cuda.device(dev):
        _launch("track_transmittance", (
            p1.data_ptr(), p2.data_ptr(), keys.data_ptr(), mask8.data_ptr(), n,
            _site(site), *hm.grid_args(), tr.data_ptr(), sweeps._stream(),
        ))
    LAUNCHES["track_transmittance"] += 1
    return tr


# --------------------------------------------------------------------------
# the corner table of a live grid
# --------------------------------------------------------------------------
def pack_corners_plain(density):
    """Plain PyTorch version of ``pack_corners``: the scene builder's
    packing. Returns (nx * ny * nz, 8), corner d = dx*4 + dy*2 + dz of row
    (i, j, k) the grid at (i + dx, j + dy, k + dz), edges clamped."""
    PLAIN_CALLS["pack_corners"] += 1
    nx, ny, nz = density.shape
    dev = density.device
    ix, iy, iz = (torch.arange(k, device=dev) for k in (nx, ny, nz))
    out = torch.empty((nx, ny, nz, 8), dtype=density.dtype, device=dev)
    for d in range(8):
        dx, dy, dz = (d >> 2) & 1, (d >> 1) & 1, d & 1
        out[..., d] = density[torch.clamp(ix + dx, max=nx - 1)][
            :, torch.clamp(iy + dy, max=ny - 1)][:, :, torch.clamp(iz + dz, max=nz - 1)]
    return out.reshape(-1, 8)


def pack_corners(density, out=None):
    """The corner table (nx * ny * nz, 8) f32 of the (nx, ny, nz) f32 grid
    ``density``, written into ``out`` when given (its shape, 32-byte
    aligned). A grid past ``PACK_GATE`` has none (the builder's gate):
    ValueError."""
    if density.numel() > PACK_GATE:
        raise ValueError(f"pack_corners: {tuple(density.shape)} is past the "
                         f"corner table's size gate ({PACK_GATE} cells)")
    if not density.is_cuda:
        table = pack_corners_plain(density)
        if out is None:
            return table
        out.copy_(table)
        return out
    dev = density.device
    sweeps._check("density", density, torch.float32, density.shape, dev)
    n = density.numel()
    if out is None:
        out = torch.empty((n, 8), dtype=torch.float32, device=dev)
    sweeps._check("out", out, torch.float32, (n, 8), dev)
    if out.data_ptr() % 32:
        raise ValueError("pack_corners: out must be 32-byte aligned")
    if n == 0:
        return out
    with torch.cuda.device(dev):
        _launch("pack_corners", (density.data_ptr(), *density.shape,
                                 out.data_ptr(), sweeps._stream()))
    LAUNCHES["pack_corners"] += 1
    return out


# --------------------------------------------------------------------------
# factories
# --------------------------------------------------------------------------
def try_make_fused_het_sampler(tables, max_steps, force=False,
                               chan_uniform=False):
    """``het_fn`` for ``media.sample_medium`` (same contract as
    ``media._sample_heterogeneous``: (rays, t0, t1, tp, keys, site,
    het_mask) -> MediumSample) through ``track_sample``, or None if the
    scene does not qualify. Tables on the CPU qualify only with ``force``
    (``het_fn`` then runs the plain version)."""
    if not force and not tables.grid_density.is_cuda:
        return None
    hm = het_medium(tables, max_steps, chan_uniform=chan_uniform)
    if hm is None:
        return None

    def het_fn(rays, t0, t1, path_throughput, keys, site, het_mask):
        zero = torch.zeros_like(t0)
        t_res, weight, scattered, scat_step = track_sample(
            hm, rays.o.contiguous(), rays.d.contiguous(),
            torch.where(het_mask, t0, zero), torch.where(het_mask, t1, zero),
            path_throughput.contiguous(), keys, site, het_mask,
        )
        # the phase draw at the recorded scatter step's site and the NaN
        # guard stay outside the kernel, as in media._sample_heterogeneous
        d = media.scatter_direction(
            rays, keys, site, scat_step.to(torch.int64), scattered, hm.g
        )
        return media.MediumSample(
            pos=rays.at(t_res), dir=d, weight=media.nan_guard(weight),
            scattered=scattered,
        )

    return het_fn


def try_make_fused_het_transmittance(tables, max_steps, force=False):
    """``het_tr_fn`` for ``media.segment_transmittance``: (p1, p2, keys,
    site, het_mask) -> (N, 3) through ``track_transmittance``, or None."""
    if not force and not tables.grid_density.is_cuda:
        return None
    hm = het_medium(tables, max_steps)
    if hm is None:
        return None

    def het_tr_fn(p1, p2, keys, site, het_mask):
        p2s = torch.where(het_mask[:, None], p2, p1)
        return track_transmittance(
            hm, p1.contiguous(), p2s.contiguous(), keys, site, het_mask
        )

    return het_tr_fn
