"""The triangle sweeps of the main path: CUDA kernels, their wrappers and
their plain PyTorch versions.

Counterpart of ``xraytracer_tpu/geometry/pallas_kernels.py``. Three kernels,
one templated device function in ``csrc/sweep.cu``:

* ``sweep_nearest`` replaces ``pallas_kernels.py::_sweep_kernel`` (through
  ``sweep_pallas`` / ``intersect_triangles_pallas``): nearest triangle hit
  per ray, ``(t, idx, u, v)``.
* ``sweep_nearest_rec`` replaces ``pallas_kernels.py::_sweep_kernel_rec``
  (through ``sweep_pallas_rec`` / ``intersect_triangles_pallas_rec``): the
  same plus the winner's 32-float surface record.
* ``occluded_anyhit`` replaces ``pallas_kernels.py::_anyhit_kernel``
  (through ``occluded_triangles_pallas``): boolean any-hit closer than
  ``t_max`` over a blocking mask.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and counts the launch in
``LAUNCHES``. A wrapper runs the plain version only for tensors that lie on
the CPU (counted in ``PLAIN_CALLS``); for a CUDA tensor it launches the
kernel or raises.

The kernels walk a chunk table of the triangle table (``csrc/sweep.cuh``):
per chunk of ``SWEEP_CHUNK`` rows and per group of ``SWEEP_GROUP`` chunks a
padded box, and every row's 16 pair-test coefficients, zero for rows the
mask leaves out. A fourth kernel, ``chunk_boxes`` (in
``csrc/sweep.cu``, replacing the XLA pre-pass ``_build_chunk_aabbs`` /
``_build_g_chunks`` that every Pallas sweep runs), builds it on the card;
``_chunk_table`` keeps the last few tables by the identity and version of
the tensors they were built from, so a render that sweeps one constant table
thousands of times builds it once per mask.

The plain versions are the port of the JAX package's off-TPU sweep
(``intersect_triangles_mm`` + ``tri_rec[idx]``, and ``t < t_max`` for the
shadow sweep), so the port's CPU path is the same computation as the JAX
package's CPU path; it needs no chunk table. What bounds each kernel on the
card and what the design does about it is noted at the top of
``csrc/sweep.cu``.
"""

import ctypes
import weakref

import torch

from .types import Rays

SWEEPS = ("sweep_nearest", "sweep_nearest_rec", "occluded_anyhit")
KERNEL_NAMES = SWEEPS + ("chunk_boxes",)

# launches of each kernel, and calls of each plain version, since the last
# ``reset_counts()``: plain ints, bumped exactly where a wrapper launches
# its kernel (resp. where a plain version runs) and nowhere else
LAUNCHES = {name: 0 for name in KERNEL_NAMES}
PLAIN_CALLS = {name: 0 for name in KERNEL_NAMES}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    # o, d, n, [v0, e1, e2,] t_total, center, boxes, coef, [extra in], outs,
    # stream
    "sweep_nearest": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "sweep_nearest_rec": [
        _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ],
    "occluded_anyhit": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
    # v0, e1, e2, mask, t_total, center, boxes, coef, stream
    "chunk_boxes": [_P, _P, _P, _P, _I, _P, _P, _P, _P],
}


def _bind(lib):
    """Declare the launchers' C signatures on a loaded sweep library."""
    if not getattr(lib, "_xrt_bound", False):
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib._xrt_bound = True
    return lib


def _lib():
    from .._build import load

    return _bind(load("sweep"))


def _check(name, x, dtype, shape, device):
    if not torch.is_tensor(x):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_table(v0, e1, e2, mask, dev):
    """Validate a triangle table and its mask; returns (t_total, mask as
    uint8)."""
    f32 = torch.float32
    if v0.dim() != 2:
        raise ValueError("v0 must be (T, 3)")
    t_total = v0.shape[0]
    _check("v0", v0, f32, (t_total, 3), dev)
    _check("e1", e1, f32, (t_total, 3), dev)
    _check("e2", e2, f32, (t_total, 3), dev)
    if mask.dtype == torch.bool:
        _check("mask", mask, torch.bool, (t_total,), dev)
        mask = mask.view(torch.uint8)
    else:
        _check("mask", mask, torch.uint8, (t_total,), dev)
    if t_total >= 2 ** 31 // 32:
        raise ValueError("triangle count exceeds the kernels' int32 indexing")
    return t_total, mask


def _check_sweep_inputs(o, d, v0, e1, e2, mask):
    """Validate the common inputs; returns (n, t_total, mask as uint8)."""
    dev = o.device
    if o.dim() != 2:
        raise ValueError("o must be (N, 3)")
    n = o.shape[0]
    _check("o", o, torch.float32, (n, 3), dev)
    _check("d", d, torch.float32, (n, 3), dev)
    t_total, mask8 = _check_table(v0, e1, e2, mask, dev)
    if n >= 2 ** 31 // 32:
        raise ValueError("ray count exceeds the kernels' int32 indexing")
    return n, t_total, mask8


def _launch(name, args):
    rc = getattr(_lib(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {rc}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


# the last table's centroid: (weak reference to v0, v0._version, centroid)
_center_cache = (None, None, None)


def _center(v0):
    """Triangle-table centroid (3,), the origin of the centred coordinates
    both the kernels and the plain sweep evaluate the bilinear forms in.
    A render sweeps one constant table thousands of times, so the centroid
    of the last table is kept and reduced again only when another tensor,
    or the same one after an in-place write, comes in."""
    global _center_cache
    ref, version, center = _center_cache
    if ref is not None and ref() is v0 and version == v0._version:
        return center
    if v0.shape[0] == 0:
        center = torch.zeros((3,), dtype=v0.dtype, device=v0.device)
    else:
        center = torch.mean(v0, dim=0).contiguous()
    _center_cache = (weakref.ref(v0), v0._version, center)
    return center


# --------------------------------------------------------------------------
# the chunk table the sweeps walk
# --------------------------------------------------------------------------
BOX_BIG = 3.0e38  # an empty box is [BOX_BIG, -BOX_BIG] (csrc/sweep.cuh)
# the layout csrc/sweep.cuh compiles (its SWEEP_CHUNK, SWEEP_GROUP): rows
# per chunk (the JAX package's TRI_CHUNK is 128), chunks per group (its
# CHUNK_GROUP)
SWEEP_CHUNK, SWEEP_GROUP = 32, 16


def _pad_rows(x, rows, value):
    """``x`` with ``rows`` more rows of ``value`` at the end."""
    if rows == 0:
        return x
    return torch.cat([x, torch.full((rows,) + tuple(x.shape[1:]), value,
                                    dtype=x.dtype, device=x.device)])


def _coeff_rows(v0, e1, e2, mask, center):
    """(T, 16) pair-test coefficients of every row (``tri_test.cuh``'s
    ``tri_coeffs`` in the centred coordinates), zero where ``mask`` is 0."""
    p = v0 - center
    ng = torch.linalg.cross(e1, e2)
    pe2 = torch.linalg.cross(p, e2)
    e1p = torch.linalg.cross(e1, p)
    p_ng = (p[:, 0] * ng[:, 0] + p[:, 1] * ng[:, 1]) + p[:, 2] * ng[:, 2]
    rows = torch.cat([ng, p_ng[:, None], e2, pe2, e1, e1p], dim=1)
    return torch.where(mask.bool()[:, None], rows, torch.zeros_like(rows))


def chunk_boxes_plain(v0, e1, e2, mask, center):
    """Plain PyTorch version of ``chunk_boxes``: ``(boxes, coef)``, the
    chunk table of ``csrc/sweep.cuh``. ``boxes`` (n_chunks + n_groups, 8):
    per chunk of ``SWEEP_CHUNK`` rows the box of its valid rows' vertices in the
    coordinates centred on ``center``, padded by 1e-4 x its largest extent +
    1e-6, then 1.0 iff the chunk holds a valid row, then 0 (the JAX
    package's ``_build_chunk_aabbs``, with a ragged last chunk); then per
    group of ``SWEEP_GROUP`` chunks the union of its chunks' padded boxes
    and whether any is valid. ``coef`` (n_chunks * SWEEP_CHUNK, 16):
    ``_coeff_rows`` with zero rows padding the last chunk."""
    PLAIN_CALLS["chunk_boxes"] += 1
    chunk, group = SWEEP_CHUNK, SWEEP_GROUP
    t_total = v0.shape[0]
    n_chunks = -(-t_total // chunk)
    n_groups = -(-n_chunks // group)
    extra = n_chunks * chunk - t_total
    valid = _pad_rows(mask.bool(), extra, False)
    vm = valid[:, None]
    p = v0 - center
    corners = [_pad_rows(c, extra, 0.0) for c in (p, p + e1, p + e2)]
    lo = torch.minimum(torch.minimum(
        *[torch.where(vm, c, BOX_BIG) for c in corners[:2]]),
        torch.where(vm, corners[2], BOX_BIG))
    hi = torch.maximum(torch.maximum(
        *[torch.where(vm, c, -BOX_BIG) for c in corners[:2]]),
        torch.where(vm, corners[2], -BOX_BIG))
    lo = lo.reshape(n_chunks, chunk, 3).amin(dim=1)
    hi = hi.reshape(n_chunks, chunk, 3).amax(dim=1)
    has = valid.reshape(n_chunks, chunk).any(dim=1, keepdim=True)
    pad = 1e-4 * torch.clamp(hi - lo, min=0.0).amax(dim=-1, keepdim=True) + 1e-6
    zero = torch.zeros_like(pad)
    cbox = torch.cat([lo - pad, hi + pad, has.to(v0.dtype), zero], dim=-1)
    gextra = n_groups * group - n_chunks
    glo = _pad_rows(cbox[:, 0:3], gextra, BOX_BIG).reshape(n_groups, group, 3)
    ghi = _pad_rows(cbox[:, 3:6], gextra, -BOX_BIG).reshape(n_groups, group, 3)
    gvalid = _pad_rows(cbox[:, 6:7], gextra, 0.0).reshape(n_groups, group)
    gbox = torch.cat([glo.amin(dim=1), ghi.amax(dim=1),
                      gvalid.amax(dim=1, keepdim=True),
                      torch.zeros((n_groups, 1), dtype=v0.dtype, device=v0.device)],
                     dim=-1)
    coef = _pad_rows(_coeff_rows(v0, e1, e2, mask, center), extra, 0.0)
    return torch.cat([cbox, gbox]).contiguous(), coef.contiguous()


def chunk_boxes(v0, e1, e2, mask, center):
    """The chunk table ``(boxes, coef)`` of a triangle table and mask (see
    ``chunk_boxes_plain``). One launch; none for an empty table."""
    if not v0.is_cuda:
        return chunk_boxes_plain(v0, e1, e2, mask, center)
    dev = v0.device
    t_total, mask8 = _check_table(v0, e1, e2, mask, dev)
    _check("center", center, torch.float32, (3,), dev)
    n_chunks = -(-t_total // SWEEP_CHUNK)
    n_groups = -(-n_chunks // SWEEP_GROUP)
    boxes = torch.empty((n_chunks + n_groups, 8), dtype=torch.float32, device=dev)
    coef = torch.empty((n_chunks * SWEEP_CHUNK, 16), dtype=torch.float32, device=dev)
    if t_total == 0:
        return boxes, coef
    with torch.cuda.device(dev):
        _launch("chunk_boxes", (
            v0.data_ptr(), e1.data_ptr(), e2.data_ptr(), mask8.data_ptr(), t_total,
            center.data_ptr(), boxes.data_ptr(), coef.data_ptr(), _stream(),
        ))
    LAUNCHES["chunk_boxes"] += 1
    return boxes, coef


# the chunk tables last built: [(weak references to v0, e1, e2, mask,
# their _version, (boxes, coef))], most recent last
_chunk_tables = []
_CHUNK_TABLES_KEPT = 4   # a render sweeps one table under two masks


def _chunk_table(v0, e1, e2, mask):
    """The chunk table of this table and mask, built on the first call and
    kept while the same tensors come in unchanged (same objects, same
    ``_version``); a failed build raises. The masks are made once per scene
    (``intersect.tables_present``), so a render builds a table once per
    mask. A table whose tensors are gone is dropped at the next call."""
    inputs = (v0, e1, e2, mask)
    versions = tuple(x._version for x in inputs)
    _chunk_tables[:] = [e for e in _chunk_tables
                        if all(r() is not None for r in e[0])]
    for k, (refs, vers, table) in enumerate(_chunk_tables):
        if vers == versions and all(r() is x for r, x in zip(refs, inputs)):
            _chunk_tables.append(_chunk_tables.pop(k))
            return table
    table = chunk_boxes(v0, e1, e2, mask, _center(v0))
    _chunk_tables.append((tuple(weakref.ref(x) for x in inputs), versions, table))
    del _chunk_tables[:-_CHUNK_TABLES_KEPT]
    return table


# --------------------------------------------------------------------------
# K2: nearest hit
# --------------------------------------------------------------------------
def sweep_nearest_plain(o, d, v0, e1, e2, valid):
    """Plain PyTorch version of ``sweep_nearest``: the matmul-form sweep
    with the stable winner epilogue. Returns (t, idx, u, v)."""
    from .intersect import intersect_triangles_mm

    PLAIN_CALLS["sweep_nearest"] += 1
    return intersect_triangles_mm(Rays(o=o, d=d), v0, e1, e2, valid)


def sweep_nearest(o, d, v0, e1, e2, valid):
    """Nearest triangle hit per ray. ``o, d`` (N, 3) f32; ``v0, e1, e2``
    (T, 3) f32; ``valid`` (T,) bool. Returns ``t`` (N,) f32 (INF on miss),
    ``idx`` (N,) int32 (-1 on miss), ``u``, ``v`` (N,) f32 (0 on miss)."""
    if not o.is_cuda:
        return sweep_nearest_plain(o, d, v0, e1, e2, valid)
    n, t_total, _ = _check_sweep_inputs(o, d, v0, e1, e2, valid)
    dev = o.device
    boxes, coef = _chunk_table(v0, e1, e2, valid)
    center = _center(v0)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("sweep_nearest", (
            o.data_ptr(), d.data_ptr(), n,
            v0.data_ptr(), e1.data_ptr(), e2.data_ptr(), t_total,
            center.data_ptr(), boxes.data_ptr(), coef.data_ptr(),
            t.data_ptr(), idx.data_ptr(), u.data_ptr(), v.data_ptr(),
            _stream(),
        ))
    LAUNCHES["sweep_nearest"] += 1
    return t, idx, u, v


def sweep_nearest_tri_fn(rays, v0, e1, e2, valid):
    """``sweep_nearest`` in the ``tri_fn`` form that ``intersect_scene`` and
    ``occluded`` accept (counterpart of ``intersect_triangles_pallas``)."""
    return sweep_nearest(rays.o, rays.d, v0, e1, e2, valid)


class SweepStopGrad(torch.autograd.Function):
    """``sweep_nearest`` inside gradient pipelines: zero gradients for rays
    and geometry in reverse mode, zero tangents in forward mode.
    Counterpart of ``pallas_kernels.py::intersect_triangles_pallas_stopgrad``.

    Exact for the parameters the gradient pipelines differentiate (albedo,
    emission): with detached sampling, ray origins, directions and vertices
    depend on geometry and random numbers only, so no gradient flows
    through the sweep's outputs; appearance gradients travel through the
    winner's record, gathered outside the kernel as ``tri_rec[idx]``. Not
    for vertex gradients (they would be silently zero): those take
    ``intersect_triangles_mm``. The forward pass launches the kernel for
    CUDA tensors and runs the plain version for CPU tensors."""

    @staticmethod
    def forward(o, d, v0, e1, e2, valid):
        return sweep_nearest(o.contiguous(), d.contiguous(), v0, e1, e2, valid)

    @staticmethod
    def setup_context(ctx, inputs, output):
        o, d, v0, e1, e2, _ = inputs
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in (o, d, v0, e1, e2)]
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, *grads):
        zeros = [torch.zeros(s, dtype=t, device=dev) for s, t, dev in ctx.shapes]
        return (*zeros, None)

    @staticmethod
    def jvp(ctx, *tangents):
        (o_shape, dt, dev) = ctx.shapes[0]
        z = torch.zeros(o_shape[:1], dtype=dt, device=dev)
        return z, None, z, z


def sweep_nearest_stopgrad_tri_fn(rays, v0, e1, e2, valid):
    """``SweepStopGrad`` in the ``tri_fn`` form. Its ``detached_ok`` tells
    ``occluded`` to send this pipeline's shadow rays, detached, through the
    boolean any-hit kernel."""
    return SweepStopGrad.apply(rays.o, rays.d, v0, e1, e2, valid)


sweep_nearest_stopgrad_tri_fn.detached_ok = True


# --------------------------------------------------------------------------
# K3: nearest hit + winner record
# --------------------------------------------------------------------------
def sweep_nearest_rec_plain(o, d, v0, e1, e2, valid, tri_rec):
    """Plain PyTorch version of ``sweep_nearest_rec``: the matmul-form sweep
    plus ``tri_rec[idx]``, zeroed on miss. Returns (t, idx, u, v, rec)."""
    from .intersect import intersect_triangles_mm

    PLAIN_CALLS["sweep_nearest_rec"] += 1
    t, idx, u, v = intersect_triangles_mm(Rays(o=o, d=d), v0, e1, e2, valid)
    rec = tri_rec[torch.clamp(idx, min=0).to(torch.int64)]
    rec = torch.where((idx >= 0)[:, None], rec, torch.zeros_like(rec))
    return t, idx, u, v, rec


def sweep_nearest_rec(o, d, v0, e1, e2, valid, tri_rec):
    """``sweep_nearest`` plus the winner's packed surface record:
    ``tri_rec`` (T, 32) f32 -> ``rec`` (N, 32) f32, zero on miss."""
    if not o.is_cuda:
        return sweep_nearest_rec_plain(o, d, v0, e1, e2, valid, tri_rec)
    n, t_total, _ = _check_sweep_inputs(o, d, v0, e1, e2, valid)
    dev = o.device
    _check("tri_rec", tri_rec, torch.float32, (t_total, 32), dev)
    boxes, coef = _chunk_table(v0, e1, e2, valid)
    center = _center(v0)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    rec = torch.empty((n, 32), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("sweep_nearest_rec", (
            o.data_ptr(), d.data_ptr(), n,
            v0.data_ptr(), e1.data_ptr(), e2.data_ptr(), t_total,
            center.data_ptr(), boxes.data_ptr(), coef.data_ptr(), tri_rec.data_ptr(),
            t.data_ptr(), idx.data_ptr(), u.data_ptr(), v.data_ptr(),
            rec.data_ptr(), _stream(),
        ))
    LAUNCHES["sweep_nearest_rec"] += 1
    return t, idx, u, v, rec


# --------------------------------------------------------------------------
# K4: boolean any-hit
# --------------------------------------------------------------------------
def occluded_anyhit_plain(o, d, v0, e1, e2, blocks, t_max):
    """Plain PyTorch version of ``occluded_anyhit``: nearest hit over the
    ``blocks`` mask, then ``t < t_max``. Returns (N,) bool."""
    from .intersect import occluded_triangles_mm

    PLAIN_CALLS["occluded_anyhit"] += 1
    return occluded_triangles_mm(Rays(o=o, d=d), v0, e1, e2, blocks, t_max)


def occluded_anyhit(o, d, v0, e1, e2, blocks, t_max):
    """``blocked[i]`` = some triangle with ``blocks`` set is hit by ray i at
    a distance in (K_EPS, t_max[i]). ``t_max`` (N,) f32; a lane with
    ``t_max = 0`` is never blocked. Returns (N,) bool."""
    if not o.is_cuda:
        return occluded_anyhit_plain(o, d, v0, e1, e2, blocks, t_max)
    n, t_total, _ = _check_sweep_inputs(o, d, v0, e1, e2, blocks)
    dev = o.device
    _check("t_max", t_max, torch.float32, (n,), dev)
    boxes, coef = _chunk_table(v0, e1, e2, blocks)
    center = _center(v0)
    blocked = torch.empty((n,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _launch("occluded_anyhit", (
            o.data_ptr(), d.data_ptr(), n, t_total, center.data_ptr(),
            boxes.data_ptr(), coef.data_ptr(), t_max.data_ptr(),
            blocked.data_ptr(), _stream(),
        ))
    LAUNCHES["occluded_anyhit"] += 1
    return blocked.view(torch.bool)


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
