"""Batched ray-scene intersection (plain PyTorch path + kernel dispatch).

PyTorch counterpart of ``xraytracer_tpu/geometry/intersect.py`` and of the
reference's per-ray virtual ``intersect`` dispatch (reference:
Src/scene.cpp:190-211 looping ``Object::intersect``,
Src/primitive.cpp:83-168 Möller-Trumbore, Src/primitive.h:106-177 sphere,
Src/primitive.h:243-268 box slab). Instead of a loop over objects, the scene
is three flat tables (triangles / spheres / medium boxes) and the whole
wavefront is tested against each table with masked min-reductions.

Deliberate divergences from the reference (SURVEY.md §2.4):
  * Box hits compete on nearest-t like everything else. (The C++ BoxMesh
    overwrites ``info`` unconditionally and its ``occluded`` returns true for
    every ray, Src/primitive.h:243-268 — order-dependent and wrong for mixed
    scenes.) Medium-only boxes never occlude shadow rays here.
  * Sphere hits get a proper ONB for (dpdu, dpdv). (The C++ leaves them
    uninitialized for spheres, Src/primitive.h:106-124.)

Dispatch: the triangle sweeps of ``intersect_scene`` and ``occluded`` go
through the wrappers in ``kernels.py``. For tensors on a CUDA device those
launch the hand-written sweep kernels; for CPU tensors they run the plain
versions below. There is no ``try``: a CUDA tensor either reaches its kernel
or the wrapper raises.
"""

from typing import NamedTuple

import torch

from ..constants import INF, K_EPS
from ..math import cross, dot, normalize, orthonormal_basis, take_rows
from . import kernels
from .types import Hit, Rays

# Triangle-table chunk processed per step of the classic sweep: bounds peak
# memory at N_rays * TRI_CHUNK intermediates.
TRI_CHUNK = 128

# Triangle chunk per step of the matmul formulation, and the ray block that
# bounds its (rays, chunk, 4) product tensor.
TRI_CHUNK_MM = 512
RAY_BLOCK_MM = 1 << 16

_BIG = 3.4e38


def _tri_chunk_hits(o, d, v0, e1, e2, valid, culling=False):
    """Möller-Trumbore for one (C,)-triangle chunk against (N,) rays.

    Mirrors Src/primitive.cpp:140-168: with ``culling`` (the reference's
    optional CULLING compile define) backfaces (det < kEpsilon) miss;
    otherwise parallel rays miss on |det| < kEpsilon. Hits require
    t > kEpsilon. Returns (t, u, v, ok) each (N, C).
    """
    dN = d[:, None, :]
    pvec = cross(dN, e2[None, :, :])                    # (N, C, 3)
    det = torch.sum(e1[None, :, :] * pvec, dim=-1)
    inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    tvec = o[:, None, :] - v0[None, :, :]
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = cross(tvec, e1[None, :, :])
    v = torch.sum(dN * qvec, dim=-1) * inv_det
    t = torch.sum(e2[None, :, :] * qvec, dim=-1) * inv_det
    det_ok = (det >= K_EPS) if culling else (torch.abs(det) >= K_EPS)
    ok = (
        det_ok
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > K_EPS)
        & valid[None, :]
    )
    return t, u, v, ok


def intersect_triangles(rays: Rays, v0, e1, e2, valid, chunk=TRI_CHUNK,
                        culling=False):
    """Nearest triangle hit per ray (classic chunked Möller-Trumbore).
    Returns (t, idx, u, v); t=INF and idx=-1 on miss. A ragged last chunk
    is swept like any other (the Python loop needs no equal-sized steps)."""
    o, d = rays.o, rays.d
    n = o.shape[0]
    t_total = v0.shape[0]
    bt = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    bi = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros((n,), dtype=o.dtype, device=o.device)
    bv = torch.zeros((n,), dtype=o.dtype, device=o.device)
    chunk = max(1, min(chunk, t_total))
    for s in range(0, t_total, chunk):
        e = min(s + chunk, t_total)
        t, u, v, ok = _tri_chunk_hits(
            o, d, v0[s:e], e1[s:e], e2[s:e], valid[s:e], culling=culling
        )
        t = torch.where(ok, t, torch.full_like(t, INF))
        local = torch.argmin(t, dim=1, keepdim=True)
        tmin = torch.gather(t, 1, local)[:, 0]
        umin = torch.gather(u, 1, local)[:, 0]
        vmin = torch.gather(v, 1, local)[:, 0]
        better = tmin < bt
        bt = torch.where(better, tmin, bt)
        bi = torch.where(better, (s + local[:, 0]).to(torch.int32), bi)
        bu = torch.where(better, umin, bu)
        bv = torch.where(better, vmin, bv)
    return bt, bi, bu, bv


def _tri_features(v0, e1, e2):
    """Per-triangle feature matrix for the bilinear formulation of
    Möller-Trumbore. Each of det / u_num / v_num / t_num is a scalar triple
    product, which is bilinear between per-RAY quantities and per-TRIANGLE
    quantities:

        det   = e1.(d x e2)        = -d . ng                 (ng = e1 x e2)
        u_num = (o - v0).(d x e2)  = (o x d).e2 + d.(v0 x e2)
        v_num = d.((o - v0) x e1)  = -(o x d).e1 + d.(e1 x v0)
        t_num = e2.((o - v0) x e1) = o.ng - v0.ng

    With ray features F = [o x d, d, o, 1] (N, 10), all four values for all
    (ray, triangle) pairs are one product F @ G with G (10, 4T). The CUDA
    sweeps (csrc/sweep.cu) evaluate the same four forms per thread from the
    same per-triangle coefficients. Returns G.
    """
    ng = cross(e1, e2)
    zeros = torch.zeros_like(v0)
    zcol = torch.zeros_like(v0[:, :1])
    # columns: [coeff of (o x d) (3), coeff of d (3), coeff of o (3), const]
    g_det = torch.cat([zeros, -ng, zeros, zcol], dim=1)
    g_u = torch.cat([e2, cross(v0, e2), zeros, zcol], dim=1)
    g_v = torch.cat([-e1, cross(e1, v0), zeros, zcol], dim=1)
    g_t = torch.cat([zeros, zeros, ng, -dot(v0, ng)[:, None]], dim=1)
    # (T, 4, 10) -> (10, 4T), laid out so a chunk slice stays contiguous
    return torch.stack([g_det, g_u, g_v, g_t], dim=1).reshape(-1, 10).T


def _ray_features(o, d):
    """(N, 10) ray features [o x d, d, o, 1] for the bilinear formulation."""
    return torch.cat([cross(o, d), d, o, torch.ones_like(o[:, :1])], dim=1)


def _mm_hit_test(f, gc, vc):
    """Division-free hit test of ray features ``f`` (n, 10) against one
    chunk of triangle features ``gc`` (c, 4, 10). Returns (ok, det, t_num,
    t_s, absd), each (n, c)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "geometry products need full float32: "
            "torch.backends.cuda.matmul.allow_tf32 must stay False "
            "(reduced precision flips ~2% of hits)"
        )
    c = gc.shape[0]
    prod = (f @ gc.reshape(c * 4, 10).T).reshape(f.shape[0], c, 4)
    det = prod[..., 0]
    u_num = prod[..., 1]
    v_num = prod[..., 2]
    t_num = prod[..., 3]
    # with s = sign(det), a = |det|
    sgn = torch.sign(det)
    absd = torch.abs(det)
    u_s = u_num * sgn
    v_s = v_num * sgn
    t_s = t_num * sgn
    ok = (
        (absd >= K_EPS)
        & (u_s >= 0.0)
        & (v_s >= 0.0)
        & (u_s + v_s <= absd)
        & (t_s > K_EPS * absd)
        & (vc[None, :] > 0.0)
    )
    return ok, det, t_num, t_s, absd


def intersect_triangles_mm(rays: Rays, v0, e1, e2, valid, chunk=TRI_CHUNK_MM):
    """Matmul-form nearest hit: identical contract to ``intersect_triangles``
    but the inner sweep is (N, 10) @ (10, 4C) products over triangle chunks,
    with a division-free hit test; (t, u, v) for the winning triangle are
    recomputed once per ray with the numerically-stable classic form.

    To bound cancellation in the expanded triple products the scene is
    re-centered about the triangle-table centroid (both formulations are
    translation invariant; the expansion is not, so centering keeps the
    products small).

    Counterpart of the JAX ``intersect_triangles_mm`` — the sweep the JAX
    package runs off the TPU, and therefore the one its CPU golden was made
    with. Differences: the chunk loop is a Python loop, so a ragged last
    chunk is swept in the same form (the JAX scan needs equal chunks and
    falls back to the classic sweep there), and rays go through in blocks
    of ``RAY_BLOCK_MM`` so the (rays, chunk, 4) product stays bounded.
    """
    o, d = rays.o, rays.d
    n = o.shape[0]
    t_total = v0.shape[0]
    if t_total == 0:
        return intersect_triangles(rays, v0, e1, e2, valid)
    chunk = min(chunk, t_total)

    center = torch.mean(v0, dim=0)
    g = _tri_features(v0 - center, e1, e2)          # (10, 4T)
    g = g.T.reshape(t_total, 4, 10)                 # chunkable on axis 0
    f_all = _ray_features(o - center, d)            # (N, 10)
    valid_f = valid.to(torch.float32)

    bi_parts = []
    for r0 in range(0, max(n, 1), RAY_BLOCK_MM):
        f = f_all[r0:r0 + RAY_BLOCK_MM]
        nb = f.shape[0]
        bt = torch.full((nb,), _BIG, dtype=o.dtype, device=o.device)
        bi = torch.full((nb,), -1, dtype=torch.int32, device=o.device)
        for s in range(0, t_total, chunk):
            e = min(s + chunk, t_total)
            ok, det, t_num, _, _ = _mm_hit_test(f, g[s:e], valid_f[s:e])
            t = torch.where(
                ok,
                t_num / torch.where(det == 0.0, torch.ones_like(det), det),
                torch.full_like(det, _BIG),
            )
            local = torch.argmin(t, dim=1, keepdim=True)
            tmin = torch.gather(t, 1, local)[:, 0]
            better = tmin < bt
            bt = torch.where(better, tmin, bt)
            bi = torch.where(better, (s + local[:, 0]).to(torch.int32), bi)
        bi_parts.append(bi)
    bi = torch.cat(bi_parts)

    # winner epilogue: stable classic MT for just (N,) pairs
    ix = torch.clamp(bi, min=0).to(torch.int64)
    w_v0 = v0[ix]
    w_e1 = e1[ix]
    w_e2 = e2[ix]
    pvec = cross(d, w_e2)
    det = dot(w_e1, pvec)
    inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    tvec = o - w_v0
    bu = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, w_e1)
    bv = dot(d, qvec) * inv_det
    bt_stable = dot(w_e2, qvec) * inv_det
    hit = bi >= 0
    zero = torch.zeros_like(bu)
    return (
        torch.where(hit, bt_stable, torch.full_like(bt_stable, INF)),
        bi,
        torch.where(hit, bu, zero),
        torch.where(hit, bv, zero),
    )


def occluded_triangles_mm(rays: Rays, v0, e1, e2, blocks, t_max,
                          chunk=TRI_CHUNK_MM):
    """Plain boolean shadow sweep: the matmul-form nearest hit over the
    ``blocks`` mask followed by ``t < t_max`` — what the JAX package's
    ``occluded`` computes off the TPU."""
    tt, _, _, _ = intersect_triangles_mm(rays, v0, e1, e2, blocks, chunk)
    return tt < t_max


def intersect_spheres(rays: Rays, center, radius, valid):
    """Nearest sphere hit per ray; numerically-stable q-form quadratic
    (reference: Src/primitive.h:133-177). Returns (t, idx)."""
    o, d = rays.o, rays.d
    ell = o[:, None, :] - center[None, :, :]            # (N, S, 3)
    a = dot(d, d)[:, None]
    b = 2.0 * torch.sum(d[:, None, :] * ell, dim=-1)
    c = torch.sum(ell * ell, dim=-1) - (radius * radius)[None, :]
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b > 0.0, -0.5 * (b + sq), -0.5 * (b - sq))
    q_safe = torch.where(q == 0.0, torch.ones_like(q), q)
    x0 = q / a
    x1 = torch.where(q == 0.0, x0, c / q_safe)
    t0 = torch.minimum(x0, x1)
    t1 = torch.maximum(x0, x1)
    t = torch.where(t0 > 0.0, t0, t1)
    ok = (disc >= 0.0) & (t > 0.0) & valid[None, :]
    t = torch.where(ok, t, torch.full_like(t, INF))
    idx = torch.argmin(t, dim=1, keepdim=True)
    tmin = torch.gather(t, 1, idx)[:, 0]
    idx = idx[:, 0].to(torch.int32)
    idx = torch.where(tmin < INF, idx, torch.full_like(idx, -1))
    return tmin, idx


def intersect_boxes(rays: Rays, bmin, bmax, valid):
    """Nearest AABB hit per ray, slab method filling entry t0 and exit t1
    (reference: Src/primitive.h:243-264). Returns (t0, t1, idx)."""
    d = rays.d
    # guard exactly-zero components (axis-aligned rays) against 0*inf NaNs
    d_safe = torch.where(torch.abs(d) < 1e-12, torch.full_like(d, 1e-12), d)
    inv = 1.0 / d_safe
    ta = (bmin[None, :, :] - rays.o[:, None, :]) * inv[:, None, :]
    tb = (bmax[None, :, :] - rays.o[:, None, :]) * inv[:, None, :]
    tmin = torch.minimum(ta, tb)
    tmax = torch.maximum(ta, tb)
    t0 = torch.amax(tmin, dim=-1)
    t1 = torch.amin(tmax, dim=-1)
    ok = (t0 <= t1) & (t1 > 0.0) & valid[None, :]
    t0 = torch.clamp(t0, min=0.0)
    inf = torch.full_like(t0, INF)
    t0 = torch.where(ok, t0, inf)
    t1 = torch.where(ok, t1, inf)
    idx = torch.argmin(t0, dim=1, keepdim=True)
    en = torch.gather(t0, 1, idx)[:, 0]
    ex = torch.gather(t1, 1, idx)[:, 0]
    idx = idx[:, 0].to(torch.int32)
    idx = torch.where(en < INF, idx, torch.full_like(idx, -1))
    return en, ex, idx


def table_nonempty(obj_ids):
    """True when a primitive table has any real (non-sentinel) row. Reads
    one value back from the device, so callers that sweep every bounce
    resolve it ONCE and pass it to ``intersect_scene`` / ``occluded`` as
    ``present`` (the JAX package resolves it at trace time)."""
    return bool((obj_ids >= 0).any())


class Present(NamedTuple):
    """A scene's constants for ``intersect_scene`` / ``occluded``."""

    has_spheres: bool
    has_boxes: bool
    tri_valid: torch.Tensor   # (T,) bool: rows that belong to an object
    tri_blocks: torch.Tensor  # (T,) bool: valid rows whose object carries
                              # no area light (such objects never block)


def tables_present(scene):
    """The scene's ``Present``, resolved once per scene by the integrator
    factories. The triangle masks are made here, once: the sweep kernels
    build one chunk table per mask tensor they are given."""
    valid = scene.tri_obj >= 0
    blocks = valid & (scene.obj_light[_ix(scene.tri_obj)] < 0)
    return Present(table_nonempty(scene.sph_obj), table_nonempty(scene.box_obj),
                   valid, blocks)


def _ix(i):
    """Possibly-negative int32 rows -> clamped int64 gather indices."""
    return torch.clamp(i, min=0).to(torch.int64)


def intersect_scene(scene, rays: Rays, tri_fn=None, present=None) -> Hit:
    """Nearest hit across all primitive tables, with full surface record.

    ``tri_fn`` lets the caller swap the triangle sweep implementation
    (``tri_fn(rays, v0, e1, e2, valid) -> (t, idx, u, v)``); the winner's
    packed record is then read as ``tri_rec[idx]``. The default is the
    record sweep ``kernels.sweep_nearest_rec``: the CUDA kernel for tensors
    on the card, its plain version on the CPU. ``present`` is
    ``tables_present(scene)`` resolved by the caller (None = resolve here).
    """
    o, d = rays.o, rays.d
    n = o.shape[0]
    dev = o.device
    if present is None:
        present = tables_present(scene)
    has_sph, has_box, tri_valid, _ = present
    if tri_fn is None:
        tt, ti, tu, tv, rec = kernels.sweep_nearest_rec(
            o.contiguous(), d.contiguous(), scene.tri_v0, scene.tri_e1, scene.tri_e2, tri_valid,
            scene.tri_rec,
        )
    else:
        tt, ti, tu, tv = tri_fn(
            rays, scene.tri_v0, scene.tri_e1, scene.tri_e2, tri_valid
        )
        rec = take_rows(scene.tri_rec, _ix(ti))
    if has_sph:
        st, si = intersect_spheres(
            rays, scene.sph_center, scene.sph_radius, scene.sph_obj >= 0
        )
    else:
        st = torch.full((n,), INF, device=dev)
        si = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if has_box:
        b0, b1, bi = intersect_boxes(
            rays, scene.box_min, scene.box_max, scene.box_obj >= 0
        )
    else:
        b0 = torch.full((n,), INF, device=dev)
        b1 = torch.full((n,), INF, device=dev)
        bi = torch.full((n,), -1, dtype=torch.int32, device=dev)

    # winner: 0 = triangle, 1 = sphere, 2 = box
    t_all = torch.stack([tt, st, b0], dim=1)
    kind = torch.argmin(t_all, dim=1)
    t = torch.amin(t_all, dim=1)
    hit = t < INF

    i32 = torch.int32
    neg1 = torch.full((n,), -1, dtype=i32, device=dev)
    inf = torch.full((n,), INF, device=dev)

    # triangle surface record (reference: Src/primitive.cpp:96-110) — from
    # the packed (T, 32) record (fetched in-kernel on the card)
    te1 = rec[:, 18:21]
    te2 = rec[:, 21:24]
    w = (1.0 - tu - tv)[:, None]
    tri_ng = normalize(cross(te1, te2))
    # deliberate fix vs. the reference: barycentric-interpolated normals are
    # re-normalized (Src/primitive.cpp:107 leaves them non-unit, which skews
    # the ONB for smooth meshes; all reference scenes use flat normals).
    tri_ns_raw = (
        w * rec[:, 0:3]
        + tu[:, None] * rec[:, 3:6]
        + tv[:, None] * rec[:, 6:9]
    )
    tri_ns = normalize(tri_ns_raw, eps=1e-20)
    tri_uv = (
        w * rec[:, 9:11]
        + tu[:, None] * rec[:, 11:13]
        + tv[:, None] * rec[:, 13:15]
    )
    tri_obj = torch.where(ti >= 0, rec[:, 24].to(i32), neg1)
    tri_light = rec[:, 25].to(i32)
    tri_medium = rec[:, 26].to(i32)
    tri_mtype = rec[:, 27].to(i32)
    tri_ior = rec[:, 28]
    tri_albedo = rec[:, 29:32]

    # sphere surface record (reference: Src/primitive.h:113-123)
    six = _ix(si)
    sc = scene.sph_center[six]
    sphere_pos = rays.at(st)
    sph_ng = normalize(sphere_pos - sc)
    sph_uv = torch.stack(
        [
            (1.0 + torch.atan2(sph_ng[:, 2], sph_ng[:, 0]) / torch.pi) * 0.5,
            torch.acos(torch.clamp(sph_ng[:, 1], -1.0, 1.0)) / torch.pi,
        ],
        dim=-1,
    )
    sph_obj = torch.where(si >= 0, scene.sph_obj[six], neg1)
    sph_oix = _ix(sph_obj)
    sph_light = torch.where(sph_obj >= 0, scene.obj_light[sph_oix], neg1)
    sph_medium = torch.where(sph_obj >= 0, scene.obj_medium[sph_oix], neg1)
    sph_mat = scene.obj_mat[sph_oix]
    sph_mix = _ix(sph_mat)
    sph_mtype = torch.where(
        (sph_obj >= 0) & (sph_mat >= 0), scene.mat_type[sph_mix], neg1
    )
    sph_ior = scene.mat_ior[sph_mix]
    sph_albedo = take_rows(scene.mat_albedo, sph_mix)

    # box record: t/t1 only, no surface (reference: Src/primitive.h:256-259)
    bix = _ix(bi)
    box_obj = torch.where(bi >= 0, scene.box_obj[bix], neg1)
    box_oix = _ix(box_obj)
    box_light = torch.where(box_obj >= 0, scene.obj_light[box_oix], neg1)
    box_medium = torch.where(box_obj >= 0, scene.obj_medium[box_oix], neg1)

    is_tri = (kind == 0) & hit
    is_sph = (kind == 1) & hit
    is_box = (kind == 2) & hit

    def pick_i(a_tri, a_sph, a_box):
        return torch.where(
            is_tri, a_tri,
            torch.where(is_sph, a_sph, torch.where(is_box, a_box, neg1)),
        )

    obj = pick_i(tri_obj, sph_obj, box_obj)
    light = pick_i(tri_light, sph_light, box_light)
    medium = pick_i(tri_medium, sph_medium, box_medium)
    mtype = torch.where(is_tri, tri_mtype, torch.where(is_sph, sph_mtype, neg1))
    ior = torch.where(
        is_tri, tri_ior, torch.where(is_sph, sph_ior, torch.ones_like(tri_ior))
    )
    z3 = torch.zeros((n, 3), device=dev)
    z2 = torch.zeros((n, 2), device=dev)
    tri_m = is_tri[:, None]
    sph_m = is_sph[:, None]
    albedo = torch.where(tri_m, tri_albedo, torch.where(sph_m, sph_albedo, z3))
    t = torch.where(obj >= 0, t, inf)
    t1 = torch.where(is_box, b1, inf)

    position = rays.at(torch.where(obj >= 0, t, torch.zeros_like(t)))
    ng = torch.where(tri_m, tri_ng, torch.where(sph_m, sph_ng, z3))
    ns = torch.where(tri_m, tri_ns, torch.where(sph_m, sph_ng, z3))
    uv = torch.where(tri_m, tri_uv, torch.where(sph_m, sph_uv, z2))
    # frame from the shading normal (reference: Src/primitive.cpp:107-108);
    # guard the miss/box lanes so ONB math stays finite.
    surf = tri_m | sph_m
    up = torch.tensor([0.0, 1.0, 0.0], device=dev).expand(n, 3)
    dpdu, dpdv = orthonormal_basis(torch.where(surf, ns, up))
    dpdu = torch.where(surf, dpdu, z3)
    dpdv = torch.where(surf, dpdv, z3)

    return Hit(
        t=t,
        t1=t1,
        obj=obj,
        position=position,
        ng=ng,
        ns=ns,
        dpdu=dpdu,
        dpdv=dpdv,
        uv=uv,
        bary=torch.stack([tu, tv], dim=-1) * tri_m,
        light=light,
        medium=medium,
        mtype=mtype,
        ior=ior,
        albedo=albedo,
    )


def occluded(scene, rays: Rays, t_max, tri_fn=None, present=None):
    """Shadow-ray test: any blocking hit with t < t_max.

    Mirrors Src/scene.cpp:202-211: objects carrying an area light never
    block. Medium boxes never block (deliberate fix, see module docstring).
    Returns (N,) bool. With ``tri_fn=None`` the triangle part is the boolean
    any-hit sweep ``kernels.occluded_anyhit`` (CUDA kernel on the card, its
    plain version on the CPU); so it is with a ``tri_fn`` that carries
    ``detached_ok = True`` (the gradient pipelines' sweep, diff.py):
    visibility is a detached boolean in every estimator, so the shadow rays
    go in detached and the kernel needs no gradient rule. Any other given
    ``tri_fn`` is swept over the blocking mask and its nearest t compared
    with ``t_max``. ``present`` as for ``intersect_scene``.
    """
    if present is None:
        present = tables_present(scene)
    has_sph, _, _, tri_blocks = present
    if tri_fn is None or getattr(tri_fn, "detached_ok", False):
        n = rays.o.shape[0]
        t_max = torch.as_tensor(
            t_max, dtype=torch.float32, device=rays.o.device
        ).detach().expand(n)
        blocked = kernels.occluded_anyhit(
            rays.o.detach().contiguous(), rays.d.detach().contiguous(),
            scene.tri_v0, scene.tri_e1, scene.tri_e2,
            tri_blocks, t_max.contiguous(),
        )
    else:
        tt, _, _, _ = tri_fn(
            rays, scene.tri_v0, scene.tri_e1, scene.tri_e2, tri_blocks
        )
        blocked = tt < t_max

    if has_sph:
        sph_light = scene.obj_light[_ix(scene.sph_obj)]
        sph_blocks = (scene.sph_obj >= 0) & (sph_light < 0)
        st, _ = intersect_spheres(
            rays, scene.sph_center, scene.sph_radius, sph_blocks
        )
        blocked = blocked | (st < t_max)

    return blocked
