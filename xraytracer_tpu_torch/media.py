"""Participating media: free-flight sampling, tracking loops, transmittance.

PyTorch counterpart of ``xraytracer_tpu/media.py`` and of the reference's
``Medium`` hierarchy (reference: Src/medium.h:71-387, Src/medium.cpp). The
reference's unbounded per-ray ``while(true)`` delta-/ratio-tracking loops
(Src/medium.cpp:56, Src/medium.h:335,369) become one wavefront loop on the
host with per-lane active masks and a hard ``max_steps`` bound (SURVEY.md §7
"hard parts"): the loop ends early when every lane has resolved, and lanes
that would exceed the bound are terminated with throughput 0 (counted, never
silently biased high).

Spectral MIS follows the reference (Pixar memo 17-07 channel selection,
Src/medium.h:97-115): a channel is picked proportional to
throughput * albedo, and the single-sample MIS weight sums the pdf over
channels.

The heterogeneous tracking loops here are also the plain versions of the
CUDA tracking kernels (``media_kernels.py``, ``csrc/media.cuh``). Wherever a
discrete decision (escape, scatter-or-null, channel pick, DDA step) hangs on
a sum, the ORDER of its additions is written out below and the kernels
follow it term by term; the comments marked "order:" say which.

Gradients (``differentiable=True``): the tracking loops are Python loops of
out-of-place tensor operations, so ``torch.autograd`` differentiates them
w.r.t. ``med_sigma_a`` / ``med_sigma_s`` / ``grid_density`` directly; the
discrete decisions enter only through boolean masks and are detached. A
differentiable lookup reads the dense ``grid_density`` (the corner table
``grid_packed`` is a build-time copy that a live grid would leave stale).
The loops still stop when no lane is active: the same values and
gradients as the reference's fixed-trip loop, with a shorter tape.
``score_terms=True`` adds ``_score_ratio`` factors for the sampled
decisions (see there). Every clamp a gradient passes through is
``torch.maximum`` (derivative 1/2 at a tie, as JAX's), never
``torch.clamp`` (1).
"""

from typing import NamedTuple

import numpy as np
import torch

from .constants import RAY_EPS
from .geometry.types import Rays
from .math import dot, take_rows
from .sampling import (
    hg_phase,
    hg_sample_direction,
    sample_channel,
    uniform1,
    uniform2,
)
from .scene.tables import (
    MED_HETEROGENEOUS,
    MED_HOMOG_ACHROMATIC,
    MED_HOMOG_MIS,
)

# Random sites consumed per tracking-loop iteration (wavelength, distance,
# event, phase-direction pair). Integrators reserve
# ``max_steps * SITES_PER_STEP`` sites for each sampleMedium call.
SITES_PER_STEP = 4

class MediumSample(NamedTuple):
    """Result of one ``sampleMedium`` over the wavefront."""

    pos: torch.Tensor        # (N, 3) new ray origin
    dir: torch.Tensor        # (N, 3) new ray direction
    weight: torch.Tensor     # (N, 3) throughput multiplier
    scattered: torch.Tensor  # (N,) bool — real in-scatter event


def _ix(i):
    return torch.clamp(i, min=0).to(torch.int64)


def gather_medium(scene, med_idx):
    """Medium-table row gather with -1 guarded to row 0 (``take_rows``: every
    lane reads one of a few rows, whose gradient is then a scatter-add)."""
    m = _ix(med_idx)
    return dict(
        mtype=torch.where(
            med_idx >= 0, scene.med_type[m], torch.full_like(scene.med_type[m], -1)
        ),
        g=take_rows(scene.med_g, m),
        sigma_a=take_rows(scene.med_sigma_a, m),
        sigma_s=take_rows(scene.med_sigma_s, m),
        majorant=take_rows(scene.med_majorant, m),
        density_mult=take_rows(scene.med_density_mult, m),
    )


def _grid_res(scene):
    g = scene.grid_density
    return torch.tensor(
        [float(s) for s in g.shape], dtype=torch.float32, device=g.device
    )


def _grid_coords(scene, p):
    res = _grid_res(scene)
    ext = scene.grid_max - scene.grid_min
    # voxel centers span the bounds: continuous index in [0, res-1]
    x = (p - scene.grid_min[None, :]) / ext[None, :] * (res[None, :] - 1.0)
    inside = torch.all(
        (p >= scene.grid_min[None, :]) & (p <= scene.grid_max[None, :]), dim=-1
    )
    x = torch.minimum(torch.clamp(x, min=0.0), res[None, :] - 1.0)
    x0 = torch.floor(x)
    return x0.to(torch.int32), x - x0, inside


def density_lookup(scene, p, use_packed=True):
    """World-space trilinear density (reference: Src/grid.h:71-77, the
    OpenVDB ``BoxSampler`` world lookup; outside the bounds the VDB
    background value 0 applies). ``p``: (N, 3) -> (N,) density.

    ``use_packed``: one row of the corner-packed (Nx*Ny*Nz, 8) table instead
    of eight gathers from ``grid_density``; both hold the same corner
    values. Corner d = dx*4 + dy*2 + dz has weight (wx[dx] * wy[dy]) * wz[dz].
    The dense gathers go through ``take_rows`` on the flat grid, so the
    gradient w.r.t. ``grid_density`` is a scatter-add of the eight weights.

    order: the eight products corner * weight are added one after the other
    for d = 0, 1, ..., 7, starting from the first product."""
    g = scene.grid_density
    nx, ny, nz = g.shape
    i0, f, inside = _grid_coords(scene, p)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    wx = (1.0 - fx, fx)
    wy = (1.0 - fy, fy)
    wz = (1.0 - fz, fz)
    # grids past the scene builder's packing gate ship a 1-row sentinel: take the
    # eight corners from the dense grid for them
    if use_packed and scene.grid_packed.shape[0] != g.numel():
        use_packed = False
    i0 = i0.to(torch.int64)
    if use_packed:
        flat = (i0[:, 0] * ny + i0[:, 1]) * nz + i0[:, 2]
        corners = scene.grid_packed[flat]                # (N, 8)
        cs = [corners[:, d] for d in range(8)]
    else:
        lim = torch.tensor([nx - 1, ny - 1, nz - 1], device=g.device)
        i1 = torch.minimum(i0 + 1, lim[None, :])
        flat_g = g.reshape(-1)
        cs = []
        for d in range(8):
            ix = i1[:, 0] if (d >> 2) & 1 else i0[:, 0]
            iy = i1[:, 1] if (d >> 1) & 1 else i0[:, 1]
            iz = i1[:, 2] if d & 1 else i0[:, 2]
            cs.append(take_rows(flat_g, (ix * ny + iy) * nz + iz))
    val = None
    for d in range(8):
        w = (wx[(d >> 2) & 1] * wy[(d >> 1) & 1]) * wz[d & 1]
        term = cs[d] * w
        val = term if val is None else val + term
    return torch.where(inside, val, torch.zeros_like(val))


def _free_flight(u, sigma):
    """t = -ln(max(1-u, 0)) / sigma (reference: Src/medium.h:168-169)."""
    return -torch.log(torch.clamp(1.0 - u, min=1e-38)) / sigma


# --- piecewise-majorant (supergrid) tracking ------------------------------
#
# Tracking with one global majorant pays a fine density lookup per null
# collision, and sparse grids make most steps null collisions in empty
# space. Instead:
#
#  1. Walk each lane's ray through a <= 8^3 block-max supergrid with a
#     fixed-length DDA, producing per-lane piecewise-constant majorant
#     segments.
#  2. Track in OPTICAL-DEPTH space: candidate collisions are unit-rate
#     exponential arrivals in tau = ∫majorant; block crossings disappear
#     into a running sum + a piecewise inversion.
#  3. Only genuine collision candidates pay the fine trilinear lookup, and
#     their expected count is ∫(local majorant) — far below
#     global_majorant * path_length for sparse media.
#
# For a single-block supergrid this reproduces the global-majorant
# algorithm draw-for-draw (t = t0 + tau/m is the same free-flight mapping).

_DDA_SEGMENTS = 24  # >= nbx+nby+nbz - 2 (<= 22 for 8^3 blocks) + margin


def _super_lookup(scene, b):
    """Supergrid block max for (N, 3) integer block coords: a plain index
    into the flat x-major table."""
    nb = scene.grid_super_nb.to(torch.int64)
    b = b.to(torch.int64)
    return scene.grid_super[(b[:, 0] * nb[1] + b[:, 1]) * nb[2] + b[:, 2]]


def _majorant_segments(scene, med, rays, t0, t1):
    """Per-lane piecewise-constant majorant over [t0, t1].

    Returns (seg_t, seg_m, tau_edges): segment start times (N, K+1), local
    majorants (N, K+1) and cumulative optical depth at segment starts plus
    the final edge (N, K+2), where K = _DDA_SEGMENTS and segment K is a
    global-majorant tail that covers any remainder if the fixed walk ran
    out (a true upper bound is preserved in all cases).

    order: ``tau_edges`` is a left-to-right running sum (no ``cumsum``: a
    scan tree rounds differently, ~1e-4 at tau ~ 10, which would desync the
    kernels from this version)."""
    bs = scene.grid_super_bsize
    res = _grid_res(scene)
    ext = scene.grid_max - scene.grid_min
    scale = (res - 1.0) / torch.where(ext == 0.0, torch.ones_like(ext), ext)
    a = (rays.o - scene.grid_min[None, :]) * scale[None, :]   # index space
    v = rays.d * scale[None, :]
    # the majorants are a sampling choice (any upper bound keeps the
    # estimators unbiased) and are held fixed under differentiation, as
    # the majorant tables are: detached, so that no tracked point moves
    # with sigma. The JAX package differentiates through them, and its
    # d/d sigma is then NaN with next-event estimation (square roots of 0
    # in the light sample at moved points)
    sigma_t_max = torch.amax(med["sigma_a"] + med["sigma_s"], dim=-1).detach()
    dm = med["density_mult"].detach()

    zero = torch.zeros_like(t0)
    t0f = torch.where(torch.isfinite(t0), t0, zero)
    t1f = torch.where(torch.isfinite(t1), torch.maximum(t1, t0f), t0f)

    nbf = scene.grid_super_nb.to(torch.float32)
    # Integer-walk DDA: the block index advances along the exiting axis
    # (first-min tie-break: x, then y, then z), so the majorant SEQUENCE is a
    # function of integer state — robust to 1-ulp differences between this
    # version and the kernels, and never stalling on block boundaries.
    x0 = a + t0f[:, None] * v
    b = torch.minimum(
        torch.clamp(torch.floor(x0 / bs[None, :]), min=0.0), nbf[None, :] - 1.0
    )
    sgn = torch.where(v >= 0.0, torch.ones_like(v), -torch.ones_like(v))
    inf = torch.full_like(v, float("inf"))
    v_safe = torch.where(torch.abs(v) < 1e-20, torch.full_like(v, 1e-20), v)
    seg_t = []
    seg_m = []
    t_cur = t0f
    for _ in range(_DDA_SEGMENTS):
        dens_max = _super_lookup(scene, b.to(torch.int32))
        m_loc = dens_max * dm * sigma_t_max
        # exit time of the current block along each axis
        lo = b * bs[None, :]
        hi = (b + 1.0) * bs[None, :]
        t_exit_ax = torch.where(
            v > 1e-20, (hi - a) / v_safe,
            torch.where(v < -1e-20, (lo - a) / v_safe, inf),
        )
        ex, ey, ez = t_exit_ax[:, 0], t_exit_ax[:, 1], t_exit_ax[:, 2]
        t_hi = torch.minimum(torch.minimum(ex, ey), ez)
        step_x = (ex <= ey) & (ex <= ez)        # argmin, first-min ties
        step_y = ~step_x & (ey <= ez)
        step_z = ~step_x & ~step_y
        step = torch.stack([step_x, step_y, step_z], dim=-1)
        seg_t.append(t_cur)
        seg_m.append(torch.where(t_cur < t1f, m_loc, zero))
        b = torch.minimum(
            torch.clamp(b + step * sgn, min=0.0), nbf[None, :] - 1.0
        )
        t_cur = torch.minimum(torch.maximum(t_hi, t_cur), t1f)
    # tail segment: global majorant over any remainder (the walk ran out)
    t_tail = torch.minimum(t_cur, t1f)
    seg_t.append(t_tail)
    seg_m.append(torch.where(t_tail < t1f, med["majorant"], zero))

    seg_t = torch.stack(seg_t, dim=1)                    # (N, K+1)
    seg_m = torch.stack(seg_m, dim=1)
    ends = torch.cat([seg_t[:, 1:], t1f[:, None]], dim=1)
    seg_len = torch.clamp(ends - seg_t, min=0.0)
    dtau = seg_m * seg_len
    edges = [zero]
    for k in range(dtau.shape[1]):
        edges.append(edges[-1] + dtau[:, k])
    tau_edges = torch.stack(edges, dim=1)                # (N, K+2)
    return seg_t, seg_m, tau_edges


def _tau_to_t(seg_t, seg_m, tau_edges, tau):
    """Invert the piecewise-linear tau(t): (N,) tau -> (t, m_loc)."""
    k = torch.sum((tau_edges[:, :-1] <= tau[:, None]).to(torch.int64), dim=1) - 1
    k = torch.clamp(k, 0, seg_m.shape[1] - 1)[:, None]
    m_loc = torch.gather(seg_m, 1, k)[:, 0]
    t_k = torch.gather(seg_t, 1, k)[:, 0]
    tau_k = torch.gather(tau_edges, 1, k)[:, 0]
    t = t_k + (tau - tau_k) / torch.where(m_loc <= 0.0, torch.ones_like(m_loc), m_loc)
    return t, m_loc


def _analytic_tr(t, sigma):
    """exp(-sigma t) (reference: Src/medium.h:92-95)."""
    return torch.exp(-sigma * t[..., None])


def _sum3(x):
    """order: (x0 + x1) + x2 over the channel axis, keeping the axis."""
    return ((x[..., 0] + x[..., 1]) + x[..., 2])[..., None]


def _safe(x):
    return torch.where(x == 0.0, torch.ones_like(x), x)


def _sample_homogeneous(med, rays, t0, t1, path_throughput, keys, site):
    """All three homogeneous variants, branch-free (reference:
    Src/medium.h:148-277). Free flight is measured from the box ENTRY point
    ``t0`` — the segment before the box is vacuum (Src/medium.h:183,225,270).
    """
    sigma_t = med["sigma_a"] + med["sigma_s"]
    sigma_s = med["sigma_s"]
    mtype = med["mtype"]

    u_wl = uniform1(keys, site + 0)
    u_dist = uniform1(keys, site + 1)
    u_phase = uniform2(keys, site + 2)

    # channel selection per variant
    albedo = sigma_s / _safe(sigma_t)
    ch_mis, pmf_mis = sample_channel(path_throughput * albedo, u_wl)
    ch_nomis = torch.clamp((3.0 * u_wl).to(torch.int32), max=2)
    is_mis = mtype == MED_HOMOG_MIS
    is_achro = mtype == MED_HOMOG_ACHROMATIC
    channel = torch.where(
        is_mis, ch_mis, torch.where(is_achro, torch.zeros_like(ch_mis), ch_nomis)
    )
    pmf = torch.where(
        is_mis[:, None], pmf_mis, torch.full_like(pmf_mis, 1.0 / 3.0)
    )

    sig_c = torch.gather(sigma_t, 1, channel.to(torch.int64)[:, None])[:, 0]
    sig_c = _safe(sig_c)
    t = _free_flight(u_dist, sig_c)
    dist = t1 - t0
    escaped = t > dist - RAY_EPS

    # escape weight (single-sample MIS over channels; achromatic = 1)
    tr_d = _analytic_tr(dist, sigma_t)
    pdf_esc = _sum3(pmf * tr_d)
    w_esc = tr_d / _safe(pdf_esc)
    w_esc = torch.where(is_achro[:, None], torch.ones_like(w_esc), w_esc)

    # scatter weight
    tr_t = _analytic_tr(t, sigma_t)
    pdf_sc = _sum3(pmf * sigma_t * tr_t)
    w_sc = tr_t * sigma_s / _safe(pdf_sc)
    w_sc = torch.where(is_achro[:, None], albedo, w_sc)

    new_dir, _ = hg_sample_direction(rays.d, u_phase[:, 0], u_phase[:, 1], med["g"])

    pos = torch.where(
        escaped[:, None], rays.at(t1 + RAY_EPS), rays.at(t0 + t)
    )
    d = torch.where(escaped[:, None], rays.d, new_dir)
    weight = torch.where(escaped[:, None], w_esc, w_sc)
    return MediumSample(pos=pos, dir=d, weight=weight, scattered=~escaped)


def _pick_channel(w, u):
    """``sampling.sample_channel`` on a tuple of three (N,) weights: pmf
    proportional to the weights with a uniform fallback on a zero sum;
    lower_bound with the x == 0 bump. Returns (channel (N,) int64, pmf
    tuple). order: s = (w0 + w1) + w2, c2 = pmf0 + pmf1."""
    s = (w[0] + w[1]) + w[2]
    pos = s > 0.0
    sg = _safe(s)
    third = torch.full_like(s, 1.0 / 3.0)
    pmf = tuple(torch.where(pos, wc / sg, third) for wc in w)
    c1 = pmf[0]
    c2 = pmf[0] + pmf[1]
    x = (0.0 < u).to(torch.int64) + (c1 < u).to(torch.int64) + (c2 < u).to(torch.int64)
    return torch.clamp(x, min=1) - 1, pmf


def _by_channel(channel, v):
    return torch.where(channel == 0, v[0], torch.where(channel == 1, v[1], v[2]))


def _score_ratio(p, p_min=1e-5):
    """``p / p.detach()`` with guards: value exactly 1, gradient the score
    term ∂log p. Multiplying a path weight by this for every SAMPLED
    discrete event whose probability depends on the differentiated
    parameters turns the detached-sampling gradient into the full
    score-corrected estimator d/dθ E[F] = E[dF + F·∂log p]; the forward value
    is untouched, and later contributions inherit the factor through the
    throughput product. Events with probability at most ``p_min`` carry no
    score (∂p/p explodes as p -> 0 when a near-impossible branch is drawn):
    the clipped estimator's bias is O(p_min), its variance bounded."""
    ps = p.detach()
    safe = ps > p_min
    one = torch.ones_like(ps)
    return torch.where(safe, p, one) / torch.where(safe, ps, one)


def _track_sample(
    scene, med, rays, t0, t1, path_throughput, keys, site, max_steps,
    het_mask=None, chan_uniform=False, candidates=None,
    differentiable=False, score_terms=False,
):
    """The tracking loop of ``_sample_heterogeneous``: weighted delta
    tracking over COLLISION CANDIDATES in optical-depth space. Returns what
    the tracking kernel returns: ``t`` (N,) where the lane stopped (the
    scatter point, or ``t1 + RAY_EPS`` after an escape), ``weight`` (N, 3),
    ``scattered`` (N,) bool and ``scat_step`` (N,) int64, the loop step of
    the scatter (0 where none). A list passed as ``candidates`` receives
    the number of active lanes at each step (the work this call did).

    Per-channel values are kept as tuples of (N,) tensors, and every sum
    that feeds a decision is written left to right; ``csrc/media.cuh``
    follows these lines. ``differentiable`` reads the dense grid;
    ``score_terms`` multiplies the weights by the score ratios of the
    channel pick and of the scatter-or-null split (``_score_ratio``); the
    distance draws and the escape are sampled from the majorant tables,
    which hold no parameter, and carry none."""
    n = rays.o.shape[0]
    dev = rays.o.device
    dm = med["density_mult"]
    sa = tuple(med["sigma_a"][:, c] for c in range(3))
    ss = tuple(med["sigma_s"][:, c] for c in range(3))
    tp = tuple(path_throughput[:, c] for c in range(3))

    seg_t, seg_m, tau_edges = _majorant_segments(scene, med, rays, t0, t1)
    tau_total = tau_edges[:, -1] - RAY_EPS * med["majorant"]  # t1 - RAY_EPS

    # initial sigma_a at the entry point, for the first channel pick
    # (Src/medium.cpp:52-54)
    use_packed = not differentiable
    dens0 = density_lookup(scene, rays.at(t0), use_packed=use_packed) * dm
    sig_a = tuple(sa[c] * dens0 for c in range(3))
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    _, m_entry = _tau_to_t(seg_t, seg_m, tau_edges, zero)
    m_prev = torch.maximum(m_entry, zero)

    # lanes outside the heterogeneous medium (masked out by the caller) must
    # not drive the loop: a surface-hit lane carries t1 = INF (finite!),
    # whose tail segment would otherwise null-scatter to max_steps
    active = (
        torch.ones((n,), dtype=torch.bool, device=dev) if het_mask is None
        else het_mask.clone()
    )
    tau = zero
    w = (torch.ones_like(zero),) * 3
    t_res = t1 + RAY_EPS     # default: pass through (overwritten when done)
    scat_step = torch.zeros((n,), dtype=torch.int64, device=dev)
    scattered = torch.zeros((n,), dtype=torch.bool, device=dev)

    step = 0
    while step < max_steps:
        n_active = int(active.sum())
        if n_active == 0:
            break
        if candidates is not None:
            candidates.append(n_active)
        s_base = site + step * SITES_PER_STEP
        u_wl = uniform1(keys, s_base + 0)
        u_dist = uniform1(keys, s_base + 1)
        u_ev = uniform1(keys, s_base + 2)

        # channel-pick weights: single-scatter albedo proxy vs the LOCAL
        # majorant (reference uses the global one, Src/medium.cpp:58-60);
        # clamped >= 0 for stale-majorant safety — the pick pmf is always
        # accounted in the pdfs, so any positive weighting stays unbiased.
        # chan_uniform: the reference's noMIS uniform channel pick
        # (Src/medium.h:234-277), used by the gradient-friendly estimator
        if chan_uniform:
            pick_w = (torch.ones_like(zero),) * 3
        else:
            m_prev_s = torch.where(m_prev <= 0.0, torch.ones_like(m_prev), m_prev)
            pick_w = tuple(
                (tp[c] * w[c]) * torch.maximum((m_prev - sig_a[c]) / m_prev_s, zero)
                for c in range(3)
            )
        channel, pmf = _pick_channel(pick_w, u_wl)

        dtau = -torch.log(torch.clamp(1.0 - u_dist, min=1e-38))   # Exp(1) in tau
        tau_new = tau + dtau

        # boundary escape (Src/medium.cpp:70-93); with a scalar majorant the
        # channel-independent exp factors cancel between weight and pdf,
        # leaving w_esc = w_track / sum(pmf) — kept literal for parity.
        # order: pdf_esc = (pmf0 * tr + pmf1 * tr) + pmf2 * tr
        esc = tau_new > tau_total
        tr_esc = torch.exp(-(tau_total - tau))
        pdf_esc = (pmf[0] * tr_esc + pmf[1] * tr_esc) + pmf[2] * tr_esc
        pe = _safe(pdf_esc)

        t_new, m_loc = _tau_to_t(seg_t, seg_m, tau_edges, tau_new)
        m_safe = torch.where(m_loc <= 0.0, torch.ones_like(m_loc), m_loc)
        dens = density_lookup(scene, rays.at(t_new), use_packed=use_packed) * dm
        sig_s = tuple(ss[c] * dens for c in range(3))
        sig_a = tuple(sa[c] * dens for c in range(3))
        # clamped at 0: the supergrid majorant bounds the trilinear field by
        # construction; stale majorants after a grid_density override can
        # undershoot, which must bias (slightly) rather than go negative.
        # order: (m_loc - sig_a) - sig_s
        sig_n = tuple(
            torch.maximum((m_loc - sig_a[c]) - sig_s[c], zero) for c in range(3)
        )
        denom = tuple(_safe(sig_s[c] + sig_n[c]) for c in range(3))
        p_s = tuple(sig_s[c] / denom[c] for c in range(3))
        p_n = tuple(sig_n[c] / denom[c] for c in range(3))
        p_s_c = _by_channel(channel, p_s)

        tr_s = torch.exp(-dtau)
        # in-scatter (Src/medium.cpp:104-124) and null-scatter (:126-131).
        # order: the three channel terms ((pmf * m_safe) * tr_s) * p are
        # added left to right
        base = tuple((pmf[c] * m_safe) * tr_s for c in range(3))
        scat = ~esc & (u_ev < p_s_c)
        a_esc = active & esc
        a_scat = active & scat
        cont = active & ~esc & ~scat
        # each weight is kept only on its own lanes: elsewhere its
        # denominator is set to 1 (a tiny pdf there would make its
        # derivative 0 * inf = NaN in the gradient, values unchanged)
        one = torch.ones_like(pe)
        pe = torch.where(a_esc, pe, one)
        w_esc = tuple(w[c] * tr_esc / pe for c in range(3))
        pdf_sc = (base[0] * p_s[0] + base[1] * p_s[1]) + base[2] * p_s[2]
        ps_safe = torch.where(a_scat, _safe(pdf_sc), one)
        w_scat = tuple((w[c] * tr_s) * sig_s[c] / ps_safe for c in range(3))
        pdf_nl = (base[0] * p_n[0] + base[1] * p_n[1]) + base[2] * p_n[2]
        pn_safe = torch.where(cont, _safe(pdf_nl), one)
        w_null = tuple((w[c] * tr_s) * sig_n[c] / pn_safe for c in range(3))
        if score_terms:
            # the sampled decisions whose probabilities depend on the
            # parameters: the channel pick (pmf of the picked channel, a
            # function of the albedo proxy unless picks are uniform) and the
            # scatter-or-null split (p_s_c resp. 1 - p_s_c, functions of the
            # density); each ratio is exactly 1 in value
            r_pick = _score_ratio(_by_channel(channel, pmf))
            r_scat = r_pick * _score_ratio(p_s_c)
            r_null = r_pick * _score_ratio(1.0 - p_s_c)
            w_esc = tuple(v * r_pick for v in w_esc)
            w_scat = tuple(v * r_scat for v in w_scat)
            w_null = tuple(v * r_null for v in w_null)

        t_res = torch.where(a_esc, t1 + RAY_EPS, t_res)
        t_res = torch.where(a_scat, t_new, t_res)
        # the phase-direction draw is hoisted out of the loop: record the
        # scatter step so the site can be replayed afterwards
        scat_step = torch.where(a_scat, torch.full_like(scat_step, step), scat_step)
        scattered = scattered | a_scat
        w_out = []
        for c in range(3):
            wc = torch.where(a_esc, w_esc[c], w[c])
            wc = torch.where(a_scat, w_scat[c], wc)
            w_out.append(torch.where(cont, w_null[c], wc))
        w = tuple(w_out)
        active = cont
        tau = torch.where(cont, tau_new, tau)
        m_prev = m_loc
        step += 1

    # exhausted lanes: kill with weight 0 (bounded-loop policy)
    weight = torch.stack(w, dim=-1)
    weight = torch.where(active[:, None], torch.zeros_like(weight), weight)
    return t_res, weight, scattered, scat_step


def scatter_direction(rays, keys, site, scat_step, scattered, g):
    """The phase direction, drawn once at the recorded scatter step's site
    (``site + scat_step * SITES_PER_STEP + 3``); ``rays.d`` where the lane
    did not scatter."""
    u_ph = uniform2(keys, site + scat_step * SITES_PER_STEP + 3)
    new_dir, _ = hg_sample_direction(rays.d, u_ph[:, 0], u_ph[:, 1], g)
    return torch.where(scattered[:, None], new_dir, rays.d)


def nan_guard(weight):
    """A weight with any NaN channel becomes 0 (Src/medium.cpp:83-91,113-121)."""
    bad = torch.isnan(weight).any(dim=-1, keepdim=True)
    return torch.where(bad, torch.zeros_like(weight), weight)


def _sample_heterogeneous(
    scene, med, rays, t0, t1, path_throughput, keys, site, max_steps,
    differentiable=False, het_mask=None, score_terms=False,
    chan_uniform=False,
):
    """Weighted delta tracking with spectral MIS (reference:
    Src/medium.cpp:45-133), as a bounded masked loop over COLLISION
    CANDIDATES in optical-depth space with per-lane piecewise block majorants
    (see the supergrid note above ``_majorant_segments``). The reference's
    per-step mechanics (channel pick, escape weight, scatter/null split, NaN
    guards) are preserved with the local majorant in place of the global
    one; for a single-block supergrid the draws are identical to the
    global-majorant algorithm.

    State machine per lane: tracking -> {escaped, scattered, exhausted}.
    Exhausted lanes (step bound hit) get weight 0 — a biased-dark, never
    biased-bright, failure mode; the bound is sized by the caller from
    majorant * bbox diagonal (a valid upper bound on expected candidates,
    loose for sparse grids where the local majorants dominate).
    """
    t_res, weight, scattered, scat_step = _track_sample(
        scene, med, rays, t0, t1, path_throughput, keys, site, max_steps,
        het_mask=het_mask, chan_uniform=chan_uniform,
        differentiable=differentiable, score_terms=score_terms,
    )
    d = scatter_direction(rays, keys, site, scat_step, scattered, med["g"])
    return MediumSample(
        pos=rays.at(t_res), dir=d, weight=nan_guard(weight), scattered=scattered
    )


def sample_medium(
    scene, med_idx, rays, t0, t1, path_throughput, keys, site,
    max_steps=256, has_heterogeneous=True, has_homogeneous=True,
    differentiable=False, het_fn=None, score_terms=False,
    chan_uniform=False,
):
    """Wavefront ``Object::sampleMedium`` dispatch (reference:
    Src/primitive.cpp:63-74 -> Src/medium.h:148-277 / Src/medium.cpp:45-133).

    ``med_idx``: (N,) medium row per lane (-1 = no medium -> pass-through
    with weight 1). The static ``has_*`` flags (from ``scene_statics``) let
    integrators skip the unused branch entirely. ``het_fn``
    (``media_kernels.try_make_fused_het_sampler``) replaces the host-side
    heterogeneous tracking loop with the tracking kernel. ``differentiable``
    and ``score_terms``: see ``_track_sample``; the homogeneous variants are
    closed forms that autograd differentiates as they are.
    """
    med = gather_medium(scene, med_idx)
    n = rays.o.shape[0]
    dev = rays.o.device
    none = MediumSample(
        pos=rays.at(t1 + RAY_EPS),
        dir=rays.d,
        weight=torch.ones((n, 3), dtype=torch.float32, device=dev),
        scattered=torch.zeros((n,), dtype=torch.bool, device=dev),
    )
    parts = [none]
    masks = [med["mtype"] < 0]
    if has_homogeneous:
        # lanes without a homogeneous medium get a zero span: their values
        # are discarded, and an infinite or long span would put
        # exp(-sigma * t)'s 0 * inf = NaN into the gradient of sigma
        hmask = (med["mtype"] >= 0) & (med["mtype"] != MED_HETEROGENEOUS)
        zero = torch.zeros_like(t0)
        parts.append(_sample_homogeneous(
            med, rays, torch.where(hmask, t0, zero), torch.where(hmask, t1, zero),
            path_throughput, keys, site))
        masks.append(hmask)
    if has_heterogeneous:
        het_mask = med["mtype"] == MED_HETEROGENEOUS
        if het_fn is not None:
            parts.append(
                het_fn(rays, t0, t1, path_throughput, keys, site, het_mask)
            )
        else:
            parts.append(
                _sample_heterogeneous(
                    scene, med, rays, t0, t1, path_throughput, keys, site,
                    max_steps, differentiable=differentiable,
                    het_mask=het_mask, score_terms=score_terms,
                    chan_uniform=chan_uniform,
                )
            )
        masks.append(het_mask)

    out = parts[0]
    for p, m in zip(parts[1:], masks[1:]):
        out = MediumSample(
            pos=torch.where(m[:, None], p.pos, out.pos),
            dir=torch.where(m[:, None], p.dir, out.dir),
            weight=torch.where(m[:, None], p.weight, out.weight),
            scattered=torch.where(m, p.scattered, out.scattered),
        )
    return out


def _segment_dir(p1, p2):
    """(dist (N,), unit direction (N, 3)) from p1 to p2; a zero-length
    segment gets direction 0. order: dist^2 = (dx*dx + dy*dy) + dz*dz."""
    dv = p2 - p1
    sq = dv * dv
    dist = torch.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2])
    return dist, dv / _safe(dist)[:, None]


def _track_transmittance(
    scene, med, p1, p2, keys, site, max_steps, het_mask, candidates=None,
    differentiable=False,
):
    """The ratio-tracking loop of ``segment_transmittance``: (N, 3)
    transmittance over collision candidates in optical-depth space with
    piecewise block majorants — unbiased: E[prod(sig_n / m)] over Poisson(m)
    arrivals = exp(-int sigma_t). Lanes outside ``het_mask`` return 1,
    exhausted lanes 0 (never biased bright). ``candidates`` and
    ``differentiable`` as in ``_track_sample``; ratio tracking samples from
    the majorant alone, so it has no score terms."""
    n = p1.shape[0]
    dev = p1.device
    dm = med["density_mult"]
    st = tuple(med["sigma_a"][:, c] + med["sigma_s"][:, c] for c in range(3))
    dist, d = _segment_dir(p1, p2)
    srays = Rays(o=p1, d=d)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    seg_t, seg_m, tau_edges = _majorant_segments(scene, med, srays, zero, dist)
    tau_total = tau_edges[:, -1]

    active = het_mask.clone()
    tau = zero
    tr = (torch.ones_like(zero),) * 3
    step = 0
    while step < max_steps:
        n_active = int(active.sum())
        if n_active == 0:
            break
        if candidates is not None:
            candidates.append(n_active)
        u = uniform1(keys, site + step)
        tau_new = tau - torch.log(torch.clamp(1.0 - u, min=1e-38))
        esc = tau_new > tau_total
        t_new, m_loc = _tau_to_t(seg_t, seg_m, tau_edges, tau_new)
        dens = density_lookup(
            scene, srays.at(t_new), use_packed=not differentiable
        ) * dm
        m_safe = torch.where(m_loc <= 0.0, torch.ones_like(m_loc), m_loc)
        upd = active & ~esc
        tr = tuple(
            torch.where(
                upd,
                (tr[c] * torch.maximum(m_loc - st[c] * dens, zero)) / m_safe,
                tr[c],
            )
            for c in range(3)
        )
        active = upd
        tau = torch.where(upd, tau_new, tau)
        step += 1
    tr_r = torch.stack(tr, dim=-1)
    return torch.where(active[:, None], torch.zeros_like(tr_r), tr_r)


def segment_transmittance(
    scene, med_idx, p1, p2, keys, site, max_steps=256, differentiable=False,
    het_tr_fn=None,
):
    """Transmittance between two points through one medium segment
    (reference: ``Object::sampleTransparency`` -> ``Medium::transmittance``;
    homogeneous = analytic exp(-sigma_t d) Src/medium.h:133-139,
    heterogeneous = ratio tracking Src/medium.h:360-386).

    ``med_idx`` < 0 lanes return 1. ``het_tr_fn``
    (``media_kernels.try_make_fused_het_transmittance``) replaces the
    host-side ratio-tracking loop with the transmittance kernel.
    ``differentiable``: see ``_track_sample``.
    """
    med = gather_medium(scene, med_idx)
    dist, _ = _segment_dir(p1, p2)

    # homogeneous: analytic; lanes without a homogeneous medium (whose
    # values are discarded) take it over 0: an infinite segment (a shadow
    # ray that left no box) would put exp(-sigma * inf)'s 0 * inf = NaN into
    # the gradient of sigma
    sigma_t = med["sigma_a"] + med["sigma_s"]
    is_het = med["mtype"] == MED_HETEROGENEOUS
    homog = (med["mtype"] >= 0) & ~is_het
    tr_h = _analytic_tr(torch.where(homog, dist, torch.zeros_like(dist)), sigma_t)

    if het_tr_fn is not None:
        tr_r = het_tr_fn(p1, p2, keys, site, is_het)
    else:
        tr_r = _track_transmittance(
            scene, med, p1, p2, keys, site, max_steps, is_het,
            differentiable=differentiable,
        )
    tr = torch.where(is_het[:, None], tr_r, tr_h)
    return torch.where((med["mtype"] >= 0)[:, None], tr, torch.ones_like(tr))


def delta_tracking_transmittance(
    scene, med_idx, p1, p2, keys, site, max_steps=256,
):
    """Delta-tracking (binary) transmittance estimator — the reference's
    alternate to ratio tracking (Src/medium.h:321-358): pick a channel
    uniformly, walk majorant free flights, and on a real/absorption
    collision return 0; survivors accumulate the channel-ratio weight.
    Higher variance than ratio tracking but each step is cheaper; provided
    for parity and for variance experiments. ``med_idx`` < 0 lanes return 1.
    """
    med = gather_medium(scene, med_idx)
    n = p1.shape[0]
    dev = p1.device
    dist, d = _segment_dir(p1, p2)
    majorant = med["majorant"]
    inv_maj = 1.0 / _safe(majorant)
    dm = med["density_mult"]
    sigma_t = med["sigma_a"] + med["sigma_s"]
    # uniform channel pick (sampleWavelength with unit weights,
    # Src/medium.h:330-333)
    ch = torch.clamp((3.0 * uniform1(keys, site)).to(torch.int64), max=2)[:, None]

    is_het = med["mtype"] == MED_HETEROGENEOUS
    active = is_het.clone()
    t = torch.zeros((n,), dtype=torch.float32, device=dev)
    tr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    step = 0
    while step < max_steps and bool(active.any()):
        u = uniform1(keys, site + 1 + step * 2)
        t_new = t + _free_flight(u, majorant)
        esc = t_new > dist
        dens = density_lookup(scene, p1 + t_new[:, None] * d) * dm
        sig_n = majorant[:, None] - sigma_t * dens[:, None]
        p_n = sig_n * inv_maj[:, None]
        p_n_c = torch.gather(p_n, 1, ch)[:, 0]
        u_ev = uniform1(keys, site + 2 + step * 2)
        collide = active & ~esc & (u_ev > p_n_c)
        sig_n_c = torch.gather(sig_n, 1, ch)[:, 0]
        ratio = sig_n / _safe(sig_n_c)[:, None]
        tr = torch.where((active & ~esc & ~collide)[:, None], tr * ratio, tr)
        tr = torch.where(collide[:, None], torch.zeros_like(tr), tr)
        active = active & ~esc & ~collide
        t = torch.where(active, t_new, t)
        step += 1
    tr_r = torch.where(active[:, None], torch.zeros_like(tr), tr)

    tr_h = _analytic_tr(dist, sigma_t)
    out = torch.where(is_het[:, None], tr_r, tr_h)
    return torch.where((med["mtype"] >= 0)[:, None], out, torch.ones_like(out))


def eval_phase(scene, med_idx, wo, wi):
    """HG phase value between world directions (reference:
    Src/medium.h:86-90, 29-34). ``wo`` = current ray direction."""
    med = gather_medium(scene, med_idx)
    return hg_phase(dot(wo, wi), med["g"])[:, None].expand(-1, 3)


def default_max_steps(tables, safety=3.0, floor=64, cap=4096):
    """Principled tracking-step bound: majorant * grid-bbox diagonal is the
    expected null-collision step count to cross the whole volume, so
    ``safety`` times that (plus slack) makes bound-truncation (which biases
    dark) astronomically unlikely (SURVEY.md §7 "hard parts"). Host-side,
    from concrete tables."""
    med_type = tables.med_type.cpu().numpy()
    het = med_type == MED_HETEROGENEOUS
    if not het.any():
        return floor
    maj = float(tables.med_majorant.cpu().numpy()[het].max())
    diag = float(
        np.linalg.norm(
            tables.grid_max.cpu().numpy() - tables.grid_min.cpu().numpy()
        )
    )
    return int(min(cap, max(floor, safety * maj * diag + 32)))
