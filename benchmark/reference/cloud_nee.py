"""Plain reference of volumetric path tracing, with or without next-event
estimation, in a heterogeneous cloud under sphere lights.

The estimators of the reference renderer's ``VolumePathTracingNEE``
(Src/integrator.h:481-636) and ``VolumePathTracing`` (:401-478) over a
dense density grid, written from their equations and run on a batch of
lanes, one lane a (pixel, sample) path:

* the cloud's box is the grid's bounds; the density is the trilinear value
  of the grid with voxel centres on the bounds and 0 outside
  (Src/grid.h:71-77);
* free flights are sampled by weighted delta tracking with spectral MIS
  (Src/medium.cpp:45-133), in optical depth over piecewise-constant
  majorants: an <= 8^3 block-max supergrid whose block b bounds the corners
  ``[floor(b B), min(ceil((b + 1) B), n - 1)]`` (B = (n - 1) / blocks), walked
  by an integer DDA for 24 blocks with the global majorant as the tail;
  channel pick ``pmf ~ throughput * weight * max((m - sigma_a) / m, 0)``;
  escape, in-scatter and null weights as in Src/medium.cpp;
* a path iteration: roulette from depth 1, an emitter adds Le (with NEE at
  depth 0 only, without at every depth), the medium tracks, a scatter vertex
  does NEE where the estimator has it (a uniform light pick, PBRT's cone
  sample of the sphere, Src/light.h:160-198, the transmittance by ratio
  tracking over the same majorants) and draws an HG direction;
  ``2 max_depth + 2`` iterations, depth counting scatters only;
* random draws per iteration ``i`` at site ``i * 2^16 + k``: roulette k = 0,
  tracking step j at k = 16 + 4j (+0 channel, +1 distance, +2 event, +3 the
  phase direction of the step that scattered), the light pick at
  k = P = max(8192, 16 + 4 max_steps), the cone sample at P + 1 and the
  ratio tracking's step j at P + 16 + j (without NEE these sites are not
  drawn, and every other site is the same);
* ``max_steps = min(4096, max(64, 3 majorant |bbox diagonal| + 32))``;
  a lane that runs out of steps ends with weight 0;
* a sample with a NaN, Inf or negative channel counts 0.

Every derived quantity (supergrid, majorants, step bound) is worked out
here from the grid the benchmark made; nothing of the program is imported.
"""

import numpy as np
import torch

from .common import (
    MASK, PI, RAY_EPS, SITES_PER_BOUNCE, camera_rays, dot, lane_blocks,
    normalize, onb, path_keys, sum_per_pixel, u1, u2,
)

DDA_SEGMENTS = 24
SITE_MEDIUM = 16
SITES_PER_STEP = 4
LANE_BLOCK = 1 << 20

# ``render.integrator``: whether the estimator it names does NEE
NEE = {"vpt_nee": True, "vpt": False}


def score_ratio(p, p_min=1e-5):
    """``p / p.detach()``, 1 in value and d log p in gradient, for a
    sampled event of probability above ``p_min`` (1 otherwise)."""
    ps = p.detach()
    safe = ps > p_min
    one = torch.ones_like(ps)
    return torch.where(safe, p, one) / torch.where(safe, ps, one)


def supergrid(grid):
    """(blocks per axis, block size in index units, block maxima)."""
    n = np.asarray(grid.shape, np.int64)
    nb = np.minimum(np.maximum(n - 1, 1), 8)
    bs = (np.maximum(n.astype(np.float32) - 1.0, 1.0) / nb).astype(np.float32)
    sg = np.zeros(tuple(nb), np.float32)
    for bx in range(nb[0]):
        for by in range(nb[1]):
            for bz in range(nb[2]):
                lo = [int(np.floor(b * s)) for b, s in zip((bx, by, bz), bs)]
                hi = [min(int(np.ceil((b + 1) * s)), int(k) - 1)
                      for b, s, k in zip((bx, by, bz), bs, n)]
                sg[bx, by, bz] = grid[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1,
                                      lo[2]:hi[2] + 1].max(initial=0.0)
    return nb, bs, sg


def medium_constants(grid, bmin, bmax, absorption, scattering):
    """The global majorant and the tracking-step bound, in float32 as a
    float32 scene table holds them."""
    sa = np.asarray(absorption, np.float32) * np.ones(3, np.float32)
    ss = np.asarray(scattering, np.float32) * np.ones(3, np.float32)
    majorant = np.float32(((sa + ss) * np.float32(grid.max())).max())
    diag = float(np.linalg.norm(np.asarray(bmax, np.float32)
                                - np.asarray(bmin, np.float32)))
    max_steps = int(min(4096, max(64, 3.0 * float(majorant) * diag + 32)))
    return majorant, max_steps


class CloudNEE:
    """The estimator over one cloud scene, on ``device`` in dtype ``dt``.
    ``grid``: the (nx, ny, nz) float32 density the benchmark made. NEE or
    not as the configuration's integrator says."""

    def __init__(self, config, grid, device, dt=torch.float32,
                 grad_sampling=False, score_terms=False):
        self.cfg = config
        # the gradient-friendly variant: roulette off, uniform channel pick;
        # with score_terms the weights carry the score ratios of the
        # scatter-or-null split (value 1, gradient d log p)
        self.grad_sampling = grad_sampling
        self.score_terms = score_terms
        self.dev = torch.device(device)
        self.dt = dt
        r = config["render"]
        self.nee = NEE[r["integrator"]]
        self.width, self.height = int(r["width"]), int(r["height"])
        self.max_depth = int(r["max_depth"])
        sc = config["scene"]
        gspec = sc["density_grid"]
        med = sc["media"][0]
        grid = np.asarray(grid, np.float32)
        bmin = np.asarray(gspec["bmin"], np.float32)
        bmax = np.asarray(gspec["bmax"], np.float32)
        majorant, self.max_steps = medium_constants(
            grid, bmin, bmax, med["absorption"], med["scattering"])
        nb, bs, sg = supergrid(grid)

        def t(x, dtype=None):
            return torch.as_tensor(np.asarray(x)).to(self.dev).to(dtype or dt)

        self.res = grid.shape
        self.grid = t(grid).reshape(-1)
        self.gmin, self.gmax = t(bmin), t(bmax)
        self.resf = t(np.asarray(grid.shape, np.float32))
        self.nb = torch.as_tensor(nb).to(self.dev)
        self.nbf = t(nb.astype(np.float32))
        self.bs = t(bs)
        self.sg = t(sg).reshape(-1)
        self.majorant = float(majorant)
        self.sa = t(np.asarray(med["absorption"], np.float32) * np.ones(3, np.float32))
        self.ss = t(np.asarray(med["scattering"], np.float32) * np.ones(3, np.float32))
        self.st_max = float((self.sa + self.ss).max())
        self.g = float(med.get("g", 0.0))
        lights = sc["sphere_lights"]
        self.l_c = t([l["center"] for l in lights])
        self.l_r = t([float(l["radius"]) for l in lights])
        self.l_le = t([l["le"] for l in lights])
        self.n_lights = len(lights)
        self.site_pick = max(8192, SITE_MEDIUM + self.max_steps * SITES_PER_STEP)
        self.tally = dict(rays=0, scattered=0, sample_lanes=0,
                          sample_segments=0, sample_candidates=0, tr_lanes=0,
                          tr_segments=0, tr_candidates=0)

    # -- geometry ---------------------------------------------------------
    def _spheres(self, o, d):
        """(t, light row) of the nearest sphere light, (inf, -1) on a miss."""
        ell = o[:, None, :] - self.l_c[None]
        a = dot(d, d)[:, None]
        b = 2.0 * dot(d[:, None, :], ell)
        c = dot(ell, ell) - (self.l_r * self.l_r)[None]
        disc = b * b - 4.0 * a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        q = torch.where(b > 0, -0.5 * (b + sq), -0.5 * (b - sq))
        x0 = q / a
        x1 = torch.where(q == 0, x0, c / torch.where(q == 0, torch.ones_like(q), q))
        t = torch.where(torch.minimum(x0, x1) > 0, torch.minimum(x0, x1),
                        torch.maximum(x0, x1))
        ok = (disc >= 0) & (t > 0)
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        tmin, idx = t.min(dim=1)
        return tmin, torch.where(torch.isfinite(tmin), idx, torch.full_like(idx, -1))

    def _box(self, o, d):
        """Slab entry (clamped at 0) and exit of the cloud's box, inf on a miss."""
        ds = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        inv = 1.0 / ds
        ta = (self.gmin[None] - o) * inv
        tb = (self.gmax[None] - o) * inv
        t0 = torch.minimum(ta, tb).amax(-1)
        t1 = torch.maximum(ta, tb).amin(-1)
        ok = (t0 <= t1) & (t1 > 0)
        t0 = torch.clamp(t0, min=0.0)
        inf = torch.full_like(t0, float("inf"))
        return torch.where(ok, t0, inf), torch.where(ok, t1, inf)

    # -- the medium ---------------------------------------------------------
    def _density(self, p):
        ext = self.gmax - self.gmin
        x = (p - self.gmin[None]) / ext[None] * (self.resf[None] - 1.0)
        inside = ((p >= self.gmin[None]) & (p <= self.gmax[None])).all(-1)
        x = torch.minimum(torch.clamp(x, min=0.0), self.resf[None] - 1.0)
        x0 = torch.floor(x)
        f = x - x0
        i0 = x0.to(torch.int64)
        nx, ny, nz = self.res
        lim = torch.tensor([nx - 1, ny - 1, nz - 1], device=self.dev)
        i1 = torch.minimum(i0 + 1, lim[None])
        w = [(1.0 - f[:, k], f[:, k]) for k in range(3)]
        val = None
        for c in range(8):
            dx, dy, dz = (c >> 2) & 1, (c >> 1) & 1, c & 1
            ix = (i1 if dx else i0)[:, 0]
            iy = (i1 if dy else i0)[:, 1]
            iz = (i1 if dz else i0)[:, 2]
            term = self.grid[(ix * ny + iy) * nz + iz] * ((w[0][dx] * w[1][dy]) * w[2][dz])
            val = term if val is None else val + term
        return torch.where(inside, val, torch.zeros_like(val))

    def _segments(self, o, d, t0, t1):
        """Per-lane majorant segments over [t0, t1]: start times (N, K+1),
        majorants (N, K+1), optical depth at the edges (N, K+2), and the
        number of segments that start before the span's end."""
        ext = self.gmax - self.gmin
        scale = (self.resf - 1.0) / torch.where(ext == 0, torch.ones_like(ext), ext)
        a = (o - self.gmin[None]) * scale[None]
        v = d * scale[None]
        zero = torch.zeros_like(t0)
        t0f = torch.where(torch.isfinite(t0), t0, zero)
        t1f = torch.where(torch.isfinite(t1), torch.maximum(t1, t0f), t0f)
        b = torch.minimum(torch.clamp(torch.floor((a + t0f[:, None] * v) / self.bs[None]),
                                      min=0.0), self.nbf[None] - 1.0)
        sgn = torch.where(v >= 0, torch.ones_like(v), -torch.ones_like(v))
        vs = torch.where(v.abs() < 1e-20, torch.full_like(v, 1e-20), v)
        inf = torch.full_like(v, float("inf"))
        nb = self.nb
        seg_t, seg_m = [], []
        t_cur = t0f
        for _ in range(DDA_SEGMENTS):
            bi = b.to(torch.int64)
            m_loc = self.sg[(bi[:, 0] * nb[1] + bi[:, 1]) * nb[2] + bi[:, 2]] * self.st_max
            lo = b * self.bs[None]
            hi = (b + 1.0) * self.bs[None]
            te = torch.where(v > 1e-20, (hi - a) / vs,
                             torch.where(v < -1e-20, (lo - a) / vs, inf))
            ex, ey, ez = te[:, 0], te[:, 1], te[:, 2]
            t_hi = torch.minimum(torch.minimum(ex, ey), ez)
            sx = (ex <= ey) & (ex <= ez)
            sy = ~sx & (ey <= ez)
            sz = ~sx & ~sy
            seg_t.append(t_cur)
            seg_m.append(torch.where(t_cur < t1f, m_loc, zero))
            step = torch.stack([sx, sy, sz], dim=-1).to(v.dtype)
            b = torch.minimum(torch.clamp(b + step * sgn, min=0.0), self.nbf[None] - 1.0)
            t_cur = torch.minimum(torch.maximum(t_hi, t_cur), t1f)
        t_tail = torch.minimum(t_cur, t1f)
        seg_t.append(t_tail)
        seg_m.append(torch.where(t_tail < t1f, torch.full_like(t_tail, self.majorant), zero))
        seg_t = torch.stack(seg_t, 1)
        seg_m = torch.stack(seg_m, 1)
        ends = torch.cat([seg_t[:, 1:], t1f[:, None]], 1)
        dtau = seg_m * torch.clamp(ends - seg_t, min=0.0)
        edges = [zero]
        for k in range(dtau.shape[1]):
            edges.append(edges[-1] + dtau[:, k])
        n_seg = int((seg_t < t1f[:, None]).sum())
        return seg_t, seg_m, torch.stack(edges, 1), n_seg

    @staticmethod
    def _tau_to_t(seg_t, seg_m, edges, tau):
        k = (edges[:, :-1] <= tau[:, None]).sum(1) - 1
        k = torch.clamp(k, 0, seg_m.shape[1] - 1)[:, None]
        m = seg_m.gather(1, k)[:, 0]
        t = seg_t.gather(1, k)[:, 0] + (tau - edges.gather(1, k)[:, 0]) / torch.where(
            m <= 0, torch.ones_like(m), m)
        return t, m

    def _track(self, o, d, t0, t1, tp, keys, site):
        """Weighted delta tracking of the lanes over [t0, t1]: (t where each
        stopped, weight (N, 3), scattered, step of the scatter)."""
        dt = self.dt
        n = o.shape[0]
        seg_t, seg_m, edges, n_seg = self._segments(o, d, t0, t1)
        self.tally["sample_lanes"] += n
        self.tally["sample_segments"] += n_seg
        tau_total = edges[:, -1] - RAY_EPS * self.majorant
        sig_a = (self.sa[None] * self._density(o + t0[:, None] * d)[:, None]).detach()
        zero = torch.zeros((n,), dtype=dt, device=self.dev)
        _, m_entry = self._tau_to_t(seg_t, seg_m, edges, zero)
        m_prev = torch.clamp(m_entry, min=0.0)
        tau = zero.clone()
        w = torch.ones((n, 3), dtype=dt, device=self.dev)
        t_res = t1 + RAY_EPS
        scattered = torch.zeros((n,), dtype=torch.bool, device=self.dev)
        scat_step = torch.zeros((n,), dtype=torch.int64, device=self.dev)
        act = torch.arange(n, device=self.dev)
        for step in range(self.max_steps):
            if act.numel() == 0:
                break
            self.tally["sample_candidates"] += act.numel()
            k = keys[act]
            sb = site + step * SITES_PER_STEP
            u_wl, u_dist, u_ev = u1(k, sb, dt), u1(k, sb + 1, dt), u1(k, sb + 2, dt)
            mp = m_prev[act]
            mps = torch.where(mp <= 0, torch.ones_like(mp), mp)
            wa = w[act]
            if self.grad_sampling:
                pick_w = torch.ones_like(wa)
            else:
                pick_w = (tp[act] * wa) * torch.clamp(
                    (mp[:, None] - sig_a[act]) / mps[:, None], min=0.0)
            pick_w = pick_w.detach()
            s = (pick_w[:, 0] + pick_w[:, 1]) + pick_w[:, 2]
            pmf = torch.where((s > 0)[:, None], pick_w / torch.where(s == 0, torch.ones_like(s), s)[:, None],
                              torch.full_like(pick_w, 1.0 / 3.0))
            ch = ((0.0 < u_wl).long() + (pmf[:, 0] < u_wl).long()
                  + ((pmf[:, 0] + pmf[:, 1]) < u_wl).long())
            ch = torch.clamp(ch, min=1) - 1
            dtau = -torch.log(torch.clamp(1.0 - u_dist, min=1e-38))
            ta = tau[act]
            tau_new = ta + dtau
            esc = tau_new > tau_total[act]
            tr_esc = torch.exp(-(tau_total[act] - ta))
            pe = (pmf[:, 0] * tr_esc + pmf[:, 1] * tr_esc) + pmf[:, 2] * tr_esc
            t_new, m_loc = self._tau_to_t(seg_t[act], seg_m[act], edges[act], tau_new)
            m_safe = torch.where(m_loc <= 0, torch.ones_like(m_loc), m_loc)
            dens = self._density(o[act] + t_new[:, None] * d[act])
            sig_s = self.ss[None] * dens[:, None]
            sa_new = self.sa[None] * dens[:, None]
            sig_n = torch.clamp((m_loc[:, None] - sa_new) - sig_s, min=0.0)
            den = sig_s + sig_n
            den = torch.where(den == 0, torch.ones_like(den), den)
            p_s, p_n = sig_s / den, sig_n / den
            tr_s = torch.exp(-dtau)
            base = (pmf * m_safe[:, None]) * tr_s[:, None]
            p_s_ch = p_s.gather(1, ch[:, None])[:, 0]
            scat = ~esc & (u_ev < p_s_ch)
            cont = ~esc & ~scat

            def nz(x):
                return torch.where(x == 0, torch.ones_like(x), x)

            pdf_sc = (base[:, 0] * p_s[:, 0] + base[:, 1] * p_s[:, 1]) + base[:, 2] * p_s[:, 2]
            pdf_nl = (base[:, 0] * p_n[:, 0] + base[:, 1] * p_n[:, 1]) + base[:, 2] * p_n[:, 2]
            w_esc = wa * tr_esc[:, None] / nz(pe)[:, None]
            w_sc = (wa * tr_s[:, None]) * sig_s / nz(pdf_sc)[:, None]
            w_nl = (wa * tr_s[:, None]) * sig_n / nz(pdf_nl)[:, None]
            if self.score_terms:
                w_sc = w_sc * score_ratio(p_s_ch)[:, None]
                w_nl = w_nl * score_ratio(1.0 - p_s_ch)[:, None]
            w = w.index_put((act,), torch.where(esc[:, None], w_esc,
                                                torch.where(scat[:, None], w_sc, w_nl)))
            done_s = act[scat]
            t_res[done_s] = t_new[scat]
            scattered[done_s] = True
            scat_step[done_s] = step
            tau[act] = torch.where(cont, tau_new, ta)
            m_prev[act] = m_loc
            sig_a[act] = sa_new.detach()
            act = act[cont]
        w = w.index_put((act,), torch.zeros_like(w[act]))   # out of steps: weight 0
        return t_res, w, scattered, scat_step

    def _transmittance(self, p1, p2, keys, site):
        """Ratio-tracked transmittance (N, 3) from p1 to p2."""
        dt = self.dt
        n = p1.shape[0]
        dv = p2 - p1
        sq = dv * dv
        dist = torch.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2])
        d = dv / torch.where(dist == 0, torch.ones_like(dist), dist)[:, None]
        zero = torch.zeros((n,), dtype=dt, device=self.dev)
        seg_t, seg_m, edges, n_seg = self._segments(p1, d, zero, dist)
        self.tally["tr_lanes"] += n
        self.tally["tr_segments"] += n_seg
        tau_total = edges[:, -1]
        st = self.sa + self.ss
        tr = torch.ones((n, 3), dtype=dt, device=self.dev)
        tau = zero.clone()
        act = torch.arange(n, device=self.dev)
        for step in range(self.max_steps):
            if act.numel() == 0:
                break
            self.tally["tr_candidates"] += act.numel()
            u = u1(keys[act], site + step, dt)
            tau_new = tau[act] - torch.log(torch.clamp(1.0 - u, min=1e-38))
            esc = tau_new > tau_total[act]
            t_new, m_loc = self._tau_to_t(seg_t[act], seg_m[act], edges[act], tau_new)
            dens = self._density(p1[act] + t_new[:, None] * d[act])
            m_safe = torch.where(m_loc <= 0, torch.ones_like(m_loc), m_loc)
            upd = ~esc
            new_tr = (tr[act] * torch.clamp(m_loc[:, None] - st[None] * dens[:, None], min=0.0)) / m_safe[:, None]
            tr = tr.index_put((act,), torch.where(upd[:, None], new_tr, tr[act]))
            tau[act] = torch.where(upd, tau_new, tau[act])
            act = act[upd]
        return tr.index_put((act,), torch.zeros_like(tr[act]))

    def _cone(self, pos, li, lu, lv):
        """PBRT's cone sample of sphere light ``li`` from ``pos``:
        (direction, distance, pdf, Le toward pos)."""
        c = self.l_c[li]
        r = self.l_r[li]
        dzv = c - pos
        l2 = dot(dzv, dzv)
        ln = torch.sqrt(l2)
        dz = -dzv / torch.where(ln == 0, torch.ones_like(ln), ln)[:, None]
        dx, dy = onb(dz)
        sin2 = r * r / torch.where(l2 == 0, torch.ones_like(l2), l2)
        sin_tm = torch.sqrt(sin2)
        cos_tm = torch.sqrt(torch.clamp(1.0 - sin2, min=0.0))
        cos_t = 1.0 + (cos_tm - 1.0) * lu
        sin_t2 = 1.0 - cos_t * cos_t
        cos_a = sin_t2 / torch.where(sin_tm == 0, torch.ones_like(sin_tm), sin_tm) + cos_t * torch.sqrt(
            torch.clamp(1.0 - sin_t2 / torch.where(sin2 == 0, torch.ones_like(sin2), sin2), min=0.0))
        sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
        phi = (2.0 * PI) * lv
        nrm = ((torch.cos(phi) * sin_a)[:, None] * dx + (torch.sin(phi) * sin_a)[:, None] * dy
               + cos_a[:, None] * dz)
        p = c + nrm * r[:, None]
        dvec = p - pos
        tmax = torch.sqrt(dot(dvec, dvec))
        front = dot(dvec, nrm) < 0
        pdf = 1.0 / ((2.0 * PI) * torch.clamp(1.0 - cos_tm, min=1e-12))
        wi = dvec / torch.where(tmax == 0, torch.ones_like(tmax), tmax)[:, None]
        le = torch.where(front[:, None], self.l_le[li], torch.zeros_like(self.l_le[li]))
        return wi, pdf, le

    def _phase_dir(self, d, up1, up2):
        g = self.g
        if abs(g) < 1e-3:
            cos_t = 2.0 * up1 - 1.0
        else:
            sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * up1)
            cos_t = (1.0 + g * g - sqr * sqr) / (2.0 * g)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi = (2.0 * PI) * up2
        t, b = onb(d)
        return ((torch.cos(phi) * sin_t)[:, None] * t + cos_t[:, None] * d
                + (torch.sin(phi) * sin_t)[:, None] * b)

    def _phase(self, cos):
        g = self.g
        den = 1.0 + g * g - 2.0 * g * cos
        return (1.0 / (4.0 * PI)) * (1.0 - g * g) / (den * torch.sqrt(den))

    def _nee(self, rad, lane, ps, d, tpw, ks, site):
        """NEE at the scatter vertices ``ps``: a uniform light pick, the
        cone sample, the shadow ray's ratio-tracked transmittance; adds the
        weighted contribution to ``rad`` at rows ``lane``."""
        dt = self.dt
        u_pick = u1(ks, site + self.site_pick, dt)
        lidx = torch.clamp((u_pick * self.n_lights).to(torch.int64), max=self.n_lights - 1)
        lu, lv = u2(ks, site + self.site_pick + 1, dt)
        wi, cpdf, le = self._cone(ps, lidx, lu, lv)
        pdf = (1.0 / self.n_lights) * cpdf
        ok = pdf > 0
        st_s, _ = self._spheres(ps, wi)
        sb0, sb1 = self._box(ps, wi)
        in_box = ok & torch.isfinite(sb0) & (sb0 < st_s)
        tr = torch.ones_like(le)
        bsel = in_box.nonzero()[:, 0]
        if bsel.numel():
            t1f = torch.where(torch.isfinite(sb1[bsel]), sb1[bsel], sb0[bsel])
            p1 = ps[bsel] + sb0[bsel][:, None] * wi[bsel]
            p2 = ps[bsel] + t1f[:, None] * wi[bsel]
            tr = tr.index_put((bsel,), self._transmittance(
                p1, p2, ks[bsel], site + self.site_pick + 16))
        f = self._phase(dot(d, wi))[:, None]
        contrib = tr * f * le / torch.where(pdf == 0, torch.ones_like(pdf), pdf)[:, None]
        add = tpw * contrib
        return rad.index_add(0, lane, torch.where(ok[:, None], add, torch.zeros_like(add)))

    # -- the estimator ----------------------------------------------------
    def _paths(self, seeds, pixel_ids, samples):
        dt = self.dt
        keys = path_keys(seeds, pixel_ids, samples)
        o, d = camera_rays(self.cfg["camera"], self.width, self.height,
                           pixel_ids, keys, dt)
        n = keys.shape[0]
        rad = torch.zeros((n, 3), dtype=dt, device=self.dev)
        thr = torch.ones((n, 3), dtype=dt, device=self.dev)
        depth = torch.zeros((n,), dtype=torch.int64, device=self.dev)
        lane = torch.arange(n, device=self.dev)
        for it in range(2 * self.max_depth + 2):
            live = depth[lane] < self.max_depth
            lane, o, d = lane[live], o[live], d[live]
            if lane.numel() == 0:
                break
            self.tally["rays"] += lane.numel()
            site = it * SITES_PER_BOUNCE
            k = keys[lane]
            dep = depth[lane]
            t_s, li = self._spheres(o, d)
            b0, b1 = self._box(o, d)
            hit = torch.isfinite(t_s) | torch.isfinite(b0)
            box = torch.isfinite(b0) & (b0 < t_s)
            tp = thr[lane]
            mean = ((tp[:, 0] + tp[:, 1]) + tp[:, 2]) * (1.0 / 3.0)
            rr = torch.clamp(mean, max=1.0)
            do_rr = hit & (dep > 0) & (not self.grad_sampling)
            killed = do_rr & (u1(k, site, dt) >= rr)
            alive = hit & ~killed
            tp = torch.where((do_rr & alive)[:, None], tp * (1.0 / torch.clamp(rr, min=1e-12))[:, None], tp)
            emit = alive & ~box
            if bool(emit.any()):
                ls = torch.clamp(li, min=0)
                pe = o + torch.where(emit, t_s, torch.zeros_like(t_s))[:, None] * d
                ns = normalize(pe - self.l_c[ls])
                add = emit & (dot(-d, ns) > 0)
                if self.nee:
                    add = add & (dep == 0)
                rad = rad.index_add(0, lane, torch.where(add[:, None], tp * self.l_le[ls],
                                                         torch.zeros_like(tp)))
            med = alive & box
            sel = med.nonzero()[:, 0]
            lane, o, d, tp, k = lane[sel], o[sel], d[sel], tp[sel], k[sel]
            if lane.numel() == 0:
                break
            t_res, w, scat, scat_step = self._track(o, d, b0[sel], b1[sel], tp, k, site + SITE_MEDIUM)
            w = torch.where(torch.isnan(w).any(-1, keepdim=True), torch.zeros_like(w), w)
            pos = o + t_res[:, None] * d
            self.tally["scattered"] += int(scat.sum())
            ssel = scat.nonzero()[:, 0]
            new_d = d.clone()
            if ssel.numel():
                ks = k[ssel]
                if self.nee:
                    rad = self._nee(rad, lane[ssel], pos[ssel], d[ssel], tp[ssel] * w[ssel],
                                    ks, site)
                up1, up2 = u2(ks, site + SITE_MEDIUM + scat_step[ssel] * SITES_PER_STEP + 3, dt)
                new_d[ssel] = self._phase_dir(d[ssel], up1, up2)
            thr = thr.index_put((lane,), tp * w)
            depth[lane] += scat.long()
            keep = (tp * w > 0).any(-1)
            lane, o, d = lane[keep], pos[keep], new_d[keep]
        bad = (~torch.isfinite(rad) | (rad < 0)).any(dim=-1)
        return torch.where(bad[:, None], torch.zeros_like(rad), rad), bad

    def render_pixels(self, seeds, pixel_ids, spp):
        """Mean radiance (P, 3) float64 of ``spp`` samples at each of the
        pixels ``pixel_ids`` ((P,) int64) of the frames rendered with
        ``seeds`` ((P,) ints, one a pixel), and the rejected-sample count."""
        pixel_ids = torch.as_tensor(pixel_ids, dtype=torch.int64, device=self.dev)
        seeds = torch.as_tensor([int(s) & MASK for s in seeds], dtype=torch.int64,
                                device=self.dev)
        n_pix = pixel_ids.numel()
        sums = torch.zeros((n_pix, 3), dtype=torch.float64, device=self.dev)
        rejected = 0
        n = n_pix * spp
        for s, e in lane_blocks(n, LANE_BLOCK):
            j = torch.arange(s, e, device=self.dev)
            slot = j // spp
            rad, bad = self._paths(seeds[slot], pixel_ids[slot], j % spp)
            sums += sum_per_pixel(n_pix, slot, rad)
            rejected += int(bad.sum())
        return sums / spp, rejected



def make(config, grid, device, dt=torch.float32):
    """The configuration's reference over the density grid the run made."""
    return CloudNEE(config, grid, device, dt)
