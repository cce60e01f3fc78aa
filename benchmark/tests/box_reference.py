"""A plain reference of a homogeneous box under quad lights rendered without
NEE, for the test that adds such a cell as files alone
(``test_bench_manifest.py``): the test copies this file into its copy of
the benchmark as ``reference/<config name>.py``.

The estimator of the reference renderer's ``VolumePathTracing``
(Src/integrator.h:401-478) on its vpt scene (Src/examples/vpt.cpp:47-71):
one homogeneous medium in an axis-aligned box (Src/medium.h:148-233, the
spectral-MIS variant: a channel picked by throughput times albedo, a free
flight from the box's entry, one-sample MIS weights over the channels), an
HG phase direction at site 2 of the medium block, and one-sided quad lights
whose Le is added at every depth. Roulette from depth 1; ``2 max_depth +
2`` iterations; random sites as ``cloud_nee``'s (roulette 0, the medium's
channel 16, distance 17, phase direction 18).
"""

import numpy as np
import torch

from benchmark.reference.common import (
    K_EPS, MASK, PI, RAY_EPS, SITES_PER_BOUNCE, camera_rays, cross, dot,
    lane_blocks, normalize, onb, path_keys, sum_per_pixel, u1, u2,
)

SITE_MEDIUM = 16


class HomogeneousBox:
    def __init__(self, config, device, dt=torch.float32):
        self.cfg = config
        self.dev = torch.device(device)
        self.dt = dt
        r = config["render"]
        if r["integrator"] != "vpt":
            raise ValueError("the box's reference is the estimator without NEE")
        self.width, self.height = int(r["width"]), int(r["height"])
        self.max_depth = int(r["max_depth"])
        sc = config["scene"]
        (med,) = sc["media"]
        if med["kind"] != "homogeneous":
            raise ValueError("one homogeneous medium")

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32)).to(self.dev).to(dt)

        self.bmin, self.bmax = t(med["bmin"]), t(med["bmax"])
        self.sa = t(np.asarray(med["absorption"], np.float32) * np.ones(3, np.float32))
        self.ss = t(np.asarray(med["scattering"], np.float32) * np.ones(3, np.float32))
        self.g = float(med["g"])
        tris, le = [], []
        for ql in sc["quad_lights"]:
            v0, v1, v2 = (np.asarray(ql[k], np.float32) for k in ("v0", "v1", "v2"))
            v3 = v0 + (v1 - v0) + (v2 - v0)
            tris += [(v0, v1, v2), (v1, v3, v2)]
            le += [ql["le"]] * 2
        v = np.asarray(tris, np.float32)
        self.v0, self.e1, self.e2 = t(v[:, 0]), t(v[:, 1] - v[:, 0]), t(v[:, 2] - v[:, 0])
        self.ng = normalize(cross(self.e1, self.e2))
        self.le = t(le)
        self.tally = dict(rays=0, scattered=0)

    def _light(self, o, d):
        """(t, row) of the nearest light triangle by Moller-Trumbore."""
        dn = d[:, None, :]
        pvec = cross(dn, self.e2[None])
        det = dot(self.e1[None], pvec)
        inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
        tvec = o[:, None, :] - self.v0[None]
        u = dot(tvec, pvec) * inv
        qvec = cross(tvec, self.e1[None])
        v = dot(dn, qvec) * inv
        t = dot(self.e2[None], qvec) * inv
        ok = ((det.abs() >= K_EPS) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
              & (t > K_EPS))
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        return t.min(dim=1)

    def _box(self, o, d):
        ds = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        inv = 1.0 / ds
        ta = (self.bmin[None] - o) * inv
        tb = (self.bmax[None] - o) * inv
        t0 = torch.minimum(ta, tb).amax(-1)
        t1 = torch.maximum(ta, tb).amin(-1)
        ok = (t0 <= t1) & (t1 > 0)
        inf = torch.full_like(t0, float("inf"))
        return torch.where(ok, torch.clamp(t0, min=0.0), inf), torch.where(ok, t1, inf)

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

    def _medium(self, o, d, t0, t1, tp, k, site):
        """(position, direction, weight, scattered) of one free flight."""
        st, ss = self.sa + self.ss, self.ss
        u_wl, u_dist = u1(k, site, self.dt), u1(k, site + 1, self.dt)
        up1, up2 = u2(k, site + 2, self.dt)
        w = tp * (ss / torch.where(st == 0, torch.ones_like(st), st))[None]
        s = (w[:, 0] + w[:, 1]) + w[:, 2]
        pmf = torch.where((s > 0)[:, None], w / torch.where(s == 0, torch.ones_like(s), s)[:, None],
                          torch.full_like(w, 1.0 / 3.0))
        ch = ((0.0 < u_wl).long() + (pmf[:, 0] < u_wl).long()
              + ((pmf[:, 0] + pmf[:, 1]) < u_wl).long())
        ch = torch.clamp(ch, min=1) - 1
        sig = st[ch]
        t = -torch.log(torch.clamp(1.0 - u_dist, min=1e-38)) / sig
        dist = t1 - t0
        esc = t > dist - RAY_EPS

        def sum3(x):
            return (x[:, 0] + x[:, 1]) + x[:, 2]

        def nz(x):
            return torch.where(x == 0, torch.ones_like(x), x)

        tr_d = torch.exp(-st[None] * dist[:, None])
        w_esc = tr_d / nz(sum3(pmf * tr_d))[:, None]
        tr_t = torch.exp(-st[None] * t[:, None])
        w_sc = tr_t * ss[None] / nz(sum3(pmf * st[None] * tr_t))[:, None]
        pos = torch.where(esc[:, None], o + (t1 + RAY_EPS)[:, None] * d, o + (t0 + t)[:, None] * d)
        new_d = torch.where(esc[:, None], d, self._phase_dir(d, up1, up2))
        return pos, new_d, torch.where(esc[:, None], w_esc, w_sc), ~esc

    def _paths(self, seeds, pixel_ids, samples):
        dt = self.dt
        keys = path_keys(seeds, pixel_ids, samples)
        o, d = camera_rays(self.cfg["camera"], self.width, self.height, pixel_ids, keys, dt)
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
            t_l, row = self._light(o, d)
            b0, b1 = self._box(o, d)
            hit = torch.isfinite(t_l) | torch.isfinite(b0)
            tp = thr[lane]
            mean = ((tp[:, 0] + tp[:, 1]) + tp[:, 2]) * (1.0 / 3.0)
            rr = torch.clamp(mean, max=1.0)
            do_rr = hit & (depth[lane] > 0)
            alive = hit & ~(do_rr & (u1(k, site, dt) >= rr))
            tp = torch.where((do_rr & alive)[:, None], tp * (1.0 / torch.clamp(rr, min=1e-12))[:, None], tp)
            emit = alive & (t_l <= b0)          # ties go to the triangle
            facing = dot(-d, self.ng[row]) > 0
            rad = rad.index_add(0, lane, torch.where((emit & facing)[:, None], tp * self.le[row],
                                                     torch.zeros_like(tp)))
            sel = (alive & ~emit).nonzero()[:, 0]
            lane, o, d, tp, k = lane[sel], o[sel], d[sel], tp[sel], k[sel]
            if lane.numel() == 0:
                break
            pos, new_d, w, scat = self._medium(o, d, b0[sel], b1[sel], tp, k, site + SITE_MEDIUM)
            self.tally["scattered"] += int(scat.sum())
            thr = thr.index_put((lane,), tp * w)
            depth[lane] += scat.long()
            keep = (tp * w > 0).any(-1)
            lane, o, d = lane[keep], pos[keep], new_d[keep]
        bad = (~torch.isfinite(rad) | (rad < 0)).any(dim=-1)
        return torch.where(bad[:, None], torch.zeros_like(rad), rad), bad

    def render_pixels(self, seeds, pixel_ids, spp):
        pixel_ids = torch.as_tensor(pixel_ids, dtype=torch.int64, device=self.dev)
        seeds = torch.as_tensor([int(s) & MASK for s in seeds], dtype=torch.int64,
                                device=self.dev)
        n_pix = pixel_ids.numel()
        sums = torch.zeros((n_pix, 3), dtype=torch.float64, device=self.dev)
        rejected = 0
        for s, e in lane_blocks(n_pix * spp, 1 << 20):
            j = torch.arange(s, e, device=self.dev)
            slot = j // spp
            rad, bad = self._paths(seeds[slot], pixel_ids[slot], j % spp)
            sums += sum_per_pixel(n_pix, slot, rad)
            rejected += int(bad.sum())
        return sums / spp, rejected


def make(config, grid, device, dt=torch.float32):
    return HomogeneousBox(config, device, dt)
