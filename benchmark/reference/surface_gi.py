"""Plain reference of the GI path tracer on triangle scenes with quad lights.

The estimator of the reference renderer's ``PathTracingIntegrator``
(Src/integrator.h:198-291), written from its equations and run on a batch of
lanes, one lane a (pixel, sample) path:

* nearest hit by Moller-Trumbore over every triangle of the scene (the
  emitters' included), ties to the lower row; ``|det| >= kEpsilon`` and
  ``t > kEpsilon`` (Src/primitive.cpp:140-168);
* Russian roulette from depth 1 on, before the emitter test, with the
  survival probability ``min(mean throughput, 1)`` (Src/integrator.h:224-231);
* an emitter adds its one-sided Le at depth 0 only and ends the path
  (Src/integrator.h:236-244);
* next-event estimation over every quad light at every vertex: a bilinear
  point ``v0 + u e1 + v e2``, pdf ``t^3 / |d . (e1 x e2)|``, the shadow ray
  from ``p + 0.01 ng`` over ``t - 0.01``, blocked by any non-emitter
  triangle, ``cos`` against the geometric normal (Src/integrator.h:250-269,
  Src/light.cpp:49-82);
* the Lambert bounce: uniform hemisphere around the shading normal
  (``cos theta = u1``, Src/material.h:55-73), weight ``2 albedo cos``, or
  cosine-weighted (Malley) with weight ``albedo``; the frame is Duff et al.'s
  basis around the normal, and the next ray starts at ``p + 0.01 ng`` on the
  incoming side;
* random draws at site ``bounce * 2^16 + k``: roulette k = 0, bounce
  direction k = 1, light i at k = 16 + i;
* a sample with a NaN, Inf or negative channel counts 0 (Src/renderer.cpp:
  56-73).

It takes the scene as the configuration states it (quads, materials, lights,
camera) and imports nothing of the program under test.
"""

import numpy as np
import torch

from .common import (
    MASK, K_EPS, PI, SHADOW_BIAS, SITES_PER_BOUNCE, camera_rays, cross, dot,
    lane_blocks, normalize, onb, path_keys, sum_per_pixel, u1, u2,
)

LANE_BLOCK = 1 << 18


def scene_arrays(scene):
    """Triangles (v0, e1, e2 as (T, 3) float32), per-triangle albedo, the
    light row of each triangle (-1: none), and the quad lights, in the order
    the scene description lists them: every mesh's quads fanned (0,1,2),
    (0,2,3), then each quad light as (v0,v1,v2), (v1,v3,v2)."""
    tris, albedo, light = [], [], []
    for mesh in scene["meshes"]:
        for q in mesh["quads"]:
            q = [np.asarray(v, np.float32) for v in q]
            for a, b, c in ((q[0], q[1], q[2]), (q[0], q[2], q[3])):
                tris.append((a, b, c))
                albedo.append(mesh["albedo"])
                light.append(-1)
    lights = []
    for li, ql in enumerate(scene.get("quad_lights", [])):
        v0, v1, v2 = (np.asarray(ql[k], np.float32) for k in ("v0", "v1", "v2"))
        e1, e2 = v1 - v0, v2 - v0
        lights.append(dict(v0=v0, e1=e1, e2=e2, ng=np.cross(e1, e2),
                           le=np.asarray(ql["le"], np.float32)))
        v3 = v0 + e1 + e2
        for a, b, c in ((v0, v1, v2), (v1, v3, v2)):
            tris.append((a, b, c))
            albedo.append((0.0, 0.0, 0.0))
            light.append(li)
    v = np.asarray(tris, np.float32)
    return dict(
        v0=v[:, 0], e1=v[:, 1] - v[:, 0], e2=v[:, 2] - v[:, 0],
        albedo=np.asarray(albedo, np.float32),
        light=np.asarray(light, np.int64),
        lights=lights,
    )


class SurfaceGI:
    """The estimator over one scene, on ``device`` in float dtype ``dt``."""

    def __init__(self, config, device, dt=torch.float32):
        self.cfg = config
        self.dev = torch.device(device)
        self.dt = dt
        r = config["render"]
        self.width, self.height = int(r["width"]), int(r["height"])
        self.max_depth = int(r["max_depth"])
        self.cosine = bool(r.get("cosine_sampling", False))
        a = scene_arrays(config["scene"])

        def t(x, dtype=None):
            return torch.as_tensor(np.asarray(x)).to(self.dev).to(dtype or dt)

        self.v0, self.e1, self.e2 = t(a["v0"]), t(a["e1"]), t(a["e2"])
        self.albedo = t(a["albedo"])
        self.light = torch.as_tensor(a["light"]).to(self.dev)
        self.blocks = self.light < 0                 # emitters never block
        self.ng = normalize(cross(self.e1, self.e2))
        self.lights = [{k: t(v) for k, v in l.items()} for l in a["lights"]]
        # what the paths did: per-bounce lane counts, for the roofline counts
        self.tally = {"rays": 0, "shadow_rays": 0}

    # -- geometry ---------------------------------------------------------
    def _mt(self, o, d, valid):
        """(N, T) hit distances (inf where no hit) of Moller-Trumbore."""
        dn = d[:, None, :]
        pvec = cross(dn, self.e2[None])
        det = dot(self.e1[None], pvec)
        inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
        tvec = o[:, None, :] - self.v0[None]
        u = dot(tvec, pvec) * inv
        qvec = cross(tvec, self.e1[None])
        v = dot(dn, qvec) * inv
        t = dot(self.e2[None], qvec) * inv
        ok = ((det.abs() >= K_EPS) & (u >= 0) & (u <= 1) & (v >= 0)
              & (u + v <= 1) & (t > K_EPS) & valid[None])
        return torch.where(ok, t, torch.full_like(t, float("inf")))

    def _nearest(self, o, d):
        t = self._mt(o, d, torch.ones_like(self.blocks))
        tmin, idx = t.min(dim=1)     # first minimum: the lower row
        return tmin, idx

    def _blocked(self, o, d, t_max):
        t = self._mt(o, d, self.blocks)
        return (t < t_max[:, None]).any(dim=1)

    # -- the estimator ----------------------------------------------------
    def _paths(self, seeds, pixel_ids, samples):
        dt = self.dt
        keys = path_keys(seeds, pixel_ids, samples)
        o, d = camera_rays(self.cfg["camera"], self.width, self.height,
                           pixel_ids, keys, dt)
        n = keys.shape[0]
        rad = torch.zeros((n, 3), dtype=dt, device=self.dev)
        thr = torch.ones((n, 3), dtype=dt, device=self.dev)
        lane = torch.arange(n, device=self.dev)       # live lanes' slots
        for depth in range(self.max_depth):
            if lane.numel() == 0:
                break
            base = depth * SITES_PER_BOUNCE
            k = keys[lane]
            self.tally["rays"] += lane.numel()
            t, idx = self._nearest(o, d)
            hit = torch.isfinite(t)
            tp = thr[lane]
            if depth > 0:
                mean = ((tp[:, 0] + tp[:, 1]) + tp[:, 2]) * (1.0 / 3.0)
                rr = torch.clamp(mean, max=1.0)
                live = hit & (u1(k, base, dt) < rr)
                tp = tp / torch.clamp(rr, min=1e-12)[:, None]
            else:
                live = hit.clone()
            idx_s = torch.where(hit, idx, torch.zeros_like(idx))
            pos = o + torch.where(hit, t, torch.zeros_like(t))[:, None] * d
            ng = self.ng[idx_s]
            lrow = self.light[idx_s]
            emit = live & (lrow >= 0)
            if depth == 0 and self.lights:
                le = torch.stack([l["le"] for l in self.lights])[
                    torch.clamp(lrow, min=0)]
                front = dot(-d, ng) > 0
                add = emit & front
                rad[lane] += torch.where(add[:, None], tp * le, torch.zeros_like(le))
            live = live & ~emit
            alb = self.albedo[idx_s]
            wo_up = dot(-d, ng) > 0
            # next-event estimation over every light
            for li, l in enumerate(self.lights):
                ux, uy = u2(k, base + 16 + li, dt)
                p = l["v0"] + ux[:, None] * l["e1"] + uy[:, None] * l["e2"]
                dv = p - pos
                tl = torch.sqrt(dot(dv, dv))
                ddn = dot(dv, l["ng"])
                den = torch.where(ddn == 0, torch.ones_like(ddn), ddn.abs())
                pdf = tl * tl * tl / den
                front = ddn < 0
                ok = live & (pdf > 0)
                wi = dv / torch.where(tl == 0, torch.ones_like(tl), tl)[:, None]
                cos = torch.clamp(dot(ng, wi), min=0.0)
                need = ok & front & wo_up & (dot(wi, ng) > 0) & (cos > 0)
                vis = torch.zeros_like(need)
                if bool(need.any()):
                    sel = need.nonzero()[:, 0]
                    self.tally["shadow_rays"] += int(sel.numel())
                    so = pos[sel] + ng[sel] * SHADOW_BIAS
                    vis[sel] = ~self._blocked(so, wi[sel], tl[sel] - SHADOW_BIAS)
                fr = alb * (1.0 / PI)
                c = fr * l["le"] * (cos / torch.where(pdf > 0, pdf, torch.ones_like(pdf)))[:, None]
                rad[lane] += torch.where((need & vis)[:, None], tp * c, torch.zeros_like(c))
            # the bounce
            bx, by = u2(k, base + 1, dt)
            phi = 2.0 * PI * by
            if self.cosine:
                r = torch.sqrt(bx)
                wl = torch.stack([r * torch.cos(phi),
                                  torch.sqrt(torch.clamp(1.0 - bx, min=0.0)),
                                  r * torch.sin(phi)], dim=-1)
                w = alb
            else:
                st = torch.sqrt(torch.clamp(1.0 - bx * bx, min=0.0))
                wl = torch.stack([st * torch.cos(phi), bx, st * torch.sin(phi)], dim=-1)
                w = 2.0 * alb * torch.clamp(wl[:, 1], min=0.0)[:, None]
            tg, bt = onb(ng)
            wi = wl[:, 0:1] * tg + wl[:, 1:2] * ng + wl[:, 2:3] * bt
            tp = tp * w
            live = live & (tp > 0).any(dim=-1)
            sign = -torch.sign(dot(d, ng))
            thr[lane] = tp
            o = (pos + (sign * SHADOW_BIAS)[:, None] * ng)[live]
            d = wi[live]
            lane = lane[live]
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
    """The configuration's reference (``grid`` is unused: no medium)."""
    return SurfaceGI(config, device, dt)
