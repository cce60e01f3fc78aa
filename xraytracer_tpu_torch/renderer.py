"""Execution layer: wavefront renderer, accumulation, sharding, checkpoints.

PyTorch counterpart of ``xraytracer_tpu/renderer.py`` and of the
reference's ``NormalRenderer`` / ``ParallelRenderer`` (reference:
Src/renderer.cpp:8-99). The per-pixel double loop + spp loop becomes: one
wavefront of all pixels and a host loop over spp that dispatches one
single-spp step per sample (PyTorch runs eagerly; launches are
asynchronous, so the host enqueues ahead of the device).

Reference semantics preserved:
  * jittered sub-pixel SSAA: uv = ((x + u), (y + v)) / (W, H)
    (Src/renderer.cpp:42-47);
  * per-sample NaN/Inf/negative radiance REJECTION with a running count
    (Src/renderer.cpp:56-73) — rejected samples contribute 0 but still
    divide by the full spp;
  * per-pixel determinism: the RNG key is a pure function of
    (seed, global pixel id, sample index), so renders are bitwise identical
    across chunkings (SURVEY.md §7).

Checkpoint/resume (absent in the reference, SURVEY.md §5): spp is
accumulated in chunks; the accumulator (sum buffer + rejected count +
samples done) round-trips through an .npz file between chunks.

A frame stays on the render's device until it is an image: the lane map
is made there, the sums are un-permuted (lanes out of raster order only)
and divided by spp there, and one copy brings the image to the host
(``counts()["frame_copies"]`` counts the frame-sized copies).

An integrator that carries ``fused_spec`` (``make_path_integrator`` or
``make_volume_integrator`` with ``fused="auto"`` on an eligible scene) is
upgraded to its whole-render kernel: one launch per spp chunk
(``make_fused_chunk_fn``). ``kind="volume"`` in the spec selects the
homogeneous volume kernels, ``kind="het_volume"`` the heterogeneous ones.

``sharding=pixel_sharding(group)`` is the multi-GPU ``ParallelRenderer``:
each rank of a ``torch.distributed`` group (``parallel/mesh.py``) renders
one contiguous block of the lanes, by the wavefront route or, for a fused
route, as the whole-render kernel's own lane set; the finished blocks are
gathered and every rank returns the full image. No collective runs inside
the sample loop, since every lane owns its pixel (the disjointness argument
of the reference's ``std::for_each(par_unseq)``, Src/renderer.cpp:90-93).
"""

import os
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .device import resolve_device
from .parallel import (
    block_sizes,
    gather_rows,
    make_mesh,
    multihost_init,
    sharded_pixels,
    sum_over_ranks,
)
from .sampling import path_keys, uniform2
from .tracing import span

# Dedicated RNG site for camera jitter, far above any per-bounce block
# (bounce i uses sites [i * SITES_PER_BOUNCE, (i+1) * SITES_PER_BOUNCE)).
CAMERA_SITE = 0x7FFF0000


def _morton_argsort(width, height, device):
    """Lane order that visits pixels along a Z-order curve: consecutive
    lanes then cover compact 2-D pixel BLOCKS instead of scanlines, which
    keeps the rays of one thread block close together on large meshes.
    Made on ``device``; the codes are uint32 values held in int64, the same
    whatever the frame's size, and the sort is stable."""
    ids = torch.arange(width * height, dtype=torch.int64, device=device)

    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    code = (spread(ids % width) << 1) | spread(ids // width)
    return torch.sort(code, stable=True).indices.to(torch.int32)


def pixel_grid(width, height, order="raster", device=None):
    """Global pixel ids (int32) and pixel (x, y) (float32), in
    lane-traversal order, made on ``device`` (ids below 2^24 are exact in
    float32).

    Pixel IDs stay row-major (matching the reference's ``j + width * i``
    seeding, Src/renderer.cpp:36) — per-pixel RNG streams and therefore
    the IMAGE are identical for every ``order``; only the lane TRAVERSAL
    changes ("morton" visits pixels Z-order, and image assembly
    un-permutes)."""
    device = resolve_device(device)
    if order == "morton":
        ids = _morton_argsort(width, height, device)
    else:
        ids = torch.arange(width * height, dtype=torch.int32, device=device)
    xy = torch.stack([ids % width, ids // width], dim=-1).to(torch.float32)
    return ids, xy


def make_sample_fn(scene, camera, integrate, width, height, seed):
    """One-spp wavefront step: (pixel_ids, pixel_xy, sample_idx) ->
    (radiance (N,3), n_rejected, stats)."""
    wh = torch.tensor(
        [float(width), float(height)], dtype=torch.float32,
        device=camera.c2w.device,
    )

    def sample_once(pixel_ids, pixel_xy, s):
        keys = path_keys(seed, pixel_ids, s)
        u = uniform2(keys, CAMERA_SITE)
        uv = (pixel_xy + u) / wh
        rays = camera.sample_rays(uv)
        out = integrate(rays, keys)
        # with_stats integrators return (radiance, per-bounce counter dict)
        rad, stats = out if isinstance(out, tuple) else (out, None)
        # rejection (Src/renderer.cpp:56-73): any nan/inf/negative channel
        # voids the whole sample
        bad = (~torch.isfinite(rad) | (rad < 0.0)).any(dim=-1)
        rad = torch.where(bad[:, None], torch.zeros_like(rad), rad)
        return rad, bad.sum().to(torch.int32), stats

    return sample_once


def make_chunk_fn(sample_once):
    """spp-chunk accumulator: a host loop over spp around the single-spp
    step. The accumulator and the reject count are updated IN PLACE
    (``acc += rad``): the caller hands over the buffer and reads the result
    from the same tensor (the JAX package donates its accumulator to the
    same effect)."""

    def run_chunk(acc, nrej, pixel_ids, pixel_xy, s0, n, stats_acc=None):
        for i in range(n):
            rad, bad, stats = sample_once(pixel_ids, pixel_xy, s0 + i)
            acc += rad
            nrej += bad
            if stats is not None:
                stats_acc = (
                    stats if stats_acc is None
                    else {k: stats_acc[k] + v for k, v in stats.items()}
                )
        return acc, nrej, stats_acc

    return run_chunk


def make_fused_chunk_fn(fused_render):
    """Chunk runner over a whole-render kernel
    (``megakernel.try_make_fused_spp_render``,
    ``vol_megakernel.try_make_fused_volume_spp_render`` or
    ``het_megakernel.try_make_fused_het_spp_render``): camera rays, paths,
    rejection and the sum over the chunk's samples all happen in ONE launch
    per chunk; ``s0`` and the sample count are launch arguments. Same
    signature as ``make_chunk_fn``'s runner, and like it the accumulator is
    updated in place. (The JAX package caps the pixel-samples of one call
    for its runtime's watchdog; nothing here needs that.)"""

    def run_chunk(acc, nrej, pixel_ids, pixel_xy, s0, n, stats_acc=None):
        rad, rej = fused_render(int(s0), int(n))
        acc += rad
        nrej += rej.to(nrej.dtype)
        return acc, nrej, stats_acc

    return run_chunk


@dataclass
class RenderResult:
    image: np.ndarray      # (H, W, 3) float32, averaged radiance
    spp: int
    n_rejected: int
    # the sample loop, from before its first launch to the sync on the
    # sums (a split render's gather included): the image is not yet on the
    # host, so the readback and the assembly are not in it
    seconds: float
    samples_per_sec: float  # primary camera samples (pixels*spp) per second, over ``seconds``
    # per-bounce counters summed over the whole render (SURVEY.md §5),
    # present when the integrator was built with ``with_stats=True``:
    # e.g. {"rays": (D,), "shadow_rays": (D,), "rr_killed": (D,), ...}
    stats: dict | None = None

    @property
    def total_rays(self):
        """All rays traced (primary + bounce + shadow); None when stats
        were not collected."""
        if self.stats is None:
            return None
        t = int(np.asarray(self.stats["rays"]).sum())
        if "shadow_rays" in self.stats:
            t += int(np.asarray(self.stats["shadow_rays"]).sum())
        return t


# frame-sized copies between host memory and a render's device (the sums,
# the image, a lane map) since the last ``reset_counts()``: a plain int,
# bumped exactly where the renderer's code makes one (and on the CPU at the
# same places, so a CPU render counts what it would on the card)
COPIES = {"frame_copies": 0}


def reset_counts():
    """Set the frame-copy count to 0."""
    COPIES["frame_copies"] = 0


def counts():
    """``{"frame_copies": n}`` since the last reset."""
    return dict(COPIES)


def count_frame_copy():
    """Count one frame-sized copy between host memory and a device."""
    COPIES["frame_copies"] += 1


def _to_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _to_host(t):
    """A frame-sized tensor as a numpy array (one counted copy)."""
    count_frame_copy()
    return _to_numpy(t)


def _to_device(t, device):
    """A frame-sized tensor or numpy array on ``device`` (one counted copy,
    unless it is a tensor there already)."""
    if torch.is_tensor(t) and t.device == device:
        return t
    count_frame_copy()
    return torch.as_tensor(t).to(device)


def _same_lanes(a, b):
    """Whether two lane -> pixel-id maps (None: raster) are the same."""
    if a is None or b is None:
        return a is b
    return a is b or torch.equal(_to_device(a, b.device), b)


def _image(sums, lanes, width, height, spp):
    """The (H, W, 3) float32 image of lane-order ``sums``, made on their
    device: un-permuted by the lane -> pixel-id map ``lanes`` (None: the
    lanes are in raster order and nothing moves), divided by ``spp``, then
    copied once into a host array of its own. The divisor is a tensor on the
    device, so the division is IEEE's, bitwise numpy's ``float32 / spp``:
    by a Python number, PyTorch's CUDA division multiplies by the
    reciprocal instead."""
    with span("renderer.scatter"):
        if lanes is not None:
            sums = torch.empty_like(sums).index_copy_(
                0, _to_device(lanes, sums.device).long(), sums)
        img = sums / torch.full((), spp, dtype=sums.dtype, device=sums.device)
    with span("renderer.readback"):
        out = np.empty((height, width, 3), np.float32)
        count_frame_copy()
        torch.from_numpy(out).copy_(img.view(height, width, 3))
    return out


class Accumulator:
    """Checkpointable spp accumulation state."""

    def __init__(self, width, height, acc=None, n_rejected=0, spp_done=0,
                 pixel_perm=None, device=None):
        self.width = width
        self.height = height
        if acc is None:
            acc = torch.zeros(
                (width * height, 3), dtype=torch.float32,
                device=resolve_device(device),
            )
        self.acc = acc
        self.n_rejected = n_rejected
        self.spp_done = spp_done
        # lane -> pixel-id map (an int tensor) when the renderer traverses
        # pixels out of raster order (pixel_grid(order="morton")); None =
        # raster
        self.pixel_perm = pixel_perm

    def save(self, path):
        extra = {}
        if self.pixel_perm is not None:
            extra["pixel_perm"] = _to_host(self.pixel_perm)
        np.savez(
            path,
            acc=_to_host(self.acc),
            n_rejected=_to_numpy(self.n_rejected),
            spp_done=self.spp_done,
            width=self.width,
            height=self.height,
            **extra,
        )

    @staticmethod
    def load(path, device=None):
        device = resolve_device(device)
        with np.load(path) as z:
            return Accumulator(
                int(z["width"]), int(z["height"]),
                acc=_to_device(z["acc"], device),
                n_rejected=int(z["n_rejected"]),
                spp_done=int(z["spp_done"]),
                pixel_perm=(_to_device(z["pixel_perm"], device)
                            if "pixel_perm" in z else None),
            )

    def image(self):
        return _image(self.acc, self.pixel_perm, self.width, self.height,
                      max(self.spp_done, 1))


class WavefrontRenderer:
    """Reusable pipeline for one (scene, camera, integrator, resolution,
    seed) configuration: the pixel grid and the sample step are built once
    and every ``render`` call reuses them. Runs on the device the camera's
    tensors live on.

    ``sharding``: a ``PixelGroup`` (``pixel_sharding(group)``) whose rank
    renders its block of the lanes (``parallel.sharded_pixels``); every
    rank must call ``render`` with the same arguments, and each returns the
    full image, the rejected samples and the stats summed over ranks. A
    checkpoint holds the whole frame and is written by rank 0, so a run on
    any number of ranks resumes it."""

    def __init__(
        self, scene, camera, integrate, width, height, seed=0,
        pixel_order="auto", sharding=None,
    ):
        with span("renderer.build"):
            self.width = width
            self.height = height
            self.n_pix = width * height
            self.device = camera.c2w.device
            if scene.tri_v0.device != self.device:
                raise ValueError(
                    f"scene tables on {scene.tri_v0.device}, camera on {self.device}"
                )
            if pixel_order == "auto":
                # Z-order traversal wherever the table spans several sweep
                # tiles (> 128 triangles), as in the JAX package
                big = int((scene.tri_obj >= 0).sum()) > 128
                pixel_order = "morton" if big else "raster"
            self.pixel_order = pixel_order
            with span("renderer.pixel_grid"):
                ids, xy = pixel_grid(width, height, order=pixel_order, device=self.device)
            # the whole frame's lane -> pixel-id map, for assembly and
            # checkpoints; None where the lanes are in raster order
            self._lanes = ids if pixel_order == "morton" else None
            self.group = sharding
            self._block = None
            if sharding is not None:
                if sharding.device != self.device:
                    raise ValueError(
                        f"rank's device {sharding.device}, camera on {self.device}")
                self._block = sharded_pixels(sharding, self.n_pix)
                ids, xy = ids[self._block], xy[self._block]
            self.pixel_ids, self.pixel_xy = ids, xy
            self.sample_once = make_sample_fn(
                scene, camera, integrate, width, height, seed
            )
            self.run_chunk = None
            spec = getattr(integrate, "fused_spec", None)
            if spec is not None:
                spec = dict(spec)
                kind = spec.pop("kind", "surface")
                if kind == "volume":
                    from .integrators.vol_megakernel import (
                        try_make_fused_volume_spp_render as make_fused,
                    )
                elif kind == "het_volume":
                    from .integrators.het_megakernel import (
                        try_make_fused_het_spp_render as make_fused,
                    )
                else:
                    from .integrators.megakernel import (
                        try_make_fused_spp_render as make_fused,
                    )
                with span("renderer.route"):
                    # its lanes are this renderer's (this rank's block of
                    # them), so the frame's lane map above assembles its sums
                    fused = make_fused(
                        camera=camera, width=width, height=height, seed=seed,
                        pixel_order=self.pixel_order, mesh=sharding,
                        lanes=(ids, xy), **spec,
                    )
                if fused is not None:
                    self.run_chunk = make_fused_chunk_fn(fused)
            if self.run_chunk is None:
                self.run_chunk = make_chunk_fn(self.sample_once)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def render(
        self, spp, spp_chunk=None, accumulator=None, checkpoint_path=None
    ):
        with span("renderer.launch"):
            spp_chunk = spp_chunk or spp
            acc_state = accumulator or Accumulator(
                self.width, self.height, device=self.device
            )
            old_perm, new_perm = acc_state.pixel_perm, self._lanes
            if acc_state.spp_done and not _same_lanes(old_perm, new_perm):
                # resumed checkpoint written under a DIFFERENT lane traversal
                # (e.g. raster-era checkpoint resumed by an auto-morton
                # renderer): remap the stored sums into this renderer's lane
                # order, on the device, so accumulation stays per-pixel
                # consistent
                a = _to_device(acc_state.acc, self.device)
                if old_perm is not None:
                    a = torch.empty_like(a).index_copy_(
                        0, _to_device(old_perm, self.device).long(), a)
                acc_state.acc = a if new_perm is None else a[new_perm.long()]
            acc_state.pixel_perm = new_perm
            acc = _to_device(acc_state.acc, self.device)
            nrej = torch.as_tensor(
                acc_state.n_rejected, dtype=torch.int32, device=self.device
            ).clone()
            if self.group is not None:
                # this rank's block of the sums; its own rejects, counted from 0
                # and added to the resumed total in _assemble
                acc = acc[self._block].clone()
                rej_resumed, nrej = nrej, torch.zeros_like(nrej)
            spp_resumed = acc_state.spp_done
            stats_acc = None
            self._sync()
            t0 = time.perf_counter()
            s = acc_state.spp_done
            while s < spp:
                n = min(spp_chunk, spp - s)
                acc, nrej, stats_acc = self.run_chunk(
                    acc, nrej, self.pixel_ids, self.pixel_xy, s, n,
                    stats_acc=stats_acc,
                )
                s += n
                acc_state.spp_done = s
                if self.group is None:
                    acc_state.acc = acc
                    acc_state.n_rejected = nrej
                elif checkpoint_path is not None:
                    acc_state.acc, acc_state.n_rejected = self._assemble(
                        acc, nrej, rej_resumed)
                if checkpoint_path is not None:
                    self._sync()
                    if self.group is None or self.group.rank == 0:
                        acc_state.save(checkpoint_path)
        if self.group is not None:
            acc_state.acc, acc_state.n_rejected = self._assemble(
                acc, nrej, rej_resumed)
            nrej = acc_state.n_rejected
            if stats_acc is not None:
                stats_acc = {k: sum_over_ranks(self.group, v)
                             for k, v in stats_acc.items()}
        with span("renderer.wait"):
            self._sync()
        dt = time.perf_counter() - t0

        img = _image(acc_state.acc, self._lanes, self.width, self.height, spp)
        n_samples = self.n_pix * max(spp - spp_resumed, 0)
        return RenderResult(
            image=img,
            spp=spp,
            n_rejected=int(nrej),
            seconds=dt,
            samples_per_sec=n_samples / max(dt, 1e-9),
            stats=(
                None if stats_acc is None
                else {k: _to_numpy(v) for k, v in stats_acc.items()}
            ),
        )

    def _assemble(self, acc, nrej, rej_resumed):
        """The whole frame's sums in lane order and the total rejects, from
        every rank's block (a collective: every rank calls it)."""
        with span("parallel.assemble"):
            full = gather_rows(self.group, acc, block_sizes(self.group, self.n_pix))
            return full, rej_resumed + sum_over_ranks(self.group, nrej)


def render(
    scene, camera, integrate, width, height, spp,
    seed=0, spp_chunk=None, accumulator=None, checkpoint_path=None,
    sharding=None,
):
    """One-shot convenience wrapper around ``WavefrontRenderer``. The device
    is the one ``scene`` and ``camera`` were built on (``device=`` of
    ``SceneBuilder.build`` and ``PinholeCamera.make``; the card by
    default). ``sharding``: ``pixel_sharding(group)``, the pixel split over
    a process group (every rank calls ``render``)."""
    with span("renderer.render", (seed,)):
        r = WavefrontRenderer(scene, camera, integrate, width, height, seed=seed,
                              sharding=sharding)
        return r.render(
            spp, spp_chunk=spp_chunk, accumulator=accumulator,
            checkpoint_path=checkpoint_path,
        )


def pixel_sharding(group):
    """The pixel split over ``group`` (a ``parallel.PixelGroup``) for
    ``render`` / ``WavefrontRenderer``'s ``sharding``: each rank renders
    one contiguous block of the lanes. The group itself carries everything
    the split needs, so this returns it."""
    return group


def default_mesh(device=None):
    """This process's ``PixelGroup``. A world of one, unless a launcher
    (``torchrun``) set WORLD_SIZE / RANK / LOCAL_RANK: then the process
    joins that group (``parallel.multihost_init``, if it has not yet) and
    rank r runs on ``cuda:LOCAL_RANK`` (or the CPU, for ``device="cpu"``)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        backend = None
        if device is not None and torch.device(device).type == "cpu":
            backend = "gloo"
        multihost_init(backend=backend)
    group = make_mesh(device)
    if group.device.type == "cuda":
        # NCCL's collectives run on the current device: the rank's card
        torch.cuda.set_device(group.device)
    return group
