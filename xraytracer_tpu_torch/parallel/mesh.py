"""Process-group parallelism: the multi-GPU ``ParallelRenderer``.

PyTorch counterpart of ``xraytracer_tpu/parallel/mesh.py`` and of the
reference's one parallelism story, a shared-memory thread pool over a
pixel-index list (``std::for_each(std::execution::par_unseq)``, reference:
Src/renderer.cpp:83-99; SURVEY.md §2.5). The disjoint-pixel argument
becomes a split over the ranks of a ``torch.distributed`` process group,
each rank on one device:

  * **pixel axis** (primary): each rank owns one contiguous block of lanes
    (``sharded_pixels``), the scene is replicated, and the only collective
    is the gather of the finished blocks (``shard_map_render``; the
    renderer's ``sharding=``).
  * **spp axis** (secondary): every rank renders the full image at sample
    indices k, k+D, k+2D, ... and the partial sums are gathered and added in
    rank order on every rank (``spp_parallel_render``), so the result is the
    same from run to run; useful when the image is small and spp is huge
    (the reference's volume workloads run 10240 spp,
    Src/examples/volume.cpp:25).

Because the RNG is a pure function of the global pixel id and the sample
index (sampling/rng.py), a pixel's samples are the same on any rank: a
pixel-split render is the single-device render.

Backends: ``nccl`` for CUDA devices, ``gloo`` for the CPU, unless the caller
picks one. NCCL refuses two ranks on one device; gloo runs them, but has
no ``all_gather`` for CUDA tensors, so with gloo a CUDA block is staged
through host memory for its gather (``gather_rows``). Only the finished
sums move: the rendering stays on each rank's device.
"""

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass(frozen=True)
class PixelGroup:
    """One rank's view of the group: its rank, the world size, its device
    and the process group's backend (None for a world of one without a
    process group)."""

    rank: int
    world: int
    device: torch.device
    backend: str | None = None


def multihost_init(coordinator=None, num_processes=None, process_id=None,
                   backend=None, timeout=None):
    """``torch.distributed.init_process_group`` for this process. With no
    ``coordinator`` the group is read from the environment a launcher sets
    (``torchrun``: MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK); else
    ``coordinator`` is an ``init_method`` URL (``tcp://host:port``,
    ``file:///path``) or a ``host:port``, with ``num_processes`` ranks of
    which this is ``process_id``. ``backend`` defaults to ``nccl`` where
    CUDA is available and ``gloo`` otherwise; ``timeout`` (seconds) bounds
    every collective, so a rank that hangs fails the others."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id,
                                **kwargs)


def make_mesh(device=None):
    """This process's ``PixelGroup``: the initialised process group's rank
    and world, or a world of one. ``device`` defaults to the card; a CUDA
    device without an index becomes ``cuda:LOCAL_RANK``, one card per rank
    of a host."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_available() and dist.is_initialized():
        return PixelGroup(dist.get_rank(), dist.get_world_size(), dev,
                          dist.get_backend())
    return PixelGroup(0, 1, dev)


def sharded_pixels(group, n):
    """The lanes rank ``group.rank`` owns out of ``n``: one contiguous block
    (a ``slice``), the first ``n % world`` ranks one lane more. Every lane
    goes to exactly one rank."""
    base, extra = divmod(n, group.world)
    start = group.rank * base + min(group.rank, extra)
    return slice(start, start + base + int(group.rank < extra))


def block_sizes(group, n):
    """Every rank's lane count under ``sharded_pixels``, in rank order."""
    base, extra = divmod(n, group.world)
    return [base + int(r < extra) for r in range(group.world)]


def _host_staged(group, t):
    """gloo runs few collectives on CUDA tensors (no all_gather): with
    gloo, a CUDA tensor goes through host memory."""
    return group.backend == "gloo" and t.is_cuda


def gather_rows(group, t, sizes=None):
    """Every rank's ``t`` (rows along dim 0; ``sizes[r]`` rows on rank r,
    default all equal) concatenated in rank order, on every rank, on
    ``t``'s device."""
    if group.world == 1:
        return t
    if sizes is None:
        sizes = [t.shape[0]] * group.world
    width = max(sizes)
    src = t.cpu() if _host_staged(group, t) else t
    if src.shape[0] < width:
        pad = src.new_zeros((width - src.shape[0],) + tuple(src.shape[1:]))
        src = torch.cat([src, pad])
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(group.world)]
    dist.all_gather(parts, src)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]).to(t.device)


def sum_over_ranks(group, t):
    """The sum of every rank's ``t``, added in rank order on every rank:
    the same bits on every rank and in every run (an ``all_reduce`` may add
    in any order)."""
    if group.world == 1:
        return t
    parts = gather_rows(group, t.reshape(1, *t.shape))
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


def replicated(group, tables):
    """``tables`` (a tensor, or a NamedTuple such as ``SceneTables`` whose
    tensor fields are broadcast) as rank 0 holds them, on every rank. A
    contiguous tensor is overwritten in place."""
    if group.world == 1:
        return tables
    if torch.is_tensor(tables):
        t = tables.contiguous()
        buf = t.cpu() if _host_staged(group, t) else t
        dist.broadcast(buf.view(torch.uint8) if buf.dtype == torch.bool else buf,
                       src=0)
        if buf is not t:
            t.copy_(buf)
        return t
    return type(tables)(*(
        replicated(group, f) if torch.is_tensor(f) else f for f in tables))


def _local_sum(sample_once, ids, xy, samples):
    acc = torch.zeros((ids.shape[0], 3), device=xy.device)
    rej = torch.zeros((), dtype=torch.int32, device=xy.device)
    for s in samples:
        rad, bad, _stats = sample_once(ids, xy, s)
        acc += rad
        rej += bad
    return acc, rej


def shard_map_render(scene, sample_once, pixel_ids, pixel_xy, spp, group):
    """Pixel-parallel render: each rank runs the spp loop over its block of
    the lanes (``sharded_pixels``); returns the framebuffer sum of all
    lanes (N, 3) in ``pixel_ids``' lane order and the rejected-sample count
    summed over ranks, on every rank. ``sample_once`` is the step from
    ``renderer.make_sample_fn``. No padding: blocks may differ by a lane."""
    n = pixel_ids.shape[0]
    blk = sharded_pixels(group, n)
    acc, rej = _local_sum(sample_once, pixel_ids[blk], pixel_xy[blk], range(spp))
    return gather_rows(group, acc, block_sizes(group, n)), sum_over_ranks(group, rej)


def spp_parallel_render(scene, sample_once, pixel_ids, pixel_xy, spp, group):
    """spp-axis data parallelism: rank k renders sample indices k, k+D,
    k+2D, ... (``spp % D`` need not be 0: the first ranks take one sample
    more); the partial framebuffers are added in rank order. Returns the
    (acc, n_rejected) every rank holds; the caller divides by spp."""
    k, n_dev = group.rank, group.world
    acc, rej = _local_sum(sample_once, pixel_ids, pixel_xy,
                          range(k, spp, n_dev))
    return sum_over_ranks(group, acc), sum_over_ranks(group, rej)
