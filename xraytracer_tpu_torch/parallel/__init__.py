"""Multi-GPU rendering over a ``torch.distributed`` process group (the
port of ``xraytracer_tpu/parallel``)."""

from .mesh import (
    PixelGroup,
    block_sizes,
    gather_rows,
    make_mesh,
    multihost_init,
    replicated,
    shard_map_render,
    sharded_pixels,
    spp_parallel_render,
    sum_over_ranks,
)

__all__ = [
    "PixelGroup",
    "block_sizes",
    "gather_rows",
    "make_mesh",
    "multihost_init",
    "replicated",
    "shard_map_render",
    "sharded_pixels",
    "spp_parallel_render",
    "sum_over_ranks",
]
