"""A rank of a split cell on the CPU (gloo), for the tests: joins the
group, applies a fault if one is named, runs the cell and puts rank 0's
result on the queue."""

import datetime
import time


def worker(rank, world, port, workload, fault, queue):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    from xraytracer_tpu_torch.parallel import make_mesh

    import faults
    from benchmark.harness import run_cell
    from tiny import tiny_cell

    faults.apply(fault)
    try:
        res = run_cell.execute(tiny_cell(workload, pixels_per_frame=64), 2**31 + 9, 0.3, 0, time.time(),
                               "cpu", group=make_mesh("cpu"), require_route=False)
        if rank == 0:
            queue.put(res)
    finally:
        dist.destroy_process_group()
