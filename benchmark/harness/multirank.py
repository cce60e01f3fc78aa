"""A cell split over several cards: this process spawns one rank per card
(``run.py`` again, with ``--rank``), each joins an NCCL process group
through a rendezvous file in a fresh directory under ``TMPDIR`` and runs
``run_cell.execute`` on its block of the pixels; rank 0's result line comes
back on its standard output."""

import os
import shutil
import subprocess
import sys
import tempfile
import time

RANK_TIMEOUT_S = 340


def launch(run_py, args, world, t_process):
    """Spawn the ranks, wait for every one of them, return rank 0's last
    standard-output line (None if any rank failed)."""
    rdv_dir = tempfile.mkdtemp(prefix="bench-rdv-")
    try:
        return _launch(run_py, args, world, t_process,
                       os.path.join(rdv_dir, "rendezvous"))
    finally:
        shutil.rmtree(rdv_dir, ignore_errors=True)


def _launch(run_py, args, world, t_process, rdv):
    env = dict(os.environ)
    # NCCL keeps no segments in /dev/shm: the cards talk over NVLink (P2P)
    env["NCCL_SHM_DISABLE"] = "1"
    procs = []
    for r in range(world):
        cmd = [sys.executable, run_py, "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", str(args.seconds),
               "--trace", str(args.trace), "--rank", str(r),
               "--world", str(world), "--rendezvous", rdv,
               "--t-process", repr(t_process)]
        procs.append(subprocess.Popen(
            cmd, env=dict(env, LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
            text=True))
    out0 = ""
    deadline = time.time() + RANK_TIMEOUT_S
    try:
        out0, _ = procs[0].communicate(timeout=RANK_TIMEOUT_S)
        rcs = [procs[0].returncode]
        for p in procs[1:]:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.time())))
    except subprocess.TimeoutExpired:
        rcs = [None]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(rc != 0 for rc in rcs):
        print(f"ranks exited with {rcs}", file=sys.stderr)
        return None
    lines = [l for l in out0.splitlines() if l.strip()]
    return lines[-1] if lines else None


def rank_group(rank, world, rendezvous):
    """Join the group as ``rank``; the rank's card is cuda:rank."""
    import datetime

    import torch
    import torch.distributed as dist
    from xraytracer_tpu_torch.parallel import make_mesh

    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120),
                            device_id=device)
    return make_mesh(device)
