"""One ``render`` CLI replacing the reference's five example mains.

PyTorch counterpart of ``xraytracer_tpu/cli.py``. The reference ships five
binaries each hard-coding resolution/spp/depth/camera/scene/integrator and
ignoring argv entirely (reference: Src/examples/example.cpp:19-103 etc.;
SURVEY.md §2.3). Here a single entry point selects a preset (or an ``.obj``
file, or a density grid for the cloud presets) and lets every knob be
overridden:

    python -m xraytracer_tpu_torch.cli --preset cornellbox_gi --spp 64 -o out.png

It renders on the card unless ``--device cpu`` is given. On the card a path
integrator over an eligible scene (``integrators/megakernel.py``; the
Cornell presets are) takes the fused whole-render route, one kernel launch
per spp chunk; ``--stats``, ``gi_mis`` and ``--device cpu`` keep the
composable wavefront route. The ``vpt`` preset (one homogeneous box) takes
the whole-render volume kernel in the same way, and ``volume`` and ``nee``
(a heterogeneous cloud under a sphere light) the whole-render heterogeneous
kernel; with ``--stats`` they run the wavefront loop with the two tracking
kernels. The normal, furnace, direct and Whitted integrators (the
``example`` and ``whitted`` presets among them) run the wavefront route:
the record sweep for every hit, the any-hit sweep for every shadow ray.
Every preset, integrator and flag of the JAX package's CLI is here.
``--shard`` splits the pixels over the ranks of ``renderer.default_mesh()``:
a world of one in a plain process; under ``torchrun --nproc-per-node=N``
each rank renders its block of the lanes on ``cuda:LOCAL_RANK``, and rank 0
writes the image and the checkpoint.
"""

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from .camera import PinholeCamera
from .config import PRESETS, get_preset
from .device import resolve_device
from .film import write_image
from .integrators import (
    make_direct_integrator,
    make_furnace_integrator,
    make_normal_integrator,
    make_path_integrator,
    make_volume_integrator,
    make_whitted_integrator,
)
from .renderer import Accumulator, default_mesh, pixel_sharding, render
from .scene import presets as scene_presets
from .scene.builder import SceneBuilder, scene_statics


def build_scene(cfg, device=None, density_grid=None):
    """Preset name (or ``cfg.obj`` path) -> (tables, camera_kwargs).
    ``density_grid``: a ``.npy`` / ``.npz`` dense grid (a path, or the
    array itself) that replaces the procedural cloud of the ``volume`` and
    ``nee`` presets."""
    if cfg.obj:
        from .scene.objloader import load_obj_into

        b = SceneBuilder()
        load_obj_into(b, cfg.obj)
        return b.build(device), scene_presets.cornell_camera()
    if density_grid is not None and cfg.preset in ("volume", "nee"):
        # replace the procedural stand-in cloud with a converted grid
        # (reference analogue: the NanoVDBConvert offline tool feeding
        # examples/volume.cpp)
        loaded = (density_grid if isinstance(density_grid, np.ndarray)
                  else np.load(density_grid))
        if isinstance(loaded, np.lib.npyio.NpzFile):
            key = "density" if "density" in loaded else loaded.files[0]
            loaded = loaded[key]
        kwargs = (
            dict(absorption=(0.01,) * 3, scattering=(0.05,) * 3, le=30.0,
                 light_center=(0.0, 400.0, 0.0))
            if cfg.preset == "nee" else {}
        )
        tables = scene_presets.build_volume_scene(
            density=loaded.astype("float32"), **kwargs
        ).build(device)
        return tables, scene_presets.cloud_camera()
    fn = getattr(scene_presets, f"preset_{cfg.preset}")
    tables, cam_kwargs, _ = fn(device=device)
    return tables, cam_kwargs


def make_integrator(cfg, tables, statics, with_stats=False):
    if cfg.integrator == "normal":
        return make_normal_integrator(tables)
    if cfg.integrator == "furnace":
        return make_furnace_integrator(
            tables, cosine_sampling=cfg.cosine_sampling
        )
    if cfg.integrator == "direct":
        return make_direct_integrator(tables, statics)
    if cfg.integrator == "indirect":
        return make_path_integrator(
            tables, statics, cfg.max_depth, nee=False,
            cosine_sampling=cfg.cosine_sampling, with_stats=with_stats,
        )
    if cfg.integrator == "gi":
        return make_path_integrator(
            tables, statics, cfg.max_depth, nee=True,
            cosine_sampling=cfg.cosine_sampling, with_stats=with_stats,
            nee_mode=cfg.nee_mode,
        )
    if cfg.integrator == "gi_mis":
        return make_path_integrator(
            tables, statics, cfg.max_depth, mis=True,
            cosine_sampling=cfg.cosine_sampling, with_stats=with_stats,
            nee_mode=cfg.nee_mode,
        )
    if cfg.integrator == "whitted":
        return make_whitted_integrator(tables, statics, cfg.max_depth)
    if cfg.integrator in ("vpt", "vpt_nee"):
        return make_volume_integrator(
            tables, statics, cfg.max_depth, nee=cfg.integrator == "vpt_nee",
            max_steps=cfg.max_steps or None, with_stats=with_stats,
        )
    raise ValueError(f"unknown integrator {cfg.integrator!r}")


def print_stats(cfg, result):
    st = result.stats
    n_lanes = cfg.width * cfg.height * cfg.spp
    if "scattered" in st:
        # volume integrators: five counters per iteration
        print(f"[stats] total rays traced: {result.total_rays}"
              f" ({result.total_rays / max(result.seconds, 1e-9) / 1e6:.2f}"
              " Mrays/s)")
        for b in range(len(st["rays"])):
            rays = int(st["rays"][b])
            print(f"[stats] iteration {b}: rays={rays}"
                  f" occupancy={rays / max(n_lanes, 1):.3f}"
                  f" rr_killed={int(st['rr_killed'][b])}"
                  f" emitter_hits={int(st['emitter_hits'][b])}"
                  f" scattered={int(st['scattered'][b])}"
                  f" active_out={int(st['active_out'][b])}")
        return
    print(f"[stats] total rays traced: {result.total_rays}"
          f" ({result.total_rays / max(result.seconds, 1e-9) / 1e6:.2f}"
          " Mrays/s incl. shadow)")
    rays = st["rays"]
    for b in range(len(rays)):
        parts = [f"depth {b}: rays={int(rays[b])}",
                 f"occupancy={int(rays[b]) / max(n_lanes, 1):.3f}"]
        if "shadow_rays" in st:
            parts.append(f"shadow={int(st['shadow_rays'][b])}")
        rr = int(st["rr_killed"][b])
        survivors = int(rays[b]) - rr
        parts.append(f"rr_survival={survivors / max(int(rays[b]), 1):.3f}")
        parts.append(f"active_out={int(st['active_out'][b])}")
        print("[stats] " + " ".join(parts))


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="xraytracer_tpu_torch",
        description="Monte-Carlo path tracer (PyTorch/CUDA port)",
    )
    p.add_argument("--preset", choices=sorted(PRESETS), default="cornellbox")
    p.add_argument("--integrator", default=None,
                   help="normal|furnace|direct|indirect|gi|gi_mis|whitted|"
                        "vpt|vpt_nee")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--max-depth", type=int, default=None, dest="max_depth")
    p.add_argument("--gamma", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--spp-chunk", type=int, default=None, dest="spp_chunk")
    p.add_argument("--nee-mode", default=None, dest="nee_mode",
                   choices=("all", "one", "power"),
                   help="NEE light selection: sum all lights (reference "
                        "semantics), one uniform pick, or power-weighted "
                        "pick (many-light scenes)")
    p.add_argument("--max-steps", type=int, default=None, dest="max_steps",
                   help="tracking-loop step bound for heterogeneous media "
                        "(default: auto from majorant x bbox diagonal)")
    p.add_argument("--cosine", action="store_true", default=None,
                   dest="cosine_sampling",
                   help="cosine-weighted Lambert sampling (lower variance)")
    p.add_argument("--shard", action="store_true", default=None,
                   help="split the pixels over the ranks of the process group "
                        "a launcher (torchrun) set up; a world of one otherwise")
    p.add_argument("--checkpoint", default=None,
                   help=".npz path for chunked accumulation checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--obj", default=None, help="render an .obj scene file")
    p.add_argument("--density-grid", default=None, dest="density_grid",
                   help=".npy / .npz dense density grid for the volume/nee "
                        "presets")
    p.add_argument("--profile", default=None,
                   help="directory for a torch.profiler Chrome trace of the "
                        "render")
    p.add_argument("--stats", action="store_true",
                   help="collect + print per-bounce ray/occupancy/RR metrics"
                        " (SURVEY.md §5; path and volume integrators)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    p.add_argument("-o", "--output", default=None)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_preset(
        args.preset,
        integrator=args.integrator, width=args.width, height=args.height,
        spp=args.spp, max_depth=args.max_depth, gamma=args.gamma,
        seed=args.seed, spp_chunk=args.spp_chunk,
        cosine_sampling=args.cosine_sampling, shard=args.shard,
        checkpoint=args.checkpoint, obj=args.obj, output=args.output,
        nee_mode=args.nee_mode, max_steps=args.max_steps,
    )
    sharding = None
    if cfg.shard:
        # rank r of a launcher's group renders on cuda:LOCAL_RANK
        sharding = pixel_sharding(default_mesh(args.device))
        device = sharding.device
    lead = sharding is None or sharding.rank == 0

    tables, cam_kwargs = build_scene(cfg, device=device,
                                     density_grid=args.density_grid)
    statics = scene_statics(tables)
    camera = PinholeCamera.make(
        cfg.width / cfg.height, device=device, **cam_kwargs
    )
    integrate = make_integrator(cfg, tables, statics, with_stats=args.stats)

    accumulator = None
    if args.resume and cfg.checkpoint and os.path.exists(cfg.checkpoint):
        accumulator = Accumulator.load(cfg.checkpoint, device=device)
        print(f"resuming from {cfg.checkpoint} at spp {accumulator.spp_done}")

    print(
        f"[render] preset={cfg.preset} integrator={cfg.integrator} "
        f"{cfg.width}x{cfg.height} spp={cfg.spp} depth={cfg.max_depth} "
        f"device={device}"
    )
    t0 = time.perf_counter()
    trace_cm = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        trace_cm = profile(activities=activities)
    with trace_cm as prof:
        result = render(
            tables, camera, integrate, cfg.width, cfg.height, cfg.spp,
            seed=cfg.seed, spp_chunk=cfg.spp_chunk or None,
            accumulator=accumulator, checkpoint_path=cfg.checkpoint,
            sharding=sharding,
        )
    if args.profile and lead:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "render.trace.json")
        prof.export_chrome_trace(trace)
        print(f"[render] wrote the profiler trace {trace}")
    print(
        f"[render] done in {result.seconds:.2f}s "
        f"({result.samples_per_sec/1e6:.2f} Msamples/s, "
        f"{result.n_rejected} rejected)"
    )
    if result.stats is not None:
        print_stats(cfg, result)
    if lead:
        write_image(cfg.output, result.image, gamma=cfg.gamma)
        print(f"[render] wrote {cfg.output} (total {time.perf_counter()-t0:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
