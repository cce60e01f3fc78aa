"""One ``render`` CLI replacing the reference's five example mains.

PyTorch counterpart of ``xraytracer_tpu/cli.py``. The reference ships five
binaries each hard-coding resolution/spp/depth/camera/scene/integrator and
ignoring argv entirely (reference: Src/examples/example.cpp:19-103 etc.;
SURVEY.md §2.3). Here a single entry point selects a preset and lets every
knob be overridden:

    python -m xraytracer_tpu_torch.cli --preset cornellbox_gi --spp 64 -o out.png

It renders on the card unless ``--device cpu`` is given. On the card a path
integrator over an eligible scene (``integrators/megakernel.py``; the
Cornell presets are) takes the fused whole-render route, one kernel launch
per spp chunk; ``--stats``, ``gi_mis`` and ``--device cpu`` keep the
composable wavefront route. The ``vpt`` preset (one homogeneous box) takes
the whole-render volume kernel in the same way, and ``volume`` and ``nee``
(a heterogeneous cloud under a sphere light) the whole-render heterogeneous
kernel; with ``--stats`` they run the wavefront loop with the two tracking
kernels.
Presets and integrators that are not ported yet raise ``NotImplementedError`` naming
the ROADMAP.md item they wait for.
"""

import argparse
import os
import sys
import time

from .camera import PinholeCamera
from .config import PRESETS, get_preset
from .device import resolve_device
from .film import write_image
from .integrators import (
    make_normal_integrator,
    make_path_integrator,
    make_volume_integrator,
)
from .renderer import Accumulator, render
from .scene import presets as scene_presets
from .scene.builder import scene_statics

# integrator / preset -> the ROADMAP.md item that ports it
_WAITING_INTEGRATORS = {
    "furnace": "queue 1, direct/furnace/Whitted integrators and delta lights",
    "direct": "queue 1, direct/furnace/Whitted integrators and delta lights",
    "whitted": "queue 1, direct/furnace/Whitted integrators and delta lights",
}
_WAITING_PRESETS = {
    "example": "queue 1, direct/furnace/Whitted integrators and delta lights",
}


def build_scene(cfg, device=None):
    """Preset name -> (tables, camera_kwargs)."""
    if cfg.obj:
        raise NotImplementedError(
            "--obj is not ported yet (ROADMAP.md: objloader.py and the "
            "ctypes IO tier)"
        )
    if cfg.preset in _WAITING_PRESETS:
        raise NotImplementedError(
            f"preset scene {cfg.preset!r} is not ported yet "
            f"(ROADMAP.md: {_WAITING_PRESETS[cfg.preset]})"
        )
    fn = getattr(scene_presets, f"preset_{cfg.preset}")
    tables, cam_kwargs, _ = fn(device=device)
    return tables, cam_kwargs


def make_integrator(cfg, tables, statics, with_stats=False):
    if cfg.integrator == "normal":
        return make_normal_integrator(tables)
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
    if cfg.integrator in ("vpt", "vpt_nee"):
        return make_volume_integrator(
            tables, statics, cfg.max_depth, nee=cfg.integrator == "vpt_nee",
            max_steps=cfg.max_steps or None, with_stats=with_stats,
        )
    if cfg.integrator in _WAITING_INTEGRATORS:
        raise NotImplementedError(
            f"integrator {cfg.integrator!r} is not ported yet "
            f"(ROADMAP.md: {_WAITING_INTEGRATORS[cfg.integrator]})"
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
                   help="normal|gi|gi_mis|indirect|vpt|vpt_nee")
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
    p.add_argument("--checkpoint", default=None,
                   help=".npz path for chunked accumulation checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
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
        cosine_sampling=args.cosine_sampling,
        checkpoint=args.checkpoint, output=args.output,
        nee_mode=args.nee_mode, max_steps=args.max_steps,
    )

    tables, cam_kwargs = build_scene(cfg, device=device)
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
    result = render(
        tables, camera, integrate, cfg.width, cfg.height, cfg.spp,
        seed=cfg.seed, spp_chunk=cfg.spp_chunk or None,
        accumulator=accumulator, checkpoint_path=cfg.checkpoint,
    )
    print(
        f"[render] done in {result.seconds:.2f}s "
        f"({result.samples_per_sec/1e6:.2f} Msamples/s, "
        f"{result.n_rejected} rejected)"
    )
    if result.stats is not None:
        print_stats(cfg, result)
    write_image(cfg.output, result.image, gamma=cfg.gamma)
    print(f"[render] wrote {cfg.output} (total {time.perf_counter()-t0:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
