"""Dataclass render configs + named presets.

PyTorch counterpart of ``xraytracer_tpu/config.py`` (same fields, same
presets) and of the reference's compile-time-only configuration: every
scene/render parameter there is hard-coded in one of five example mains
with CMake feature defines (reference: Src/examples/*.cpp,
Src/cmakelists.txt:57-65; SURVEY.md §5 "Config / flag system"). Here one
``RenderConfig`` + named presets reproduce each example workload, and the
CLI overrides any field. Presets whose scene or integrator is not ported
yet are listed all the same; the CLI says which ROADMAP item they wait for.
"""

from dataclasses import dataclass, replace
from typing import Optional


@dataclass
class RenderConfig:
    preset: str = "cornellbox"
    integrator: str = "gi"     # normal|direct|indirect|gi|whitted|vpt|vpt_nee
    width: int = 780
    height: int = 585
    spp: int = 16
    max_depth: int = 3
    gamma: float = 1.2
    seed: int = 0
    spp_chunk: int = 0          # 0 = all spp in one chunk
    cosine_sampling: bool = False  # lower-variance Lambert sampling
    nee_mode: str = "all"       # all|one|power — NEE light-selection strategy
    max_steps: int = 0          # tracking-loop bound; 0 = auto from majorant x bbox diagonal
    shard: bool = False         # shard pixels over all local devices
    checkpoint: Optional[str] = None
    output: str = "render.png"
    obj: Optional[str] = None   # render an .obj file instead of a preset


# The reference's five example binaries as presets (SURVEY.md §2.3).
# integrator choices follow what each main actually instantiates.
PRESETS = {
    "example": RenderConfig(
        preset="example", integrator="normal",
        width=780, height=585, spp=16, max_depth=3, gamma=1.2,
    ),
    "cornellbox": RenderConfig(
        preset="cornellbox", integrator="normal",
        width=780, height=585, spp=16, max_depth=3, gamma=1.2,
    ),
    # the shipped-in-comments GI config — the north-star workload
    "cornellbox_gi": RenderConfig(
        preset="cornellbox", integrator="gi",
        width=780, height=585, spp=512, max_depth=3, gamma=1.2,
    ),
    "vpt": RenderConfig(
        preset="vpt", integrator="vpt",
        width=512, height=512, spp=1024, max_depth=10, gamma=2.2,
    ),
    "volume": RenderConfig(
        preset="volume", integrator="vpt",
        width=512, height=512, spp=10240, max_depth=100, gamma=2.2,
    ),
    "nee": RenderConfig(
        preset="nee", integrator="vpt_nee",
        width=780, height=585, spp=1024, max_depth=32, gamma=2.2,
    ),
    "whitted": RenderConfig(
        preset="example", integrator="whitted",
        width=780, height=585, spp=16, max_depth=3, gamma=1.2,
    ),
}


def get_preset(name: str, **overrides) -> RenderConfig:
    cfg = PRESETS[name]
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return replace(cfg, **overrides)
