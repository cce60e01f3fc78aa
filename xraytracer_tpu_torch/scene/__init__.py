from .tables import (
    SceneTables,
    MAT_LAMBERT,
    MAT_MIRROR,
    MAT_GLASS,
    AL_TRIANGLE,
    AL_QUAD,
    AL_SPHERE,
    DL_POINT,
    DL_DISTANT,
    MED_HOMOG_MIS,
    MED_HOMOG_ACHROMATIC,
    MED_HOMOG_NOMIS,
    MED_HETEROGENEOUS,
    rejoin_appearance,
)
from .builder import SceneBuilder, scene_statics
from . import presets

__all__ = [
    "SceneTables",
    "SceneBuilder",
    "scene_statics",
    "rejoin_appearance",
    "presets",
    "MAT_LAMBERT",
    "MAT_MIRROR",
    "MAT_GLASS",
    "AL_TRIANGLE",
    "AL_QUAD",
    "AL_SPHERE",
    "DL_POINT",
    "DL_DISTANT",
    "MED_HOMOG_MIS",
    "MED_HOMOG_ACHROMATIC",
    "MED_HOMOG_NOMIS",
    "MED_HETEROGENEOUS",
]
