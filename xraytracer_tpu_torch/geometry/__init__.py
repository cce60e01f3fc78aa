from .types import Rays, Hit, miss_hit
from .intersect import (
    intersect_scene,
    intersect_triangles,
    intersect_triangles_mm,
    intersect_spheres,
    intersect_boxes,
    occluded,
    TRI_CHUNK,
)

__all__ = [
    "Rays",
    "Hit",
    "miss_hit",
    "intersect_scene",
    "intersect_triangles",
    "intersect_triangles_mm",
    "intersect_spheres",
    "intersect_boxes",
    "occluded",
    "TRI_CHUNK",
]
