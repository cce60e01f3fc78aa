"""Built-in scenes reproducing the reference's example workloads.

PyTorch counterpart of ``xraytracer_tpu/scene/presets.py``: the Cornell box,
the example scene and the three volume scenes (vpt, volume, nee).

Each preset mirrors one of the reference's hard-coded example mains
(reference: Src/examples/*.cpp, see SURVEY.md §2.3). Geometry is generated
programmatically from the canonical coordinates (the Cornell box data is the
public Embree/original Cornell data also embedded in the reference's
testdata/cornell_box.obj) rather than parsed from bundled files.

Each ``preset_*`` function returns (tables, camera_kwargs, render_kwargs).
"""

import numpy as np

from ..math import from_rows
from .builder import SceneBuilder

# --- Cornell box quads (canonical data; quad = 4 CCW corners) -------------
# material key -> list of quads
_CORNELL_QUADS = {
    "white": [
        # floor (3 quads: floor slab + two block footprints, original data)
        [(552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2)],
        [(290, 0, 114), (240, 0, 272), (82, 0, 225), (130, 0, 65)],
        [(472, 0, 406), (314, 0, 456), (265, 0, 296), (423, 0, 247)],
        # ceiling
        [(556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0)],
        # back wall
        [(549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2)],
        # short block (5 quads)
        [(130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)],
        [(290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)],
        [(130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)],
        [(82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)],
        [(240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)],
        # tall block (5 quads)
        [(423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)],
        [(423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)],
        [(472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)],
        [(314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)],
        [(265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)],
    ],
    "green": [
        # left wall at x=0
        [(0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2)],
    ],
    "red": [
        # right wall at x~552
        [(552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0)],
    ],
}

_CORNELL_KD = {
    "white": (1.0, 1.0, 1.0),
    "green": (0.0, 1.0, 0.0),
    "red": (1.0, 0.0, 0.0),
}


def _quads_to_tris(quads):
    """Fan-triangulate quads (tinyobj-equivalent: (0,1,2) + (0,2,3))."""
    tris = []
    for q in quads:
        q = [np.asarray(v, np.float32) for v in q]
        tris.append([q[0], q[1], q[2]])
        tris.append([q[0], q[2], q[3]])
    return np.asarray(tris, np.float32)


def build_cornell_box(builder=None):
    """Cornell box walls + blocks + the overhead quad light
    (reference: Src/examples/cornellbox.cpp:36-47)."""
    b = builder or SceneBuilder()
    for key, quads in _CORNELL_QUADS.items():
        b.add_mesh(_quads_to_tris(quads), material=b.add_lambert(_CORNELL_KD[key]))
    b.add_quad_light(
        (343.0, 548.0, 227.0),
        (343.0, 548.0, 332.0),
        (213.0, 548.0, 227.0),
        25.0 * np.ones(3, np.float32),
    )
    return b


def cornell_camera():
    """(reference: Src/examples/cornellbox.cpp:27-35)"""
    c2w = from_rows(
        -1.0, 0, 0, 0,
        0, 1.0, 0, 0,
        0, 0, -1.0, 0,
        278, 274.4, -750.0, 1,
    )
    return dict(c2w=c2w, fov_deg=60.0)


def preset_cornellbox(device=None):
    tables = build_cornell_box().build(device)
    return (
        tables,
        cornell_camera(),
        dict(width=780, height=585, spp=16, max_depth=3, gamma=1.2),
    )


def build_example_scene():
    """Cube-over-plane + analytic diffuse sphere + distant & point lights
    (reference: Src/examples/example.cpp:45-72). The cube.obj's cube faces are
    commented out in the data; only the ground plane has faces."""
    b = SceneBuilder()
    mat = b.add_lambert((0.58, 0.58, 0.58))
    plane = [
        [(15.0, -2.2, 15.0), (15.0, -2.2, -15.0), (-15.0, -2.2, -15.0),
         (-15.0, -2.2, 15.0)]
    ]
    b.add_mesh(_quads_to_tris(plane), material=mat)
    b.add_sphere((0.0, 0.0, 0.0), 1.0, material=mat)
    # distant light: travel dir = (0,0,-1) rows-transformed by l2w, taken
    # in float32 from the float32 matrix
    l2w = np.array(
        [
            [0.95292, 0.289503, 0.0901785],
            [-0.0960954, 0.5704, -0.815727],
            [-0.287593, 0.768656, 0.571365],
        ],
        np.float32,
    )
    d = -l2w[2]  # (0,0,-1) @ rot
    b.add_distant_light(d, (1.0, 1.0, 1.0), 1.0)
    b.add_point_light((5.0, 5.0, -1.0), (0.63, 0.33, 0.03), 50.0)
    return b


def preset_example(device=None):
    tables = build_example_scene().build(device)
    c2w = from_rows(
        1.0, 0, 0, 0,
        0, 1.0, 0, 0,
        0, 0, 1.0, 0,
        0, 0, 8.0, 1,
    )
    return (
        tables,
        dict(c2w=c2w, fov_deg=60.0),
        dict(width=780, height=585, spp=16, max_depth=3, gamma=1.2),
    )


def build_vpt_scene(variant="mis", g=0.0):
    """Homogeneous unit box + overhead quad light
    (reference: Src/examples/vpt.cpp:47-71). ``g`` is the medium's phase
    asymmetry: the reference's 0, or another value to reach the
    Henyey-Greenstein branch of the scattered direction."""
    b = SceneBuilder()
    b.add_homogeneous_medium(
        g, (0.5, 0.5, 0.5), (0.5, 0.5, 0.5),
        (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), variant=variant,
    )
    b.add_quad_light(
        (0.5, 1.4, 0.5), (-0.5, 1.4, 0.5), (0.5, 1.4, -0.5),
        10.0 * np.ones(3, np.float32),
    )
    return b


def preset_vpt(device=None):
    tables = build_vpt_scene().build(device)
    c2w = from_rows(
        1.0, 0, 0, 0,
        0, 1.0, 0, 0,
        0, 0, 1.0, 0,
        0, 0, 5.0, 1,
    )
    fov = 2.0 * 180.0 * np.arctan(1.0 / 3.0) / np.pi
    return (
        tables,
        dict(c2w=c2w, fov_deg=fov),
        dict(width=512, height=512, spp=1024, max_depth=10, gamma=2.2),
    )


def procedural_cloud(res=(64, 64, 64), seed=0):
    """Deterministic value-noise puff standing in for the reference's
    wdas_cloud OpenVDB asset (not redistributable; Src/examples/volume.cpp:46).
    Returns a dense (res) float32 density field in [0, 1]."""
    rng = np.random.default_rng(seed)
    density = np.zeros(res, np.float32)
    # sum of a few octaves of smoothed random lattices
    for octave, amp in ((4, 1.0), (8, 0.5), (16, 0.25)):
        lattice = rng.random((octave, octave, octave)).astype(np.float32)
        zoom = [r // octave + 1 for r in res]
        up = np.kron(lattice, np.ones(zoom, np.float32))[
            : res[0], : res[1], : res[2]
        ]
        # cheap trilinear-ish smoothing
        for ax in range(3):
            up = (up + np.roll(up, 1, ax) + np.roll(up, -1, ax)) / 3.0
        density += amp * up
    density /= density.max()
    # carve an ellipsoid falloff so it looks like a puff and has empty space
    g = np.stack(
        np.meshgrid(*[np.linspace(-1, 1, r) for r in res], indexing="ij")
    )
    r2 = (g**2).sum(0)
    density = density * np.clip(1.0 - r2, 0.0, 1.0)
    density[density < 0.1] = 0.0
    return density.astype(np.float32)


def build_volume_scene(res=(64, 64, 64), absorption=(0.5, 0.5, 0.5),
                       scattering=(0.5, 0.5, 0.5), le=10.0,
                       light_center=(0.0, 380.0, 0.0), light_radius=50.0,
                       density=None):
    """Heterogeneous cloud + sphere light (reference: Src/examples/volume.cpp:
    43-58), with the procedural cloud in place of the VDB asset (pass
    ``density`` — e.g. np.load of a converted grid — to use real data). The
    grid is scaled to the wdas-quarter-cloud's approximate world extent."""
    b = SceneBuilder()
    if density is None:
        density = procedural_cloud(res)
    bmin = np.array([-165.0, -110.0, -160.0], np.float32)
    bmax = np.array([165.0, 110.0, 160.0], np.float32)
    b.set_density_grid(density, bmin, bmax)
    b.add_heterogeneous_medium(0.0, absorption, scattering)
    b.add_sphere_light(light_center, light_radius, le * np.ones(3, np.float32))
    return b


def cloud_camera():
    """The camera of the cloud presets (volume, nee) and of ``--density-grid``."""
    c2w = from_rows(
        1.0, 0, 0, 0,
        0, 1.0, 0, 0,
        0, 0, 1.0, 0,
        0, 70.0, 550.0, 1,
    )
    return dict(c2w=c2w, fov_deg=60.0)


def preset_volume(device=None):
    tables = build_volume_scene().build(device)
    return (
        tables,
        cloud_camera(),
        dict(width=512, height=512, spp=10240, max_depth=100, gamma=2.2),
    )


def preset_nee(device=None):
    tables = build_volume_scene(
        absorption=(0.01, 0.01, 0.01), scattering=(0.05, 0.05, 0.05),
        le=30.0, light_center=(0.0, 400.0, 0.0),
    ).build(device)
    return (
        tables,
        cloud_camera(),
        dict(width=780, height=585, spp=1024, max_depth=32, gamma=2.2),
    )
