"""The system under test, driven as a user drives it: the scene built by the
port's ``SceneBuilder`` from the configuration's data, the camera and the
integrator of its preset, and ``renderer.render`` once per frame. Also the
port's launch counters, read around the window."""

import importlib

import numpy as np

# the modules that count their kernels' launches and plain-version calls
COUNTER_MODULES = (
    "xraytracer_tpu_torch.integrators.megakernel",
    "xraytracer_tpu_torch.integrators.het_megakernel",
    "xraytracer_tpu_torch.integrators.vol_megakernel",
    "xraytracer_tpu_torch.media_kernels",
    "xraytracer_tpu_torch.geometry.kernels",
)


# the keys a configuration's ``scene`` may hold, built in this order
SCENE_KEYS = ("meshes", "density_grid", "media", "quad_lights", "sphere_lights")


def _add_heterogeneous(b, med):
    b.add_heterogeneous_medium(float(med["g"]), med["absorption"], med["scattering"])


def _add_homogeneous(b, med):
    b.add_homogeneous_medium(float(med["g"]), med["absorption"], med["scattering"],
                             med["bmin"], med["bmax"])


# a medium's ``kind``: how ``SceneBuilder`` adds it, and the keys it reads
MEDIA = {"heterogeneous": _add_heterogeneous, "homogeneous": _add_homogeneous}
MEDIUM_KEYS = {"heterogeneous": {"kind", "g", "absorption", "scattering"},
               "homogeneous": {"kind", "g", "absorption", "scattering", "bmin", "bmax"}}


def _gi(tables, statics, r):
    from xraytracer_tpu_torch.integrators import make_path_integrator

    return make_path_integrator(
        tables, statics, int(r["max_depth"]), nee=True,
        cosine_sampling=bool(r.get("cosine_sampling", False)),
        nee_mode=r.get("nee_mode", "all"))


def _volume(nee):
    def make(tables, statics, r):
        from xraytracer_tpu_torch.integrators import make_volume_integrator

        return make_volume_integrator(tables, statics, int(r["max_depth"]), nee=nee,
                                      max_steps=None)
    return make


# ``render.integrator``: the port's estimator it names
INTEGRATORS = {"gi": _gi, "vpt": _volume(False), "vpt_nee": _volume(True)}


def build_scene(config, grid, device):
    """(tables, statics, camera, integrator) of the configuration. Raises on
    a scene key, medium kind or integrator this harness does not know."""
    from xraytracer_tpu_torch.camera import PinholeCamera
    from xraytracer_tpu_torch.math import from_rows
    from xraytracer_tpu_torch.scene.builder import SceneBuilder, scene_statics

    sc = config["scene"]
    r = config["render"]
    unknown = sorted(set(sc) - set(SCENE_KEYS))
    if unknown:
        raise ValueError(f"unknown scene keys {unknown}")
    if r["integrator"] not in INTEGRATORS:
        raise ValueError(f"unknown integrator {r['integrator']!r}")
    for med in sc.get("media", []):
        if med["kind"] not in MEDIA:
            raise ValueError(f"unknown medium kind {med['kind']!r}")
        if set(med) - MEDIUM_KEYS[med["kind"]]:
            raise ValueError(f"unknown medium keys {sorted(set(med) - MEDIUM_KEYS[med['kind']])}")
    b = SceneBuilder()
    for mesh in sc.get("meshes", []):
        tris = []
        for q in mesh["quads"]:
            q = [np.asarray(v, np.float32) for v in q]
            tris += [[q[0], q[1], q[2]], [q[0], q[2], q[3]]]
        b.add_mesh(np.asarray(tris, np.float32),
                   material=b.add_lambert(tuple(mesh["albedo"])))
    if grid is not None:
        spec = sc["density_grid"]
        b.set_density_grid(grid, np.asarray(spec["bmin"], np.float32),
                           np.asarray(spec["bmax"], np.float32))
    for med in sc.get("media", []):
        MEDIA[med["kind"]](b, med)
    for ql in sc.get("quad_lights", []):
        b.add_quad_light(ql["v0"], ql["v1"], ql["v2"],
                         np.asarray(ql["le"], np.float32))
    for sl in sc.get("sphere_lights", []):
        b.add_sphere_light(sl["center"], float(sl["radius"]),
                           np.asarray(sl["le"], np.float32))
    tables = b.build(device)
    statics = scene_statics(tables)
    cam = config["camera"]
    camera = PinholeCamera.make(r["width"] / r["height"], device=device,
                                c2w=from_rows(*cam["c2w"]),
                                fov_deg=float(cam["fov_deg"]))
    return tables, statics, camera, INTEGRATORS[r["integrator"]](tables, statics, r)


def reset_counts():
    for name in COUNTER_MODULES:
        importlib.import_module(name).reset_counts()


def counts():
    """{kernel: (launches, plain calls)} over every counting module."""
    out = {}
    for name in COUNTER_MODULES:
        for k, v in importlib.import_module(name).counts().items():
            out[k] = (v["launches"], v["plain_calls"])
    return out
