"""Wavefront OBJ + MTL loader (host-side).

PyTorch-package counterpart of ``xraytracer_tpu/scene/objloader.py`` (the
port's own copy: importing that module would import the JAX package), and of
the reference's tinyObjLoader-based ``Scene::loadObj``
(reference: Src/scene.cpp:46-155): triangulates polygons (fan, like
tinyobj's triangulate flag), synthesizes flat normals when absent and
barycentric uvs when absent (Src/scene.cpp:123-137), groups one object per
``o`` shape, and maps materials with the same rules as ``makeMaterial``
(Src/scene.cpp:9-29): ``no_surface`` -> no material; illum 5 (mirror) and
illum 7 (glass) fall through to Lambert unless ``enable_specular`` — the
reference has those branches commented out; we make them real but opt-in.
"""

import os

import numpy as np


def parse_mtl(path):
    mats = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "newmtl":
                cur = tok[1]
                mats[cur] = {
                    "Kd": (1.0, 1.0, 1.0),
                    "Ke": (0.0, 0.0, 0.0),
                    "Ni": 1.0,
                    "illum": 2,
                    "no_surface": False,
                }
            elif cur is None:
                continue
            elif tok[0] == "Kd":
                mats[cur]["Kd"] = tuple(float(x) for x in tok[1:4])
            elif tok[0] == "Ke":
                mats[cur]["Ke"] = tuple(float(x) for x in tok[1:4])
            elif tok[0] == "Ni":
                mats[cur]["Ni"] = float(tok[1])
            elif tok[0] == "illum":
                mats[cur]["illum"] = int(tok[1])
            elif tok[0] == "no_surface":
                mats[cur]["no_surface"] = True
    return mats


def _resolve(idx, n):
    """OBJ 1-based / negative-relative index -> 0-based."""
    return idx - 1 if idx > 0 else n + idx


def parse_obj(path, use_native=True):
    """Parse an OBJ file into shapes.

    Returns (shapes, materials): shapes is a list of dicts with keys
    ``name``, ``material`` (name or None), ``vertices`` (T,3,3),
    ``normals`` (T,3,3) or None, ``uvs`` (T,3,2) or None.

    Uses the native C++ parser (``native.py``) when available; this Python
    implementation is the semantics-defining fallback.
    """
    if use_native:
        from .. import native

        out = native.parse_obj(path) if os.path.exists(path) else None
        if out is not None:
            return out
    vs, vns, vts = [], [], []
    materials = {}
    shapes = []
    cur = None

    def new_shape(name):
        nonlocal cur
        cur = {"name": name, "material": None, "faces": []}
        shapes.append(cur)

    with open(path, encoding="utf-8-sig") as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            cmd = tok[0]
            if cmd == "v":
                vs.append([float(x) for x in tok[1:4]])
            elif cmd == "vn":
                vns.append([float(x) for x in tok[1:4]])
            elif cmd == "vt":
                vts.append([float(x) for x in tok[1:3]])
            elif cmd == "mtllib":
                materials.update(
                    parse_mtl(os.path.join(os.path.dirname(path), tok[1]))
                )
            elif cmd in ("o", "g"):
                new_shape(tok[1] if len(tok) > 1 else f"shape{len(shapes)}")
            elif cmd == "usemtl":
                if cur is None:
                    new_shape(f"shape{len(shapes)}")
                if cur["material"] is None:
                    cur["material"] = tok[1]
            elif cmd == "f":
                if cur is None:
                    new_shape(f"shape{len(shapes)}")
                corners = []
                for w in tok[1:]:
                    parts = w.split("/")
                    vi = _resolve(int(parts[0]), len(vs))
                    ti = (
                        _resolve(int(parts[1]), len(vts))
                        if len(parts) > 1 and parts[1]
                        else -1
                    )
                    ni = (
                        _resolve(int(parts[2]), len(vns))
                        if len(parts) > 2 and parts[2]
                        else -1
                    )
                    corners.append((vi, ti, ni))
                # fan triangulation (tinyobj triangulate flag equivalent)
                for k in range(1, len(corners) - 1):
                    cur["faces"].append(
                        (corners[0], corners[k], corners[k + 1])
                    )

    out = []
    vs = np.asarray(vs, np.float32)
    vns = np.asarray(vns, np.float32) if vns else np.zeros((0, 3), np.float32)
    vts = np.asarray(vts, np.float32) if vts else np.zeros((0, 2), np.float32)
    for sh in shapes:
        if not sh["faces"]:
            continue  # faceless shapes are dropped (cornell_box 'light' etc.)
        t = len(sh["faces"])
        verts = np.zeros((t, 3, 3), np.float32)
        norms = np.zeros((t, 3, 3), np.float32)
        uvs = np.zeros((t, 3, 2), np.float32)
        has_n = all(c[2] >= 0 for f in sh["faces"] for c in f)
        has_t = all(c[1] >= 0 for f in sh["faces"] for c in f)
        for i, face in enumerate(sh["faces"]):
            for j, (vi, ti, ni) in enumerate(face):
                verts[i, j] = vs[vi]
                if has_n:
                    norms[i, j] = vns[ni]
                if has_t:
                    uvs[i, j] = vts[ti]
        out.append(
            {
                "name": sh["name"],
                "material": sh["material"],
                "vertices": verts,
                "normals": norms if has_n else None,
                "uvs": uvs if has_t else None,
            }
        )
    return out, materials


def load_obj_into(builder, path, enable_specular=False, emissive_from_ke=False):
    """Load an OBJ file into a SceneBuilder, mapping materials like the
    reference's ``makeMaterial`` (Src/scene.cpp:9-29).

    ``emissive_from_ke``: shapes whose material has a nonzero Ke become
    triangle area lights — the reference's ``makeAreaLight`` exists but is
    never called (dead code at Src/scene.cpp:31-44); here it is a live
    opt-in."""
    shapes, materials = parse_obj(path)
    mat_ids = {}

    def get_mat(name):
        if name in mat_ids:
            return mat_ids[name]
        spec = materials.get(name)
        if spec is None:
            mid = builder.add_lambert((1.0, 1.0, 1.0))
        elif spec["no_surface"]:
            mid = -1
        elif enable_specular and spec["illum"] == 5:
            mid = builder.add_mirror()
        elif enable_specular and spec["illum"] == 7:
            mid = builder.add_glass(ior=spec["Ni"])
        else:
            mid = builder.add_lambert(spec["Kd"])
        mat_ids[name] = mid
        return mid

    objs = []
    for sh in shapes:
        spec = materials.get(sh["material"]) if sh["material"] else None
        ke = spec["Ke"] if spec else (0.0, 0.0, 0.0)
        if emissive_from_ke and any(k > 0 for k in ke):
            for tri in np.asarray(sh["vertices"]):
                objs.append(
                    builder.add_triangle_light(tri[0], tri[1], tri[2], ke)
                )
            continue
        objs.append(
            builder.add_mesh(
                sh["vertices"],
                sh["normals"],
                sh["uvs"],
                material=get_mat(sh["material"]),
            )
        )
    return objs

