"""Port parity: the port's native C++ IO tier (``xraytracer_tpu_torch/native.py``)
and its OBJ loader, against the pure-Python implementations and against the
JAX package.

Every case of ``tests/test_native.py``, run on the port's own build of
``native/xrt_native.cpp`` (in ``xraytracer_tpu_torch/_build/``), plus: the
loader's tables equal the JAX package's, the build lands in the package's
build directory and leaves the committed ``native/libxrt_native.so`` as it
is, ``XRT_NO_NATIVE`` selects the Python writers, and a failed build falls
back with a message on stderr.

Budget: 10 s alone on one thread.
"""

import hashlib
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from test_native import MTL, OBJ
from xraytracer_tpu_torch import _build, film, native
from xraytracer_tpu_torch.convert import tables_to_numpy
from xraytracer_tpu_torch.scene import objloader
from xraytracer_tpu_torch.scene.builder import SceneBuilder

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_SO = os.path.join(REPO, "native", "libxrt_native.so")


@pytest.fixture
def obj_file(tmp_path):
    (tmp_path / "test.mtl").write_text(MTL)
    p = tmp_path / "test.obj"
    p.write_text(OBJ)
    return str(p)


def _lib_or_skip():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def test_native_matches_python_parser(obj_file):
    _lib_or_skip()
    py_shapes, py_mats = objloader.parse_obj(obj_file, use_native=False)
    nat_shapes, nat_mats = native.parse_obj(obj_file)
    assert len(nat_shapes) == len(py_shapes) == 2
    for a, b in zip(py_shapes, nat_shapes):
        assert a["name"] == b["name"]
        assert a["material"] == b["material"]
        np.testing.assert_allclose(a["vertices"], b["vertices"], rtol=1e-6)
        for k in ("normals", "uvs"):
            if a[k] is None:
                assert b[k] is None
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
    assert set(nat_mats) == set(py_mats)
    for k in py_mats:
        np.testing.assert_allclose(nat_mats[k]["Kd"], py_mats[k]["Kd"], rtol=1e-6)
        assert nat_mats[k]["illum"] == py_mats[k]["illum"]
        assert nat_mats[k]["no_surface"] == py_mats[k]["no_surface"]
        np.testing.assert_allclose(nat_mats[k]["Ni"], py_mats[k]["Ni"], rtol=1e-6)


def _decode_png(data):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    off, idat, shape = 8, b"", None
    while off < len(data):
        (ln,) = struct.unpack(">I", data[off:off + 4])
        tag = data[off + 4:off + 8]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", data[off + 8:off + 18])
            assert (depth, ctype) == (8, 2)
            shape = (h, w)
        elif tag == b"IDAT":
            idat += data[off + 8:off + 8 + ln]
        off += 12 + ln
    h, w = shape
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    assert (rows[:, 0] == 0).all()  # filter byte
    return rows[:, 1:].reshape(h, w, 3)


def test_native_png_roundtrip(tmp_path):
    _lib_or_skip()
    img = np.random.default_rng(0).integers(0, 256, (17, 23, 3)).astype(np.uint8)
    p = str(tmp_path / "x.png")
    assert native.write_png(p, img)
    np.testing.assert_array_equal(_decode_png(open(p, "rb").read()), img)


def test_native_ppm(tmp_path):
    _lib_or_skip()
    img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    p = str(tmp_path / "x.ppm")
    assert native.write_ppm(p, img)
    data = open(p, "rb").read()
    assert data.startswith(b"P6\n3 2\n255\n")
    assert data[len(b"P6\n3 2\n255\n"):] == img.tobytes()


def test_cornell_obj_via_builder(tmp_path):
    """An OBJ through load_obj_into produces a renderable scene whichever
    parser ran, with the JAX package's tables."""
    from xraytracer_tpu.scene import objloader as jobjloader
    from xraytracer_tpu.scene.builder import SceneBuilder as JBuilder

    (tmp_path / "test.mtl").write_text(MTL)
    p = tmp_path / "scene.obj"
    p.write_text(OBJ)
    b = SceneBuilder()
    objloader.load_obj_into(b, str(p))
    tables = b.build("cpu")
    assert int((tables.tri_obj >= 0).sum()) == 3  # 2 + 1 tris
    jb = JBuilder()
    jobjloader.load_obj_into(jb, str(p))
    want = {k: np.asarray(v) for k, v in jb.build()._asdict().items()}
    got = tables_to_numpy(tables)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_emissive_from_ke(tmp_path):
    """Shapes with Ke become triangle lights when opted in (the reference's
    dead makeAreaLight, Src/scene.cpp:31-44, made live)."""
    (tmp_path / "m.mtl").write_text(
        "newmtl lamp\nKd 1 1 1\nKe 5 4 3\nnewmtl wall\nKd 0.5 0.5 0.5\n"
    )
    (tmp_path / "s.obj").write_text(
        "mtllib m.mtl\no lamp\nusemtl lamp\n"
        "v 0 2 0\nv 1 2 0\nv 0 2 1\nf 1 2 3\n"
        "o wall\nusemtl wall\nv 0 0 0\nv 1 0 0\nv 0 0 1\nf 4 5 6\n"
    )
    b = SceneBuilder()
    objloader.load_obj_into(b, str(tmp_path / "s.obj"), emissive_from_ke=True)
    t = b.build("cpu")
    assert int((t.al_type >= 0).sum()) == 1
    np.testing.assert_allclose(t.al_le[0].numpy(), [5, 4, 3])
    assert int((t.tri_obj >= 0).sum()) == 2


@pytest.mark.parametrize("face", ["f 1 2 99", "f 0 2 3", "f 1/9/1 2/1/1 3/1/1"])
def test_invalid_face_index_fails_identically(tmp_path, face):
    """A malformed face token raises IndexError from both parsers."""
    p = tmp_path / "bad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvn 0 0 1\n" + face + "\n")
    with pytest.raises(IndexError):
        objloader.parse_obj(str(p), use_native=False)
    if native.get_lib() is not None:
        with pytest.raises(IndexError):
            native.parse_obj(str(p))


def test_build_lands_in_the_package_and_leaves_the_committed_library(tmp_path):
    before = hashlib.sha256(open(COMMITTED_SO, "rb").read()).hexdigest()
    mtime = os.stat(COMMITTED_SO).st_mtime_ns
    _lib_or_skip()
    path = native.build()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.exists(path) and path != COMMITTED_SO
    assert hashlib.sha256(open(COMMITTED_SO, "rb").read()).hexdigest() == before
    assert os.stat(COMMITTED_SO).st_mtime_ns == mtime


def test_no_native_selects_the_python_writers(tmp_path, monkeypatch, capsys):
    """XRT_NO_NATIVE forces the Python tier (ASCII P3 PPM); a failed build
    falls back with a message on stderr."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setenv("XRT_NO_NATIVE", "1")
    img = np.random.default_rng(1).random((4, 5, 3)).astype(np.float32)
    u8 = film.write_image(str(tmp_path / "a.ppm"), img)
    assert open(tmp_path / "a.ppm", "rb").read(2) == b"P3"
    film.write_ppm(str(tmp_path / "b.ppm"), u8)
    assert open(tmp_path / "a.ppm", "rb").read() == open(tmp_path / "b.ppm", "rb").read()
    monkeypatch.delenv("XRT_NO_NATIVE")
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "SOURCE", str(tmp_path / "missing.cpp"))
    assert native.get_lib() is None
    assert "falling back to Python IO" in capsys.readouterr().err
