"""The port as a package: it imports without jax, without the JAX package,
without nvcc, triton or a card; its entry points run on the card unless
asked for the CPU; a kernel wrapper given CPU tensors takes the plain
version."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import xraytracer_tpu_torch
from xraytracer_tpu_torch import _build, cli, config, film
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.device import resolve_device
from xraytracer_tpu_torch.geometry import kernels
from xraytracer_tpu_torch.integrators import make_path_integrator
from xraytracer_tpu_torch.renderer import Accumulator, pixel_grid, render
from xraytracer_tpu_torch.scene.builder import scene_statics
from xraytracer_tpu_torch.scene.presets import build_cornell_box, cornell_camera

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _submodules():
    names = ["xraytracer_tpu_torch"]
    for m in pkgutil.walk_packages(xraytracer_tpu_torch.__path__,
                                   "xraytracer_tpu_torch."):
        names.append(m.name)
    return sorted(names)


def test_every_submodule_imports_without_jax():
    names = _submodules()
    for expected in ("geometry.kernels", "geometry.intersect", "sampling.rng",
                     "scene.builder", "integrators.surface", "renderer", "cli",
                     "convert", "_build", "film", "config", "camera"):
        assert f"xraytracer_tpu_torch.{expected}" in names
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'xraytracer_tpu'"
        " or m.startswith('xraytracer_tpu.') or m == 'triton']\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_sources_name_neither_jax_import_nor_jax_package():
    """No file of the port (nor chip_smoke.py) imports jax or the JAX
    package; docstrings may name the counterpart module."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fns in os.walk(os.path.join(ROOT, "xraytracer_tpu_torch")):
        files += [os.path.join(d, f) for f in fns if f.endswith(".py")]
    assert len(files) > 25
    for path in files:
        with open(path) as f:
            for line in f:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1]
                    assert mod.split(".")[0] not in ("jax", "jaxlib", "xraytracer_tpu"), (path, s)


def test_kernels_module_needs_no_compiler_or_card():
    assert kernels.KERNEL_NAMES == (
        "sweep_nearest", "sweep_nearest_rec", "occluded_anyhit", "chunk_boxes")
    assert set(kernels._ARGTYPES) == set(kernels.KERNEL_NAMES)
    assert _build._loaded == {}  # nothing was built or loaded at import
    srcs = sorted(os.listdir(_build.CSRC_DIR))
    assert "sweep.cu" in srcs and "common.cuh" in srcs
    text = open(os.path.join(_build.CSRC_DIR, "sweep.cu")).read()
    for fn in kernels.KERNEL_NAMES:
        assert f"int {fn}(" in text
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    a = _build.library_path("sweep")
    assert a == _build.library_path("sweep")
    assert os.path.basename(a).startswith("libsweep_") and a.endswith(".so")
    assert a.startswith(_build.BUILD_DIR)


def test_wrapper_on_cpu_tensors_takes_plain_version():
    rng = np.random.default_rng(0)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    o, d, v0, e1, e2 = t(50, 3), t(50, 3), t(16, 3), t(16, 3), t(16, 3)
    valid = torch.ones((16,), dtype=torch.bool)
    rec = t(16, 32)
    kernels.reset_counts()
    out = kernels.sweep_nearest(o, d, v0, e1, e2, valid)
    out_rec = kernels.sweep_nearest_rec(o, d, v0, e1, e2, valid, rec)
    blk = kernels.occluded_anyhit(o, d, v0, e1, e2, valid, torch.full((50,), 9.0))
    boxes, coef = kernels.chunk_boxes(v0, e1, e2, valid, kernels._center(v0))
    assert boxes.shape == (2, 8) and coef.shape == (kernels.SWEEP_CHUNK, 16)
    assert kernels.counts() == {
        n: {"launches": 0, "plain_calls": 1} for n in kernels.KERNEL_NAMES}
    assert out[1].dtype == torch.int32 and blk.dtype == torch.bool
    assert out_rec[4].shape == (50, 32)
    assert torch.equal(out[1], out_rec[1])
    kernels.reset_counts()
    assert all(c == {"launches": 0, "plain_calls": 0}
               for c in kernels.counts().values())


def test_table_centroid_is_reduced_once_per_table():
    """The wrappers keep the last table's centroid: the same tensor gives
    the same object back, another tensor or an in-place write reduces anew."""
    v0 = torch.as_tensor(np.random.default_rng(1).normal(size=(40, 3)).astype(np.float32))
    c = kernels._center(v0)
    assert torch.equal(c, torch.mean(v0, dim=0))
    assert kernels._center(v0) is c
    v0 += 1.0
    c2 = kernels._center(v0)
    assert c2 is not c and torch.equal(c2, torch.mean(v0, dim=0))
    other = v0.clone()
    assert kernels._center(other) is not c2
    assert torch.equal(kernels._center(torch.zeros((0, 3))), torch.zeros(3))


def test_wrapper_input_checks_raise():
    f = torch.zeros((4, 3))
    ok = torch.ones((4,), dtype=torch.bool)
    dev = f.device
    with pytest.raises(TypeError):
        kernels._check("o", f.double(), torch.float32, (4, 3), dev)
    with pytest.raises(ValueError):
        kernels._check("o", f, torch.float32, (5, 3), dev)
    with pytest.raises(ValueError):
        kernels._check("o", torch.zeros((3, 4)).T, torch.float32, (4, 3), dev)
    with pytest.raises(TypeError):
        kernels._check("o", np.zeros((4, 3)), torch.float32, (4, 3), dev)
    n, t_total, m8 = kernels._check_sweep_inputs(f, f, f, f, f, ok)
    assert (n, t_total) == (4, 4) and m8.dtype == torch.uint8
    with pytest.raises(TypeError):
        kernels._check_sweep_inputs(f, f, f, f, f, ok.to(torch.int32))


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    b = build_cornell_box()
    with pytest.raises(RuntimeError):
        b.build()
    with pytest.raises(RuntimeError):
        PinholeCamera.make(1.0, **cornell_camera())
    with pytest.raises(RuntimeError):
        pixel_grid(4, 4)
    with pytest.raises(RuntimeError):
        Accumulator(4, 4)
    with pytest.raises(RuntimeError):
        cli.main(["--preset", "cornellbox_gi", "--spp", "1"])
    # with device="cpu" the same calls run
    tables = b.build(device="cpu")
    cam = PinholeCamera.make(4 / 3, device="cpu", **cornell_camera())
    r = render(tables, cam,
               make_path_integrator(tables, scene_statics(tables), 2), 8, 6, 1)
    assert r.image.shape == (6, 8, 3) and np.isfinite(r.image).all()
    with pytest.raises(ValueError):  # scene and camera must share a device
        render(tables, cam._replace(c2w=cam.c2w.to("meta")), None, 8, 6, 1)


def test_cli_renders_on_cpu_and_names_roadmap_for_the_rest(tmp_path, capsys):
    out = str(tmp_path / "o.png")
    ck = str(tmp_path / "ck.npz")
    args = ["--preset", "cornellbox_gi", "--width", "16", "--height", "12",
            "--max-depth", "2", "--device", "cpu", "--stats", "--cosine",
            "--nee-mode", "one", "--checkpoint", ck, "--spp-chunk", "1", "-o", out]
    assert cli.main(args + ["--spp", "1"]) == 0
    assert cli.main(args + ["--spp", "2", "--resume"]) == 0
    text = capsys.readouterr().out
    assert "resuming from" in text and "[stats] total rays traced" in text
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert cli.main(["--preset", "cornellbox", "--width", "8", "--height", "6",
                     "--spp", "1", "--device", "cpu",
                     "-o", str(tmp_path / "n.ppm")]) == 0
    # write_image takes the native tier's writers when they load (binary
    # P6), as the JAX package's does: the same bytes for the same image
    from xraytracer_tpu import film as jfilm
    from xraytracer_tpu_torch import native

    magic = b"P6" if native.get_lib() is not None else b"P3"
    assert open(tmp_path / "n.ppm", "rb").read(2) == magic
    img = np.random.default_rng(2).random((6, 8, 3)).astype(np.float32)
    film.write_image(str(tmp_path / "p.ppm"), img, gamma=1.0)
    jfilm.write_image(str(tmp_path / "j.ppm"), img, gamma=1.0)
    assert open(tmp_path / "p.ppm", "rb").read() == open(tmp_path / "j.ppm", "rb").read()
    # the integrators and preset that waited for their port render now
    for extra in (["--integrator", "whitted"], ["--integrator", "direct"],
                  ["--preset", "example"]):
        assert cli.main(["--preset", "cornellbox", "--device", "cpu", "--spp", "1",
                         "--width", "8", "--height", "6", "-o", out] + extra) == 0
    with pytest.raises(ValueError):
        cli.main(["--preset", "cornellbox", "--device", "cpu",
                  "--integrator", "nope", "-o", out])


def test_config_presets_equal_the_jax_package():
    from xraytracer_tpu import config as jconfig

    assert set(config.PRESETS) == set(jconfig.PRESETS)
    for name, cfg in jconfig.PRESETS.items():
        assert vars(config.PRESETS[name]) == vars(cfg), name
    cfg = config.get_preset("cornellbox_gi", spp=4, width=None)
    assert (cfg.width, cfg.height, cfg.spp, cfg.max_depth, cfg.integrator) == (
        780, 585, 4, 3, "gi")


def test_film_matches_the_jax_package(tmp_path):
    from xraytracer_tpu import film as jfilm

    img = np.random.default_rng(0).random((6, 8, 3)).astype(np.float32) * 1.5
    img[0, 0] = -0.5
    g_t = film.gamma_correct(img, 2.2)
    np.testing.assert_allclose(g_t, np.asarray(jfilm.gamma_correct(img, 2.2)),
                               rtol=1e-6, atol=1e-7)
    u8 = film.to_u8(g_t)
    assert np.abs(u8.astype(int) - jfilm.to_u8(
        np.asarray(jfilm.gamma_correct(img, 2.2))).astype(int)).max() <= 1
    for ext in ("png", "ppm"):
        a, b = str(tmp_path / f"a.{ext}"), str(tmp_path / f"b.{ext}")
        getattr(film, f"write_{ext}")(a, u8)
        getattr(jfilm, f"write_{ext}")(b, u8)
        assert open(a, "rb").read() == open(b, "rb").read()
    assert film.write_image(str(tmp_path / "c.png"), img, gamma=1.2).dtype == np.uint8


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr
