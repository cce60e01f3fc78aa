"""Port parity, the offline tools: the port's ``tools/vdb.py``,
``tools/grid_convert.py`` and ``tools/majorant_stats.py`` (numpy only, no
JAX) through the ports of ``tests/test_tools.py`` and ``tests/test_vdb.py``,
on the golden byte fixtures that ``tests/test_vdb.py`` assembles field by
field without the codec, plus two cross-reads: a ``.vdb`` written by the
JAX package's ``write_vdb`` read by the port, and the reverse.
"""

import os
import struct

import numpy as np
import pytest
import torch

from test_vdb import _build_v221_fixture, _build_v224_fixture

from xraytracer_tpu.scene.presets import procedural_cloud as j_procedural_cloud
from xraytracer_tpu.tools import vdb as j_vdb
from xraytracer_tpu_torch.tools import vdb as xvdb
from xraytracer_tpu_torch.tools.grid_convert import convert_vdb
from xraytracer_tpu_torch.tools.grid_convert import main as convert_main
from xraytracer_tpu_torch.tools.majorant_stats import chord_integrals

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# tests/test_tools.py
# ---------------------------------------------------------------------------
def test_grid_convert_procedural_roundtrip(tmp_path):
    out = os.path.join(tmp_path, "g.npy")
    convert_main(["procedural", out, "--res", "16"])
    g = np.load(out)
    assert g.shape == (16, 16, 16) and g.dtype == np.float32
    assert g.max() <= 1.0 and g.min() >= 0.0 and (g > 0).any()
    # the port's procedural cloud is the JAX package's, bit for bit
    np.testing.assert_array_equal(g, np.asarray(j_procedural_cloud((16,) * 3)))


def test_majorant_stats_constant_grid():
    """On a constant grid the block-max majorant is EXACT (efficiency 1)
    and the residual majorant vanishes."""
    dens = np.full((16, 16, 16), 0.4, np.float32)
    r = chord_integrals(dens, nb=4, n_chords=200, n_samples=64)
    np.testing.assert_allclose(r["max_majorant"], r["true"], rtol=1e-5)
    assert r["residual"] < 1e-6
    assert r["true"] > 0.0


def test_majorant_stats_orders_majorants():
    """On a structured grid: true <= residual-implied work and
    true <= max-majorant; finer supergrids tighten the max majorant."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0.0, 1.0, (4, 4, 4)).astype(np.float32)
    dens = np.kron(base, np.ones((4, 4, 4), np.float32))  # blocky 16^3
    r4 = chord_integrals(dens, nb=4, n_chords=300)
    r8 = chord_integrals(dens, nb=8, n_chords=300)
    assert r4["true"] <= r4["max_majorant"] + 1e-5
    assert r8["max_majorant"] <= r4["max_majorant"] + 1e-5
    assert r4["residual"] <= r4["max_majorant"] + 1e-5


# ---------------------------------------------------------------------------
# tests/test_vdb.py: golden fixture reads
# ---------------------------------------------------------------------------
def test_read_golden_v224(tmp_path):
    blob, vals, active = _build_v224_fixture()
    p = tmp_path / "golden224.vdb"
    p.write_bytes(blob)
    g = xvdb.read_vdb(str(p))
    assert g.name == "density"
    assert g.meta["file_compression"] == "zip + active values"
    on = np.flatnonzero(active)
    lo = np.array([on >> 6, (on >> 3) & 7, on & 7]).min(axis=1)
    dense_full = np.zeros((8, 8, 8), np.float32)
    dense_full[on >> 6, (on >> 3) & 7, on & 7] = vals[on]
    window = dense_full[lo[0]:, lo[1]:, lo[2]:][
        :g.dense.shape[0], :g.dense.shape[1], :g.dense.shape[2]]
    np.testing.assert_array_equal(g.dense, window)
    np.testing.assert_array_equal(g.bbox_min, lo)
    np.testing.assert_allclose(g.scale, 0.5)
    np.testing.assert_allclose(g.translation, (1.0, -2.0, 3.0))


def test_read_golden_v221_legacy_layout(tmp_path):
    blob, vals, active = _build_v221_fixture()
    p = tmp_path / "golden221.vdb"
    p.write_bytes(blob)
    g = xvdb.read_vdb(str(p))
    on = np.flatnonzero(active)
    got = g.dense[(on >> 6) - g.bbox_min[0], ((on >> 3) & 7) - g.bbox_min[1],
                  (on & 7) - g.bbox_min[2]]
    np.testing.assert_array_equal(got, vals[on])


# ---------------------------------------------------------------------------
# tests/test_vdb.py: writer structure
# ---------------------------------------------------------------------------
def _written_sample(tmp_path, writer=xvdb, **kw):
    rng = np.random.RandomState(3)
    dense = np.where(rng.rand(12, 9, 16) > 0.7,
                     rng.uniform(0.1, 1.0, size=(12, 9, 16)),
                     0.0).astype(np.float32)
    p = tmp_path / "out.vdb"
    writer.write_vdb(str(p), dense, voxel_size=0.25,
                     translation=(2.0, 0.0, -1.0), **kw)
    return p, dense


def test_written_header_layout(tmp_path):
    p, _ = _written_sample(tmp_path, compression="zip")
    raw = p.read_bytes()
    assert struct.unpack_from("<q", raw, 0)[0] == 0x56444220
    assert struct.unpack_from("<I", raw, 8)[0] == 224
    assert raw[20] == 1                     # has grid offsets
    uuid = raw[21:57].decode()              # immediately after — no u32 field
    assert uuid[8] == uuid[13] == uuid[18] == uuid[23] == "-"
    assert all(c in "0123456789abcdefABCDEF-" for c in uuid)
    # file metamap count then grid count
    n_meta = struct.unpack_from("<I", raw, 57)[0]
    assert n_meta == 0
    assert struct.unpack_from("<i", raw, 61)[0] == 1
    # descriptor: unique name, type, parent, then 3 offsets
    off = 65
    for _ in range(3):
        n = struct.unpack_from("<I", raw, off)[0]
        off += 4 + n
    grid_pos, block_pos, end_pos = struct.unpack_from("<3q", raw, off)
    assert off + 24 == grid_pos and grid_pos < block_pos <= end_pos == len(raw)
    # per-grid compression word at gridPos (version >= 222)
    comp = struct.unpack_from("<I", raw, grid_pos)[0]
    assert comp == xvdb.COMPRESS_ZIP | xvdb.COMPRESS_ACTIVE_MASK
    # leaf buffer pass starts with the 64-byte value mask, then the int8
    # metadata code of the first compressed-values record
    assert raw[block_pos + 64] in (0, 6)


def test_written_file_compression_metadata_is_string(tmp_path):
    p, _ = _written_sample(tmp_path, compression="zip")
    g = xvdb.read_vdb(str(p))
    assert g.meta["file_compression"] == "zip + active values"


# ---------------------------------------------------------------------------
# tests/test_vdb.py: roundtrips
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compression", ["none", "zip"])
@pytest.mark.parametrize("half", [False, True])
def test_roundtrip(tmp_path, compression, half):
    rng = np.random.RandomState(11)
    dense = np.where(rng.rand(20, 14, 9) > 0.6,
                     rng.uniform(0.05, 2.0, (20, 14, 9)), 0.0)
    dense = dense.astype(np.float32)
    p = tmp_path / "rt.vdb"
    xvdb.write_vdb(str(p), dense, voxel_size=(0.5, 1.0, 2.0),
                   translation=(-3.0, 0.5, 9.0), origin_ijk=(-16, 8, 0),
                   compression=compression, half=half)
    g = xvdb.read_vdb(str(p))
    # reader window is the active bbox; embed it back into the input frame
    out = np.zeros_like(dense)
    lo = g.bbox_min - np.array([-16, 8, 0])
    out[lo[0]:lo[0] + g.dense.shape[0], lo[1]:lo[1] + g.dense.shape[1],
        lo[2]:lo[2] + g.dense.shape[2]] = g.dense
    if half:
        np.testing.assert_array_equal(
            out, dense.astype(np.float16).astype(np.float32))
    else:
        np.testing.assert_array_equal(out, dense)
    np.testing.assert_allclose(g.scale, (0.5, 1.0, 2.0))
    np.testing.assert_allclose(g.translation, (-3.0, 0.5, 9.0))


@pytest.mark.skipif(not xvdb.blosc_available(), reason="no libblosc")
def test_roundtrip_blosc(tmp_path):
    rng = np.random.RandomState(5)
    dense = np.where(rng.rand(9, 9, 9) > 0.5,
                     rng.uniform(0.1, 1.0, (9, 9, 9)), 0.0).astype(np.float32)
    p = tmp_path / "b.vdb"
    xvdb.write_vdb(str(p), dense, compression="blosc")
    g = xvdb.read_vdb(str(p))
    out = np.zeros_like(dense)
    lo = g.bbox_min
    out[lo[0]:lo[0] + g.dense.shape[0], lo[1]:lo[1] + g.dense.shape[1],
        lo[2]:lo[2] + g.dense.shape[2]] = g.dense
    np.testing.assert_array_equal(out, dense)


# ---------------------------------------------------------------------------
# tests/test_vdb.py: failure modes fall back cleanly
# ---------------------------------------------------------------------------
def test_grid_convert_falls_back_on_garbage(tmp_path):
    p = tmp_path / "junk.vdb"
    p.write_bytes(b"\x20\x42\x44\x56\x00\x00\x00\x00" + b"\x99" * 64)
    with pytest.raises(SystemExit):
        convert_vdb(str(p))


def test_grid_convert_survives_truncated_stream(tmp_path):
    blob, _, _ = _build_v224_fixture()
    p = tmp_path / "trunc.vdb"
    p.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(SystemExit):
        convert_vdb(str(p))


# ---------------------------------------------------------------------------
# cross-reads: each package reads the other's files
# ---------------------------------------------------------------------------
def _same_grid(a, b):
    np.testing.assert_array_equal(a.dense, b.dense)
    np.testing.assert_array_equal(a.bbox_min, b.bbox_min)
    np.testing.assert_array_equal(a.scale, b.scale)
    np.testing.assert_array_equal(a.translation, b.translation)
    assert a.name == b.name and a.meta == b.meta


@pytest.mark.parametrize("writer,reader", [(j_vdb, xvdb), (xvdb, j_vdb)],
                         ids=["jax_written_port_read", "port_written_jax_read"])
def test_cross_read(tmp_path, writer, reader):
    p, dense = _written_sample(tmp_path, writer=writer, compression="zip")
    got, want = reader.read_vdb(str(p)), writer.read_vdb(str(p))
    _same_grid(got, want)
    out = np.zeros_like(dense)
    lo = got.bbox_min
    out[lo[0]:lo[0] + got.dense.shape[0], lo[1]:lo[1] + got.dense.shape[1],
        lo[2]:lo[2] + got.dense.shape[2]] = got.dense
    np.testing.assert_array_equal(out, dense)
