"""From-scratch OpenVDB ``.vdb`` FloatGrid codec (reader + writer).

The port's own copy of ``xraytracer_tpu/tools/vdb.py`` (numpy, ``struct``,
``zlib``, and Blosc through ``ctypes`` on the system ``libblosc``): the JAX
package's module needs no JAX, but importing it runs that package's
``__init__``, which does. The two copies read and write the same bytes
(tests/test_torch_tools.py reads each one's files with the other).

The reference renders real OpenVDB assets (reference: Src/grid.h:22-84 loads
the ``density`` FloatGrid via ``openvdb::io::File``; Src/examples/volume.cpp:46
points it at ``wdas_cloud_quarter.vdb``). Neither the OpenVDB C++ library
nor ``pyopenvdb`` is a dependency, so this module implements the on-disk
format directly.

Scope — the subset every fog-volume asset in the wild uses:

  * file format version >= 220 (selective compression; current writers emit
    224, ``OPENVDB_FILE_VERSION_BLOSC_COMPRESSION``),
  * ``Tree_float_5_4_3`` grids (the standard float 5-4-3 tree; half-float
    leaf payloads via the ``_HalfFloat`` grid-type suffix are converted),
  * NONE / ZIP / BLOSC data compression, each with or without
    active-mask compression (``COMPRESS_ACTIVE_MASK``),
  * linear transforms (Affine/Scale/Translate/UniformScale* maps); frustum
    maps are rejected with a clear error.

Layout knowledge is reconstructed from the OpenVDB sources (openvdb/io/
Archive.cc ``writeHeader``/``readHeader``, io/File.cc, io/GridDescriptor.cc,
io/Compression.h ``readCompressedValues``, tree/RootNode.h / InternalNode.h /
LeafNode.h ``writeTopology``/``writeBuffers``, math/Maps.h) — no OpenVDB code
is vendored or copied; this is an independent implementation of the public
file format. The codec is validated two ways (tests/test_torch_tools.py, the
port of tests/test_vdb.py): write/read roundtrips across every compression
mode, and — decoupling the reader from the writer — a hand-assembled golden
byte fixture built field-by-field from the documented archive layout
(per-grid compression word at gridPos for versions >= 222, leaf value masks
re-serialized in the buffer pass, header compression char only for versions
220-221, hyphenated 36-char uuid).

The writer exists both for those tests and as a real feature: it exports any
dense grid to a ``.vdb`` the reference itself can load — the reverse of the
reference's NanoVDBConvert tool (Src/examples/nanovdb_convert.cpp:8-38).

CAVEAT: no file written by the real OpenVDB library has been decoded by this
codec. Reader and writer are decoupled by the hand-built byte fixtures, but a
misconception shared between the codec and the fixture builder would pass
both. ``tools/grid_convert.py`` reports which codec (the built-in reader or
the pyopenvdb fallback) handled each input, so failures on real files are
attributable.
"""

import ctypes
import ctypes.util
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

# --- format constants (openvdb/io/io.h, openvdb/version.h) -----------------
OPENVDB_MAGIC = 0x56444220  # int64 " BDV"
FILE_VERSION_SELECTIVE_COMPRESSION = 220   # header gains is-compressed char
FILE_VERSION_NODE_MASK_COMPRESSION = 222   # per-grid compression, mask codes
FILE_VERSION_BLOSC_COMPRESSION = 223       # blosc allowed in compression word
FILE_VERSION_MULTIPASS_IO = 224            # current writers emit this
WRITE_FILE_VERSION = 224
WRITE_LIB_VERSION = (8, 1)

COMPRESS_NONE = 0
COMPRESS_ZIP = 0x1
COMPRESS_ACTIVE_MASK = 0x2
COMPRESS_BLOSC = 0x4


def _compression_to_string(flags):
    """io::compressionToString — the descriptive form real archives store in
    the grid's ``file_compression`` metadata (informational only)."""
    if flags == COMPRESS_NONE:
        return "none"
    words = []
    if flags & COMPRESS_ZIP:
        words.append("zip")
    if flags & COMPRESS_BLOSC:
        words.append("blosc")
    if flags & COMPRESS_ACTIVE_MASK:
        words.append("active values")
    return " + ".join(words)

# readCompressedValues metadata codes (openvdb/io/Compression.h)
NO_MASK_OR_INACTIVE_VALS = 0
NO_MASK_AND_MINUS_BG = 1
NO_MASK_AND_ONE_INACTIVE_VAL = 2
MASK_AND_NO_INACTIVE_VALS = 3
MASK_AND_ONE_INACTIVE_VAL = 4
MASK_AND_TWO_INACTIVE_VALS = 5
NO_MASK_AND_ALL_VALS = 6

# 5-4-3 tree geometry
LEAF_LOG2, N4_LOG2, N5_LOG2 = 3, 4, 5
LEAF_DIM = 1 << LEAF_LOG2            # 8
N4_DIM = LEAF_DIM << N4_LOG2         # 128  (InternalNode<4> world span)
N5_DIM = N4_DIM << N5_LOG2           # 4096 (InternalNode<5> world span)
LEAF_SIZE = LEAF_DIM ** 3            # 512
N4_NUM = (1 << N4_LOG2) ** 3         # 4096
N5_NUM = (1 << N5_LOG2) ** 3         # 32768

GRID_TYPE_FLOAT = "Tree_float_5_4_3"
HALF_SUFFIX = "_HalfFloat"
UNIQUE_SEP = "\x1e"  # GridDescriptor name-suffix separator (ASCII RS)


class VdbError(RuntimeError):
    pass


# --- blosc via ctypes -------------------------------------------------------
_blosc = None


def _load_blosc():
    global _blosc
    if _blosc is not None:
        return _blosc
    for cand in (ctypes.util.find_library("blosc"), "libblosc.so.1",
                 "libblosc.so"):
        if not cand:
            continue
        try:
            lib = ctypes.CDLL(cand)
            lib.blosc_decompress_ctx.restype = ctypes.c_int
            lib.blosc_decompress_ctx.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_int]
            lib.blosc_compress_ctx.restype = ctypes.c_int
            lib.blosc_compress_ctx.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
            _blosc = lib
            return lib
        except OSError:
            continue
    _blosc = False
    return False


def blosc_available():
    return bool(_load_blosc())


def _blosc_decompress(payload, expect_bytes):
    lib = _load_blosc()
    if not lib:
        raise VdbError("grid uses Blosc compression but no libblosc found")
    out = ctypes.create_string_buffer(expect_bytes)
    n = lib.blosc_decompress_ctx(payload, out, expect_bytes, 1)
    if n != expect_bytes:
        raise VdbError(f"blosc_decompress returned {n}, want {expect_bytes}")
    return out.raw


def _blosc_compress(raw):
    lib = _load_blosc()
    if not lib:
        return None
    dest = ctypes.create_string_buffer(len(raw) + 64)
    n = lib.blosc_compress_ctx(9, 1, 4, len(raw), raw, dest, len(dest),
                               b"lz4", 0, 1)
    if n <= 0 or n >= len(raw):
        return None
    return dest.raw[:n]


# --- primitive IO -----------------------------------------------------------
class _R:
    """Little cursor over bytes (streams in the archive are sequential)."""

    def __init__(self, buf):
        self.buf, self.off = buf, 0

    def take(self, n):
        b = self.buf[self.off:self.off + n]
        if len(b) != n:
            raise VdbError("truncated .vdb stream")
        self.off += n
        return b

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]

    def i64(self):
        return struct.unpack("<q", self.take(8))[0]

    def f32(self):
        return struct.unpack("<f", self.take(4))[0]

    def string(self):
        return self.take(self.u32()).decode("utf-8", "replace")

    def coord(self):
        return struct.unpack("<3i", self.take(12))


class _W:
    def __init__(self):
        self.parts = []
        self.size = 0

    def raw(self, b):
        self.parts.append(bytes(b))
        self.size += len(b)

    def u32(self, v):
        self.raw(struct.pack("<I", v))

    def i32(self, v):
        self.raw(struct.pack("<i", v))

    def i64(self, v):
        self.raw(struct.pack("<q", v))

    def f32(self, v):
        self.raw(struct.pack("<f", v))

    def string(self, s):
        b = s.encode()
        self.u32(len(b))
        self.raw(b)

    def coord(self, c):
        self.raw(struct.pack("<3i", *c))

    def getvalue(self):
        return b"".join(self.parts)


def _load_mask(r, nbits):
    """NodeMask.load — raw little-endian bit array (openvdb/util/NodeMasks.h:
    bit i lives in word i>>6 bit i&63; LE byte order == bitorder='little')."""
    raw = np.frombuffer(r.take(nbits // 8), np.uint8)
    return np.unpackbits(raw, bitorder="little").astype(bool)


def _save_mask(w, bits):
    w.raw(np.packbits(bits.astype(np.uint8), bitorder="little").tobytes())


# --- compressed value arrays (openvdb/io/Compression.h) ---------------------
def _read_data(r, count, compression, half):
    """io::readData — the zip/blosc framing is an int64 byte count; negative
    means the writer stored the raw bytes (compression not beneficial)."""
    itemsize = 2 if half else 4
    dtype = np.float16 if half else np.float32
    nbytes = count * itemsize
    if compression & COMPRESS_BLOSC:
        n = r.i64()
        if n == 0:
            raw = b""
        elif n < 0:
            raw = r.take(-n)
        else:
            raw = _blosc_decompress(r.take(n), nbytes)
    elif compression & COMPRESS_ZIP:
        n = r.i64()
        if n == 0:
            raw = b""
        elif n < 0:
            raw = r.take(-n)
        else:
            raw = zlib.decompress(r.take(n))
    else:
        raw = r.take(nbytes)
    if len(raw) != nbytes:
        raise VdbError(f"value payload {len(raw)}B, want {nbytes}B")
    vals = np.frombuffer(raw, dtype).astype(np.float32)
    return vals


def _write_data(w, vals, compression, half):
    raw = vals.astype(np.float16 if half else np.float32).tobytes()
    if compression & COMPRESS_BLOSC:
        if len(raw) == 0:
            w.i64(0)
            return
        comp = _blosc_compress(raw)
        if comp is None:
            w.i64(-len(raw))
            w.raw(raw)
        else:
            w.i64(len(comp))
            w.raw(comp)
    elif compression & COMPRESS_ZIP:
        if len(raw) == 0:
            w.i64(0)
            return
        comp = zlib.compress(raw, 6)
        if len(comp) < len(raw):
            w.i64(len(comp))
            w.raw(comp)
        else:
            w.i64(-len(raw))
            w.raw(raw)
    else:
        w.raw(raw)


def _read_compressed_values(r, count, value_mask, background, compression,
                            version, half):
    """io::readCompressedValues — returns a dense (count,) float32 array."""
    metadata = NO_MASK_AND_ALL_VALS
    if version >= FILE_VERSION_NODE_MASK_COMPRESSION:
        metadata = struct.unpack("<b", r.take(1))[0]
    inactive1 = background
    inactive0 = (background if metadata == NO_MASK_OR_INACTIVE_VALS
                 else -background)
    if metadata in (NO_MASK_AND_ONE_INACTIVE_VAL, MASK_AND_ONE_INACTIVE_VAL,
                    MASK_AND_TWO_INACTIVE_VALS):
        inactive0 = r.f32()
        if metadata == MASK_AND_TWO_INACTIVE_VALS:
            inactive1 = r.f32()
    selection = None
    if metadata in (MASK_AND_NO_INACTIVE_VALS, MASK_AND_ONE_INACTIVE_VAL,
                    MASK_AND_TWO_INACTIVE_VALS):
        selection = _load_mask(r, count)
    temp_count = count
    if (compression & COMPRESS_ACTIVE_MASK
            and metadata != NO_MASK_AND_ALL_VALS
            and version >= FILE_VERSION_NODE_MASK_COMPRESSION):
        temp_count = int(value_mask.sum())
    stored = _read_data(r, temp_count, compression, half)
    if temp_count == count:
        return stored
    out = np.full(count, inactive0, np.float32)
    if selection is not None:
        out[selection] = inactive1
    out[value_mask] = stored
    return out


def _write_compressed_values(w, values, value_mask, background, compression,
                             half):
    """Writer counterpart; always emits metadata code 0 (all inactive values
    equal the background — true by construction for fog exports) with
    active-mask packing when the archive enables it."""
    if compression & COMPRESS_ACTIVE_MASK:
        w.raw(struct.pack("<b", NO_MASK_OR_INACTIVE_VALS))
        _write_data(w, values[value_mask], compression, half)
    else:
        w.raw(struct.pack("<b", NO_MASK_AND_ALL_VALS))
        _write_data(w, values, compression, half)


# --- metadata map (openvdb/MetaMap.cc) --------------------------------------
def _read_metamap(r):
    meta = {}
    for _ in range(r.u32()):
        name = r.string()
        typ = r.string()
        size = r.u32()
        raw = r.take(size)
        if typ == "string":
            meta[name] = raw.decode("utf-8", "replace")
        elif typ in ("int64",) and size == 8:
            meta[name] = struct.unpack("<q", raw)[0]
        elif typ in ("int32", "uint32") and size == 4:
            meta[name] = struct.unpack("<i" if typ == "int32" else "<I",
                                       raw)[0]
        elif typ == "bool" and size == 1:
            meta[name] = bool(raw[0])
        elif typ == "vec3i" and size == 12:
            meta[name] = struct.unpack("<3i", raw)
        elif typ == "vec3d" and size == 24:
            meta[name] = struct.unpack("<3d", raw)
        elif typ == "float" and size == 4:
            meta[name] = struct.unpack("<f", raw)[0]
        elif typ == "double" and size == 8:
            meta[name] = struct.unpack("<d", raw)[0]
        else:
            meta[name] = raw  # opaque but preserved
    return meta


def _write_metamap(w, meta):
    w.u32(len(meta))
    for name, val in meta.items():
        w.string(name)
        if isinstance(val, str):
            w.string("string")
            b = val.encode()
            w.u32(len(b))
            w.raw(b)
        elif isinstance(val, bool):
            w.string("bool")
            w.u32(1)
            w.raw(bytes([int(val)]))
        elif isinstance(val, int):
            w.string("int64")
            w.u32(8)
            w.raw(struct.pack("<q", val))
        elif isinstance(val, tuple) and len(val) == 3 \
                and all(isinstance(x, int) for x in val):
            w.string("vec3i")
            w.u32(12)
            w.raw(struct.pack("<3i", *val))
        else:
            raise VdbError(f"unsupported metadata value for {name!r}")


# --- transforms (openvdb/math/Maps.h serialization orders) -------------------
_MAP_DOUBLES = {
    # name -> (n_vec3d_fields, scale_field_idx, translation_field_idx)
    "UniformScaleMap": (5, 0, None),
    "ScaleMap": (5, 0, None),
    "TranslationMap": (1, None, 0),
    "UniformScaleTranslateMap": (6, 1, 0),
    "ScaleTranslateMap": (6, 1, 0),
}


def _read_transform(r):
    """Transform::read (file version >= 219): map type name + map payload.
    Returns (scale (3,), translation (3,)) of the index->world affine map."""
    map_type = r.string()
    if map_type in _MAP_DOUBLES:
        n, si, ti = _MAP_DOUBLES[map_type]
        vecs = [struct.unpack("<3d", r.take(24)) for _ in range(n)]
        scale = np.array(vecs[si], np.float64) if si is not None \
            else np.ones(3)
        trans = np.array(vecs[ti], np.float64) if ti is not None \
            else np.zeros(3)
        return scale, trans, map_type
    if map_type == "AffineMap":
        m = np.array(struct.unpack("<16d", r.take(128))).reshape(4, 4)
        # row-vector affine: diag scale + bottom-row translation only is
        # representable; reject shear/rotation rather than mis-sample.
        if not np.allclose(m[:3, :3], np.diag(np.diag(m[:3, :3]))):
            raise VdbError("AffineMap with rotation/shear is unsupported")
        return np.diag(m[:3, :3]).copy(), m[3, :3].copy(), map_type
    raise VdbError(f"unsupported transform map {map_type!r} "
                   "(frustum/nonlinear grids are out of scope)")


def _write_transform(w, scale, trans):
    scale = np.asarray(scale, np.float64)
    trans = np.asarray(trans, np.float64)
    w.string("UniformScaleTranslateMap"
             if np.allclose(scale, scale[0]) else "ScaleTranslateMap")
    inv = 1.0 / scale
    for vec in (trans, scale, scale, inv, inv * inv, 0.5 * inv):
        w.raw(struct.pack("<3d", *vec))


# --- tree topology/buffers ---------------------------------------------------
@dataclass
class _Leaf:
    origin: tuple
    mask: np.ndarray                 # (512,) bool
    values: np.ndarray = None        # (512,) float32, filled by buffer pass


@dataclass
class _Internal:
    origin: tuple
    log2: int                        # 5 or 4
    child_mask: np.ndarray
    value_mask: np.ndarray
    values: np.ndarray
    children: dict = field(default_factory=dict)  # offset -> node


def _offset_to_local(offset, log2):
    dim = 1 << log2
    x = offset >> (2 * log2)
    y = (offset >> log2) & (dim - 1)
    z = offset & (dim - 1)
    return x, y, z


def _read_internal(r, origin, log2, child_log2_span, background, compression,
                   version, half):
    num = (1 << log2) ** 3
    child_mask = _load_mask(r, num)
    value_mask = _load_mask(r, num)
    values = _read_compressed_values(r, num, value_mask, background,
                                     compression, version, half)
    node = _Internal(origin, log2, child_mask, value_mask, values)
    for off in np.flatnonzero(child_mask):
        lx, ly, lz = _offset_to_local(int(off), log2)
        corig = (origin[0] + lx * child_log2_span,
                 origin[1] + ly * child_log2_span,
                 origin[2] + lz * child_log2_span)
        if log2 == N5_LOG2:
            node.children[int(off)] = _read_internal(
                r, corig, N4_LOG2, LEAF_DIM, background, compression,
                version, half)
        else:
            node.children[int(off)] = _Leaf(corig, _load_mask(r, LEAF_SIZE))
    return node


def _read_internal_buffers(r, node, background, compression, version, half):
    for off in sorted(node.children):
        child = node.children[off]
        if isinstance(child, _Internal):
            _read_internal_buffers(r, child, background, compression,
                                   version, half)
        else:
            # LeafNode::readBuffers: each leaf buffer record re-serializes
            # the 64-byte value mask (authoritative for the value pass);
            # pre-222 records additionally carry origin + buffer count.
            child.mask = _load_mask(r, LEAF_SIZE)
            if version < FILE_VERSION_NODE_MASK_COMPRESSION:
                r.coord()  # leaf origin (redundant with the topology pass)
                n_buffers = struct.unpack("<b", r.take(1))[0]
                if n_buffers != 1:
                    raise VdbError(
                        f"leaf with {n_buffers} buffers (multi-buffer trees "
                        "predate file version 222 and are unsupported)")
            child.values = _read_compressed_values(
                r, LEAF_SIZE, child.mask, background, compression, version,
                half)


def _write_internal(w, node, compression, background, half):
    _save_mask(w, node.child_mask)
    _save_mask(w, node.value_mask)
    _write_compressed_values(w, node.values, node.value_mask, background,
                             compression, half)
    for off in sorted(node.children):
        child = node.children[off]
        if isinstance(child, _Internal):
            _write_internal(w, child, compression, background, half)
        else:
            _save_mask(w, child.mask)


def _write_internal_buffers(w, node, compression, background, half):
    for off in sorted(node.children):
        child = node.children[off]
        if isinstance(child, _Internal):
            _write_internal_buffers(w, child, compression, background, half)
        else:
            # LeafNode::writeBuffers re-serializes the value mask before the
            # compressed values (in addition to the topology-pass copy).
            _save_mask(w, child.mask)
            _write_compressed_values(w, child.values, child.mask, background,
                                     compression, half)


# --- public grid container ---------------------------------------------------
@dataclass
class VdbGrid:
    """One FloatGrid: dense voxel array + index->world transform.

    ``dense[x, y, z]`` covers index-space ``ijk = bbox_min + (x, y, z)``;
    ``world = ijk * scale + translation`` (linear maps only).
    ``active`` is the voxel activity mask over the same window.
    """

    name: str
    dense: np.ndarray
    active: np.ndarray
    bbox_min: np.ndarray
    scale: np.ndarray
    translation: np.ndarray
    background: float = 0.0
    meta: dict = field(default_factory=dict)

    @property
    def bbox_world(self):
        lo = self.bbox_min * self.scale + self.translation
        hi = (self.bbox_min + np.array(self.dense.shape)) * self.scale \
            + self.translation
        return np.minimum(lo, hi), np.maximum(lo, hi)


def _iter_leaves(root_children):
    for n5 in root_children:
        stack = [n5]
        while stack:
            node = stack.pop()
            for off in sorted(node.children):
                c = node.children[off]
                if isinstance(c, _Internal):
                    stack.append(c)
                else:
                    yield c


def _iter_tiles(node):
    """Active tile (origin, span, value) triples below one internal node."""
    span = LEAF_DIM if node.log2 == N4_LOG2 else N4_DIM
    for off in np.flatnonzero(node.value_mask & ~node.child_mask):
        lx, ly, lz = _offset_to_local(int(off), node.log2)
        yield ((node.origin[0] + lx * span, node.origin[1] + ly * span,
                node.origin[2] + lz * span), span, float(node.values[off]))
    for child in node.children.values():
        if isinstance(child, _Internal):
            yield from _iter_tiles(child)


# --- archive reader ----------------------------------------------------------
def read_vdb(path, grid_name=None, dense_dtype=np.float32):
    """Read one FloatGrid from an OpenVDB file into a `VdbGrid`.

    ``grid_name=None`` picks the single grid, or the one named ``density``
    when several exist (the reference's behavior, Src/grid.h:42).
    """
    with open(path, "rb") as f:
        r = _R(f.read())
    if r.i64() != OPENVDB_MAGIC:
        raise VdbError(f"{path}: not an OpenVDB file (bad magic)")
    version = r.u32()
    if version < FILE_VERSION_SELECTIVE_COMPRESSION:
        raise VdbError(f"file format version {version} predates 220; "
                       "re-save with any modern OpenVDB")
    lib_major, lib_minor = r.u32(), r.u32()
    has_offsets = r.take(1)[0]
    # Archive::readHeader: a one-byte is-compressed flag exists only for
    # versions [220, 222); from 222 on compression is stored per grid and
    # the header carries no compression field at all.
    if version < FILE_VERSION_NODE_MASK_COMPRESSION:
        compression = (COMPRESS_ZIP if r.take(1)[0]
                       else COMPRESS_NONE)
    else:
        # default until the per-grid word (readGridCompression) overrides
        compression = COMPRESS_ZIP | COMPRESS_ACTIVE_MASK
    r.take(36)  # uuid: 36 ASCII chars since file version 218
    file_meta = _read_metamap(r)
    del lib_major, lib_minor, file_meta
    grid_count = r.i32()

    descriptors = []
    for _ in range(grid_count):
        unique = r.string()
        gtype = r.string()
        parent = r.string()  # instancing (>=216)
        grid_pos, block_pos, end_pos = r.i64(), r.i64(), r.i64()
        descriptors.append((unique, gtype, parent, grid_pos, block_pos,
                            end_pos))
        if has_offsets:
            r.off = end_pos
    if not has_offsets:
        raise VdbError("streamed (non-seekable) archives are unsupported")

    names = [d[0].split(UNIQUE_SEP)[0] for d in descriptors]
    want = grid_name
    if want is None:
        want = "density" if len(names) > 1 and "density" in names \
            else names[0]
    if want not in names:
        raise VdbError(f"grid {want!r} not in {names}")
    unique, gtype, parent, grid_pos, block_pos, end_pos = \
        descriptors[names.index(want)]
    if parent:
        raise VdbError("instanced grids are unsupported")
    half = gtype.endswith(HALF_SUFFIX)
    base_type = gtype[:-len(HALF_SUFFIX)] if half else gtype
    if base_type != GRID_TYPE_FLOAT:
        raise VdbError(f"grid type {base_type!r} unsupported "
                       f"(only {GRID_TYPE_FLOAT})")

    r.off = grid_pos
    # io::readGridCompression: from version 222 on, a raw uint32 compression
    # word precedes the grid metadata; it is authoritative (the
    # "file_compression" metadata entry is only a descriptive string).
    if version >= FILE_VERSION_NODE_MASK_COMPRESSION:
        compression = r.u32()
    gmeta = _read_metamap(r)
    scale, trans, _ = _read_transform(r)

    # Tree topology: TreeBase buffer count (legacy, ==1), then the root.
    if r.u32() != 1:
        raise VdbError("multi-buffer trees are unsupported")
    background = r.f32()
    num_tiles = r.u32()
    num_children = r.u32()
    root_tiles = []
    root_children = []
    for _ in range(num_tiles):
        c = r.coord()
        v = r.f32()
        active = bool(r.take(1)[0])
        root_tiles.append((c, v, active))
    for _ in range(num_children):
        origin = r.coord()
        root_children.append(_read_internal(
            r, origin, N5_LOG2, N4_DIM, background, compression, version,
            half))

    # Buffer pass starts at blockPos (right after topology when sequential).
    r.off = block_pos
    for n5 in root_children:
        _read_internal_buffers(r, n5, background, compression, version, half)

    # Rasterize: active-voxel bbox over leaves + active tiles, like
    # evalActiveVoxelBoundingBox (reference: Src/grid.h:59-63).
    lo = np.array([2**31 - 1] * 3, np.int64)
    hi = np.array([-2**31] * 3, np.int64)
    leaves = list(_iter_leaves(root_children))
    for leaf in leaves:
        if leaf.mask.any():
            on = np.flatnonzero(leaf.mask)
            xs = on >> 6
            ys = (on >> 3) & 7
            zs = on & 7
            o = np.array(leaf.origin)
            lo = np.minimum(lo, o + [xs.min(), ys.min(), zs.min()])
            hi = np.maximum(hi, o + [xs.max(), ys.max(), zs.max()])
    tiles = []
    for n5 in root_children:
        tiles.extend(_iter_tiles(n5))
    for (c, v, active) in root_tiles:
        if active:
            tiles.append((c, N5_DIM, v))
    for origin, span, _v in tiles:
        lo = np.minimum(lo, origin)
        hi = np.maximum(hi, np.array(origin) + span - 1)
    if (hi < lo).any():
        dense = np.zeros((0, 0, 0), dense_dtype)
        return VdbGrid(want, dense, np.zeros((0, 0, 0), bool),
                       np.zeros(3, np.int64), scale, trans, background,
                       gmeta)

    shape = tuple((hi - lo + 1).tolist())
    dense = np.full(shape, background, dense_dtype)
    active = np.zeros(shape, bool)
    for origin, span, v in tiles:
        s = tuple(slice(max(0, origin[i] - lo[i]),
                        max(0, origin[i] - lo[i] + span)) for i in range(3))
        dense[s] = v
        active[s] = True
    for leaf in leaves:
        o = np.array(leaf.origin) - lo
        block = leaf.values.reshape(LEAF_DIM, LEAF_DIM, LEAF_DIM)
        mask = leaf.mask.reshape(LEAF_DIM, LEAF_DIM, LEAF_DIM)
        # clip to the bbox window (inactive leaf margins may stick out)
        src_lo = np.maximum(0, -o)
        src_hi = np.minimum(LEAF_DIM, np.array(shape) - o)
        if (src_hi <= src_lo).any():
            continue
        dst = tuple(slice(o[i] + src_lo[i], o[i] + src_hi[i])
                    for i in range(3))
        src = tuple(slice(src_lo[i], src_hi[i]) for i in range(3))
        dense[dst] = block[src]
        active[dst] = mask[src]
    return VdbGrid(want, dense, active, lo.astype(np.int64), scale, trans,
                   float(background), gmeta)


# --- archive writer ----------------------------------------------------------
def _build_tree(dense, origin_ijk, background):
    """Sparsify a dense [x,y,z] array into root children (5-4-3 layout).
    Voxels equal to the background are inactive; all-background leaves are
    dropped (their parent keeps an inactive background tile)."""
    dense = np.asarray(dense, np.float32)
    ox, oy, oz = (int(v) for v in origin_ijk)
    roots = {}

    def _node(cache, key, origin, log2):
        if key not in cache:
            num = (1 << log2) ** 3
            cache[key] = _Internal(origin, log2,
                                   np.zeros(num, bool), np.zeros(num, bool),
                                   np.full(num, background, np.float32))
        return cache[key]

    nx, ny, nz = dense.shape
    for bx in range(0, nx, LEAF_DIM):
        for by in range(0, ny, LEAF_DIM):
            for bz in range(0, nz, LEAF_DIM):
                gx, gy, gz = ox + bx, oy + by, oz + bz
                if gx % LEAF_DIM or gy % LEAF_DIM or gz % LEAF_DIM:
                    raise VdbError("origin_ijk must be 8-aligned")
                block = np.full((LEAF_DIM,) * 3, background, np.float32)
                sub = dense[bx:bx + LEAF_DIM, by:by + LEAF_DIM,
                            bz:bz + LEAF_DIM]
                block[:sub.shape[0], :sub.shape[1], :sub.shape[2]] = sub
                mask = block != background
                if not mask.any():
                    continue
                # floor division aligns origins for negative coords too
                ro = tuple((v // N5_DIM) * N5_DIM for v in (gx, gy, gz))
                n5 = _node(roots, ro, ro, N5_LOG2)
                l5 = tuple((v - o) // N4_DIM for v, o in zip((gx, gy, gz),
                                                            ro))
                off5 = (l5[0] << (2 * N5_LOG2)) + (l5[1] << N5_LOG2) + l5[2]
                n5.child_mask[off5] = True
                n4o = tuple(o + l * N4_DIM for o, l in zip(ro, l5))
                if off5 not in n5.children or \
                        not isinstance(n5.children.get(off5), _Internal):
                    n5.children[off5] = _Internal(
                        n4o, N4_LOG2, np.zeros(N4_NUM, bool),
                        np.zeros(N4_NUM, bool),
                        np.full(N4_NUM, background, np.float32))
                n4 = n5.children[off5]
                l4 = tuple((v - o) // LEAF_DIM
                           for v, o in zip((gx, gy, gz), n4o))
                off4 = (l4[0] << (2 * N4_LOG2)) + (l4[1] << N4_LOG2) + l4[2]
                n4.child_mask[off4] = True
                n4.children[off4] = _Leaf(
                    (gx, gy, gz), mask.reshape(-1), block.reshape(-1))
    return [roots[k] for k in sorted(roots)]


def write_vdb(path, dense, name="density", voxel_size=1.0,
              translation=(0.0, 0.0, 0.0), origin_ijk=(0, 0, 0),
              background=0.0, compression="zip", half=False,
              grid_class="fog volume"):
    """Write a dense [x,y,z] float array as a single-FloatGrid ``.vdb``.

    ``compression``: "zip" | "blosc" | "none" (+active-mask always on for
    zip/blosc, matching OpenVDB's default archive settings). The output is
    format version 224 — loadable by the reference's OpenVDBGrid
    (Src/grid.h:28-49).
    """
    comp_flags = {"zip": COMPRESS_ZIP | COMPRESS_ACTIVE_MASK,
                  "blosc": COMPRESS_BLOSC | COMPRESS_ACTIVE_MASK,
                  "none": COMPRESS_NONE}[compression]
    if compression == "blosc" and not blosc_available():
        raise VdbError("libblosc not available for writing")
    scale = np.full(3, float(voxel_size), np.float64) \
        if np.isscalar(voxel_size) else np.asarray(voxel_size, np.float64)
    roots = _build_tree(dense, origin_ijk, background)

    gtype = GRID_TYPE_FLOAT + (HALF_SUFFIX if half else "")
    # grid block: per-grid compression word (writeGridCompression, >=222),
    # then metadata, transform, topology; buffers follow at blockPos.
    gw = _W()
    gw.u32(comp_flags)
    _write_metamap(gw, {
        "class": grid_class, "name": name,
        "file_compression": _compression_to_string(comp_flags),
    })
    _write_transform(gw, scale, np.asarray(translation, np.float64))
    gw.u32(1)  # TreeBase buffer count
    gw.f32(background)
    gw.u32(0)  # root tiles
    gw.u32(len(roots))
    for n5 in roots:
        gw.coord(n5.origin)
        _write_internal(gw, n5, comp_flags, background, half)
    topo = gw.getvalue()
    bw = _W()
    for n5 in roots:
        _write_internal_buffers(bw, n5, comp_flags, background, half)
    buffers = bw.getvalue()

    hw = _W()
    hw.i64(OPENVDB_MAGIC)
    hw.u32(WRITE_FILE_VERSION)
    hw.u32(WRITE_LIB_VERSION[0])
    hw.u32(WRITE_LIB_VERSION[1])
    hw.raw(b"\x01")  # has grid offsets (seekable archive)
    # no header compression field at version >= 222 (stored per grid)
    hw.raw(b"00000000-0000-0000-0000-000000000000")  # hyphenated 36-char uuid
    _write_metamap(hw, {})  # file-level metadata
    hw.i32(1)  # grid count
    header = hw.getvalue()

    dw = _W()
    dw.string(name)  # unique name (no \x1e suffix needed for one grid)
    dw.string(gtype)
    dw.string("")    # instance parent
    desc_fixed = dw.getvalue()
    # descriptor tail: three int64 offsets
    desc_len = len(desc_fixed) + 24
    grid_pos = len(header) + desc_len
    block_pos = grid_pos + len(topo)
    end_pos = block_pos + len(buffers)
    with open(path, "wb") as f:
        f.write(header)
        f.write(desc_fixed)
        f.write(struct.pack("<3q", grid_pos, block_pos, end_pos))
        f.write(topo)
        f.write(buffers)
    return end_pos
