"""Offline density-grid converter -> .npy.

PyTorch-port counterpart of ``xraytracer_tpu/tools/grid_convert.py`` and of
the reference's NanoVDBConvert offline tool (reference:
Src/examples/nanovdb_convert.cpp:8-38, .vdb -> .nvdb). The renderer consumes
dense float32 grids (``cli.py --density-grid``); this tool rasterizes
whatever source is available into one. It is numpy only:

  * ``.vdb``      — the built-in codec (``tools/vdb.py``), with ``pyopenvdb``
                    as a fallback where it is installed (the command
                    degrades with a clear error where it is not).
  * ``.npz/.npy`` — passthrough / key extraction.
  * ``procedural``— the built-in value-noise cloud (deterministic stand-in
                    for the non-redistributable wdas cloud asset).

Usage:
    python -m xraytracer_tpu_torch.tools.grid_convert procedural out.npy --res 96
    python -m xraytracer_tpu_torch.tools.grid_convert cloud.vdb out.npy
"""

import argparse
import sys

import numpy as np


def convert_vdb(path, grid_name="density"):
    """Rasterize a ``.vdb`` FloatGrid to a dense array via the built-in
    pure-Python OpenVDB codec (tools/vdb.py — no pyopenvdb needed); falls
    back to pyopenvdb for exotic files the codec rejects."""
    from . import vdb as xvdb

    try:
        dense = xvdb.read_vdb(path, grid_name).dense
        # Which codec handled the file matters for triage: the pure-python
        # codec has never been validated against a real OpenVDB-written file
        # (see tools/vdb.py docstring caveat), so name it in the output.
        print("[grid_convert] codec: built-in pure-python vdb reader")
        return dense
    except Exception as native_err:
        # Malformed/exotic files can surface as zlib.error, struct.error,
        # ValueError, ... — not only VdbError; any parse failure should fall
        # back (or produce the actionable SystemExit below), never a raw
        # traceback from codec internals.
        try:
            import pyopenvdb as vdb
        except ImportError:
            raise SystemExit(
                f"built-in .vdb reader: {native_err}; and pyopenvdb is not "
                "installed to fall back on — re-save the grid with a modern "
                "OpenVDB or convert offline to .npy."
            )
        print("[grid_convert] codec: pyopenvdb fallback "
              f"(built-in reader failed: {native_err})")
        grid = vdb.read(path, grid_name)
        bbox = grid.evalActiveVoxelBoundingBox()
        lo, hi = np.asarray(bbox[0]), np.asarray(bbox[1])
        shape = tuple((hi - lo + 1).tolist())
        dense = np.zeros(shape, np.float32)
        grid.copyToArray(dense, ijk=tuple(lo.tolist()))
        return dense


def main(argv=None):
    p = argparse.ArgumentParser(prog="grid_convert")
    p.add_argument("source", help=".vdb / .npy / .npz path, or 'procedural'")
    p.add_argument("output", help="output .npy path")
    p.add_argument("--res", type=int, default=64,
                   help="resolution for the procedural cloud")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grid", default="density", help="VDB grid name")
    p.add_argument("--key", default=None, help="npz key")
    args = p.parse_args(argv)

    if args.source == "procedural":
        from ..scene.presets import procedural_cloud

        dense = procedural_cloud((args.res,) * 3, seed=args.seed)
    elif args.source.endswith(".vdb"):
        dense = convert_vdb(args.source, args.grid)
    elif args.source.endswith(".npz"):
        z = np.load(args.source)
        dense = np.asarray(z[args.key or list(z.keys())[0]], np.float32)
    else:
        dense = np.load(args.source).astype(np.float32)

    np.save(args.output, dense)
    print(
        f"[grid_convert] wrote {args.output} shape={dense.shape} "
        f"max={dense.max():.4f} occupancy={(dense > 0).mean():.2%}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
