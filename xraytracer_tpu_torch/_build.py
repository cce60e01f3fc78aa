"""Build the CUDA sources under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``
(no PyTorch headers are included, so a build takes seconds). Libraries land
in ``xraytracer_tpu_torch/_build/`` under a name keyed by a hash of every
file in ``csrc/`` and of ``NVCC_FLAGS``, so editing a source rebuilds it.
Several sources are compiled concurrently, one ``nvcc`` process each.
Nothing is built or looked for when this module is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, shown by build(verbose=True)
)

_loaded = {}


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install prefix."""
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _sources_hash():
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC_DIR)):
        if fn.endswith((".cu", ".cuh", ".h")):
            h.update(fn.encode())
            with open(os.path.join(CSRC_DIR, fn), "rb") as f:
                h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name):
    return os.path.join(BUILD_DIR, f"lib{name}_{_sources_hash()}.so")


def build(names=None, verbose=False):
    """Compile ``csrc/<name>.cu`` for every name (default: all) that has no
    up-to-date library yet; one ``nvcc`` per source, all started together.
    Returns ``{name: path}``. A failed build raises with nvcc's stderr."""
    if names is None:
        names = sorted(
            fn[:-3] for fn in os.listdir(CSRC_DIR) if fn.endswith(".cu")
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, n + ".cu")]
        procs[n] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ),
            tmp,
            cmd,
        )
    errors = []
    for n, (proc, tmp, cmd) in procs.items():
        out_s, err_s = proc.communicate()
        if proc.returncode != 0:
            errors.append(
                f"nvcc failed for {n} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{err_s}"
            )
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        if verbose and (out_s or err_s):
            print(out_s + err_s, flush=True)
        os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name):
    """The ``ctypes`` handle of ``csrc/<name>.cu``'s library, built on first
    use. Handles are cached for the life of the process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _loaded[name] = lib
    return lib
