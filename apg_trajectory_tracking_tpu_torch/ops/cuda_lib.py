"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/`` in the package
(listed in ``.gitignore``), and loaded with ctypes at first use. Nothing
is built when a module is imported: the CPU tests import every module on a
machine without ``nvcc``.
"""

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS = {}


def nvcc_path():
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    first ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or add it to PATH")
    return found


def build(name, src=None):
    """Compile ``src`` (by default ``csrc/<name>.cu``) into
    ``build/lib<name>.so`` unless the library is newer than its source.
    Returns (library path, compiler log; empty when nothing was
    compiled)."""
    src = SOURCE_DIR / f"{name}.cu" if src is None else Path(src)
    lib = BUILD_DIR / f"lib{name}.so"
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent reader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load(name, signatures, src=None):
    """Build (from ``src``, as :func:`build`) if needed and load
    ``lib<name>.so``; ``signatures`` maps each C function to its ctypes
    argtypes (all return ``int``)."""
    if name not in _LIBS:
        path, _ = build(name, src)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]
