"""Build, check, launch and count the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/`` in the package
(listed in ``.gitignore``), and loaded with ctypes at first use. Nothing
is built when a module is imported: the CPU tests import every module on a
machine without ``nvcc``.

Every kernel launch goes through :func:`launch`, which counts it in
:data:`LAUNCHES` under its C function's name; :func:`check_args` refuses
the tensors a kernel cannot take.
"""

import collections
import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# alignment the kernels need of every tensor's first element: they copy
# rows between global and shared memory in 16-byte units
ALIGN_BYTES = 16
# successful launches of each kernel, by C function name. A replayed CUDA
# graph launches nothing from the host: training.common.GraphedStep adds
# the launches it saw at capture on every replay.
LAUNCHES = collections.Counter()

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


def check_args(shapes, **tensors):
    """Refuse the tensors a kernel cannot take (``ValueError``): each one,
    by argument name, must be float32, contiguous, of the shape
    ``shapes[name]`` and start at an :data:`ALIGN_BYTES` aligned address;
    then the first must be a CUDA tensor and every other lie on its
    device. Every layout is checked before any device, so a CPU tensor
    shows its layout faults too."""
    for name, tensor in tensors.items():
        if tensor.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {tensor.dtype}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(tensor.shape) != tuple(shapes[name]):
            raise ValueError(f"{name} has shape {tuple(tensor.shape)}, "
                             f"expected {tuple(shapes[name])}")
        if tensor.data_ptr() % ALIGN_BYTES:
            raise ValueError(
                f"{name} must start at a {ALIGN_BYTES}-byte aligned "
                f"address, got storage offset {tensor.storage_offset()}")
    (first, lead), *rest = tensors.items()
    if not lead.is_cuda:
        raise ValueError(f"{first} must be a CUDA tensor, got {lead.device}")
    for name, tensor in rest:
        if tensor.device != lead.device:
            raise ValueError(f"{name} lie on {tensor.device}, the {first} "
                             f"on {lead.device}")


def launch(lib, name, device, *args):
    """Call the C function ``name`` of ``lib`` with ``args`` and the
    current stream of ``device``, with ``device`` current; raise
    ``RuntimeError`` on a nonzero CUDA error code, else count the launch
    in :data:`LAUNCHES`."""
    with torch.cuda.device(device):
        err = getattr(lib, name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
