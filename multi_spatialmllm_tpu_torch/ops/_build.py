"""Builds the hand-written CUDA kernels at first use and binds them.

Each kernel source is one `csrc/<source>.cu` file with one or more plain C
entry points (a wrapper per entry point; the source defaults to the entry
point's name), which may include the shared headers `csrc/*.cuh`. It is
compiled with `nvcc` for `sm_90a` into a shared library
under `_build/` (listed in `.gitignore`), loaded with `ctypes`, and
launched on PyTorch's current stream. The sources include no PyTorch
header, so a build takes seconds rather than the minutes an extension
built with `torch.utils.cpp_extension` needs.

Nothing here falls back: a host without a CUDA device or without `nvcc`,
a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

CSRC_DIR = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc() -> str | None:
    """`$CUDA_HOME/bin/nvcc`, then the toolkit's default place, then PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    return None


def source_digest(source: str, csrc_dir: str = CSRC_DIR) -> str:
    """16 hex digits over `csrc_dir/<source>.cu`, every header `*.cuh` of
    that directory (any of them may be included) and the nvcc flags: an
    edit to any of them names a new library, so no stale build loads."""
    h = hashlib.sha256()
    for path in [os.path.join(csrc_dir, f"{source}.cu"),
                 *sorted(glob.glob(os.path.join(csrc_dir, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read()
                     + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source: str, csrc_dir: str = CSRC_DIR,
                 build_dir: str = BUILD_DIR) -> str:
    """Where the library built from `source` lives, named by its digest."""
    return os.path.join(build_dir,
                        f"lib{source}-{source_digest(source, csrc_dir)}.so")


class CudaKernel:
    """One kernel library: built at first call, then launched by calling
    the instance with the entry point's arguments (the stream is added).

    `launches` counts the launches made through this wrapper, from any
    thread; a run can reset it to show that a path went through the
    kernel."""

    def __init__(self, name: str, argtypes: list, source: str | None = None):
        self.name = name
        self.source = source or name
        self.argtypes = argtypes
        self.launches = 0
        self._count = threading.Lock()
        self.build_seconds: float | None = None
        self.build_log = ""
        self._fn = None

    def build(self):
        if self._fn is not None:
            return self._fn
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"kernel {self.name!r} needs a CUDA device; none is "
                f"available (CPU tensors take the plain version instead)")
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                f"kernel {self.name!r}: nvcc not found (set CUDA_HOME)")
        src = os.path.join(CSRC_DIR, f"{self.source}.cu")
        lib_path = library_path(self.source)
        t0 = time.perf_counter()
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                      capture_output=True, text=True)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {src} (exit {proc.returncode}):\n"
                        f"{self.build_log}")
                os.replace(tmp, lib_path)  # atomic: no half-written library
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(lib_path)
        fn = getattr(lib, self.name)
        fn.argtypes = [*self.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        self._fn = fn
        return fn

    def __call__(self, *args) -> None:
        fn = self.build()
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(
                f"kernel {self.name!r} launch failed: cudaError_t {err}")
        with self._count:
            self.launches += 1


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """Device address of a tensor for a `c_void_p` argument (None -> NULL)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check_cuda_operand(name: str, t: torch.Tensor, device: torch.device,
                       dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless `t` is a contiguous tensor of this device, dtype and
    shape: the kernels index raw pointers and take nothing else."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_tma_aligned(name: str, t: torch.Tensor) -> None:
    """Raise unless `t` starts on a 16-byte boundary: the kernels that load
    it with TMA (and 16-byte vector loads) take nothing else, and a
    contiguous view at an odd offset would pass the other checks."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: address {t.data_ptr():#x} is not 16-byte "
                         f"aligned (the kernel's TMA loads need it)")
