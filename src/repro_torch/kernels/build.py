"""Build, load and launch the port's CUDA kernels.

Each kernel is one CUDA C++ source in ``repro_torch/csrc/`` with a plain
C interface: a launch function that takes raw pointers, sizes and a
stream, and returns ``cudaGetLastError()``.  At first use the source is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch_kernels/`` at the root of the checkout and loaded
with ``ctypes``.  The library name carries a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused.
``build`` compiles several sources at once, one ``nvcc`` process each.

Nothing here runs when the module is imported, so every module imports
on a machine without ``nvcc`` or a card; ``nvcc`` is needed only when a
kernel is first built or launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"

_CTYPES = {"ptr": ctypes.c_void_p, "i64": ctypes.c_int64}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default install prefix; raises when none exists."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                       "or put nvcc on PATH")


def library_path(source: str) -> Path:
    """Where ``source``'s shared library lives once built."""
    text = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources: Iterable[str]) -> Dict[str, dict]:
    """Compile every source whose library is missing, all at once (one
    ``nvcc`` each), and return ``{source: {"path", "seconds", "log"}}``:
    ``seconds`` is the source's compile time (0.0 when it was already
    built) and ``log`` the compiler's register / shared-memory report.
    Raises with the compiler's output if a compile fails."""
    sources = list(dict.fromkeys(sources))
    out: Dict[str, dict] = {}
    running = []
    for src in sources:
        path = library_path(src)
        log = path.with_suffix(".log")
        if path.exists():
            out[src] = {"path": path, "seconds": 0.0,
                        "log": log.read_text() if log.exists() else ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, path, tmp, proc, time.perf_counter()))
    failures = []
    for src, path, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {src} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        path.with_suffix(".log").write_text(log)
        out[src] = {"path": path, "seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d ``dtype`` tensor on
    ``device`` — what a kernel's raw-pointer interface assumes."""
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected a {ndim}-d {dtype} tensor, got "
                        f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class CudaKernel:
    """One exported launch function of a kernel library.

    ``launch`` calls it on PyTorch's current stream of the tensors'
    device and raises if the launch reported an error; ``launches``
    counts successful launches, so a run can show which kernels its
    path went through."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence[str]):
        self.source = source
        self.symbol = symbol
        self.argtypes = [_CTYPES[a] for a in argtypes]
        self.launches = 0
        self._fn = None
        self._error_string = None

    def _load(self):
        path = build([self.source])[self.source]["path"]
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes + [ctypes.c_void_p]   # + stream
        fn.restype = ctypes.c_int
        err = lib.kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._error_string = fn, err

    def launch(self, device: torch.device, *args) -> None:
        if self._fn is None:
            self._load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: "
                               f"{self._error_string(rc).decode()}")
        self.launches += 1
