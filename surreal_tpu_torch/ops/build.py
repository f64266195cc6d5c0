"""Builds the CUDA C++ kernels with nvcc and loads them with ctypes.

Each `csrc/*.cu` file becomes one shared library with a plain C interface
under `build/kernels/` at the repo root, named after a hash of its source
and the flags, so an edit rebuilds it and an unchanged source is loaded as
built. nvcc's output (with ptxas's registers, shared memory and spills per
kernel) is kept beside it (`build_log`). The nvcc processes for all sources
start together. Nothing is built at import time: the first launch (or
`build_all`) builds.

Every exported C function launches on the stream it is given, allocates
nothing, and returns `cudaGetLastError()`; `Kernel.launch` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise FileNotFoundError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def _lib_path(source: str) -> Path:
    key = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build_all(sources: list[str] | None = None) -> list[Path]:
    """Compiles every source whose library is missing, all nvcc processes
    at once, and waits for them. Raises with nvcc's output on failure."""
    sources = sources or sorted(p.name for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (rc {proc.returncode}):\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [_lib_path(s) for s in sources]


def build_log(source: str) -> str:
    """nvcc's output from building `csrc/<source>` ("" if it was built
    before logs were kept)."""
    path = _lib_path(source).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def library(source: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<source>`, building it first if
    needed."""
    lib = _libs.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build_all([source])
        lib = ctypes.CDLL(str(path))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


class Kernel:
    """One exported C launcher. `launches` counts the launches made through
    `launch`, so a run can show that its main path went through the kernel."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args, device: torch.device) -> None:
        if self._fn is None:
            lib = library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]  # trailing: stream
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)
        lib, fn = self._fn
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
        if err != 0:
            msg = lib.kernel_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} launch failed: {msg} (cudaError {err})")
        self.launches += 1


def check_cuda_tensors(dtype: torch.dtype = torch.float32, **tensors: torch.Tensor) -> None:
    """Raises unless every tensor is a contiguous `dtype` tensor on CUDA."""
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes contiguous {dtype} CUDA tensors, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
