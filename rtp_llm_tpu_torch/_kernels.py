"""Build and bind the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under ``build/``
at the repository root (named by a hash of its source, so an edited source
rebuilds) and loaded with ``ctypes``. Every pointer and the stream travel as
``ctypes.c_void_p``; every C entry returns ``cudaGetLastError()`` and the
wrapper raises if it is not 0.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float


class Counter:
    """A plain call counter (kernel launches, plain-version calls)."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                           "use on a machine with the CUDA toolkit")
    return path


class Kernel:
    """One ``csrc`` source file, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, entry: str, argtypes: list):
        self.name = name
        self.source = os.path.join(CSRC, source)
        self.entry = entry
        self.argtypes = argtypes
        self.launches = Counter(name)
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def _lib_path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"{stem}-{digest[:12]}.so")

    def build(self) -> str:
        """Compile the source unless a library for this exact source exists."""
        path = self._lib_path()
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                              capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{self.build_log}")
        os.replace(tmp, path)
        return path

    def fn(self):
        """The bound C entry point (builds and loads on first call)."""
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(self.build())
                fn = getattr(lib, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def launch(self, *args):
        """Call the entry point; count the launch; raise on a CUDA error."""
        rc = self.fn()(*args)
        self.launches.n += 1
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch")


def build_all(kernels) -> float:
    """Build every kernel's library concurrently (one nvcc each); returns
    the wall seconds."""
    t0 = time.time()
    kernels = list(kernels)
    with ThreadPoolExecutor(max_workers=max(1, len(kernels))) as ex:
        for fut in [ex.submit(k.fn) for k in kernels]:
            fut.result()
    return time.time() - t0


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
