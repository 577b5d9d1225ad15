"""Build and bind the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface of one or more entry
points. At first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared
library under ``build/`` at the repository root and loaded with ``ctypes``.
The library is named by a hash of its source, of every shared header
``csrc/*.cuh`` and of the compiler flags, so an edit to any of them
rebuilds. Kernels that name the same source share one library: it is built
and loaded once. Every pointer and the stream travel as
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
    """A plain call counter (kernel launches, plain-version calls). Every
    counter is listed in ``COUNTERS``, so that a captured CUDA graph can
    account for the calls it replays (``CapturedCalls``)."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0
        COUNTERS.append(self)


COUNTERS: list[Counter] = []


class CapturedCalls:
    """The counted calls made while a CUDA graph is captured.

    Capture runs no kernel: ``with CapturedCalls() as calls:`` takes back
    every count the body added, and each ``calls.replay()`` adds them again,
    once per replay of the graph. So a counter keeps the number of kernels
    that ran, whether launched one by one or replayed."""

    def __init__(self):
        self.deltas: list[tuple[Counter, int]] = []
        self._before: dict[int, int] = {}

    def __enter__(self) -> "CapturedCalls":
        self._before = {id(c): c.n for c in COUNTERS}
        return self

    def __exit__(self, *exc) -> None:
        self.deltas = [(c, c.n - self._before.get(id(c), 0)) for c in COUNTERS
                       if c.n != self._before.get(id(c), 0)]
        for c, d in self.deltas:
            c.n -= d

    def replay(self) -> None:
        for c, d in self.deltas:
            c.n += d


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                           "use on a machine with the CUDA toolkit")
    return path


class Library:
    """One ``csrc`` source file and the shared library built from it, with
    ``defines`` (``NAME=value`` strings) passed to ``nvcc`` as ``-D``."""

    def __init__(self, source: str, defines: tuple = ()):
        self.source = os.path.join(CSRC, source)
        self.flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def _lib_path(self) -> str:
        h = hashlib.sha1(" ".join(self.flags).encode())
        headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                         if f.endswith(".cuh"))
        for path in [self.source, *headers]:
            with open(path, "rb") as f:
                h.update(os.path.basename(path).encode() + b"\0" + f.read())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:12]}.so")

    def build(self) -> str:
        """Compile the source unless a library for these exact sources exists."""
        path = self._lib_path()
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([_nvcc(), *self.flags, "-o", tmp, self.source],
                              capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{self.build_log}")
        os.replace(tmp, path)
        return path

    def load(self) -> ctypes.CDLL:
        """The loaded library (builds on first call)."""
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(self.build())
        return self._lib


_LIBRARIES: dict[tuple, Library] = {}
_LIBRARIES_LOCK = threading.Lock()


def library(source: str, defines: tuple = ()) -> Library:
    """The one ``Library`` of a source file and defines, shared by all its
    kernels."""
    key = (source, tuple(defines))
    with _LIBRARIES_LOCK:
        if key not in _LIBRARIES:
            _LIBRARIES[key] = Library(source, key[1])
        return _LIBRARIES[key]


class Kernel:
    """One C entry point of a ``csrc`` source file and its launch count."""

    def __init__(self, name: str, source: str, entry: str, argtypes: list,
                 defines: tuple = ()):
        self.name = name
        self.lib = library(source, defines)
        self.entry = entry
        self.argtypes = argtypes
        self.launches = Counter(name)
        self._fn = None

    def fn(self):
        """The bound C entry point (builds and loads on first call)."""
        if self._fn is None:
            fn = getattr(self.lib.load(), self.entry)
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
    """Build every kernel's library concurrently (one nvcc per source);
    returns the wall seconds."""
    t0 = time.time()
    libs = list({id(k.lib): k.lib for k in kernels}.values())
    with ThreadPoolExecutor(max_workers=max(1, len(libs))) as ex:
        for fut in [ex.submit(lib.load) for lib in libs]:
            fut.result()
    for k in kernels:
        k.fn()
    return time.time() - t0


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
