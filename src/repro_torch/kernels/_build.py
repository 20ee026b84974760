"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each source under ``csrc/`` has a plain C interface and is compiled by
``nvcc`` into its own shared library for Hopper (``sm_90a``), without fast
math. Libraries are cached in ``kernels/.build/`` under a name that hashes
the source and the flags, so an edited source is rebuilt and a build is
never half-visible (it is written to a temporary name and renamed).
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the module imports on a host with no
``nvcc`` and no card, where the kernels are never launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH``, or
    the toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class CudaKernel:
    """One hand-written kernel: its source, its C entry point, the library
    built from them, and ``launches``, the count of successful launches.

    ``launch(*args)`` calls the C entry point (which returns the
    ``cudaError_t`` of the launch) and raises ``RuntimeError`` unless it is
    0; only then does ``launches`` go up by one.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = os.path.join(CSRC_DIR, source)
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self.build_s = 0.0
        self._fn = None
        self._error_string = None
        self._lock = threading.Lock()

    @property
    def library(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR, f"{self.name}-{digest.hexdigest()[:16]}.so")

    def start_build(self):
        """Start ``nvcc`` on this kernel's source unless its library exists.
        Returns ``(process, tmp_path, lib_path, t0)``, or ``None``."""
        lib = self.library
        if os.path.isfile(lib):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, self.source]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        return proc, tmp, lib, time.perf_counter()

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, lib, t0 = started
        out, _ = proc.communicate()
        self.build_s = time.perf_counter() - t0
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {self.name} (exit {proc.returncode}):\n{out}"
            )
        os.replace(tmp, lib)

    def _load(self):
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(self.library)
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.kernel_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._error_string = err
                self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        code = self._load()(*args)
        if code != 0:
            msg = self._error_string(code).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {code} ({msg})")
        self.launches += 1


def build_all(kernels) -> dict:
    """Build every kernel's library at once (one ``nvcc`` each, started
    together) and load them. Returns ``{name: seconds}`` (0 for a library
    that was already built)."""
    started = [(k, k.start_build()) for k in kernels]
    errors = []
    for k, s in started:
        try:
            k.finish_build(s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k._load()
    return {k.name: k.build_s for k, s in started}
