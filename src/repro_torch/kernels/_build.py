"""Build the CUDA sources in ``csrc/`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain C launch functions.  At first use it
is compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/`` (next to ``csrc/``; git-ignored), named by a digest of the
source and flags so an edited source never loads a stale library, and
loaded with :mod:`ctypes`.  Pointers cross as ``data_ptr()`` integers and
the stream as ``torch.cuda.current_stream().cuda_stream``; every launch
function returns ``cudaGetLastError()``, which :meth:`Kernel.launch`
checks.  There is no fallback: a source that does not build raises.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each build made by this process
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to (digest of the source, the shared
    headers and the flags)."""
    text = (CSRC_DIR / source).read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(sources: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every source not yet built, one ``nvcc`` each, all started
    together.  Returns ``{source: seconds}`` for the ones compiled here."""
    if sources is None:
        sources = sorted(p.name for p in CSRC_DIR.glob("*.cu"))
    with _lock:
        return _build_locked(list(sources))


def _build_locked(sources: List[str]) -> Dict[str, float]:
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for src in todo:
        out = library_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    seconds, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        build_logs[src] = log
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)      # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def _load(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            _build_locked([source])
            lib = ctypes.CDLL(str(library_path(source)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


class Kernel:
    """One exported launch function of one ``csrc`` source.

    ``launches`` counts successful launches through :meth:`launch` — the
    only place the kernel is started — so a run can show that its main
    path went through the kernel.  ``routes`` counts the same launches by
    the route a wrapper names (its shape class, e.g. "G1 hd64 not
    causal"), so a run can show which of them it took.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.routes = collections.Counter()
        self._fn = None

    def lib(self) -> ctypes.CDLL:
        return _load(self.source)

    def _function(self):
        if self._fn is None:
            fn = getattr(self.lib(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args, route: Optional[str] = None) -> None:
        err = self._function()(*args)
        if err != 0:
            msg = self.lib().repro_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error "
                               f"{err} ({msg})")
        self.launches += 1
        if route is not None:
            self.routes[route] += 1


PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float

# the devices whose tensors take a kernel's plain PyTorch version: the CPU,
# and the meta device, where the plain version computes shapes alone (the
# dry-run's FLOP count and per-rank state); a CUDA tensor launches the
# kernel, any other device raises
PLAIN_DEVICES = ("cpu", "meta")
