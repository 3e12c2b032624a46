"""Build the package's native sources and load them with ctypes: the CUDA
sources with nvcc, the host's C++ sources (``host=True``) with the host's
C++ compiler.

Each library is compiled at first use, from the sources in the checkout,
into ``dfol_vqa_tpu_torch/_build/<name>-<hash>/`` (listed in .gitignore),
where the hash covers the sources, the headers in ``csrc/`` and the
compiler's flags. The sources expose a
plain C interface, so the build needs no PyTorch headers and takes seconds;
libraries of different names build concurrently (one lock per name), and
concurrent processes each build into a file of their own and rename it
into place. Every CUDA source defines ``dfol_cuda_error_string``, which
``check`` uses to name a failed launch. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# no flag that changes float results (no -ffast-math; no fused multiply-adds)
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")


@dataclasses.dataclass
class Built:
    """How a library was obtained: the nvcc command, its seconds (0 when an
    earlier build with the same hash was reused), the compiler's output
    (ptxas registers / shared memory / spills), and, for a library that
    includes ``csrc/pair_tail_tile.cuh``, its ``pair_tail_slices``, read once
    when it is loaded."""

    path: str
    command: List[str]
    seconds: float
    log: str
    slices: Optional[Tuple[int, int, int]] = None


_LOCK = threading.Lock()
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LOADED: Dict[str, Tuple[ctypes.CDLL, Built]] = {}


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc") if os.environ.get("CUDA_HOME") else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def find_cxx() -> str:
    for name in ("c++", "g++", "clang++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler found: put c++, g++ or clang++ on PATH")


def _digest(sources: Sequence[str], csrc_dir: str = CSRC_DIR,
            flags: Sequence[str] = NVCC_FLAGS) -> str:
    """Hash of the compiler's flags, the sources and every header in
    ``csrc_dir`` (a source may include any of them), so an edited header
    rebuilds."""
    h = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(os.path.join(csrc_dir, f) for f in os.listdir(csrc_dir) if f.endswith(".cuh"))
    for path in [*sources, *headers]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(name: str, sources: Sequence[str], compiler: str, flags: Sequence[str]) -> Built:
    out_dir = os.path.join(BUILD_DIR, f"{name}-{_digest(sources, flags=flags)}")
    out = os.path.join(out_dir, f"lib{name}.so")
    log_path = os.path.join(out_dir, "build.log")
    shown = [compiler, *flags, "-o", out, *sources]
    if os.path.isfile(out):
        with open(log_path) as f:
            return Built(out, shown, 0.0, f.read())
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", tmp, *sources],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed ({proc.returncode}) "
                           f"building {name}:\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return Built(out, shown, seconds, log)


def load(name: str, sources: Sequence[str],
         configure: Optional[Callable[[ctypes.CDLL], None]] = None,
         host: bool = False) -> Tuple[ctypes.CDLL, Built]:
    """Build (once per source hash) and load ``lib<name>.so``; ``configure``
    declares the argtypes/restype of its functions. ``host``: C++ for the
    host, built with ``find_cxx`` and ``HOST_FLAGS``, with no
    ``dfol_cuda_error_string``."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        hit = _LOADED.get(name)
        if hit is None:
            compiler, flags = (find_cxx(), HOST_FLAGS) if host else (find_nvcc(), NVCC_FLAGS)
            built = _build(name, [os.path.join(CSRC_DIR, s) for s in sources], compiler, flags)
            lib = ctypes.CDLL(built.path)
            if not host:
                lib.dfol_cuda_error_string.argtypes = [ctypes.c_int]
                lib.dfol_cuda_error_string.restype = ctypes.c_char_p
            if configure is not None:
                configure(lib)
            if hasattr(lib, "dfol_pair_tail_slices"):
                built.slices = pair_tail_slices(lib)
            hit = _LOADED[name] = (lib, built)
        return hit


def pair_tail_slices(lib: ctypes.CDLL) -> Tuple[int, int, int]:
    """(slice_h, slice_e, multiple) of a library that includes
    ``csrc/pair_tail_tile.cuh``: its kernels take a width in slices of
    slice_h (a layer's input) and slice_e (its output), and any width that is
    a multiple of ``multiple`` (the callers zero-pad to it)."""
    fn = lib.dfol_pair_tail_slices
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = None
    out = [ctypes.c_int() for _ in range(3)]
    fn(*[ctypes.byref(x) for x in out])
    return out[0].value, out[1].value, out[2].value


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a non-zero cudaError_t."""
    if rc != 0:
        msg = lib.dfol_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")
