"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/*.cu`` source becomes its own shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use. All sources are
compiled at once, one ``nvcc`` process each, into
``<repo>/build/kernels/<hash>/`` where the hash covers every file in
``csrc/`` and the flags, so an edited source builds anew and an unchanged one
is loaded as it is. Each C entry point returns ``cudaGetLastError()`` after
its launches; :func:`check` turns a nonzero code into an exception. A failed
build raises: nothing falls back to another path.

This module never builds at import; the CPU tests import it freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -split-compile=0 lets nvcc optimise the kernels of one source on all the
# host's cores, which shortens the longest build, dot_centrality.cu's 96
# instantiations (chip_smoke.py prints the build time, PERF.md keeps it).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")
SOURCES = ("dot_centrality", "l1_centrality", "topk_smallest",
           "dot_pairwise", "l1_pairwise", "threefry")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# C entry point -> (library, argument types); every entry returns an int.
SIGNATURES = {
    "dot_centrality_launch": ("dot_centrality",
                              (_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL,
                               _I, _I, _I, _I, _I, _P)),
    "l1_centrality_launch": ("l1_centrality",
                             (_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I,
                              _I, _P)),
    "topk_smallest_launch": ("topk_smallest",
                             (_P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P)),
    "dot_pairwise_launch": ("dot_pairwise",
                            (_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _I,
                             _P)),
    "l1_pairwise_launch": ("l1_pairwise",
                           (_P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _P)),
    "threefry_draws_launch": ("threefry",
                              (_P, _P, _P, _P, _LL, _LL, _LL, _P)),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and "
                           "PATH): the CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile every source that has no library yet, all in parallel, and
    return the build directory. Raises ``RuntimeError`` on any failure."""
    out = build_dir()
    todo = [s for s in SOURCES if not (out / f"lib{s}.so").is_file()]
    if not todo:
        return out
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        tmp = tempfile.NamedTemporaryFile(dir=out, prefix=f".lib{name}.",
                                          suffix=".so", delete=False)
        tmp.close()
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp.name, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp.name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def build_logs() -> dict[str, str]:
    """The compiler output (``-Xptxas -v``: registers, shared memory,
    spills) of each source in the current build directory."""
    out = build_dir()
    return {s: (out / f"{s}.log").read_text()
            for s in SOURCES if (out / f"{s}.log").is_file()}


def function(entry: str) -> ctypes._CFuncPtr:
    """The bound C entry point ``entry``, building the libraries first if
    needed."""
    fn = _FNS.get(entry)
    if fn is not None:
        return fn
    with _LOCK:
        if entry not in _FNS:
            lib_name, argtypes = SIGNATURES[entry]
            if lib_name not in _LIBS:
                _LIBS[lib_name] = ctypes.CDLL(str(build() /
                                                  f"lib{lib_name}.so"))
            f = getattr(_LIBS[lib_name], entry)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            _FNS[entry] = f
        return _FNS[entry]


def check(entry: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        import torch

        raise RuntimeError(f"{entry} failed: {torch.cuda.CudaError(code)}")
