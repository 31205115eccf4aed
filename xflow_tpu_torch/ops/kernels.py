"""Build and load the hand-written CUDA kernels under `xflow_tpu_torch/csrc/`.

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into its own shared
library with a plain C interface, loaded through ctypes. Libraries land
in `xflow_tpu_torch/_build/`, named by a digest of the source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source never loads a
stale library. Nothing is built at import: `load` builds the one library
it needs at first use, and `build` compiles several at once (one nvcc
process per source, started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C signature of each library's entry points: name -> [(symbol, argtypes)]
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "gather_sorted": [
        ("xf_gather_sorted", [_P, _P, _P, _L, _I, _I, _L, _I, _P]),
    ],
    "row_sums": [
        ("xf_row_sums", [_P, _P, _P, _I, _L, _L, _P, _P, _P, _P, _P, _P]),
    ],
    "scatter_sorted": [
        ("xf_scatter_sorted", [_P, _P, _P, _L, _P, _L, _P, _L, _I, _L, _I, _P]),
        ("xf_scatter_sorted_tile", [_I]),
    ],
    "scatter_ftrl": [
        ("xf_scatter_ftrl",
         [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _F, _F, _F, _F, _P]),
    ],
    "gather_sorted_multi": [
        ("xf_gather_sorted_multi", [_P, _P, _P, _L, _I, _I, _L, _I, _P]),
    ],
    "scatter_sorted_multi": [
        ("xf_scatter_sorted_multi", [_P, _P, _P, _L, _P, _L, _P, _L, _I, _L, _I, _L, _I, _P]),
        ("xf_scatter_sorted_multi_tile", [_I]),
    ],
    "lab_mosaic": [
        ("xf_lab_tma_encode", [_P, _I, _L, _L, _L, _I, _I]),
        ("xf_lab_scale_blocks", [_P, _P, _L, _I, _F, _P]),
        ("xf_lab_dma_cols", [_P, _I, _P, _P, _P, _I, _L, _I, _I, _P]),
        ("xf_lab_dma_rows", [_P, _P, _P, _P, _L, _I, _I, _I, _P]),
    ],
    "lab_rowsum": [
        ("xf_lab_rowsum", [_P, _P, _P, _I, _L, _L, _P]),
    ],
}

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")


def build(names=None) -> dict:
    """Compile the named kernels (all of them by default) that are not
    built yet, in parallel. Returns {name: compiler output} for each
    library compiled by this call; raises RuntimeError naming every
    source that failed."""
    names = list(SIGNATURES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp.{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            for sym, argtypes in SIGNATURES[name]:
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
