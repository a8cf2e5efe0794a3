"""The port's CUDA kernels as one library: build, load, bind and launch.

Every hand-written kernel's host side reaches the card through this module.
`SOURCES` are compiled with `nvcc` for `sm_90a` in one call into one shared
library with a plain C interface, at first use, from the sources in the
checkout only, into `BUILD_DIR` keyed by a hash of the sources, headers and
flags, and loaded with `ctypes`. A missing `nvcc` or a failed build raises:
there is no fallback to the plain versions. `BUILD_DIR` lies in the
checkout that holds `src/`, so the port runs from a checkout, not from an
installed copy.

`SIGNATURES` binds every `extern "C"` entry of the sources. A launch entry
takes the stream as its last argument and returns a `cudaError_t`;
`launch` supplies the stream and raises on a non-zero code, with the text
of `embedding_bag_error_string`, which serves every kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_KERNELS = Path(__file__).resolve().parent
_BAG = _KERNELS / "embedding_bag" / "csrc"
SOURCES = (_BAG / "embedding_bag.cu", _BAG / "ragged_bag.cu",
           _BAG / "fused_lookup.cu",
           _KERNELS / "interaction" / "csrc" / "dot_interaction.cu",
           _KERNELS / "hstu_attention" / "csrc" / "hstu_attention.cu",
           _KERNELS / "mips_topk" / "csrc" / "mips_topk.cu")
HEADERS = (_BAG / "bag_common.cuh",)
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: The kernels' dtype argument (`dtype` in every launch entry).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LL, _I32, _PTR = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
#: entry -> (argtypes, restype), for every `extern "C"` function of SOURCES
SIGNATURES = {
    "embedding_bag_launch": ([
        _PTR, _LL, _LL, _PTR, _LL, _LL, _LL, _LL, _PTR, _PTR, _PTR, _LL,
        _I32, _I32, _I32, _I32, _I32, _I32, _I32, _PTR], _I32),
    "embedding_bag_last_launch_info": ([_PTR], _I32),
    "embedding_bag_error_string": ([_I32], ctypes.c_char_p),
    "ragged_bag_launch": ([
        _PTR, _LL, _PTR, _PTR, _PTR, _PTR, _PTR, _LL, _I32, _I32, _I32, _I32,
        _I32, _I32, _PTR], _I32),
    "ragged_bag_last_launch_info": ([_PTR], _I32),
    "fused_lookup_pool": ([
        _PTR, _LL, _LL, _LL, _PTR, _LL, _LL, _LL, _LL, _PTR, _PTR, _PTR,
        _PTR, _PTR, _PTR, _LL, _LL, _I32, _I32, _I32, _I32, _I32, _I32,
        _PTR], _I32),
    "fused_lookup_lists": ([
        _PTR, _PTR, _LL, _PTR, _PTR, _LL, _PTR, _PTR, _PTR, _LL, _LL, _I32,
        _I32, _PTR], _I32),
    "fused_lookup_last_launch_info": ([_PTR], _I32),
    "dot_interaction_launch": ([
        _PTR, _PTR, _PTR, _LL, _I32, _I32, _I32, _PTR], _I32),
    "dot_interaction_last_launch_info": ([_PTR], _I32),
    "hstu_time_codes_launch": ([
        _PTR, _PTR, _I32, _LL, _PTR, _PTR, _I32, _PTR, _LL, _PTR], _I32),
    "hstu_attention_launch": ([
        _PTR, _PTR, _PTR, _LL, _PTR, _PTR, _I32, _LL, _PTR, _PTR, _PTR, _I32,
        _PTR, _LL, _I32, _I32, _I32, _I32, _PTR], _I32),
    "hstu_attention_last_launch_info": ([_PTR], _I32),
    "mips_topk_launch": ([
        _PTR, _I32, _I32, _PTR, _LL, _I32, _PTR, _PTR, _I32, _PTR, _PTR,
        _PTR], _I32),
    "mips_topk_last_launch_info": ([_PTR], _I32),
}

# the first launch builds and loads the library: one thread does it
_LOAD_LOCK = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels are built from source and have no fallback")


def build() -> dict:
    """Compile SOURCES into `libkernels_{hash}.so` unless this exact source
    (headers and flags included) is built.

    Returns {'path', 'seconds', 'cached', 'log'}; `log` holds nvcc's output
    (ptxas register and spill counts)."""
    nvcc = _nvcc()
    digest = hashlib.sha256()
    for src in (*SOURCES, *HEADERS):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"libkernels_{digest.hexdigest()[:16]}.so"
    if path.exists():
        return {"path": str(path), "seconds": 0.0, "cached": True, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return {"path": str(path), "seconds": seconds, "cached": False,
            "log": proc.stdout + proc.stderr}


def load() -> ctypes.CDLL:
    """The library, built and bound at the first call."""
    global _lib
    with _LOAD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            for entry, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def _check(lib, entry: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{entry} failed: "
                           + lib.embedding_bag_error_string(err).decode())


def launch(entry: str, device, *args) -> None:
    """Call the launch entry `entry` with `args` and the current stream of
    `device`; raise RuntimeError on a non-zero code."""
    lib = load()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args,
                                  torch.cuda.current_stream().cuda_stream)
    _check(lib, entry, err)


def launch_info(entry: str, keys) -> dict:
    """Ask a kernel about the instantiation it launched last, through its
    `*_last_launch_info` entry, which fills one int per key (registers,
    resident blocks per SM and the launch shape: cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = load()
    out = (ctypes.c_int * len(keys))()
    _check(lib, entry, getattr(lib, entry)(out))
    return dict(zip(keys, out))
