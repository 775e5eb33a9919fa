"""Hand-written Hopper kernels: build, load and launch accounting.

Every kernel of the port is CUDA C++ under ``csrc/``, compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
and loaded with ``ctypes``. The build runs at first use, into
``_build/`` beside this file (one ``nvcc`` per source, all started
together); a library is named by the hash of its source, so an edited
source rebuilds and an unchanged one is reused.

Routing is by device, with no gate and no fallback: a wrapper given CUDA
tensors launches its kernel or raises; given CPU tensors it runs the
kernel's plain PyTorch version, which lives beside it in the same module.
Each wrapper counts its launches in :data:`LAUNCHES` (one per call that
launches its kernel, nowhere else), so a run can show that a path went
through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("sort", "join", "strings", "groupby")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"partition_order": 0, "radix_order": 0,
                            "probe": 0, "match_table": 0, "like_table": 0,
                            "substring": 0, "seg_sum": 0}

#: kernel name -> the size (rows or entries) of each launch, kept only
#: while :func:`record_sizes` has it on
SIZES: Optional[Dict[str, List[int]]] = None

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: source stem -> nvcc's register / shared-memory report (-Xptxas -v)
PTXAS_REPORT: Dict[str, str] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def record_sizes(on: bool) -> Dict[str, List[int]]:
    """Start (``on``) or stop keeping each launch's size; returns what was
    kept since the last start."""
    global SIZES
    kept = SIZES or {}
    SIZES = {} if on else None
    return kept


def count_launch(name: str, size: int) -> None:
    """One launch of kernel ``name`` over ``size`` rows or entries."""
    LAUNCHES[name] += 1
    if SIZES is not None:
        SIZES.setdefault(name, []).append(size)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "spark_rapids_tpu_torch cannot be built")
    return path


def _lib_path(stem: str) -> str:
    with open(os.path.join(CSRC, stem + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def build(stems=SOURCES) -> Dict[str, str]:
    """Compile every source not yet built, all ``nvcc`` processes started
    together. Returns stem -> library path. Raises with the compiler's
    output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {s: _lib_path(s) for s in stems}
    procs = {}
    for stem, path in todo.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, stem + ".cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    errors = []
    for stem, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        PTXAS_REPORT[stem] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {stem}.cu:\n{out}")
            continue
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def load(stem: str) -> ctypes.CDLL:
    """The built library for ``csrc/<stem>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path = build((stem,))[stem]
            lib = ctypes.CDLL(path)
            _declare(stem, lib)
            _libs[stem] = lib
        return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _declare(stem: str, lib: ctypes.CDLL) -> None:
    if stem == "sort":
        lib.srt_k1_scratch_bytes.argtypes = []
        lib.srt_k1_scratch_bytes.restype = ctypes.c_size_t
        lib.srt_k1_partition_order.argtypes = [_P, _I, _P, _P, ctypes.c_uint,
                                               _P, _P]
        lib.srt_k1_partition_order.restype = _I
        lib.srt_k2_scratch_bytes.argtypes = [_I, _I, ctypes.POINTER(_I)]
        lib.srt_k2_scratch_bytes.restype = ctypes.c_size_t
        lib.srt_k2_radix_order.argtypes = [
            _I, ctypes.POINTER(_P), ctypes.POINTER(_I), ctypes.POINTER(_I),
            _I, _P, _P, _P]
        lib.srt_k2_radix_order.restype = _I
    elif stem == "join":
        lib.srt_k3_probe.argtypes = [_P, _I, _P, _I, _P, _I, _P, _P, _P]
        lib.srt_k3_probe.restype = _I
    elif stem == "strings":
        lib.srt_k4_match_table.argtypes = [_P, _P, _I, _I, ctypes.c_char_p,
                                           _I, _I, _P, _P]
        lib.srt_k4_match_table.restype = _I
        lib.srt_k5_like_table.argtypes = [
            _P, _P, _I, _I, ctypes.c_char_p, ctypes.c_char_p, _I, _P, _I, _I,
            _I, _I, _P, _P]
        lib.srt_k5_like_table.restype = _I
        lib.srt_k6_substring.argtypes = [_P, _P, _I, _I, _LL, _LL, _I, _P,
                                         _P, _P]
        lib.srt_k6_substring.restype = _I
    elif stem == "groupby":
        lib.srt_seg_fold_chunk.argtypes = []
        lib.srt_seg_fold_chunk.restype = _LL
        lib.srt_seg_fold.argtypes = [_I, _I, _P, _I, _LL, _P, _P, _LL, _P,
                                     _P, _P, ctypes.c_uint, _P]
        lib.srt_seg_fold.restype = _I


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t "
                           f"{err}")


def stream_handle(device) -> int:
    """The raw handle of ``device``'s current stream, from torch's raw
    accessor: cheaper than building a Stream object on every launch."""
    import torch

    index = torch.device(device).index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def require_cuda(name: str, tensors: List, dtypes: Optional[List] = None
                 ) -> None:
    """Validate what a kernel takes: one CUDA device, contiguous, and the
    stated dtypes."""
    dev = tensors[0].get_device()  # -1 on the CPU
    for i, t in enumerate(tensors):
        if dev < 0 or t.get_device() != dev:
            raise ValueError(f"{name}: every tensor must be on "
                             f"{tensors[0].device}, a CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor {i} is not contiguous")
        if dtypes is not None and dtypes[i] is not None and \
                t.dtype != dtypes[i]:
            raise TypeError(f"{name}: tensor {i} has dtype {t.dtype}, "
                            f"expected {dtypes[i]}")
    if tensors[0].numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 - 1 rows")
