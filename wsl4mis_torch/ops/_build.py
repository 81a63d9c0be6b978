"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each source under ``wsl4mis_torch/csrc/`` compiles with ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, not minutes). Libraries go to ``build/wsl4mis_torch/`` at
the repository root, named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads as it is. All sources
build in parallel, one ``nvcc`` process each, on the first call that
needs any of them.

Pointers and the stream are passed as ``ctypes.c_void_p``; every entry
point returns ``cudaGetLastError()``, and ``check`` raises on a non-zero
code.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "wsl4mis_torch")

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# name -> (source file, extra nvcc flags, {function: argtypes})
LIBRARIES = {
    # -split-compile=0: the f32 kernels' unrolled bodies took ptxas most
    # of a minute in one thread; split over the CPUs, about 15 s
    "conv3x3": (
        "conv3x3.cu",
        ["-split-compile=0"],
        {
            "conv3x3_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
            "conv3x3_stats_rows": [_I, _I, _I, _I, _I],
            "conv3x3_fwd_stats": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _P],
            "conv3x3_wgrad_splits": [_I, _I, _I, _I, _I, _I],
            "conv3x3_wgrad": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        },
    ),
    # -fmad=false: the rotate's coordinates must round like the plain
    # version's separate multiply and add (see the source's note)
    "augment": (
        "augment.cu",
        ["-fmad=false"],
        {"augment": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
         "augment_s2l": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]},
    ),
    "maxpool": (
        "maxpool.cu",
        [],
        {
            "maxpool_fwd": [_P, _P, _I, _I, _I, _I, _I, _P],
            "maxpool_bwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        },
    ),
    # -fmad=false: the forward rounds each multiply and add as the eager
    # chain's separate kernels do (see the source's note)
    "bn_act": (
        "bn_act.cu",
        ["-fmad=false"],
        {
            "bn_act_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _F, _F, _F, _F, _F, _F, _I, _I, _I, _P],
            "bn_act_blocks": [_I, _I, _I],
            "bn_act_sums": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _I,
                            _P],
            "bn_act_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                           _I, _P],
        },
    ),
    # weights, xy sigmas and desc_of are host arrays (float[nd], float[nd],
    # int[F]), copied into the kernel's by-value arguments
    "gated_crf": (
        "gated_crf.cu",
        [],
        {
            "gated_crf_products": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _I, _P, _P, _P, _P],
        },
    ),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc/ptxas output per library


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of wsl4mis_torch "
        "build from source at first use"
    )


def _target(name: str) -> tuple[str, list[str]]:
    src, extra, _ = LIBRARIES[name]
    flags = _ARCH + _FLAGS + extra
    h = hashlib.sha256()
    for fname in sorted(os.listdir(CSRC)):  # headers may be shared
        if fname == src or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    h.update(" ".join(flags).encode())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    return out, flags


def _bind(name: str, path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, argtypes in LIBRARIES[name][2].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.wsl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.wsl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_all() -> dict[str, ctypes.CDLL]:
    """Build (in parallel) whatever is not built yet, load every library."""
    with _lock:
        missing = [n for n in LIBRARIES if n not in _libs]
        if not missing:
            return _libs
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name in missing:
            out, flags = _target(name)
            if os.path.isfile(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *flags, "-o", tmp,
                   os.path.join(CSRC, LIBRARIES[name][0])]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in missing:
            _libs[name] = _bind(name, _target(name)[0])
        return _libs


def lib_path(name: str) -> str:
    """The built shared library of `name` (building it first if needed)."""
    load_all()
    return _target(name)[0]


def lib(name: str) -> ctypes.CDLL:
    libs = _libs if name in _libs else load_all()
    return libs[name]


def check(library: str, kernel: str, err: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        msg = _libs[library].wsl_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({msg})")


def on_device(t):
    """A context in which t's card is the current device (the kernels launch
    on the current device): a no-op when it already is."""
    idx = t.device.index
    if idx == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(idx)


def stream(t):
    """The handle of the current stream of t's card, without building a
    torch.cuda.Stream object."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
