"""Build and load the port's hand-written CUDA kernels at first use.

All sources under ``scenedepthestimation_tpu_torch/csrc/`` are compiled by
``nvcc`` for ``sm_90a`` (Hopper) into ONE shared library with a plain C
interface, loaded with ``ctypes``. That takes seconds, where a build that
includes PyTorch's headers takes minutes. The library lives in
``build/torch_kernels/<hash>/`` at the repository root, keyed on a hash of
the sources and the flags, so an edit rebuilds and an unchanged tree
reuses the library.

There is no fallback: a missing ``nvcc``, a failed build or a refused
launch raises. The wrappers that launch kernels (``conv_block``,
``upsample_concat``, ``correlation``, ``correlation_gram``,
``soft_argmin``, ``fused_tail``, ``winograd``) add one to
:data:`LAUNCHES` per launch, so a run can show that its main path went
through them.
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
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
LIB_NAME = "libsde_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, kept in nvcc.log
)

# Kernel launches by wrapper name, counted where each wrapper launches.
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Seconds the build took in this process; 0.0 when the library existed.
build_seconds: Optional[float] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # x, w, slab, bias, out, workspace, splits, B, H, W, Cin, Cout, dtype,
    # out_f32, act, border, device, stream
    "sde_conv3x3": (_P,) * 6 + (_I,) * 11 + (_P,),
    # B, H, W, Cin, Cout, dtype, num_sms
    "sde_conv3x3_splits": (_I,) * 7,
    # w, slab, Cin, Cout, device, stream
    "sde_conv3x3_arrange": (_P, _P, _I, _I, _I, _P),
    # x, skip, out, B, H, W, C1, C2, esize, device, stream
    "sde_upsample_concat": (_P, _P, _P) + (_I,) * 7 + (_P,),
    # fl, fr, out, rows, W, C, D, dtype, device, stream
    "sde_correlation": (_P, _P, _P) + (_I,) * 6 + (_P,),
    # fl, fr, out, rows, W, C, D, device, stream
    "sde_correlation_gram": (_P, _P, _P) + (_I,) * 5 + (_P,),
    # cost, out, n, D, dtype, scale, depth, fb, device, stream
    "sde_soft_argmin": (_P, _P, _L, _I, _I, _F, _I, _F, _I, _P),
    # y1, w00, b00, w01, b01, y0, B, h, w, C1, C0, C0o, dtype, device, stream
    "sde_fused_tail": (_P,) * 6 + (_I,) * 8 + (_P,),
    # x00..x11, sxb, sxh, sxw, r00..r11, srb, srh, srw, u, bias, y00..y11,
    # syb, syh, syw, B, Hp, Wp, C, Co, relu, dtype, device, stream
    "sde_winograd": (_P,) * 4 + (_L,) * 3 + (_P,) * 4 + (_L,) * 3 + (_P,) * 6
    + (_L,) * 3 + (_I,) * 8 + (_P,),
}


def _sources() -> list:
    return sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location. Raises when none exists."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from source at first use"
    )


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB_NAME)


def build() -> str:
    """Compile the library unless it exists; returns its path."""
    global build_seconds
    path = library_path()
    if os.path.exists(path):
        if build_seconds is None:
            build_seconds = 0.0
        return path
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    # One nvcc per source, all started together, then one link: the build
    # takes about as long as its slowest source. A job's output (ptxas's
    # report, a few KB) waits in its pipe until its turn to be read.
    jobs, objs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        objs.append(os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o"))
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", objs[-1], src]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    text, failed = [], []
    for cmd, proc in jobs:
        out, _ = proc.communicate()
        text.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out[-4000:]}")
    tmp = f"{path}.{tag}"
    if not failed:
        link = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        text.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
        f.write("\n".join(text))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, path)  # atomic: a concurrent process sees all or nothing
    build_seconds = time.perf_counter() - t0
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.sde_fused_tail_smem.argtypes = [_I] * 4
            handle.sde_fused_tail_smem.restype = _L
            handle.sde_error_string.argtypes = [ctypes.c_int]
            handle.sde_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib().sde_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
