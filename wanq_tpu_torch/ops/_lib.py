"""Build, load and launch the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` -- one
nvcc process per source, all started together -- and linked into one
shared library with a plain C interface, at first use, into
``wanq_tpu_torch/_build/``. The library's file name carries a hash of the
sources and flags, so an edited source is rebuilt. The library is bound
with ``ctypes``: every pointer and the CUDA stream pass as ``c_void_p``,
and each entry point returns the launch's ``cudaError_t``, which
:func:`launch` raises on. The attention kernels (K4, K10, and K11 / K12 of the
backward) and the wgmma int GEMMs (K2, K8, K9) build their TMA tensor maps
on the host per launch; they look ``cuTensorMapEncodeTiled`` up in the
``libcuda.so.1`` that PyTorch has already loaded (``csrc/sm90.cuh``), so the
link line names no further library.

Each launch adds one to the kernel's count in :data:`LAUNCHES` (read and
reset through :func:`launch_counts` / :func:`reset_launch_counts`), so a run
can show that the main path went through the kernels and not through
their plain PyTorch versions.

Nothing here runs at import: the tests import every module on machines
without ``nvcc`` or a card.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# no --use_fast_math: it would change division, sqrt and rounding
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# C entry point -> argument types (the trailing stream included)
_SIGNATURES = {
    "wanq_ln_modulate_quant": [_P, _I, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _F, _P],
    "wanq_w8a8_gemm": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "wanq_w8a8_gemm_gelu_quant": [_P] * 10 + [_I, _I, _I, _P],
    "wanq_quant_sum": [_P, _I, _I, _P, _P, _P, _P, _LL, _I, _P],
    "wanq_gelu_bf16_check": [_P, _P, _P],
    "wanq_w4a8_gemm": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "wanq_w4a8_gemm_gelu_quant": [_P] * 10 + [_I, _I, _I, _P],
    "wanq_w4a4_gemm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "wanq_rms_rope_heads": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _F, _P],
    "wanq_flash_attention": [_P, _P, _P, _P, _LL, _I, _I, _I] + [_LL] * 12
    + [_I, _F, _I, _P, _P, _P],
    "wanq_flash_bwd_dq": [_P] * 6 + [_LL, _I, _I, _I, _P, _I, _F, _P],
    "wanq_flash_bwd_dkv": [_P] * 7 + [_LL, _I, _I, _I, _P, _I, _F, _P],
    "wanq_quantize_qkv_int8": [_P] * 3 + [_LL] * 9 + [_P] * 7 + [_LL, _I, _I, _I, _P],
    "wanq_attention_int8": [_P] * 7 + [_LL, _I, _I, _I, _I, _F, _LL, _LL, _LL, _P],
}

LAUNCHES: "collections.Counter[str]" = collections.Counter()
_lib: Optional[ctypes.CDLL] = None
last_build: Dict[str, object] = {}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libwanq_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is built."""
    so = library_path()
    if so.exists():
        last_build.update(path=str(so), seconds=0.0, cached=True)
        return so
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{f.stem}.o" for f in cu]
    t0 = time.time()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True, cwd=str(CSRC)))
             for cmd in ([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(f)]
                         for f, o in zip(cu, objs))]
    logs, failed = [], []
    for cmd, proc in procs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    tmp = so.with_name(f"{tag}.tmp")
    if not failed:
        cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            failed.append(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}")
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, so)
    log = "".join(logs)
    (BUILD_DIR / "build.log").write_text(log)
    last_build.update(path=str(so), seconds=time.time() - t0, cached=False, log=log)
    return so


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        handle.wanq_error_string.argtypes = [ctypes.c_int]
        handle.wanq_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def launch(counter: str, entry: str, *args) -> None:
    """Call C entry point ``entry`` on the current stream; raise on error."""
    handle = lib()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(handle, entry)(*args, stream)
    if err != 0:
        msg = handle.wanq_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")
    LAUNCHES[counter] += 1


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def require_cuda(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    """Checks a kernel operand; raises instead of falling back."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
