"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` of the package is compiled for ``sm_90a`` by its own
``nvcc`` process, all started together, and one more ``nvcc`` links the
objects into ``build/torch_kernels/libssq_torch_kernels.so`` at the
repository root, which ``.gitignore`` lists. The library has a plain C
interface and is loaded with ``ctypes``: no PyTorch headers, so the build
takes seconds; ``int_matmul.cu`` alone includes CuTe (CUTLASS's headers,
``CUTLASS_INCLUDE``, by default ``/usr/local/cutlass/include``) for its
wgmma shared-memory layouts. It runs at first use and is cached by a hash
of the sources and the flags; a failed build raises with nvcc's stderr.
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

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libssq_torch_kernels.so"
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
CUTLASS_INCLUDE = os.environ.get("CUTLASS_INCLUDE",
                                 "/usr/local/cutlass/include")
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v", "--expt-relaxed-constexpr",
              "-I", CUTLASS_INCLUDE]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes. Every entry returns cudaGetLastError().
SIGNATURES = {
    # x, codes, w_packed, w_zp, scale, bias, qp, out, B, H, W, K, stride,
    # N, bits, relu, vec, requant, stream
    "ssq_packed_qmm": [_P, _I] + [_P] * 6 + [_I] * 9 + [_P, _P],
    # x, w (wgmma B tiles, bf16), scale, bias, qp, out, B, H, W, OC, stream
    "ssq_stem_fused": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, w (C, 3) tap words, scalef, biasf, qp, out, B, H, W, C, stride,
    # act, stream
    "ssq_dw_conv3x3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, chunks (prepare_mbconv records), ap, qp, out, B, H, W, CI, CE, CO,
    # has_expand, has_residual, R, cls, G (launch_plan), stream
    "ssq_mbconv_fused": [_P] * 5 + [_I] * 11 + [_P],
    # x, w (K, N), scale, bias, qp, out, M, K, N, relu, stream
    "ssq_quant_matmul": [_P] * 6 + [_I] * 4 + [_P],
    # codes, w (S, N, K), table, acc_offset, delta, out, S, B, H, W, C, KH,
    # KW, SH, SW, PH, PW, N, pad, vec, requant, stream
    "ssq_int8_conv": [_P] * 6 + [_I] * 14 + [_P, _P],
    # codes, w (S, N, KH*KW*Cg), table, acc_offset, delta, out, S, B, H, W,
    # C, KH, KW, SH, SW, PH, PW, N, G, pad, plan (group_conv.LaunchPlan as
    # ints), requant, stream
    "ssq_int8_group_conv": [_P] * 6 + [_I] * 14 + [_P] * 3,
    # codes, w (S, C, K*K), table, acc_offset, delta, out, S, B, H, W, C, K,
    # stride, pad, requant, stream
    "ssq_dw_conv_int8": [_P] * 6 + [_I] * 8 + [_P, _P],
    # x, delta, zp, out, R, C, per_row, lo, hi, stream
    "ssq_fake_quant": [_P] * 4 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None      # wall time of this process's build, if it built
build_log = ""            # ptxas resource lines (registers, shared memory)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _start(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc) -> str:
    """Wait for an nvcc process; its stderr, or raise with it."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(proc.args)}\n{err}")
    return err


def build() -> Path:
    """Compile the library unless a build of the same sources exists."""
    global build_seconds, build_log
    sources = _sources()
    digest = _digest(sources)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    if lib_path.exists() and stamp.exists() \
            and stamp.read_text().strip() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    procs = [_start([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
             for src, obj in zip(sources, objs)]
    try:
        logs = [_finish(proc) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    _finish(_start([nvcc, *GENCODE, "-shared", "-o", str(tmp),
                    *map(str, objs)]))
    for obj in objs:
        obj.unlink()
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ssq_error_string.argtypes = [ctypes.c_int]
            lib.ssq_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        msg = lib.ssq_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
