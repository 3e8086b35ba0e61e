"""Build and load the package's CUDA kernels.

At first use, ``nvcc`` compiles every ``flash_attn_tpu_torch/csrc/*.cu``
for ``sm_90a`` (one process per source, all at once) and links them into
one shared library with a plain C interface, placed in
``flash_attn_tpu_torch/_build/`` under a name keyed by a hash of the
sources and flags, and loads it with ``ctypes``. Nothing includes PyTorch's
headers, so a build takes seconds. Without ``nvcc`` the build raises: there
is no fallback. ptxas reports each kernel's registers, shared memory and
spills (``-Xptxas -v``); the report is kept beside the library
(``build_log``).

Each C entry point returns ``cudaGetLastError()`` after its launch, or a
CUDA error code for arguments it refuses; ``check`` raises on any nonzero
code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint32
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, strides, seg_plan, b, h, h_kv, sq, sk, d, scale,
    # causal, seed, threshold, rp, window_left, window_right, sinks,
    # softcap, alibi, dtype, stream
    "fattn_flash_fwd": [_P] * 7 + [_I] * 6 + [_F, _I, _U, _U, _F]
    + [_I] * 3 + [_F, _P, _I, _P],
    # q, k, v, o, dout, lse, dlse, stats, dq_acc, dq, dk, dv, strides,
    # seg_plan, b, h, h_kv, sq, sk, d, scale, causal, seed, threshold, rp,
    # window_left, window_right, sinks, softcap, alibi, dtype, stream
    "fattn_flash_bwd": [_P] * 14 + [_I] * 6 + [_F, _I, _U, _U, _F]
    + [_I] * 3 + [_F, _P, _I, _P],
    # q_seg, kv_seg, q_pos, kv_pos, plan, b, sq, sk, causal, window_left,
    # window_right, stream
    "fattn_seg_plan": [_P] * 5 + [_I] * 6 + [_P],
    # b, sq, sk -> int32 words of the plan (long long)
    "fattn_seg_plan_words": [_I] * 3,
    # q, q_sb, q_sh, k_pages, v_pages, lengths, page_table, out, partials,
    # new_k, new_v, new rows' strides of batch and head, b, h_kv, group,
    # num_pages, page_size, pages_max, n_splits, split_keys, d, scale,
    # window_left, sinks, softcap, alibi, dtype, stream
    "fattn_paged_decode": [_P, _L, _L] + [_P] * 8 + [_L] * 2 + [_I] * 9
    + [_F, _I, _I, _F, _P, _I, _P],
    # q, q_sb, q_st, q_sh, k_pages, v_pages, lengths, chunk_lens,
    # page_table, out, partials, new_k, new_v, cache_lens, new rows'
    # strides of batch, token and head, b, sq, h_kv, group, num_pages,
    # page_size, pages_max, n_splits, split_keys, d, scale, window_left,
    # softcap, alibi, dtype, stream
    "fattn_paged_chunk": [_P, _L, _L, _L] + [_P] * 10 + [_L] * 3 + [_I] * 10
    + [_F, _I, _F, _P, _I, _P],
    # new_k, new_v, k_pages, v_pages, page_table, lengths, new_lens, b, sq,
    # h, num_pages, page_size, pages_max, d, new rows' strides of batch,
    # token and head, elem_bytes, stream
    "fattn_append_span": [_P] * 7 + [_I] * 7 + [_L] * 3 + [_I, _P],
    # new_k, new_v, k_pages, v_pages, page_table, lengths, b, h,
    # num_pages, page_size, pages_max, d, new rows' strides of batch and
    # head, elem_bytes, stream
    "fattn_append_token": [_P] * 6 + [_I] * 6 + [_L] * 2 + [_I, _P],
    # k, v, k_pages, v_pages, page_table, b, len, n_pages, h, num_pages,
    # page_size, d, k/v strides of row, token and head, elem_bytes, stream
    "fattn_write_pages": [_P] * 5 + [_I] * 7 + [_L] * 3 + [_I, _P],
    # q, k, v, o, lse, strides, kv_idx, kv_cnt, kv_full, rowmask, q_valid,
    # k_valid, key_bits, b, h, sq, sk, d, max_kv, ncells, scale, causal,
    # seed, threshold, rp, dtype, stream
    "fattn_blocksparse_fwd": [_P] * 13 + [_I] * 7 + [_F, _I, _U, _U, _F, _I,
                                                     _P],
    # q, k, v, dout, lse, di, dk, dv, stats, strides, q_idx, q_cnt, q_full,
    # rowmask, rowmask_t, q_valid, k_valid, b, h, sq, sk, d, max_q, ncells,
    # scale, causal, seed, threshold, rp, dtype, stream
    "fattn_blocksparse_dkv": [_P] * 17 + [_I] * 7 + [_F, _I, _U, _U, _F, _I,
                                                     _P],
    # q, k, v, dout, lse, di, dq, strides, kv_idx, kv_cnt, kv_full, rowmask,
    # q_valid, k_valid, key_bits, b, h, sq, sk, d, max_kv, ncells, scale,
    # causal, seed, threshold, rp, dtype, stream
    "fattn_blocksparse_dq": [_P] * 15 + [_I] * 7 + [_F, _I, _U, _U, _F, _I,
                                                    _P],
    # x, d, w, res, out, x and d row strides, rows, n, eps, dtype, w_dtype,
    # stream
    "fattn_add_rmsnorm": [_P] * 5 + [_L] * 2 + [_I] * 2 + [_F, _I, _I, _P],
    # q, its strides of batch, token and head, k, its strides, pos, its
    # strides of batch and token, inv_freq, q_norm, k_norm, b, s, hq, hk,
    # hd, eps, dtype, w_dtype, stream
    "fattn_qk_rope": [_P] + [_L] * 3 + [_P] + [_L] * 3 + [_P] + [_L] * 2
    + [_P] * 3 + [_I] * 5 + [_F, _I, _I, _P],
    # gate, up, out, gate and up row strides, rows, n, dtype, stream
    "fattn_swiglu": [_P] * 3 + [_L] * 2 + [_I] * 3 + [_P],
    # d: the dynamic shared memory of K1's / K2's bf16/fp16 kernel
    "fattn_flash_fwd_smem": [_I],
    "fattn_flash_bwd_smem": [_I],
    # d: the dynamic shared memory of K5's / K6's bf16/fp16 kernel
    "fattn_paged_decode_smem": [_I],
    "fattn_paged_chunk_smem": [_I],
    # d: the dynamic shared memory of K8a's, K8b's and K8c's bf16/fp16
    # kernels
    "fattn_blocksparse_fwd_smem": [_I],
    "fattn_blocksparse_dkv_smem": [_I],
    "fattn_blocksparse_dq_smem": [_I],
}

# Return types other than the error code (int).
_RESTYPES = {"fattn_seg_plan_words": ctypes.c_longlong}
_lib: ctypes.CDLL | None = None


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of flash_attn_tpu_torch cannot be built"
    )


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfattn_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them already exists."""
    so = library_path()
    if so.exists():
        return so
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: refusing to build kernels")
    nvcc = _find_nvcc()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    objs = BUILD_DIR / f"obj_{os.getpid()}"
    objs.mkdir(parents=True, exist_ok=True)
    jobs = []  # (command, object file, process)
    try:
        for src in sorted(CSRC.glob("*.cu")):
            obj = objs / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report = []
        for cmd, _, proc in jobs:
            output, _ = proc.communicate()
            _check_run(cmd, proc.returncode, output)
            report.append(output)
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp),
                *(str(obj) for _, obj, _ in jobs)]
        done = subprocess.run(link, capture_output=True, text=True)
        _check_run(link, done.returncode, done.stdout + done.stderr)
    finally:
        for _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(objs, ignore_errors=True)
    so.with_suffix(".log").write_text("".join(report))
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def build_log() -> str | None:
    """ptxas's report (registers, shared memory, spills per kernel) of the
    build of the current sources, if this checkout built them."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else None


def _check_run(cmd, returncode, output) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{output}")


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        loaded.fattn_error_string.argtypes = [ctypes.c_int]
        loaded.fattn_error_string.restype = ctypes.c_char_p
        _lib = loaded
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        msg = lib().fattn_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_device(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA tensor on one device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, need CUDA")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device."""
    require_device(name, *tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} "
                             "is not contiguous")
