"""Build and bind the port's CUDA kernels (``deepspeed_tpu_torch/csrc``).

Every ``csrc/*.cu`` compiles with ``nvcc -gencode arch=compute_90a,
code=sm_90a -O3`` to an object file (one ``nvcc`` per source, all started
together), and the objects link into one shared library with a plain C
interface, loaded with :mod:`ctypes`.  Nothing includes PyTorch's headers,
so a full build takes seconds, not minutes.

The library is built at first use into ``build/deepspeed_tpu_torch/`` at the
root of the checkout, named by a hash of the sources so an edited kernel
never loads a stale build.  Pointers and the stream travel as
``ctypes.c_void_p``; every entry point returns ``cudaGetLastError()`` after
its launch and :func:`check` raises when that is not 0.
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "deepspeed_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# the kernels' `dtype` argument, and the head dims they are instantiated for:
# B1-B3 and B5 take all three codes (B5: a float16 q over bfloat16 pages),
# the fused Adam, B7-B9 and the int8 K/V write only F32_BF16
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
F32_BF16 = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (csrc/*.cu, extern "C")
SIGNATURES = {
    # q, k, v, seg, o, lse, B, T, S, H, KV, D, scale, causal, dtype, body,
    # stream
    "dstt_flash_fwd": [_P] * 6 + [_I] * 6 + [_F, _I, _I, _I, _P],
    # q, k, v, o, do, lse, delta (written), seg, dq, B, T, S, H, KV, D,
    # scale, causal, dtype, body, stream
    "dstt_flash_bwd_dq": [_P] * 9 + [_I] * 6 + [_F, _I, _I, _I, _P],
    # q, k, v, do, lse, delta, seg, dk, dv, B, T, S, H, KV, D, scale, causal,
    # dtype, body, stream
    "dstt_flash_bwd_dkv": [_P] * 9 + [_I] * 6 + [_F, _I, _I, _I, _P],
    # g, m, v, p, u, m_out, v_out, n, b1, 1-b1, b2, 1-b2, eps, wd, c1, c2,
    # lr, g_dtype, p_dtype, stream
    "dstt_fused_adam": [_P] * 7 + [ctypes.c_longlong] + [_F] * 9
    + [_I, _I, _P],
    # q, kp, vp, table, start, out, B, C, H, KV, D, P, ps, mp, scale, dtype,
    # body, counters, part, span_pages, stream
    "dstt_paged_attention": [_P] * 6 + [_I] * 8 + [_F, _I, _I, _P, _P, _I, _P],
    # q, kq, ks, vq, vs, table, start, out, B, C, H, KV, D, P, ps, mp, scale,
    # dtype, body, counters, part, span_pages, stream
    "dstt_paged_attention_quant": [_P] * 8 + [_I] * 8
    + [_F, _I, _I, _P, _P, _I, _P],
    # q, kp, vp, table, start, part_m, part_l, part_acc, B, C, H, KV, D, P,
    # ps, mp, split_keys, nsplit, scale, dtype, stream
    "dstt_paged_split": [_P] * 8 + [_I] * 10 + [_F, _I, _P],
    # part_m, part_l, part_acc, out, B, C, H, KV, D, nsplit, dtype, stream
    "dstt_paged_combine": [_P] * 4 + [_I] * 7 + [_P],
    # logits, out, B, V, row_stride, dtype, spans, stream
    "dstt_greedy_argmax": [_P, _P, _I, _I, ctypes.c_longlong, _I, _I, _P],
    # x, q, scale, n_groups, group_size, dtype, body, stream
    "dstt_quantize_int8": [_P] * 3 + [ctypes.c_longlong] * 2 + [_I, _I, _P],
    # new_k, new_v, table, start, kq, ks, vq, vs, B, T, C, KV, D, P, ps, mp,
    # dtype, stream
    "dstt_quantize_write_kv": [_P] * 8 + [_I] * 9 + [_P],
    # x, out, n, stream
    "dstt_env_probe": [_P, _P, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdstt_kernels_{source_hash()}.so"


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link them into the
    shared library; returns its path.  A build that is already there for
    these sources is reused."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                   "-fPIC", "-c", str(src), "-o", str(obj)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, p in procs:
            log, _ = p.communicate()
            if verbose and log:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if p.returncode:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, out)
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
