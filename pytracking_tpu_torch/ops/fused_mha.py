"""Fused multi-head self-attention for small head dims: the port of the Pallas
TPU kernel in `pytracking_tpu/ops/pallas_mha.py`.

`fused_self_attention` takes (B, L, H, D) tensors, as the JAX function does.
On a CUDA tensor it launches the hand-written kernel of
`csrc/fused_mha.cu` (built with nvcc for sm_90a at first use, bound with
ctypes; bf16 runs a wgmma/TMA kernel that skips key tiles with no kept key,
float32 a scalar one); on a CPU tensor it computes
`fused_self_attention_reference`, the plain PyTorch version of the same
arithmetic. There is no fallback between the two: a CUDA tensor the kernel
does not take raises.

Numerics (both versions): logits accumulate in float32 and are scaled after
QK^T, masked keys get an additive -1e30, the softmax is float32, the
probabilities are cast to the input dtype before PV, and PV accumulates in
float32. A row whose keys are all masked gets the mean of V over the L real
keys (the XLA attention of the JAX package gives the same; the Pallas kernel
instead divides by its lane-padded length).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

_MASK_BIAS = -1e30
HEAD_DIMS = (32,)        # the TaMOs encoder's; the kernel is built for these
MAX_LEN_BF16 = 65536     # the bf16 kernel keeps a per-key-tile table in shared memory
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCE = os.path.join(CSRC_DIR, "fused_mha.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")


def nvcc_command(source: str, output: str, verbose: bool = False) -> list:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    report = ["-Xptxas", "-v"] if verbose else []
    return [nvcc, *report, *NVCC_FLAGS, "-o", output, source]


def source_digest(csrc_dir: str = CSRC_DIR) -> str:
    """Hash of every file under `csrc_dir` (relative names and contents, so a
    changed or added header counts) and of NVCC_FLAGS: the build's cache key."""
    h = hashlib.sha256()
    for root, dirs, files in os.walk(csrc_dir):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            h.update(os.path.relpath(path, csrc_dir).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read() + b"\0")
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile csrc/fused_mha.cu into _build/ (once per source_digest) and
    return the library path. With `verbose`, ptxas' register and shared
    memory report is printed."""
    lib = os.path.join(BUILD_DIR, f"libfused_mha_{source_digest()}.so")
    if os.path.isfile(lib) and not verbose:
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(nvcc_command(SOURCE, tmp, verbose), capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{res.stdout}{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr, flush=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.fused_mha_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                  + [ctypes.c_float, ctypes.c_void_p])
    lib.fused_mha_fwd.restype = ctypes.c_int
    return lib


def fused_self_attention_reference(query: torch.Tensor, key: torch.Tensor,
                                   value: torch.Tensor,
                                   key_keep_mask: Optional[torch.Tensor] = None,
                                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's arithmetic. (B, L, H, D) in and
    out; key_keep_mask (B, L) bool, True = attend."""
    D = query.shape[-1]
    scale = float(D) ** -0.5 if sm_scale is None else sm_scale
    s = torch.einsum("bqhd,bkhd->bhqk", query.float(), key.float()) * scale
    if key_keep_mask is not None:
        bias = torch.where(key_keep_mask, 0.0, _MASK_BIAS).to(torch.float32)
        s = s + bias[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(query.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, value.float()).to(query.dtype)


def fused_self_attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                         key_keep_mask: Optional[torch.Tensor] = None,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention for (B, L, H, D) tensors with small D; returns
    (B, L, H, D) in the input dtype. key_keep_mask: optional (B, L) bool,
    True = key is attendable (the inverse of torch's key_padding_mask).

    CUDA tensors: float32 or bfloat16, D in HEAD_DIMS, contiguous. Each launch
    adds one to `fused_self_attention.launches`. The kernel has no backward:
    on any device, an input that requires grad while autograd records
    raises (its output would carry no gradient)."""
    if key.shape != query.shape or value.shape != query.shape:
        raise ValueError("fused_self_attention is self-attention only "
                         f"(got q {tuple(query.shape)}, k {tuple(key.shape)}, "
                         f"v {tuple(value.shape)})")
    if query.dim() != 4:
        raise ValueError(f"expected (B, L, H, D) tensors, got {tuple(query.shape)}")
    B, L, H, D = query.shape
    if key_keep_mask is not None and (key_keep_mask.shape != (B, L)
                                      or key_keep_mask.dtype != torch.bool):
        raise ValueError("key_keep_mask must be a (B, L) bool tensor")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (query, key, value)):
        raise RuntimeError("fused_self_attention has no backward: call it with autograd off "
                           "(eval mode under torch.inference_mode or torch.no_grad); the "
                           "transformer's train mode takes the plain attention")
    if sm_scale is None:
        sm_scale = float(D) ** -0.5
    if query.device.type == "cpu":
        return fused_self_attention_reference(query, key, value, key_keep_mask, sm_scale)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")

    tensors = [query, key, value] + ([key_keep_mask] if key_keep_mask is not None else [])
    if any(t.device != query.device for t in tensors):
        raise ValueError("query, key, value and mask must be on one device")
    if query.dtype not in _DTYPE_CODES or key.dtype != query.dtype \
            or value.dtype != query.dtype:
        raise ValueError(f"kernel takes float32 or bfloat16, got {query.dtype}, "
                         f"{key.dtype}, {value.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"kernel takes head dims {HEAD_DIMS}, got {D}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid limit 65535")
    if query.dtype == torch.bfloat16 and L > MAX_LEN_BF16:
        raise ValueError(f"the bf16 kernel takes L <= {MAX_LEN_BF16}, got {L}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors[:3]):
        raise ValueError("query, key and value must be contiguous and 16-byte aligned")
    keep = None if key_keep_mask is None else key_keep_mask.contiguous()

    out = torch.empty_like(query)
    lib = _library()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    with torch.cuda.device(query.device):
        err = lib.fused_mha_fwd(query.data_ptr(), key.data_ptr(), value.data_ptr(),
                                None if keep is None else keep.data_ptr(),
                                out.data_ptr(), B, L, H, D, _DTYPE_CODES[query.dtype],
                                float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"fused_mha_fwd launch failed with CUDA error {err}")
    fused_self_attention.launches += 1
    return out


fused_self_attention.launches = 0
