"""Flash-decode: the CUDA kernel's wrapper and its plain version.

``decode_attention_fwd`` launches ``csrc/decode_attention_sm90.cu`` for
CUDA tensors and runs ``decode_attention_plain`` for CPU tensors.  Both compute
the reference package's Pallas ``decode_attention_fwd``: one query token
per (batch, q-head) against the cache, positions past ``cache_index``
(inclusive, one scalar for the batch) masked, GQA via h*K//H, fp32
softmax, output in the cache dtype.
"""

from __future__ import annotations

import ctypes

import torch

from .. import head_dims
from ..build import CudaKernel

NEG_INF = -2.0e38

_p, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "decode_attention_sm90.cu", "repro_decode_attention_fwd",
    [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_plain(q, k_cache, v_cache, *, cache_index: int):
    """Masked softmax over the cache in fp32.  q (B,1,H,D), caches
    (B,S,K,D[v]) -> (B,1,H,Dv) in the cache dtype."""
    B, S, K, D = k_cache.shape
    H, Dv = q.shape[2], v_cache.shape[-1]
    qg = q.float().reshape(B, K, H // K, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * (D ** -0.5)
    pos = torch.arange(S, device=q.device)
    s = torch.where(pos <= cache_index, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-37)
    out = torch.einsum("bkgs,bskv->bkgv", p, v_cache.float()) / l
    return out.reshape(B, 1, H, Dv).to(v_cache.dtype)


def _check(q, k_cache, v_cache, cache_index):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention_fwd: q must be (B,1,H,D), got "
                         f"{tuple(q.shape)}")
    B, _, H, D = q.shape
    if (k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[3] != D
            or v_cache.shape[:3] != k_cache.shape[:3]):
        raise ValueError(f"decode_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)} "
                         f"disagree")
    if H % k_cache.shape[2]:
        raise ValueError(f"decode_attention_fwd: {H} q-heads not a multiple "
                         f"of {k_cache.shape[2]} kv-heads")
    if not 0 <= cache_index < k_cache.shape[1]:
        raise ValueError(f"decode_attention_fwd: cache_index {cache_index} "
                         f"outside a cache of {k_cache.shape[1]} positions")


def decode_attention_fwd(q, k_cache, v_cache, *, cache_index: int):
    """Returns (B,1,H,Dv) in the cache dtype.  ``cache_index`` is a Python
    int (last valid position, inclusive).

    CPU tensors go to the plain version; CUDA tensors to the kernel,
    which raises on what it does not take."""
    cache_index = int(cache_index)
    _check(q, k_cache, v_cache, cache_index)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache,
                                      cache_index=cache_index)
    if (q.device.type != "cuda" or k_cache.device != q.device
            or v_cache.device != q.device):
        raise ValueError(f"decode_attention_fwd: q, caches on {q.device}, "
                         f"{k_cache.device}, {v_cache.device}; need one CUDA "
                         f"device")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention_fwd: dtypes {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}; the kernel takes "
                        f"one of float32, bfloat16")
    B, _, H, D = q.shape
    _, S, K, Dv = v_cache.shape
    head_dims.check("decode_attention_fwd", "decode", q.dtype, D, Dv)
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("decode_attention_fwd: inputs must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention_fwd: the caches must start on a "
                         "16-byte boundary (the kernel copies 16 bytes at a time)")
    out = torch.empty((B, 1, H, Dv), dtype=v_cache.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        KERNEL.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                      out.data_ptr(), B, S, H, K, D, cache_index,
                      _DTYPES[q.dtype], stream)
    return out
