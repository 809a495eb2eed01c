"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

``flash_attention_fwd`` launches ``csrc/flash_attention.cu`` for CUDA
tensors and runs ``flash_attention_plain`` for CPU tensors.  Both compute
the reference package's Pallas ``flash_attention_fwd``: GQA attention
(q-head h reads kv-head h*K//H) with scale D^-0.5, fp32 softmax, the
top-left causal mask ``k_pos <= q_pos``, and ``(out, lse)`` with
``lse = m + log(max(l, 1e-37))``.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import CudaKernel

NEG_INF = -2.0e38
HEAD_DIMS = (32, 64, 128)

_p, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "flash_attention.cu", "repro_flash_attention_fwd",
    [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Masked softmax attention with materialised scores, in fp32.
    q (B,Sq,H,D), k (B,Skv,K,D), v (B,Skv,K,Dv) -> out (B,Sq,H,Dv) in
    q's dtype, lse (B,H,Sq) fp32."""
    B, Sq, H, D = q.shape
    Skv, K, Dv = v.shape[1], k.shape[2], v.shape[3]
    G = H // K
    qg = q.float().reshape(B, Sq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (D ** -0.5)
    if causal:
        kpos = torch.arange(Skv, device=q.device)
        qpos = torch.arange(Sq, device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1).clamp_min(1e-37)
    out = torch.einsum("bkgqs,bskv->bqkgv", p, v.float())
    out = out / l.permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(l)).reshape(B, H, Sq)
    return out.reshape(B, Sq, H, Dv).to(q.dtype), lse


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd: q, k, v must be 4-D "
                         "(B,S,heads,head_dim)")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention_fwd: {H} q-heads not a multiple "
                         f"of {k.shape[2]} kv-heads")
    if Sq == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention_fwd: empty sequence")


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """Returns (out (B,Sq,H,Dv) in q's dtype, lse (B,H,Sq) fp32).

    CPU tensors go to the plain version; CUDA tensors to the kernel,
    which raises on what it does not take."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_fwd: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}; need one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_fwd: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes one of float32, bfloat16")
    B, Sq, H, D = q.shape
    _, Skv, K, Dv = v.shape
    if D not in HEAD_DIMS or Dv != D:
        raise ValueError(f"flash_attention_fwd: head dims D={D}, Dv={Dv}; the "
                         f"kernel takes D == Dv in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: inputs must be contiguous")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      lse.data_ptr(), B, Sq, Skv, H, K, D, int(causal),
                      _DTYPES[q.dtype], stream)
    return out, lse
