"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

``flash_attention_fwd`` launches ``csrc/flash_attention_sm90.cu`` for CUDA
bf16 tensors and ``csrc/flash_attention_sm90_fp32.cu`` for CUDA fp32 tensors
(both tensor cores and TMA; fp32 products as three tf32 products each), and
runs ``flash_attention_plain`` for CPU tensors.  All compute the reference
package's Pallas ``flash_attention_fwd``: GQA
attention (q-head h reads kv-head h*K//H) with scale D^-0.5, fp32 softmax,
the top-left causal mask ``k_pos <= q_pos``, and ``(out, lse)`` with
``lse = m + log(max(l, 1e-37))``.

``flash_attention_bwd`` launches ``csrc/flash_bwd_dq_sm90.cu`` then
``csrc/flash_bwd_dkv_sm90.cu`` for CUDA bf16 tensors,
``csrc/flash_bwd_dq_sm90_fp32.cu`` then ``csrc/flash_bwd_dkv_sm90_fp32.cu``
for CUDA fp32 tensors (all four tensor cores and TMA), and runs
``flash_attention_bwd_plain`` for CPU tensors.  All compute the reference's
Pallas ``flash_attention_bwd``: p recomputed from the forward's lse,
``Dvec = rowsum(dO * O)``, ``ds = p (dO V^T - Dvec) D^-0.5``, ``dq = ds K``,
``dk = ds^T Q``, ``dv = p^T dO``, all in fp32 (the bf16 kernels' products
take bf16 operands, with p and ds split into two bf16 terms each, and sum
in fp32; the fp32 kernels' products are three tf32 products each).
"""

from __future__ import annotations

import ctypes

import torch

from .. import head_dims
from ..build import CudaKernel

NEG_INF = -2.0e38

_p, _i = ctypes.c_void_p, ctypes.c_int
# the forward kernels take (q, k, v, out, lse, B, Sq, Skv, H, K, D, Dv,
# causal, stream)
_FWD_ARGS = [_p] * 5 + [_i] * 8 + [_p]
SM90_KERNEL = CudaKernel("flash_attention_sm90.cu",
                         "repro_flash_attention_fwd_sm90", _FWD_ARGS)
SM90_FP32_KERNEL = CudaKernel("flash_attention_sm90_fp32.cu",
                              "repro_flash_attention_fwd_sm90_fp32", _FWD_ARGS)
# the backward kernels all take (8 pointers, B, Sq, Skv, H, K, D, Dv,
# causal, stream)
_BWD_ARGS = [_p] * 8 + [_i] * 8 + [_p]
DQ_SM90_KERNEL = CudaKernel("flash_bwd_dq_sm90.cu", "repro_flash_bwd_dq_sm90",
                            _BWD_ARGS)
DKV_SM90_KERNEL = CudaKernel("flash_bwd_dkv_sm90.cu",
                             "repro_flash_bwd_dkv_sm90", _BWD_ARGS)
DQ_SM90_FP32_KERNEL = CudaKernel("flash_bwd_dq_sm90_fp32.cu",
                                 "repro_flash_bwd_dq_sm90_fp32", _BWD_ARGS)
DKV_SM90_FP32_KERNEL = CudaKernel("flash_bwd_dkv_sm90_fp32.cu",
                                  "repro_flash_bwd_dkv_sm90_fp32", _BWD_ARGS)
_DTYPES = (torch.float32, torch.bfloat16)


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


def _check(q, k, v, name="flash_attention_fwd"):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be 4-D (B,S,heads,head_dim)")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if H % k.shape[2]:
        raise ValueError(f"{name}: {H} q-heads not a multiple "
                         f"of {k.shape[2]} kv-heads")
    if Sq == 0 or k.shape[1] == 0:
        raise ValueError(f"{name}: empty sequence")


def _check_cuda(name, kind, q, k, v, *more):
    """What the kernels take: one CUDA device, one dtype (fp32 or bf16),
    head dims the ``kind`` ("flash_fwd" or "flash_bwd") of kernel takes
    (``head_dims``), contiguous tensors."""
    ts = (q, k, v) + more
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: inputs on "
                         f"{', '.join(str(t.device) for t in ts)}; need one "
                         "CUDA device")
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtypes "
                        f"{', '.join(str(t.dtype) for t in ts)}; the kernel "
                        "takes one of float32, bfloat16")
    head_dims.check(name, kind, q.dtype, q.shape[3], v.shape[3])
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")


def forward_kernel(dtype) -> CudaKernel:
    """The forward kernel a CUDA call of ``dtype`` launches: the Hopper
    tensor-core kernel of bf16 or of fp32."""
    return SM90_KERNEL if dtype == torch.bfloat16 else SM90_FP32_KERNEL


def backward_kernels(dtype) -> tuple[CudaKernel, CudaKernel]:
    """The (dq, dk/dv) kernels a CUDA backward of ``dtype`` launches: the
    Hopper tensor-core pair of bf16 or of fp32."""
    if dtype == torch.bfloat16:
        return DQ_SM90_KERNEL, DKV_SM90_KERNEL
    return DQ_SM90_FP32_KERNEL, DKV_SM90_FP32_KERNEL


def _check_tma(name, *ts):
    """The Hopper kernels read their inputs by TMA, from 16-byte
    boundaries."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: {str(ts[0].dtype)[6:]} inputs must start "
                         "on 16-byte boundaries (the kernel reads them by "
                         "TMA)")


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """Returns (out (B,Sq,H,Dv) in q's dtype, lse (B,H,Sq) fp32).

    CPU tensors go to the plain version; CUDA tensors to the kernel of
    their dtype (``forward_kernel``), which raises on what it does not
    take."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    _check_cuda("flash_attention_fwd", "flash_fwd", q, k, v)
    _check_tma("flash_attention_fwd", q, k, v)
    B, Sq, H, D = q.shape
    _, Skv, K, Dv = v.shape
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        forward_kernel(q.dtype).launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Sq, Skv, H, K, D, Dv, int(causal), stream)
    return out, lse


def flash_attention_bwd_plain(q, k, v, out, lse, g, *, causal: bool = True):
    """The backward recurrence with materialised scores, in fp32: p is
    recomputed from ``lse`` (not taken from autograd of the forward).
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, Sq, H, D = q.shape
    Skv, K, Dv = v.shape[1], k.shape[2], v.shape[3]
    G = H // K
    scale = D ** -0.5
    qg = q.float().reshape(B, Sq, K, G, D)
    gg = g.float().reshape(B, Sq, K, G, Dv)
    kf, vf = k.float(), v.float()
    dvec = (g.float() * out.float()).sum(-1)  # (B,Sq,H)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    if causal:
        kpos = torch.arange(Skv, device=q.device)
        qpos = torch.arange(Sq, device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
    p = torch.exp(s - lse.reshape(B, K, G, Sq)[..., None])
    dp = torch.einsum("bqkgv,bskv->bkgqs", gg, vf)
    dvec = dvec.permute(0, 2, 1).reshape(B, K, G, Sq)[..., None]
    ds = p * (dp - dvec) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(B, Sq, H, D)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    dv = torch.einsum("bkgqs,bqkgv->bskv", p, gg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, out, lse, g, *, causal: bool = True):
    """Gradients of ``flash_attention_fwd``'s out, given ``g`` = dL/dout
    and the forward's (out, lse).  Returns (dq, dk, dv) in the dtypes of
    q, k, v.

    CPU tensors go to the plain version; CUDA tensors to the dq kernel
    of their dtype (which also writes Dvec) and then its dk/dv kernel
    (``backward_kernels``), on the current stream; they raise on what the
    kernels do not take."""
    _check(q, k, v, "flash_attention_bwd")
    B, Sq, H, D = q.shape
    _, Skv, K, Dv = v.shape
    if (tuple(out.shape) != (B, Sq, H, Dv) or g.shape != out.shape
            or tuple(lse.shape) != (B, H, Sq)):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, g "
                         f"{tuple(g.shape)}, lse {tuple(lse.shape)} do not fit "
                         f"q {tuple(q.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
    _check_cuda("flash_attention_bwd", "flash_bwd", q, k, v, out, g)
    if lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise TypeError("flash_attention_bwd: lse must be contiguous float32 "
                        "on q's device")
    _check_tma("flash_attention_bwd", q, k, v, out, g)
    dq, dvec = bwd_dq_launch(q, k, v, out, lse, g, causal=causal)
    dk, dv = bwd_dkv_launch(q, k, v, g, lse, dvec, causal=causal)
    return dq, dk, dv


def _bwd_args(q, v, causal):
    B, Sq, H, D = q.shape
    _, Skv, K, Dv = v.shape
    return B, Sq, Skv, H, K, D, Dv, int(causal)


def bwd_dq_launch(q, k, v, out, lse, g, *, causal: bool = True):
    """The dq kernel of q's dtype alone, on inputs ``flash_attention_bwd``
    has checked: returns (dq, Dvec (B,H,Sq) fp32)."""
    dq = torch.empty_like(q)
    dvec = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        backward_kernels(q.dtype)[0].launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
            *_bwd_args(q, v, causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    return dq, dvec


def bwd_dkv_launch(q, k, v, g, lse, dvec, *, causal: bool = True):
    """The dk/dv kernel of q's dtype alone, after ``bwd_dq_launch`` wrote
    ``dvec`` on the same stream: returns (dk, dv)."""
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        backward_kernels(q.dtype)[1].launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_bwd_args(q, v, causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    return dk, dv
