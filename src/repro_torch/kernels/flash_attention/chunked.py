"""Flash attention with a manual chunked backward, in plain PyTorch: the
reference package's ``flash_attention_xla``
(``repro/kernels/flash_attention/xla.py``).

Autograd through the chunked online softmax (``chunked_attention``) keeps
every chunk pair's scores and probabilities for the backward: at jamba's
long context (B = 1, S = 4,096, 64 q-heads, a 512 x 1,024 chunk pair's
fp32 scores are 134 MB, 32 pairs a layer) that is several GB a layer.
Here the forward saves only (q, k, v, out, lse), and the backward
recomputes each chunk pair's probabilities from lse while it accumulates
dq, dk and dv:

    D_i   = rowsum(dO_i * O_i)
    p_ij  = exp(s_ij - lse_i)
    dv_j += p_ij^T dO_i
    ds_ij = p_ij * (dO_i V_j^T - D_i) * scale
    dq_i += ds_ij K_j ;  dk_j += ds_ij^T Q_i

Chunks are the largest divisors of the lengths up to ``q_chunk`` and
``kv_chunk`` (the reference's ``_pick_chunk``).  Products take their
operands in fp32 from the storage dtype (a bf16 product is exact in fp32)
and sum in fp32 (float64 for float64 inputs); p and ds are rounded to the
operand dtype before the products that take them, as the reference's
``astype`` does.  The forward
is ``chunked_attention``'s arithmetic op for op, so the two agree bit for
bit where the chunks agree.

This is the training path of windowed attention (``kernels/__init__.py``),
and the local body of the tensor-parallel attention for windowed calls
(``sharded.py``).  The Function has the ``setup_context`` form and
``generate_vmap_rule``, so ``torch.func`` transforms it (remat's
``torch.func.vjp``, ``vmap(grad(...))`` of ``Service.execute_batch``).
"""

from __future__ import annotations

import torch

NEG_INF = -2.0e38


def _pick_chunk(seq: int, target: int) -> int:
    c = min(seq, target)
    while seq % c:
        c -= 1
    return c


def _mask(s, qpos, kpos, causal, window):
    mask = torch.ones(qpos.numel(), kpos.numel(), dtype=torch.bool, device=s.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return torch.where(mask, s, NEG_INF)


def _acc(t) -> torch.dtype:
    """The dtype products sum in: fp32, or float64 for float64 inputs."""
    return torch.promote_types(t.dtype, torch.float32)


def chunked_forward(q, k, v, *, causal, window, q_chunk, kv_chunk):
    """(out (B,Sq,H,Dv) in v's dtype, lse (B,K,G,Sq) fp32): the online
    softmax over chunks of ``q_chunk`` queries and ``kv_chunk`` keys, the
    last of each ragged."""
    B, Sq, H, D = q.shape
    Sk, K, Dv = v.shape[1], k.shape[2], v.shape[3]
    G = H // K
    scale = D ** -0.5
    f = _acc(q)
    qg = q.reshape(B, Sq, K, G, D).to(f)
    kf, vf = k.to(f), v.to(f)
    kv_pos = torch.arange(Sk, device=q.device)
    outs, lses = [], []
    for q0 in range(0, Sq, q_chunk):
        qi = qg[:, q0:q0 + q_chunk]
        qc = qi.shape[1]
        qpos = q0 + torch.arange(qc, device=q.device)
        acc = torch.zeros(B, qc, K, G, Dv, dtype=f, device=q.device)
        m = torch.full((B, K, G, qc), NEG_INF, dtype=f, device=q.device)
        l = torch.zeros(B, K, G, qc, dtype=f, device=q.device)
        for k0 in range(0, Sk, kv_chunk):
            s = torch.einsum("bqkgd,bckd->bkgqc", qi, kf[:, k0:k0 + kv_chunk]) * scale
            s = _mask(s, qpos, kv_pos[k0:k0 + kv_chunk], causal, window)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqc,bckv->bqkgv", p.to(v.dtype).to(f),
                              vf[:, k0:k0 + kv_chunk])
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        out = acc / l.clamp_min(1e-37).permute(0, 3, 1, 2)[..., None]
        outs.append(out.reshape(B, qc, H, Dv))
        lses.append(m + torch.log(l.clamp_min(1e-37)))
    return torch.cat(outs, dim=1).to(v.dtype), torch.cat(lses, dim=-1)


def _bwd_impl(q, k, v, out, lse, g, *, causal, window, q_chunk, kv_chunk):
    """(dq, dk, dv) in q's, k's and v's dtypes."""
    B, Sq, H, D = q.shape
    Sk, K, Dv = v.shape[1], k.shape[2], v.shape[3]
    G = H // K
    scale = D ** -0.5
    qc, kc = _pick_chunk(Sq, q_chunk), _pick_chunk(Sk, kv_chunk)
    dev, f = q.device, _acc(q)
    qb = q.reshape(B, Sq, K, G, D)
    gb = g.reshape(B, Sq, K, G, Dv)
    ob = out.reshape(B, Sq, K, G, Dv)
    q_starts, k_starts = range(0, Sq, qc), range(0, Sk, kc)

    def d_block(q0):  # rowsum(dO * O) of a q chunk -> (B,K,G,qc)
        d = (gb[:, q0:q0 + qc].to(f) * ob[:, q0:q0 + qc].to(f)).sum(-1)
        return d.permute(0, 2, 3, 1)

    def scores(q0, k0):  # p of a chunk pair -> (B,K,G,qc,kc)
        s = torch.einsum("bqkgd,bckd->bkgqc", qb[:, q0:q0 + qc].to(f),
                         k[:, k0:k0 + kc].to(f)) * scale
        s = _mask(s, q0 + torch.arange(qc, device=dev),
                  k0 + torch.arange(kc, device=dev), causal, window)
        return torch.exp(s - lse[..., q0:q0 + qc, None])

    def dscores(p, q0, k0, D_i):  # ds of a chunk pair, fp32
        dp = torch.einsum("bqkgv,bckv->bkgqc", gb[:, q0:q0 + qc].to(f),
                          v[:, k0:k0 + kc].to(f))
        return p * (dp - D_i[..., None]) * scale

    # pass A: dq, one q chunk at a time over every kv chunk
    dqs = []
    for q0 in q_starts:
        D_i = d_block(q0)
        dq_i = torch.zeros(B, qc, K, G, D, dtype=f, device=dev)
        for k0 in k_starts:
            ds = dscores(scores(q0, k0), q0, k0, D_i)
            dq_i = dq_i + torch.einsum("bkgqc,bckd->bqkgd", ds.to(k.dtype).to(f),
                                       k[:, k0:k0 + kc].to(f))
        dqs.append(dq_i)
    dq = torch.cat(dqs, dim=1).reshape(B, Sq, H, D).to(q.dtype)

    # pass B: dk and dv, one kv chunk at a time over every q chunk
    dks, dvs = [], []
    for k0 in k_starts:
        dk_j = torch.zeros(B, kc, K, D, dtype=f, device=dev)
        dv_j = torch.zeros(B, kc, K, Dv, dtype=f, device=dev)
        for q0 in q_starts:
            p = scores(q0, k0)
            dv_j = dv_j + torch.einsum("bkgqc,bqkgv->bckv", p.to(g.dtype).to(f),
                                       gb[:, q0:q0 + qc].to(f))
            ds = dscores(p, q0, k0, d_block(q0))
            dk_j = dk_j + torch.einsum("bkgqc,bqkgd->bckd", ds.to(q.dtype).to(f),
                                       qb[:, q0:q0 + qc].to(f))
        dks.append(dk_j)
        dvs.append(dv_j)
    dk = torch.cat(dks, dim=1).to(k.dtype)
    dv = torch.cat(dvs, dim=1).to(v.dtype)
    return dq, dk, dv


class _ChunkedFlash(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, causal, window, q_chunk, kv_chunk):
        return chunked_forward(q, k, v, causal=causal, window=window,
                               q_chunk=_pick_chunk(q.shape[1], q_chunk),
                               kv_chunk=_pick_chunk(k.shape[1], kv_chunk))

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.causal, ctx.window, ctx.q_chunk, ctx.kv_chunk = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)

    @staticmethod
    def backward(ctx, g, _glse):
        dq, dk, dv = _bwd_impl(*ctx.saved_tensors, g, causal=ctx.causal,
                               window=ctx.window, q_chunk=ctx.q_chunk,
                               kv_chunk=ctx.kv_chunk)
        return dq, dk, dv, None, None, None, None


def flash_attention_chunked(q, k, v, causal: bool = True, window: int | None = None,
                            q_chunk: int = 512, kv_chunk: int = 1024):
    """Differentiable attention q (B,Sq,H,D), k (B,Skv,K,D), v (B,Skv,K,Dv)
    -> (B,Sq,H,Dv) in v's dtype; saves only q, k, v, out and lse."""
    return _ChunkedFlash.apply(q, k, v, causal, window, q_chunk, kv_chunk)[0]
