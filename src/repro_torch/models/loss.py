"""Chunked softmax cross-entropy with a manual backward.

Materialising (B, S, V) fp32 logits for a 150k vocabulary at B=4, S=512
is 1.2 GB per buffer (logits, dlogits, softmax temporaries).  This
computes the loss sequence chunk by sequence chunk in the forward and
*recomputes* each chunk's softmax in the backward (dx = (p - onehot) W
per chunk), so no (B, S, V) tensor ever exists: the reference package's
``repro/models/loss.py``.  The unembedding products are plain
``torch.matmul`` calls, as the reference leaves them to XLA.

The table is the live parameter (not the model's detached fp32 copy for
serving), cast to fp32 once per pass, so a tied embedding gets its
gradient from the head.
"""

from __future__ import annotations

import torch


def _chunks(S: int, target: int = 256) -> int:
    c = min(S, target)
    while S % c:
        c -= 1
    return c


class _TokenNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, targets, chunk):
        B, S, _ = x.shape
        c = _chunks(S, chunk)
        w = table.float()
        nll = torch.empty((B, S), dtype=torch.float32, device=x.device)
        for s0 in range(0, S, c):
            logits = x[:, s0:s0 + c].float() @ w.T  # (B,c,V)
            m = logits.amax(-1)
            lse = m + torch.log(torch.exp(logits - m[..., None]).sum(-1))
            gold = torch.gather(logits, -1, targets[:, s0:s0 + c, None].long())
            nll[:, s0:s0 + c] = lse - gold[..., 0]
        ctx.save_for_backward(x, table, targets)
        ctx.chunk = chunk
        return nll

    @staticmethod
    def backward(ctx, g):
        x, table, targets = ctx.saved_tensors
        B, S, d = x.shape
        c = _chunks(S, ctx.chunk)
        w = table.float()
        g = g.float()
        dtable = torch.zeros_like(w)
        dx = torch.empty((B, S, d), dtype=torch.float32, device=x.device)
        for s0 in range(0, S, c):
            xc = x[:, s0:s0 + c].float()
            dl = torch.softmax(xc @ w.T, dim=-1)  # p, then p - onehot in place
            dl.scatter_add_(-1, targets[:, s0:s0 + c, None].long(),
                            torch.full((B, c, 1), -1.0, device=x.device))
            dl.mul_(g[:, s0:s0 + c, None])
            dx[:, s0:s0 + c] = dl @ w
            dtable.addmm_(dl.reshape(-1, dl.shape[-1]).T, xc.reshape(-1, d))
        return dx.to(x.dtype), dtable.to(table.dtype), None, None


def token_nll(x, table, targets, chunk: int = 256) -> torch.Tensor:
    """Per-token negative log likelihood.

    x: (B,S,d) final hidden states; table: (V,d) unembedding; targets (B,S)
    int.  Returns (B,S) fp32 nll."""
    return _TokenNLL.apply(x, table, targets, chunk)


def fused_cross_entropy(x, table, targets, mask=None, *,
                        chunk: int = 256) -> torch.Tensor:
    """Mean-token CE over (possibly masked) targets, chunked end to end."""
    nll = token_nll(x, table, targets, chunk)
    if mask is None:
        return nll.mean()
    m = mask.to(nll.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)
