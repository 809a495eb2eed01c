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
from torch.distributed.tensor import DTensor

from ..sharding.hints import data_parallel


def _chunks(S: int, target: int = 256) -> int:
    c = min(S, target)
    while S % c:
        c -= 1
    return c


class _TokenNLL(torch.autograd.Function):
    """The chunked loss as a Function that ``torch.func`` transforms
    (``setup_context``, ``generate_vmap_rule``): the chunks are joined, not
    written into a buffer made outside the transform, so under
    ``vmap(grad(...))`` (a training program in ``Service.execute_batch``)
    each task's table and hidden states stay its own.  ``dtable`` is made
    from the table (batched with it) and summed chunk by chunk in place,
    in the order of one task's pass."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, table, targets, chunk):
        S = x.shape[1]
        c = _chunks(S, chunk)
        w = table.float()
        nll = []
        for s0 in range(0, S, c):
            logits = x[:, s0:s0 + c].float() @ w.T  # (B,c,V)
            m = logits.amax(-1)
            lse = m + torch.log(torch.exp(logits - m[..., None]).sum(-1))
            gold = torch.gather(logits, -1, targets[:, s0:s0 + c, None].long())
            nll.append(lse - gold[..., 0])
        return torch.cat(nll, 1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, table, targets, ctx.chunk = inputs
        ctx.save_for_backward(x, table, targets)

    @staticmethod
    def backward(ctx, g):
        x, table, targets = ctx.saved_tensors
        B, S, d = x.shape
        c = _chunks(S, ctx.chunk)
        w = table.float()
        g = g.float()
        dtable = torch.zeros_like(w)
        dx = []
        for s0 in range(0, S, c):
            xc = x[:, s0:s0 + c].float()
            dl = torch.softmax(xc @ w.T, dim=-1)  # p, then p - onehot in place
            dl.scatter_add_(-1, targets[:, s0:s0 + c, None].long(),
                            torch.full((B, c, 1), -1.0, device=x.device))
            dl.mul_(g[:, s0:s0 + c, None])
            dx.append(dl @ w)
            # in place: one fp32 table gradient a task, not two, at a time
            # (under vmap, where each task has its own table, functorch has
            # no rule for addmm_: its fallback runs each task's product in
            # place, as one task's pass does)
            dtable.addmm_(dl.reshape(-1, dl.shape[-1]).T, xc.reshape(-1, d))
        del w, dl  # the fp32 table is not needed for the casts below
        return torch.cat(dx, 1).to(x.dtype), dtable.to(table.dtype), None, None


def token_nll(x, table, targets, chunk: int = 256) -> torch.Tensor:
    """Per-token negative log likelihood.

    x: (B,S,d) final hidden states; table: (V,d) unembedding; targets (B,S)
    int.  Returns (B,S) fp32 nll.  With a DTensor ``x`` (a model distributed
    on a mesh) each rank takes its batch rows and the whole table
    (``data_parallel``): DTensor's gather on vocab-sharded logits has no
    working rule."""
    if isinstance(x, DTensor):
        return data_parallel(lambda x_, y_, t_: _TokenNLL.apply(x_, t_, y_, chunk),
                             (x, targets), (table,))
    return _TokenNLL.apply(x, table, targets, chunk)


def fused_cross_entropy(x, table, targets, mask=None, *,
                        chunk: int = 256) -> torch.Tensor:
    """Mean-token CE over (possibly masked) targets, chunked end to end."""
    nll = token_nll(x, table, targets, chunk)
    if mask is None:
        return nll.mean()
    m = mask.to(nll.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)
