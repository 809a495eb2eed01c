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

Under a mesh whose "model" axis divides the vocabulary the loss is
vocabulary-parallel (``_VocabNLL`` under ``sharding.hints.vocab_parallel``),
as the reference's GSPMD plan lays its logits out, the vocabulary over
"model": each rank takes its batch rows and its own rows of the table,
computes its chunk's logits over its slice of the vocabulary, and
all-reduces over "model" the running max, then the sum of exponentials
with the gold logit (which only the rank holding the target adds).  The
backward recomputes each chunk's softmax from the reduced log-sum-exp;
dx is all-reduced over "model", the table's gradient stays on the rank's
own rows.  Where the vocabulary does not divide "model" (the reference's
``sanitize_spec`` leaves that table's rows unsharded) or "model" is one
rank, each rank takes the whole table (``data_parallel``).  Its gradient
is then split as the reference's partitioner splits it where the table's
d is over "data" and "model" is more than one rank (``_SplitNLL``): each
rank computes d / data columns of it from its own rows (the "model" ranks
of a data row take the pieces in turn), all-reduces them over the data
axes and permutes them to the rank whose shard holds them.  Elsewhere
each rank computes the whole gradient of its rows, summed over the data
axes.
"""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor

from ..sharding.hints import vocab_parallel


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
        dx, dtable = _grads(x, table, targets, g, ctx.chunk)
        return dx.to(x.dtype), dtable.to(table.dtype), None, None


def _grads(x, table, targets, g, chunk, cols=slice(None)):
    """(dx, dtable[:, cols]) in fp32 of the whole-table loss, chunk by
    chunk: each chunk's softmax recomputed, ``dtable`` made from the table
    (batched with it under vmap) and summed in place."""
    B, S = x.shape[:2]
    c = _chunks(S, chunk)
    w = table.float()
    g = g.float()
    dtable = torch.zeros_like(w[:, cols])
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
        xc = xc[..., cols]
        dtable.addmm_(dl.reshape(-1, dl.shape[-1]).T, xc.reshape(-1, xc.shape[-1]))
    del w, dl  # the fp32 table is not needed for the casts that follow
    return torch.cat(dx, 1), dtable


class _SplitNLL(torch.autograd.Function):
    """The whole-table loss (``_TokenNLL``'s forward) from the rank's shard
    of a table laid out P(None, "data"), ``split`` a
    ``sharding.hints.ColumnSplit``: the shard is gathered over "data"; the
    backward computes the table gradient's product on the rank's share of
    the columns only (d / data of them, from its own rows), all-reduces it
    over the data axes and swaps it to the rank whose shard holds those
    columns, as the reference's partitioner lays out that product."""

    @staticmethod
    def forward(ctx, x, shard, targets, chunk, split):
        table = split.whole(shard)
        ctx.chunk, ctx.split = chunk, split
        ctx.save_for_backward(x, table, targets)
        return _TokenNLL.forward(x, table, targets, chunk)

    @staticmethod
    def backward(ctx, g):
        x, table, targets = ctx.saved_tensors
        split = ctx.split
        dx, dshard = _grads(x, table, targets, g, ctx.chunk, split.cols)
        for group in split.reduce:
            dshard = _all_reduce(dshard, "sum", group)
        dshard = split.permute(dshard)
        return dx.to(x.dtype), dshard.to(table.dtype), None, None, None


def _all_reduce(x, op: str, group):
    y = funcol.all_reduce(x, op, group)
    return y.wait() if isinstance(y, funcol.AsyncCollectiveTensor) else y


class _VocabNLL(torch.autograd.Function):
    """The chunked loss of one rank's rows against its slice of the
    vocabulary, ``table`` (V/tp, d) from row ``group``'s local rank times
    V/tp, with the softmax's reductions all-reduced over ``group`` (the
    "model" sub-mesh): the running max first, then the sum of exponentials
    and the gold logit together.  Saves the reduced log-sum-exp; the
    backward recomputes p from it."""

    @staticmethod
    def forward(ctx, x, table, targets, chunk, group):
        S = x.shape[1]
        c = _chunks(S, chunk)
        w = table.float()
        Vl = w.shape[0]
        v0 = group.get_local_rank() * Vl
        nll, lses = [], []
        for s0 in range(0, S, c):
            logits = x[:, s0:s0 + c].float() @ w.T  # (B,c,V/tp)
            m = _all_reduce(logits.amax(-1), "max", group)
            t = targets[:, s0:s0 + c].long() - v0
            mine = (t >= 0) & (t < Vl)
            gold = torch.gather(logits, -1, t.clamp(0, Vl - 1)[..., None])[..., 0]
            se, gold = _all_reduce(torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                                                torch.where(mine, gold, 0.0)]), "sum", group)
            lse = m + torch.log(se)
            nll.append(lse - gold)
            lses.append(lse)
        ctx.chunk, ctx.group = chunk, group
        ctx.save_for_backward(x, table, targets, torch.cat(lses, 1))
        return torch.cat(nll, 1)

    @staticmethod
    def backward(ctx, g):
        x, table, targets, lse = ctx.saved_tensors
        B, S, d = x.shape
        c = _chunks(S, ctx.chunk)
        w = table.float()
        Vl = w.shape[0]
        v0 = ctx.group.get_local_rank() * Vl
        g = g.float()
        dtable = torch.zeros_like(w)
        dx = []
        for s0 in range(0, S, c):
            xc = x[:, s0:s0 + c].float()
            dl = torch.exp(xc @ w.T - lse[:, s0:s0 + c, None])  # p, then p - onehot
            t = targets[:, s0:s0 + c, None].long() - v0
            mine = (t >= 0) & (t < Vl)
            dl.scatter_add_(-1, t.clamp(0, Vl - 1), -mine.float())
            dl.mul_(g[:, s0:s0 + c, None])
            dx.append(dl @ w)  # this slice's part of dx
            dtable.addmm_(dl.reshape(-1, Vl).T, xc.reshape(-1, d))
        del w, dl
        dx = _all_reduce(torch.cat(dx, 1), "sum", ctx.group)
        return dx.to(x.dtype), dtable.to(table.dtype), None, None, None


def token_nll(x, table, targets, chunk: int = 256) -> torch.Tensor:
    """Per-token negative log likelihood.

    x: (B,S,d) final hidden states; table: (V,d) unembedding; targets (B,S)
    int.  Returns (B,S) fp32 nll.  With a DTensor ``x`` (a model distributed
    on a mesh) each rank takes its batch rows and, where "model" divides the
    vocabulary, its own rows of the table (``vocab_parallel``); else the
    whole table (``data_parallel``), and where the table is laid out
    P(None, "data"), its share of the table gradient's columns
    (``_SplitNLL``)."""
    if isinstance(x, DTensor):
        return vocab_parallel(lambda x_, y_, t_, group: _VocabNLL.apply(x_, t_, y_, chunk,
                                                                        group),
                              lambda x_, y_, t_, split: (
                                  _TokenNLL.apply(x_, t_, y_, chunk) if split is None
                                  else _SplitNLL.apply(x_, t_, y_, chunk, split)),
                              (x, targets), table)
    return _TokenNLL.apply(x, table, targets, chunk)


def fused_cross_entropy(x, table, targets, mask=None, *,
                        chunk: int = 256) -> torch.Tensor:
    """Mean-token CE over (possibly masked) targets, chunked end to end."""
    nll = token_nll(x, table, targets, chunk)
    if mask is None:
        return nll.mean()
    m = mask.to(nll.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)
