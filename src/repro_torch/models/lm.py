"""Decoder-only LM (and VLM backbone) built from the block stack:
training, prefill and decode.

``LM`` is the port's parameter tree: an ``nn.Module`` whose weights live
on one device.  Its entry points take and return the reference
package's shapes:
  train_loss -> (scalar loss fp32, {"ce_loss", "aux_loss"})  [differentiable]
  prefill    -> (last-token logits (B,V) fp32, caches)
  decode     -> (logits (B,V) fp32, caches)   [caches updated in place]
All take ``ops``, the attention and scan functions every layer calls:
the kernels' dispatch by default (see ``repro_torch.kernels``), and
``long_context`` (default False), which gives the attention layers
``cfg.long_context_window`` as their window (jamba's; the reference's
long-context decode), as the reference's entry points do.
``train_loss`` also accepts the reference's ``block_skip`` and discards
it: the reference's attention dispatch ignores it on both its branches.
A layer's cache is a KV cache (GQA), a latent cache (MLA) or a Mamba state.
A vision config (phi-3-vision) takes precomputed ``patch_embeds`` (B,P,d)
in its batch, projected by ``patch_proj`` and placed before the text
tokens, the reference's CLIP-frontend stub; its loss covers the text
positions only.  Weights are created with ``requires_grad=False``; a
trainer turns it on.

With ``cfg.remat`` training keeps only each pattern repeat's input and
parameters and runs the repeat's forward again in the backward, as the
reference checkpoints its scan body, one repeat of the pattern; the
attention kernels' forward launches again there, and their backward uses
the recomputed (out, lse).  The route is ``_Remat``, an
``autograd.Function`` whose backward runs the repeat again through
``torch.func.functional_call`` and differentiates it: by
``torch.func.vjp`` under a function transform (``torch.func.grad``, and
``vmap(grad(...))``, a training program in ``Service.execute_batch``),
by ``torch.autograd.grad`` under ``.backward()``, where the recompute
then meets DTensor weights as DTensors and runs sharded, under the mesh
and axes its forward ran under.  Unlike
``torch.utils.checkpoint`` (saved-tensor hooks, which ``torch.func.grad``
refuses), it runs the same in every mode.
Serving ignores ``remat``.

``forward`` is ``train_loss``, so ``torch.func.functional_call(model,
params, (batch,))`` computes the loss on a ``{name: tensor}`` mapping of
weights (``runtime/train_loop.functional_loss_and_grads``).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..kernels import DISPATCH, AttentionOps
from ..sharding.hints import (current_axes, current_mesh, mesh_axes, place_caches, shard_hint,
                              use_mesh)
from .blocks import make_blocks
from .common import ModelConfig
from .layers import Embedding, dense_init, make_norm
from .loss import fused_cross_entropy


def _train_repeat(blocks, x, aux, ops: AttentionOps, long_context: bool):
    """One repeat of the pattern (``len(cfg.pattern)`` consecutive
    blocks): returns (x, aux plus the blocks' aux losses)."""
    for blk in blocks:
        x, a = blk.forward_train(x, ops=ops, long_context=long_context)
        aux = aux + a
    return x, aux


class _Repeat(nn.Module):
    """One repeat of the pattern as a module, so that
    ``torch.func.functional_call`` runs it on given parameters."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = blocks

    def forward(self, x, aux, ops: AttentionOps, long_context: bool):
        return _train_repeat(self.blocks, x, aux, ops, long_context)


class _Remat(torch.autograd.Function):
    """``rep``'s forward on (x, aux) with its parameters ``params`` as
    explicit inputs, keeping no graph; the backward runs the forward again,
    under the forward's mesh, differentiates it and returns the gradients
    of x, aux and every parameter.  ``generate_vmap_rule``: under vmap both
    passes run at the vmap level, their kernels folded by their own
    rules."""

    generate_vmap_rule = True

    @staticmethod
    def forward(rep, names, ops, long_context, x, aux, *params):
        return torch.func.functional_call(rep, dict(zip(names, params)),
                                          (x, aux, ops, long_context))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.rep, ctx.names, ctx.ops, ctx.long_context = inputs[:4]
        # the recompute runs where autograd runs the backward, on a device
        # thread of its own for CUDA tensors: it takes the forward's mesh
        ctx.mesh, ctx.axes = current_mesh(), current_axes()
        ctx.save_for_backward(*inputs[4:])

    @staticmethod
    def backward(ctx, gx, gaux):
        def run(x, aux, *params):
            with (use_mesh(ctx.mesh) if ctx.mesh is not None else contextlib.nullcontext()), \
                    mesh_axes(ctx.axes):
                return torch.func.functional_call(ctx.rep, dict(zip(ctx.names, params)),
                                                  (x, aux, ctx.ops, ctx.long_context))

        if torch._C._functorch.peek_interpreter_stack() is not None:  # under a transform
            _, vjp = torch.func.vjp(run, *ctx.saved_tensors)
            return (None, None, None, None, *vjp((gx, gaux)))
        # plain autograd: the recompute meets the saved tensors themselves, so
        # a DTensor stays one (torch.func.vjp would hide it in a wrapper, and
        # the sharded paths would not see it)
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = run(*inputs)
        grads = torch.autograd.grad(out, inputs, (gx, gaux), allow_unused=True)
        return (None, None, None, None,
                *(torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads)))


def _remat_repeat(blocks, x, aux, ops: AttentionOps, long_context: bool):
    rep = _Repeat(blocks)
    names, params = zip(*rep.named_parameters(remove_duplicate=False))
    return _Remat.apply(rep, names, ops, long_context, x, aux, *params)


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg, g)
        self.blocks = make_blocks(cfg, g)
        self.final_norm = make_norm(cfg, g.device)
        if not cfg.tie_embeddings:
            self.lm_head = Embedding(cfg, g)
        if cfg.frontend == "vision":
            # stub projection of precomputed patch embeddings
            self.patch_proj = dense_init(g, (cfg.d_model, cfg.d_model), cfg.pdtype)
        self.refresh()

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def head(self) -> Embedding:
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def refresh(self) -> None:
        """Make the fp32 unembedding copy now, on the caller's stream,
        so services never race to build it.  Call after changing weights."""
        self.head().table_f32()

    def _has_patches(self, batch) -> bool:
        return self.cfg.frontend == "vision" and "patch_embeds" in batch

    def _embed_inputs(self, batch):
        """Token embeddings, after the projected patch embeddings when the
        batch has them."""
        x = self.embed(batch["tokens"])
        if self._has_patches(batch):
            dt = self.cfg.dtype
            pe = batch["patch_embeds"].to(dt) @ self.patch_proj.to(dt)
            x = torch.cat([pe, x], dim=1)
        return x

    def forward(self, batch, **kw):
        """``train_loss``: the module's call, which ``functional_call`` makes."""
        return self.train_loss(batch, **kw)

    def train_loss(self, batch, *, ops: AttentionOps = DISPATCH, long_context=False,
                   block_skip=False):
        """batch: tokens (B,S) int, targets (B,S) int [, loss_mask (B,S),
        patch_embeds (B,P,d)].  Returns (loss + aux, {"ce_loss",
        "aux_loss"}), fp32 scalars; the reference's ``forward_train``.
        ``block_skip`` is accepted and discarded."""
        del block_skip
        if ops.train is None:
            raise ValueError("train_loss needs AttentionOps with a train member")
        x = self._embed_inputs(batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        n = len(self.cfg.pattern)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for r in range(0, len(self.blocks), n):
            if remat:  # keep the repeat's input, run its forward again in the backward
                x, aux = _remat_repeat(self.blocks[r:r + n], x, aux, ops, long_context)
            else:
                x, aux = _train_repeat(self.blocks[r:r + n], x, aux, ops, long_context)
        x = self.final_norm(x)
        if self._has_patches(batch):
            x = x[:, batch["patch_embeds"].shape[1]:]  # text positions only
        loss = fused_cross_entropy(x, self.head().table, batch["targets"],
                                   batch.get("loss_mask"))
        return loss + aux, {"ce_loss": loss, "aux_loss": aux}

    @torch.no_grad()
    def prefill(self, batch, *, seq_budget: int | None = None,
                ops: AttentionOps = DISPATCH, long_context=False):
        """batch: tokens (B,S) int [, patch_embeds (B,P,d)].  Returns
        (last-token logits (B,V), caches)."""
        x = self._embed_inputs(batch)
        seq_budget = max(seq_budget or 0, x.shape[1])
        caches = []
        for blk in self.blocks:
            x, c = blk.prefill(x, seq_budget=seq_budget, ops=ops,
                               long_context=long_context)
            caches.append(c)
        x = self.final_norm(x)
        logits = shard_hint(self.head().unembed(x[:, -1:, :]), "logits")
        return logits[:, 0], place_caches(caches, x.shape[0])

    @torch.no_grad()
    def decode(self, batch, caches, *, cache_index: int,
               ops: AttentionOps = DISPATCH, long_context=False):
        """batch: tokens (B,1). Returns (logits (B,V), caches)."""
        x = self.embed(batch["tokens"])
        for i, blk in enumerate(self.blocks):
            x, caches[i] = blk.decode(x, caches[i], cache_index=cache_index,
                                     ops=ops, long_context=long_context)
        x = self.final_norm(x)
        return shard_hint(self.head().unembed(x), "logits")[:, 0], caches

    def make_caches(self, batch: int, seq_len: int):
        """Each layer's empty cache: KV or latent slots, or a Mamba state."""
        return [blk.make_cache(batch, seq_len) for blk in self.blocks]
