"""Differentiable flash attention: the forward and backward kernels under
one ``torch.autograd.Function``, the counterpart of the reference
package's ``jax.custom_vjp`` (``repro/kernels/flash_attention/ops.py``).

The forward saves only (q, k, v, out, lse); the backward recomputes p
from lse.  ``flash_attention`` takes the kernels' dispatch (the CUDA
kernels for CUDA tensors, the plain versions for CPU tensors);
``flash_attention_plain_train`` runs the plain versions on any device,
so a whole training step's kernels can be held against them on the card.

The Function has the ``forward`` + ``setup_context`` form and
``generate_vmap_rule``, so ``torch.func`` transforms it: a training
program under ``vmap(grad(...))`` (``Service.execute_batch`` of a
training program) runs the forward and the backward at the vmap level on
BatchedTensors, where ``flash_attention_fwd`` and ``flash_attention_bwd``
enter their custom ops and each folds the N tasks into B
(``kernels/batched.py``): one forward, one dq and one dk/dv launch for
the N tasks.  lse, the forward's second output, is saved for the
backward and is not differentiable.
"""

from __future__ import annotations

import torch

from .flash_attention import (flash_attention_bwd, flash_attention_bwd_plain,
                              flash_attention_fwd, flash_attention_plain)


class _Flash(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, causal, plain):
        fwd = flash_attention_plain if plain else flash_attention_fwd
        return fwd(q, k, v, causal=causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.causal, ctx.plain = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)

    @staticmethod
    def backward(ctx, g, _glse):
        bwd = flash_attention_bwd_plain if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(*ctx.saved_tensors, g.contiguous(), causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True):
    """Differentiable GQA attention through the kernels' dispatch.
    q (B,Sq,H,D), k/v (B,Skv,K,D) -> (B,Sq,H,D) in q's dtype."""
    return _Flash.apply(q, k, v, causal, False)[0]


def flash_attention_plain_train(q, k, v, *, causal: bool = True):
    """``flash_attention`` through the plain forward and backward, on any
    device."""
    return _Flash.apply(q, k, v, causal, True)[0]
