"""Token-dropping (capacity-factor) mixture-of-experts, the reference's
``repro/models/moe.py``.

Dispatch and combine are dense one-hot products over (tokens, experts,
capacity), as in the reference (the Switch/GLaM formulation): every
expert's weights are read on every call, whatever the routing.  Capacity
is allocated per routing group of ``MoEConfig.group_size`` tokens
(``routing_group_size``), C = ceil(cf * k * group / E) slots an expert
(``expert_capacity``).

Kept from the reference, step by step: the router product in fp32 (the
router's weights are fp32 in every config); the softmax; the top k with
the lower expert index first among equal probabilities, as
``jax.lax.top_k`` (a stable sort: ``torch.topk`` promises no order); the
chosen gates renormalised when k > 1; choice-major capacity priority
(every token's first choice before any token's second) through a
cumulative sum; a token past its expert's capacity dropped, as an
all-zero dispatch row; dispatch and combine cast to the compute dtype,
the combine summed in fp32 then cast; the load-balance and z losses in
fp32.  ``dense_residual`` adds a dense MLP computed for every token
(Arctic's dense-MoE hybrid; also llama4-maverick's shared expert).  The
products are plain PyTorch: the reference's are XLA einsums, outside any
Pallas kernel.

Under ``torch.func.vmap`` (``Service.execute_batch``) routing, capacity
and drops stay per task.  Only the expert products have a rule of their
own (``expert_matmul``): vmap's rule for a batched (E, T, a) times the
unbatched (E, a, b) weights copies the weights once per task (one of
llama4-maverick's expert stacks is 10.7 GB in bf16), where folding the
tasks' slots into T reads each expert once.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.batched import under_vmap
from .common import ModelConfig
from .layers import dense_init, make_mlp


def routing_group_size(cfg: ModelConfig, seq_len: int) -> int:
    """Tokens a routing group: ``group_size`` (0: the sequence), at most
    ``seq_len``, lowered until it divides ``seq_len``."""
    g = min(cfg.moe.group_size or seq_len, seq_len)
    while seq_len % g:  # groups must tile the sequence
        g -= 1
    return g


def expert_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots an expert has in a group: ceil(cf * k * group / E), at least 1."""
    m = cfg.moe
    return max(math.ceil(m.capacity_factor * m.top_k * tokens_per_group
                         / m.n_experts), 1)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values, as ``jax.lax.top_k``."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    return probs.gather(-1, idx), idx


def expert_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, T, a) @ w (E, a, b) -> (E, T, b), one product an expert.
    Under vmap with ``w`` unbatched (the weights) it goes through the op
    ``repro_torch::expert_matmul``, whose rule folds the tasks into T."""
    if under_vmap(x) and not under_vmap(w):
        return _expert_matmul_op(x, w)
    return x @ w


@torch.library.custom_op("repro_torch::expert_matmul", mutates_args=(),
                         schema="(Tensor x, Tensor w) -> Tensor")
def _expert_matmul_op(x, w):
    return x @ w


@_expert_matmul_op.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:-1], w.shape[-1]))


@_expert_matmul_op.register_vmap
def _(info, in_dims, x, w):
    if in_dims[1] is not None:  # expert_matmul enters the op with w unbatched
        raise ValueError("expert_matmul under vmap: the weights w arrived batched")
    n = info.batch_size
    x = x.movedim(in_dims[0], 1)
    E, _, T, a = x.shape
    out = x.reshape(E, n * T, a) @ w  # the tasks' slots side by side
    return out.reshape(E, n, T, w.shape[-1]), 1


class Experts(nn.Module):
    """E MLPs stacked along a leading expert axis, in ``pdtype``: ``wi``
    and (SwiGLU) ``wg`` of (E, d, ff), ``wo`` of (E, ff, d), each expert
    initialised with its own fan-in (d, ff), not E."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        E, d, ff, pd = cfg.moe.n_experts, cfg.d_model, cfg.d_ff, cfg.pdtype
        self.wi = dense_init(g, (E, d, ff), pd, in_axis_size=d)
        self.wo = dense_init(g, (E, ff, d), pd, in_axis_size=ff)
        if cfg.mlp_act == "swiglu":
            self.wg = dense_init(g, (E, d, ff), pd, in_axis_size=d)
        self.act, self.dtype = cfg.mlp_act, cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (E, T, d): T slots an expert -> (E, T, d)."""
        dt = self.dtype
        if self.act == "swiglu":
            h = (nn.functional.silu(expert_matmul(x, self.wg.to(dt)))
                 * expert_matmul(x, self.wi.to(dt)))
        else:
            h = nn.functional.gelu(expert_matmul(x, self.wi.to(dt)), approximate="tanh")
        return expert_matmul(h, self.wo.to(dt))


class MoE(nn.Module):
    """The router (d, E), fp32 in every config, the stacked experts and,
    with ``dense_residual``, the residual MLP (``residual``)."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        m = cfg.moe
        self.router = dense_init(g, (cfg.d_model, m.n_experts), torch.float32)
        self.experts = Experts(cfg, g)
        if m.dense_residual:  # dense_residual_ff wide (0: d_ff)
            ff = m.dense_residual_ff or cfg.d_ff
            self.residual = make_mlp(cfg.replace(d_ff=ff), g)
        self.cfg = cfg

    def route(self, x: torch.Tensor):
        """The routing of x (B, S, d), in ng = B S / G groups of G tokens
        with C slots an expert: (logits (ng, G, E), probs, onehot
        (ng, G, k, E) of each token's k chosen experts, keep: onehot where
        the choice found a slot, dispatch (ng, G, E, C) in {0, 1}, combine:
        dispatch weighted by the gates), all fp32."""
        cfg, m = self.cfg, self.cfg.moe
        B, S, d = x.shape
        E, K = m.n_experts, m.top_k
        G = routing_group_size(cfg, S)
        ng, C = B * (S // G), expert_capacity(cfg, G)
        # fp32 logits from a float64 product: at least the reference's fp32
        # whatever a caller sets for TF32 on the card (a TF32 product keeps
        # ~3 digits, enough to move routing decisions)
        logits = (x.reshape(ng, G, d).double() @ self.router.double()).float()
        probs = torch.softmax(logits, dim=-1)
        gate, idx = top_k(probs, K)
        if K > 1:  # renormalise the chosen gates (mixtral-style)
            gate = gate / gate.sum(-1, keepdim=True)

        onehot = nn.functional.one_hot(idx, E).float()  # (ng, G, K, E)
        # choice-major priority: all first choices beat all second choices
        oh_cm = onehot.transpose(1, 2).reshape(ng, K * G, E)
        pos_cm = oh_cm.cumsum(1) - oh_cm  # place within the expert
        pos = pos_cm.reshape(ng, K, G, E).transpose(1, 2)  # (ng, G, K, E)
        keep = (pos < C) * onehot
        # one-hot of each choice's slot; all zeros past the capacity (as
        # jax.nn.one_hot, where torch's one_hot raises)
        slot = (pos * onehot).sum(-1)
        pos_oh = (slot[..., None] == torch.arange(C, device=x.device)).float()
        dispatch = torch.einsum("gske,gskc->gsec", keep, pos_oh)
        combine = torch.einsum("gske,gskc,gsk->gsec", keep, pos_oh, gate)
        return logits, probs, onehot, keep, dispatch, combine

    def forward(self, x: torch.Tensor):
        """x (B, S, d) in the compute dtype.  Returns (out (B, S, d), aux
        loss fp32 scalar)."""
        m, dt = self.cfg.moe, self.cfg.dtype
        B, S, d = x.shape
        logits, probs, onehot, _, dispatch, combine = self.route(x)
        ng, G, E, C = dispatch.shape

        xin = torch.einsum("gsec,gsd->egcd", dispatch.to(dt), x.reshape(ng, G, d))
        eout = self.experts(xin.reshape(E, ng * C, d)).reshape(E, ng, C, d)
        out = torch.einsum("egcd,gsec->gsd", eout.float(),
                           combine.to(dt).float()).to(dt).reshape(B, S, d)

        # aux losses (fp32)
        me = probs.mean(dim=(0, 1))  # mean router probability an expert
        ce = onehot.sum(2).mean(dim=(0, 1))  # share of assignments
        lb_loss = m.load_balance_loss * E * (me * ce).sum()
        z = torch.logsumexp(logits, dim=-1)
        aux = lb_loss + m.router_z_loss * (z * z).mean()

        if m.dense_residual:
            out = out + self.residual(x)
        return out, aux
