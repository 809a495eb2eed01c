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
tasks' slots into T reads each expert once.  The rule has gradients (dx
= g wᵀ, dw = xᵀ g), so tasks that share the weights train through it
too; a training task's own weights (batched) take the native ``x @ w``.

Under a mesh (DTensor weights, announced axes) dispatch, the expert
products and the combine run expert-parallel as one ``local_map``: each
rank takes its routing groups (over the data axes), its experts' slices
of ``dispatch`` and ``combine`` ((groups, G, E/ep, C), the experts over
"model", the ``moe_dispatch`` layout) and its experts' weights (gathered
over the data axis that shards ``d_ff``), and returns its experts' part of
the combined output in fp32, a partial sum over "model" that is reduced
once before the cast to the compute dtype.  No sharded dim is flattened:
the products see local tensors.  The routing runs before it, unchanged.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from ..kernels.batched import under_vmap
from ..sharding.hints import current_axes, reduce_partial, shard_hint
from ..sharding.specs import P, _dp, mesh_sizes, placements, sanitize_spec
from .common import ModelConfig
from .layers import dense_init, make_mlp, silu


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
    Under vmap with ``w`` unbatched (the weights) it goes through
    ``_ExpertMatmul``, whose rule folds the tasks into T."""
    if under_vmap(x) and not under_vmap(w):
        return _ExpertMatmul.apply(x, w)
    return x @ w


class _ExpertMatmul(torch.autograd.Function):
    """The expert product with the tasks folded into T under vmap, and
    its gradients dx = g wᵀ (through ``expert_matmul`` again, so the
    weights stay read once a product) and dw = xᵀ g.  An
    ``autograd.Function`` with ``setup_context`` and a ``vmap``
    staticmethod, not a ``torch.library`` op with ``register_autograd``:
    the op's autograd does not run under ``torch.func.grad``."""

    @staticmethod
    def forward(x, w):
        return x @ w

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def vmap(info, in_dims, x, w):
        if in_dims[1] is not None:  # expert_matmul enters with w unbatched
            raise ValueError("expert_matmul under vmap: the weights w arrived batched")
        n = info.batch_size
        x = x.movedim(in_dims[0], 1)
        E, _, T, a = x.shape
        out = _ExpertMatmul.apply(x.reshape(E, n * T, a), w)  # the tasks' slots side by side
        return out.reshape(E, n, T, w.shape[-1]), 1

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = expert_matmul(g, w.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        dw = x.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return dx, dw


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

    def weights(self) -> tuple:
        """(wi, wo[, wg])."""
        return (self.wi, self.wo) + ((self.wg,) if self.act == "swiglu" else ())

    def forward(self, x: torch.Tensor, weights: tuple | None = None) -> torch.Tensor:
        """x (E, T, d): T slots an expert -> (E, T, d); with ``weights``
        (``weights()``' tensors, or a rank's local shards of them) those in
        place of the module's."""
        dt = self.dtype
        wi, wo, *wg = weights or self.weights()
        if self.act == "swiglu":
            h = (silu(expert_matmul(x, wg[0].to(dt)))
                 * expert_matmul(x, wi.to(dt)))
        else:
            h = nn.functional.gelu(expert_matmul(x, wi.to(dt)), approximate="tanh")
        return expert_matmul(h, wo.to(dt))


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

        # (ng, G, K, E), by comparison as jax.nn.one_hot: torch's one_hot
        # reads its indices' range, which vmap(grad(...)) refuses
        onehot = (idx[..., None] == torch.arange(E, device=x.device)).float()
        # choice-major priority: all first choices beat all second choices
        oh_cm = onehot.transpose(1, 2).reshape(ng, K * G, E)
        pos_cm = oh_cm.cumsum(1) - oh_cm  # place within the expert
        pos = pos_cm.reshape(ng, K, G, E).transpose(1, 2)  # (ng, G, K, E)
        keep = (pos < C) * onehot
        # one-hot of each choice's slot; all zeros past the capacity (as
        # jax.nn.one_hot, where torch's one_hot raises)
        slot = (pos * onehot).sum(-1)
        pos_oh = (slot[..., None] == torch.arange(C, device=x.device)).float()
        dispatch = shard_hint(torch.einsum("gske,gskc->gsec", keep, pos_oh),
                              "moe_dispatch")
        combine = shard_hint(torch.einsum("gske,gskc,gsk->gsec", keep, pos_oh, gate),
                             "moe_dispatch")
        return logits, probs, onehot, keep, dispatch, combine

    def forward(self, x: torch.Tensor):
        """x (B, S, d) in the compute dtype.  Returns (out (B, S, d), aux
        loss fp32 scalar)."""
        m, dt = self.cfg.moe, self.cfg.dtype
        B, S, d = x.shape
        logits, probs, onehot, _, dispatch, combine = self.route(x)
        ng, G, E, _ = dispatch.shape
        xg = x.reshape(ng, G, d)
        if current_axes() is not None and isinstance(dispatch, DTensor):
            out = reduce_partial(self._expert_parallel(xg, dispatch, combine))
        else:
            out = self._experts_combined(xg, dispatch, combine)
        out = out.to(dt).reshape(B, S, d)

        # aux losses (fp32)
        me = probs.mean(dim=(0, 1))  # mean router probability an expert
        ce = onehot.sum(2).mean(dim=(0, 1))  # share of assignments
        lb_loss = m.load_balance_loss * E * (me * ce).sum()
        z = torch.logsumexp(logits, dim=-1)
        aux = lb_loss + m.router_z_loss * (z * z).mean()

        if m.dense_residual:
            out = out + self.residual(x)
        return out, aux

    def _experts_combined(self, x, dispatch, combine, weights=None):
        """x (ng, G, d); dispatch, combine (ng, G, E, C) -> the experts'
        outputs combined, (ng, G, d) fp32: the experts of ``weights`` (the E
        of ``dispatch``; None: the module's)."""
        dt = self.cfg.dtype
        ng, G, E, C = dispatch.shape
        d = x.shape[-1]
        xin = torch.einsum("gsec,gsd->egcd", dispatch.to(dt), x)
        eout = self.experts(xin.reshape(E, ng * C, d), weights).reshape(E, ng, C, d)
        return torch.einsum("egcd,gsec->gsd", eout.float(), combine.to(dt).float())

    def _expert_parallel(self, x, dispatch, combine):
        """``_experts_combined`` on each rank's groups and experts under
        ``local_map``: (ng, G, d) fp32, a partial sum over "model" where the
        experts are split over it.  The weights' gradients are the data
        ranks' sum, x's the "model" ranks'."""
        mesh = dispatch.device_mesh
        sizes = mesh_sizes(mesh)
        ng, _, E, _ = dispatch.shape
        gspec, espec = sanitize_spec(P(_dp(mesh.mesh_dim_names), "model"), (ng, E), sizes)
        rows = placements(P(gspec), mesh)  # x, the output's groups
        routes = placements(P(gspec, None, espec, None), mesh)  # dispatch, combine
        experts = placements(P(espec), mesh)  # each weight (E, a, b)
        out = [Partial() if e.is_shard() else r for e, r in zip(experts, rows)]
        w_grad = [Partial() if r.is_shard() else e for r, e in zip(rows, experts)]
        weights = self.experts.weights()
        n = len(weights)

        def local(x_, dispatch_, combine_, *ws):
            return self._experts_combined(x_, dispatch_, combine_, ws)

        return local_map(local, out_placements=out,
                         in_placements=(rows, routes, routes) + (experts,) * n,
                         in_grad_placements=(out, routes, routes) + (w_grad,) * n,
                         device_mesh=mesh, redistribute_inputs=True)(
                             x, dispatch, combine, *weights)
