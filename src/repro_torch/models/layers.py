"""Shared layers: RMSNorm, LayerNorm, qk-norm, RoPE, SwiGLU and GELU
MLPs, embeddings.

Weights are kept in the reference package's layout — a projection is a
``(d_in, d_out)`` matrix applied as ``x @ w`` — so converted parameters
need no transposes.  Initialisers draw from an explicit
``torch.Generator`` on the generator's own device.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..sharding.hints import data_parallel, reduce_partial

from .common import ModelConfig


# --------------------------------------------------------------------- #
# initializers
# --------------------------------------------------------------------- #
def dense_init(g: torch.Generator, shape, dtype: torch.dtype,
               in_axis_size: int | None = None) -> nn.Parameter:
    """Truncated-normal fan-in initializer (std fan_in^-0.5, cut at 2 std),
    fan_in ``in_axis_size``, by default ``shape[0]``.  A stack of matrices
    (more than 2 axes, e.g. an MoE's (E, d, ff) experts, whose fan-in is
    d) is drawn one matrix at a time into a tensor of ``dtype``: an fp32
    temporary of llama4's whole ``wi`` stack would take 21.5 GB."""
    std = (in_axis_size or shape[0]) ** -0.5
    if len(shape) <= 2:
        return _param(_trunc_normal(g, shape, std).to(dtype))
    out = torch.empty(shape, dtype=dtype, device=g.device)
    for matrix in out:
        matrix.copy_(_trunc_normal(g, shape[1:], std))
    return _param(out)


def rng(g) -> torch.Generator | None:
    """``g`` itself, or None for a :class:`ShapeInit`: it draws nothing."""
    return g if isinstance(g, torch.Generator) else None


class ShapeInit:
    """Stands in for the generator of ``init``: the model's tensors are
    made on ``device`` with no values drawn, shapes and dtypes only.  On
    the meta device (``META_INIT``) nothing is allocated; under a
    ``FakeTensorMode`` (the dry run, ``launch/dryrun.py``) the tensors are
    fake tensors on ``device``, those ``refresh()`` derives included."""

    def __init__(self, device):
        self.device = torch.device(device)


META_INIT = ShapeInit("meta")


def _trunc_normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=g.device)
    if rng(g) is None:  # a ShapeInit: no values (the rejection loop reads them)
        return t
    return nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=rng(g))


def embed_init(g: torch.Generator, shape, dtype: torch.dtype) -> nn.Parameter:
    t = torch.randn(shape, generator=rng(g), device=g.device) * 0.02
    return _param(t.to(dtype))


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def ones(dim: int, dtype: torch.dtype, device) -> nn.Parameter:
    return _param(torch.ones(dim, dtype=dtype, device=device))


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
class RMSNorm(nn.Module):
    """RMSNorm computed in fp32, returned in the input's dtype; on a mesh,
    of the residual stream's reduced sum (``reduce_partial``)."""

    def __init__(self, dim: int, dtype: torch.dtype, device):
        super().__init__()
        self.scale = ones(dim, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(self.scale, reduce_partial(x))


class LayerNorm(nn.Module):
    """LayerNorm with scale and bias at eps 1e-6 (the reference's, not
    torch's 1e-5), computed in fp32, returned in the input's dtype; on a
    mesh, of the residual stream's reduced sum (``reduce_partial``)."""

    def __init__(self, dim: int, dtype: torch.dtype, device):
        super().__init__()
        self.scale = ones(dim, dtype, device)
        self.bias = _param(torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        xf = reduce_partial(x).float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


def make_norm(cfg: ModelConfig, device) -> nn.Module:
    """The config's norm over d_model: RMSNorm or LayerNorm (``norm_type``)."""
    if cfg.norm_type == "layernorm":
        return LayerNorm(cfg.d_model, cfg.pdtype, device)
    return RMSNorm(cfg.d_model, cfg.pdtype, device)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """RMSNorm over the last axis in fp32; also the head-wise qk-norm when
    ``x`` is (..., heads, head_dim) and ``scale`` is (head_dim,)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# --------------------------------------------------------------------- #
# RoPE (split-half, not interleaved)
# --------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    sin = torch.sin(angles)[..., None, :]  # (..., seq, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------- #
class _SiLU(torch.autograd.Function):
    """silu with the native ``silu_backward`` kernel as its backward in
    every mode.  Under ``torch.func.grad`` PyTorch's own silu gradient is
    a decomposition that rounds otherwise, by an ulp, so a training task
    under ``vmap(grad(...))`` (``Service.execute_batch``) would not compute
    the gradients it computes alone; here both are autograd's."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return nn.functional.silu(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        return torch.ops.aten.silu_backward(g, ctx.saved_tensors[0])


def silu(x: torch.Tensor) -> torch.Tensor:
    """``nn.functional.silu``; differentiable through ``_SiLU``."""
    if not torch.is_grad_enabled():  # serving: no Function on the path
        return nn.functional.silu(x)
    return _SiLU.apply(x)


class SwiGLU(nn.Module):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        d, ff, pd = cfg.d_model, cfg.d_ff, cfg.pdtype
        self.wi = dense_init(g, (d, ff), pd)
        self.wg = dense_init(g, (d, ff), pd)
        self.wo = dense_init(g, (ff, d), pd)
        self.dtype = cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = silu(x @ self.wg.to(dt)) * (x @ self.wi.to(dt))
        return h @ self.wo.to(dt)


class GeluMLP(nn.Module):
    """``gelu(x wi) wo`` with no bias; GELU's tanh approximation, which is
    ``jax.nn.gelu``'s default."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        d, ff, pd = cfg.d_model, cfg.d_ff, cfg.pdtype
        self.wi = dense_init(g, (d, ff), pd)
        self.wo = dense_init(g, (ff, d), pd)
        self.dtype = cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = nn.functional.gelu(x @ self.wi.to(dt), approximate="tanh")
        return h @ self.wo.to(dt)


def make_mlp(cfg: ModelConfig, g: torch.Generator) -> nn.Module:
    """The config's dense MLP: SwiGLU or GELU (``mlp_act``)."""
    return GeluMLP(cfg, g) if cfg.mlp_act == "gelu" else SwiGLU(cfg, g)


# --------------------------------------------------------------------- #
# embeddings / unembedding
# --------------------------------------------------------------------- #
class Embedding(nn.Module):
    """Token table (vocab, d_model).  ``unembed`` returns fp32 logits from
    an fp32 copy of the table, made once and reused while the table is
    unchanged: casting a 151936 x 2048 table on every decode step would
    allocate 1.24 GB per step.  The copy is detached: training reads the
    live ``table`` (``models/loss.py``), and a copy of the module (deepcopy,
    pickle) leaves the fp32 copy behind, to be made again on first use."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.table = embed_init(g, (cfg.vocab_size, cfg.d_model), cfg.pdtype)
        self.dtype = cfg.dtype
        self._table_f32: tuple | None = None  # (storage, offset, version, tensor)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        table = self.table.to(self.dtype)
        if isinstance(table, DTensor):  # the lookup's backward has no DTensor rule
            return data_parallel(lambda t_, w_: w_[t_], (tokens,), (table,))
        return table[tokens]

    def table_f32(self) -> torch.Tensor:
        t = self.table
        local = t.to_local() if isinstance(t, DTensor) else t
        # keyed on its storage (a fake tensor's has no address to key on)
        key = (local.untyped_storage()._cdata, local.storage_offset(), local._version)
        cached = self._table_f32
        if cached is None or cached[:3] != key:
            cached = (*key, t.detach().float())
            self._table_f32 = cached
        return cached[3]

    def drop_f32(self) -> None:
        """Free the fp32 copy (training changes the table every step)."""
        self._table_f32 = None

    def __getstate__(self):
        return {**self.__dict__, "_table_f32": None}

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits, x.float() @ table.T in fp32."""
        return x.float() @ self.table_f32().T
