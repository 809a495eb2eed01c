"""Mamba-1 selective state-space mixer (falcon-mamba's layers): the
reference package's ``repro/models/mamba.py`` and the mamba branch of
its block prefill.

Training and prefill run the selective scan through ``ops.scan``, by
default the kernels' dispatch (on a CUDA tensor the hand-written scan
kernel, on a CPU tensor the plain chunked scan).  Decode is one token: a
plain state update with no kernel, as in the reference, written into the
state in place (as the attention layers write the KV cache).  A layer's
state is ``{"conv": (B, W-1, d_inner) in the compute dtype, "ssm":
(B, d_inner, state_dim) fp32}``.

Under a mesh (DTensor weights and activations, announced axes) the mixer
runs channel-parallel, as the reference's GSPMD plan with its ``_pin_d``:
the input product's two halves (x and the gate z) are taken whole over
"model" and each rank keeps its own channels of both (``mamba_channels``:
batch over the data axes, d_inner over "model"); the conv, the SSM
inputs' products (``x_proj``'s partial sum over "model" reduced first,
then ``dt``'s column-parallel), the scan (``mamba_scan_tp``, on each
rank's channels under ``local_map``) and the gate run on those channels,
and the output product is row-parallel.  The serve state is laid out by
channels too (``cache_partition_specs``), and a decode step updates it on
each rank's channels under ``local_map``, with no gather.  Without a mesh
every hint is the identity.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map
from torch.nn.functional import softplus

from ..kernels import AttentionOps
from ..kernels.mamba_scan.sharded import channel_placements
from ..sharding.hints import current_axes, reduce_partial, split_channels
from .common import ModelConfig
from .layers import _param, dense_init, rng, silu


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        s, pd, dev = cfg.ssm, cfg.pdtype, g.device
        d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm.state_dim
        dtr = s.resolved_dt_rank(d)
        self.in_proj = dense_init(g, (d, 2 * di), pd)
        conv = torch.randn((s.conv_width, di), generator=rng(g), device=dev)
        self.conv_w = _param((conv * s.conv_width ** -0.5).to(pd))
        self.conv_b = _param(torch.zeros(di, dtype=pd, device=dev))
        self.x_proj = dense_init(g, (di, dtr + 2 * n), pd)
        self.dt_proj_w = dense_init(g, (dtr, di), pd)
        # inverse softplus of dt drawn uniformly from [1e-3, 0.1]
        u = torch.rand(di, generator=rng(g), device=dev) * (0.1 - 1e-3) + 1e-3
        self.dt_proj_b = _param(torch.log(torch.expm1(u.clamp_min(1e-4))).to(pd))
        # S4D-real init; A_log and D stay fp32 in every config
        a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
        self.A_log = _param(torch.log(a).expand(di, n).contiguous())
        self.D = _param(torch.ones(di, dtype=torch.float32, device=dev))
        self.out_proj = dense_init(g, (di, d), pd)
        self.cfg = cfg

    def _ssm_inputs(self, xc):
        """Conv'd activations (B,S,di) -> (dt, B, C), fp32.  Under a mesh the
        product over d_inner leaves a partial sum over "model", reduced
        first (as GSPMD does): ``dt``'s product and bias then run
        column-parallel, and B and C come whole."""
        cfg = self.cfg
        n, dtr = cfg.ssm.state_dim, cfg.ssm.resolved_dt_rank(cfg.d_model)
        proj = reduce_partial(xc @ self.x_proj.to(cfg.dtype))  # (B,S,dtr+2n)
        dt = (proj[..., :dtr] @ self.dt_proj_w.to(cfg.dtype)
              + self.dt_proj_b.to(cfg.dtype))
        return (softplus(dt.float()), proj[..., dtr:dtr + n].float(),
                proj[..., dtr + n:].float())

    def _in_proj(self, x):
        """(B,S,d) -> (x, z), each (B,S,di) on its own channels."""
        return split_channels(x @ self.in_proj.to(self.cfg.dtype), 2)  # (B,S,2di)

    def _causal_conv(self, x, conv_state=None):
        """Depthwise causal conv1d over (B,S,di).  Returns (out, tail): the
        tail is the last W-1 *pre-conv* inputs, the next call's history."""
        W, dt = self.cfg.ssm.conv_width, self.cfg.dtype
        w = self.conv_w.to(dt)
        if conv_state is None:
            pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
        else:
            pad = conv_state.to(x.dtype)
        xp = torch.cat([pad, x], dim=1)  # (B, S+W-1, di)
        S = x.shape[1]
        out = sum(xp[:, i:i + S] * w[i] for i in range(W))
        tail = xp[:, -(W - 1):].clone() if W > 1 else pad  # not a view of xp
        return out + self.conv_b.to(dt), tail

    def _mix(self, x, ops: AttentionOps):
        """(B,S,d) -> (out (B,S,d), conv tail, h_final)."""
        cfg = self.cfg
        if ops.scan is None:
            raise ValueError("a Mamba layer needs AttentionOps with a scan member")
        xin, z = self._in_proj(x)
        xc, tail = self._causal_conv(xin)
        xc = silu(xc)
        dt, Bm, Cm = self._ssm_inputs(xc)
        A = -torch.exp(self.A_log)
        y, h_final = ops.scan(xc.float(), dt, A, Bm, Cm)
        y = y + xc.float() * self.D
        y = y.to(cfg.dtype) * silu(z)
        return y @ self.out_proj.to(cfg.dtype), tail, h_final

    def forward_train(self, x, *, ops: AttentionOps):
        """Differentiable (B,S,d) -> (B,S,d)."""
        return self._mix(x, ops)[0]

    def prefill(self, x, *, ops: AttentionOps):
        """Returns ((B,S,d), state)."""
        out, tail, h_final = self._mix(x, ops)
        return out, {"conv": tail, "ssm": h_final}

    def decode(self, x, state):
        """One token (B,1,d); ``state`` is updated in place and returned."""
        cfg = self.cfg
        xin, z = self._in_proj(x)
        xc, conv_state = self._causal_conv(xin, state["conv"])
        xc = silu(xc)
        dt, Bm, Cm = self._ssm_inputs(xc)  # (B,1,di), (B,1,n), (B,1,n)
        A = -torch.exp(self.A_log)
        y, h = _ssm_step_on_channels(dt, A, Bm, Cm, xc.float(), self.D, state["ssm"])
        y = y.to(cfg.dtype) * silu(z)
        state["conv"].copy_(conv_state)
        state["ssm"].copy_(h)
        return y @ self.out_proj.to(cfg.dtype), state

    def make_empty_state(self, batch: int) -> dict:
        cfg, dev = self.cfg, self.A_log.device
        return {"conv": torch.zeros((batch, cfg.ssm.conv_width - 1, cfg.d_inner),
                                    dtype=cfg.dtype, device=dev),
                "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm.state_dim),
                                   dtype=torch.float32, device=dev)}



def _ssm_step(dt, A, B, C, x, D, h):
    """One token's state update: dt, x (B,1,di); A (di,n); B, C (B,1,n); D
    (di,); h (B,di,n) -> (y (B,1,di), the new h), fp32."""
    dt0, B0, C0, x0 = dt[:, 0], B[:, 0], C[:, 0], x[:, 0]
    dA = torch.exp(dt0[..., None] * A)  # (B,di,n)
    dB = dt0[..., None] * B0[:, None, :]
    h = h * dA + dB * x0[..., None]
    y = torch.einsum("bdn,bn->bd", h, C0) + x0 * D
    return y[:, None], h


def _ssm_step_on_channels(dt, A, B, C, x, D, h):
    """``_ssm_step`` on each rank's channels under ``local_map`` (the state
    ``h`` as ``cache_partition_specs`` lays it out: batch over the data
    axes, d_inner over "model"); the call itself with no mesh."""
    if current_axes() is None or not isinstance(h, DTensor):
        return _ssm_step(dt, A, B, C, x, D, h)
    pl = channel_placements(h.device_mesh, h.shape[0], h.shape[1])
    chan, rows, whole = pl["chan"], pl["rows"], pl["whole"]
    return local_map(_ssm_step, out_placements=(chan, pl["state"]),
                     in_placements=(chan, rows, whole, whole, chan, rows, pl["state"]),
                     device_mesh=h.device_mesh, redistribute_inputs=True)(dt, A, B, C, x, D, h)
