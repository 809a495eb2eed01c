"""The selective scan under ``local_map`` over d_inner: the reference's
``_pin_d`` and ``_pin_xs`` (``repro/kernels/mamba_scan/ref.py``), which
keep d_inner sharded over "model" through its scan.

The recurrence runs channel by channel, so under a mesh with a "model"
axis each rank scans its own channels with no collective inside: x, dt
(b, s, d_inner) and h0 (b, d_inner, n) arrive with their channels over
"model" and A (d_inner, n) with its rows, B and C (b, s, n) whole over
"model"; the batch is over the data axes throughout.  The local body is
the differentiable scan (``ops.mamba_scan``): the scan kernel on the card,
the plain chunked scan on the CPU, the plain scan's VJP in the backward.
A's gradient is the sum of the data ranks' (each scans its own rows), B's
and C's the sum of the "model" ranks' (each contributes its channels).
Where the batch does not divide the data axes or d_inner the "model" axis,
that dim is taken whole.  With no mesh, no announced axes, no "model" axis
or an ``x`` that is not a DTensor, the call is the unsharded scan.
"""

from __future__ import annotations

from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from ...sharding.hints import current_axes, current_mesh
from ...sharding.specs import P, _dp, mesh_sizes, placements, sanitize_spec
from .ops import mamba_scan


def channel_placements(mesh, b: int, d: int) -> dict:
    """Placements on ``mesh`` with the batch ``b`` over the data axes and
    d_inner ``d`` over "model" (each where it divides): ``chan`` for (b, s,
    d), ``rows`` for (d, n) and (d,), ``state`` for (b, d, n), ``whole``
    for (b, s, n)."""
    bspec, dspec = sanitize_spec(P(_dp(mesh.mesh_dim_names), "model"), (b, d),
                                 mesh_sizes(mesh))
    return {"chan": placements(P(bspec, None, dspec), mesh),
            "rows": placements(P(dspec, None), mesh),
            "state": placements(P(bspec, dspec, None), mesh),
            "whole": placements(P(bspec, None, None), mesh)}


def mamba_scan_tp(x, dt, A, B, C, h0=None):
    """x, dt (b,s,d); A (d,n); B, C (b,s,n); h0 (b,d,n) or None -> (y
    (b,s,d), h_final (b,d,n)), fp32, differentiable; d over "model"."""
    mesh, axes = current_mesh(), current_axes()
    if (mesh is None or axes is None or "model" not in mesh.mesh_dim_names
            or not isinstance(x, DTensor)):
        return mamba_scan(x, dt, A, B, C, h0)
    pl = channel_placements(mesh, x.shape[0], x.shape[2])
    chan, rows, state, whole = pl["chan"], pl["rows"], pl["state"], pl["whole"]
    # a gradient summed over the axes that split the other operand
    a_grad = [Partial() if w.is_shard() else r for w, r in zip(whole, rows)]
    bc_grad = [Partial() if c.is_shard(2) else w for c, w in zip(chan, whole)]
    ins, grads = (chan, chan, rows, whole, whole), (chan, chan, a_grad, bc_grad, bc_grad)
    args = (x, dt, A, B, C)
    if h0 is not None:
        ins, grads, args = ins + (state,), grads + (state,), args + (h0,)
    return local_map(mamba_scan, out_placements=(chan, state), in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)
