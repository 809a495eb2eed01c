"""Differentiable selective scan: the counterpart of the reference
package's ``jax.custom_vjp`` (``repro/kernels/mamba_scan/ops.py``).

The forward launches the scan kernel (``mamba_scan_fwd``: the CUDA kernel
for CUDA tensors, the plain version for CPU tensors) and saves its inputs.
The backward is not a kernel, in the reference either: there it is the
VJP of the chunked jnp oracle, recomputed from the saved inputs.  Here it
is ``torch.func.vjp`` of the plain chunked scan (``mamba_scan_plain``),
recomputed inside ``backward``.  That is the one place a plain version
runs on the CUDA training path, by design, not as a fallback: a kernel
that fails to build or launch in the forward raises.  Being a function
transform, the VJP runs the same under ``.backward()``, under
``torch.func.grad`` and under ``vmap(grad(...))``, where the backward
meets BatchedTensors.

Under ``torch.func.vmap`` (``Service.execute_batch``) the Function's
``vmap`` staticmethod is the scan's one vmap rule (``kernels/batched.py``):
the tasks fold into b, and one ``_Scan.apply`` on the folded inputs
launches the kernel once.  ``A`` arriving unbatched (the serving path's
weights) stays one (d, n) matrix for the whole folded batch; ``A``
arriving batched (a training task's own weights, (d, n) a task) is
expanded to one matrix a folded batch row, (N·b, d, n), which the kernel
reads through its batch stride.  The backward then runs at the vmap level
on each task's own (d, n) ``A``.  The rule needs the ``forward(x, ...)``
+ ``setup_context`` form, which functorch asks of every
``autograd.Function`` it transforms.
"""

from __future__ import annotations

import torch

from ..batched import fold, unfold
from .mamba_scan import mamba_scan_fwd, mamba_scan_plain

# the vmap rule's view of the inputs: each folds into b
SCAN_INPUTS = ("x", "dt", "A", "B", "C", "h0")


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(x, dt, A, B, C, h0):
        return mamba_scan_fwd(x, dt, A, B, C, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def vmap(info, in_dims, *inputs):
        n = info.batch_size
        inputs, in_dims = list(inputs), list(in_dims)
        A, a_dim = inputs[2], in_dims[2]
        if a_dim is None:  # one A for every task: the kernel's shared (d, n)
            fixed = ("A",)
        else:  # each task's own A, one a batch row: (n, b, d, n_state)
            x, x_dim = inputs[0], in_dims[0]
            b = x.shape[x_dim + 1] if x_dim is not None else x.shape[0]
            A = A.movedim(a_dim, 0)
            inputs[2], in_dims[2], fixed = A[:, None].expand(n, b, *A.shape[1:]), 0, ()
        y, hf = _Scan.apply(*fold("mamba_scan", n, SCAN_INPUTS, inputs, in_dims, fixed=fixed))
        return (unfold(y, n), unfold(hf, n)), (0, 0)

    @staticmethod
    def backward(ctx, gy, gh):
        return _plain_vjp(ctx, gy, gh)


def _plain_vjp(ctx, gy, gh):
    """The scan's backward: ``torch.func.vjp`` of the plain chunked scan,
    recomputed from the saved inputs."""
    need = ctx.needs_input_grad
    if not any(need):
        return (None,) * 6
    saved = ctx.saved_tensors
    wrt = [i for i, r in enumerate(need) if r]

    def scan(*primals):
        args = list(saved)
        for i, t in zip(wrt, primals):
            args[i] = t
        return mamba_scan_plain(*args)

    _, vjp = torch.func.vjp(scan, *(saved[i] for i in wrt))
    grads = dict(zip(wrt, vjp((gy, gh))))
    return tuple(grads.get(i) for i in range(6))


class _PlainScan(torch.autograd.Function):
    """``_Scan`` with the plain chunked scan in the kernel's place: the
    forward keeps no autograd graph of the plain scan, only its inputs, and
    the backward is ``_Scan``'s.  A whole model's kernels can then be held
    against the plain versions on the card in the memory the kernels' step
    takes, where autograd through ``mamba_scan_plain`` keeps every level of
    every layer's log-depth scan until the backward."""

    @staticmethod
    def forward(x, dt, A, B, C, h0):
        return mamba_scan_plain(x, dt, A, B, C, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gy, gh):
        return _plain_vjp(ctx, gy, gh)


def mamba_scan(x, dt, A, B, C, h0=None):
    """Differentiable scan through the kernel's dispatch.  x, dt (b,s,d);
    A (d,n) or (b,d,n); B, C (b,s,n); h0 (b,d,n) or None.  Returns (y (b,s,d),
    h_final (b,d,n)), fp32."""
    return _Scan.apply(x, dt, A, B, C, h0)


def mamba_scan_plain_train(x, dt, A, B, C, h0=None):
    """``mamba_scan`` through the plain versions on any device: the plain
    chunked scan's outputs and gradients, with ``mamba_scan``'s memory."""
    return _PlainScan.apply(x, dt, A, B, C, h0)
