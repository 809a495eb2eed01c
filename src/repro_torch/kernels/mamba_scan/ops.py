"""Differentiable selective scan: the counterpart of the reference
package's ``jax.custom_vjp`` (``repro/kernels/mamba_scan/ops.py``).

The forward launches the scan kernel (``mamba_scan_fwd``: the CUDA kernel
for CUDA tensors, the plain version for CPU tensors) and saves its inputs.
The backward is not a kernel, in the reference either: there it is the
VJP of the chunked jnp oracle, recomputed from the saved inputs.  Here it
is autograd through the plain chunked scan (``mamba_scan_plain``),
recomputed under ``torch.enable_grad()`` inside ``backward``.  That is the
one place a plain version runs on the CUDA training path, by design, not
as a fallback: a kernel that fails to build or launch in the forward
raises.
"""

from __future__ import annotations

import torch

from .mamba_scan import mamba_scan_fwd, mamba_scan_plain


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0):
        y, hf = mamba_scan_fwd(x, dt, A, B, C, h0)
        ctx.save_for_backward(x, dt, A, B, C, h0)
        return y, hf

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        if not any(need):
            return (None,) * 6
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(r)
                      for t, r in zip(saved, need)]
            y, hf = mamba_scan_plain(*leaves)
            wrt = [t for t, r in zip(leaves, need) if r]
            grads = iter(torch.autograd.grad((y, hf), wrt, (gy, gh),
                                             allow_unused=True))
        return tuple(next(grads) if r else None for r in need)


def mamba_scan(x, dt, A, B, C, h0=None):
    """Differentiable scan through the kernel's dispatch.  x, dt (b,s,d);
    A (d,n); B, C (b,s,n); h0 (b,d,n) or None.  Returns (y (b,s,d),
    h_final (b,d,n)), fp32."""
    return _Scan.apply(x, dt, A, B, C, h0)
