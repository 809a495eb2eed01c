"""Kernel dispatch: hand-written CUDA kernels for CUDA tensors, their
plain PyTorch versions for CPU tensors.  The kernels: flash attention
(prefill and training forward: a tensor-core kernel for bf16 and one for
fp32, whose products are three tf32 products each), flash decode, the
flash backward's dq and dk/dv passes (tensor-core kernels for bf16 and for
fp32, the fp32 ones' products three tf32 products each), and the Mamba-1
selective scan.

There is no tuning cache yet: block sizes are fixed in the kernels.  A
windowed attention call (jamba's attention layers at long context) runs
the model's plain windowed path on every device, as the reference sends
every windowed call to its non-Pallas path: ``chunked_attention`` for
prefill and training, ``decode_attention_xla`` for decode.  It launches
no kernel and counts no launch; the kernels take no window.

A model's layers call one :class:`AttentionOps`, passed down from the
model's entry points: its attention members, and ``scan`` for Mamba
layers.  ``DISPATCH`` (the default, and the only one the serving and
training paths use) is the dispatch above; ``PLAIN`` runs the plain
versions on any device, so a caller can hold a whole model's kernels
against them on the card, with the same weights, in one call.  The
``train`` and ``scan`` members are differentiable: ``train`` through the
forward kernel, then the dq and dk/dv kernels in the backward; ``scan``
through the scan kernel, then autograd through the plain chunked scan in
the backward, as the reference's VJP does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import mamba_scan as _scan

KERNELS = (_flash.SM90_KERNEL, _flash.SM90_FP32_KERNEL, _decode.KERNEL,
           _flash.DQ_SM90_KERNEL, _flash.DKV_SM90_KERNEL,
           _flash.DQ_SM90_FP32_KERNEL, _flash.DKV_SM90_FP32_KERNEL,
           _scan.KERNEL)


class AttentionOps(NamedTuple):
    """``prefill(q, k, v, *, causal, window)``,
    ``decode(q, k_cache, v_cache, *, cache_index, window)``, the
    differentiable ``train(q, k, v, *, causal, window)`` (None: the ops
    serve only) and the differentiable selective scan
    ``scan(x, dt, A, B, C, h0=None) -> (y, h_final)`` (None: the ops run
    no Mamba layer)."""
    prefill: Callable
    decode: Callable
    train: Callable | None = None
    scan: Callable | None = None


def flash_attention_dispatch(q, k, v, *, causal=True, window=None):
    """(B,Sq,H,D) x (B,Skv,K,D) -> (B,Sq,H,Dv)."""
    if window is not None:
        from repro_torch.models.attention import chunked_attention

        return chunked_attention(q, k, v, causal=causal, window=window)
    return _flash.flash_attention_fwd(q, k, v, causal=causal)[0]


def decode_attention_dispatch(q, k_cache, v_cache, *, cache_index, window=None):
    """(B,1,H,D) against (B,S,K,D) caches -> (B,1,H,Dv)."""
    if window is not None:
        from repro_torch.models.attention import decode_attention_xla

        return decode_attention_xla(q, k_cache, v_cache,
                                    cache_index=cache_index, window=window)
    return _decode.decode_attention_fwd(q, k_cache, v_cache,
                                        cache_index=cache_index)


def flash_attention_train_dispatch(q, k, v, *, causal=True, window=None):
    """Differentiable (B,Sq,H,D) x (B,Skv,K,D) -> (B,Sq,H,Dv)."""
    if window is not None:
        from repro_torch.models.attention import chunked_attention

        return chunked_attention(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal)


def _no_window(window) -> None:
    if window is not None:
        raise NotImplementedError("the plain kernel versions take no window")


def _plain_prefill(q, k, v, *, causal=True, window=None):
    _no_window(window)
    return _flash.flash_attention_plain(q, k, v, causal=causal)[0]


def _plain_decode(q, k_cache, v_cache, *, cache_index, window=None):
    _no_window(window)
    return _decode.decode_attention_plain(q, k_cache, v_cache,
                                          cache_index=cache_index)


def _plain_train(q, k, v, *, causal=True, window=None):
    _no_window(window)
    return _flash.flash_attention_plain_train(q, k, v, causal=causal)


def mamba_scan_dispatch(x, dt, A, B, C, h0=None):
    """x, dt (b,s,d); A (d,n); B, C (b,s,n) -> (y (b,s,d), h_final
    (b,d,n)), fp32, differentiable."""
    return _scan.mamba_scan(x, dt, A, B, C, h0)


DISPATCH = AttentionOps(flash_attention_dispatch, decode_attention_dispatch,
                        flash_attention_train_dispatch, mamba_scan_dispatch)
PLAIN = AttentionOps(_plain_prefill, _plain_decode, _plain_train,
                     _scan.mamba_scan_plain)
