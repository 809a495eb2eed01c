"""Attention dispatch: hand-written CUDA kernels for CUDA tensors, their
plain PyTorch versions for CPU tensors.

There is no tuning cache yet: block sizes are fixed in the kernels.  A
windowed call has no kernel in this package: on CUDA it raises, on the
CPU it runs the model's chunked reference (only jamba has a window).

A model's attention layers call one :class:`AttentionOps`, passed down
from the model's entry points.  ``DISPATCH`` (the default, and the only
one the serving and training paths use) is the dispatch above; ``PLAIN``
runs the plain versions on any device, so a caller can hold a whole
model's kernels against them on the card, with the same weights, in one
call.  Its ``train`` member is differentiable: the forward kernel, then
the dq and dk/dv kernels in the backward.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import decode_attention as _decode
from . import flash_attention as _flash

KERNELS = (_flash.KERNEL, _decode.KERNEL, _flash.DQ_KERNEL, _flash.DKV_KERNEL)


class AttentionOps(NamedTuple):
    """``prefill(q, k, v, *, causal, window)``,
    ``decode(q, k_cache, v_cache, *, cache_index, window)`` and the
    differentiable ``train(q, k, v, *, causal, window)`` (None: the ops
    serve only)."""
    prefill: Callable
    decode: Callable
    train: Callable | None = None


def _no_window_kernel(x) -> None:
    if x.device.type == "cuda":
        raise NotImplementedError(
            "windowed attention has no CUDA kernel in repro_torch yet")


def flash_attention_dispatch(q, k, v, *, causal=True, window=None):
    """(B,Sq,H,D) x (B,Skv,K,D) -> (B,Sq,H,Dv)."""
    if window is not None:
        _no_window_kernel(q)
        from repro_torch.models.attention import chunked_attention

        return chunked_attention(q, k, v, causal=causal, window=window)
    return _flash.flash_attention_fwd(q, k, v, causal=causal)[0]


def decode_attention_dispatch(q, k_cache, v_cache, *, cache_index, window=None):
    """(B,1,H,D) against (B,S,K,D) caches -> (B,1,H,Dv)."""
    if window is not None:
        _no_window_kernel(q)
        from repro_torch.models.attention import decode_attention_xla

        return decode_attention_xla(q, k_cache, v_cache,
                                    cache_index=cache_index, window=window)
    return _decode.decode_attention_fwd(q, k_cache, v_cache,
                                        cache_index=cache_index)


def flash_attention_train_dispatch(q, k, v, *, causal=True, window=None):
    """Differentiable (B,Sq,H,D) x (B,Skv,K,D) -> (B,Sq,H,Dv)."""
    if window is not None:
        _no_window_kernel(q)
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


DISPATCH = AttentionOps(flash_attention_dispatch, decode_attention_dispatch,
                        flash_attention_train_dispatch)
PLAIN = AttentionOps(_plain_prefill, _plain_decode, _plain_train)
