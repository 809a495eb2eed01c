"""Kernel dispatch: hand-written CUDA kernels for CUDA tensors, their
plain PyTorch versions for CPU tensors.  The kernels: flash attention
(prefill and training forward: a tensor-core kernel for bf16 and one for
fp32, whose products are three tf32 products each), flash decode, the
flash backward's dq and dk/dv passes (tensor-core kernels for bf16 and for
fp32, the fp32 ones' products three tf32 products each), and the Mamba-1
selective scan.

The tuning cache (``repro_torch.tune``) picks launch parameters where
the caller names none: the bf16 and fp32 flash forwards' tiles
(``flash_fwd``), the bf16 and fp32 backward pairs' tiles (``flash_bwd``:
dq's query and key tiles, dk/dv's keys a block and queries a step),
decode's KV splits (``decode``) and the scan's lanes a channel
(``mamba``), all under the backend key ``"cuda"``; and the chunks of the
plain paths the card runs, ``chunked_attention``'s (``xla_flash``) and
the scan backward's ``mamba_scan_plain`` (``mamba``), under ``"torch"``.
With no cache installed, or on a miss, every kernel launches its untuned
geometry.  A folded call of ``Service.execute_batch`` reads the cache at
its folded batch.

A windowed attention call (jamba's attention layers at long context) runs
a plain windowed path on every device, as the reference sends every
windowed call to its non-Pallas path: ``chunked_attention`` for prefill,
the chunked flash with its manual backward (``flash_attention/chunked.py``,
the reference's ``flash_attention_xla``) for training,
``decode_attention_xla`` for decode.  It launches no kernel and counts no
launch; the kernels take no window.

The prefill, train and decode members go through the tensor-parallel
attention, which decides the route: while a mesh with a "model" axis is
current (``sharding.hints.use_mesh``) and the inputs are DTensors,
``flash_attention_tp`` runs the unsharded dispatch above, the kernels
included, on each rank's head shard under ``local_map``, and
``decode_attention_tp`` runs the decode kernel on each rank's cache chunk
and merges the chunks by their log-sum-exp over "model"; otherwise both
are the unsharded dispatch, the same launches and bits as with no mesh.
The scan member likewise runs the scan kernel on each rank's d_inner
shard under ``local_map`` (``mamba_scan_tp``).

Fake CUDA tensors (``FakeTensorMode``: the dry run, ``launch/dryrun.py``)
take each kernel's ``torch.library`` op, checked as the kernel checks
them (dtype, head dims, grid; a shape the kernel refuses raises there, as
on the card): the flash forward (``repro_torch::flash_attention_fwd``, bf16
and fp32), the backward pair (``repro_torch::flash_attention_bwd``, beside
the Dvec scratch the launches allocate), decode
(``repro_torch::decode_attention_fwd``, with ``return_lse``
``..._fwd_lse``) and the scan (``repro_torch::mamba_scan_fwd``, beside the
fp32 copies of its inputs).  Their fake impls run; nothing is built or
launched.  Each op carries a FLOP formula (``torch.utils.flop_counter``'s
registry) equal to ``FlopCounterMode``'s count of the kernel's plain
version at the same shapes, the reference's convention (its XLA path
computes the full masked grid): the flash forward 2 B H Sq Skv (D + Dv)
over the full grid, masked positions included; the backward the plain
backward's five products, 2 B H Sq Skv (3 D + 2 Dv); decode the whole
cache, 2 B H S (D + Dv), slots past ``cache_index`` included; the scan the
plain chunked scan's ``C h`` products, 2 b s d n.  So a dry run on fake
``cpu`` tensors through the plain versions counts what one on fake
``cuda`` tensors through the kernels counts.

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

from ..tune.cache import ConfigProbe
from ..tune.space import default_config
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


_CHUNKS_PROBE = ConfigProbe("xla_flash", ("B", "Sq", "Skv", "H", "K", "D", "Dv"),
                            "torch", default_config("xla_flash", "torch"))


def _chunks(q, v) -> dict:
    """The tuning cache's chunks for this shape (``xla_flash``,
    ``"torch"``), as the reference's windowed dispatch reads its
    ``"xla"`` entries."""
    B, Sq, H, D = q.shape
    _, Skv, K, Dv = v.shape
    return _CHUNKS_PROBE((B, Sq, Skv, H, K, D, Dv), q.dtype)


def local_attention(q, k, v, *, causal, window, train, q_chunk=None, kv_chunk=None):
    """The unsharded attention: the flash kernel (``train``: through its
    autograd rule, the dq and dk/dv kernels in the backward); a windowed
    call runs ``chunked_attention`` (prefill) or the chunked flash with its
    manual backward (training) at the given chunks, by default the tuning
    cache's.  The tensor-parallel attention's local body."""
    if window is None:
        if train:
            return _flash.flash_attention(q, k, v, causal=causal)
        return _flash.flash_attention_fwd(q, k, v, causal=causal)[0]
    if q_chunk is None:
        cfg = _chunks(q, v)
        q_chunk, kv_chunk = cfg["q_chunk"], cfg["kv_chunk"]
    if train:
        from .flash_attention.chunked import flash_attention_chunked

        return flash_attention_chunked(q, k, v, causal, window, q_chunk, kv_chunk)
    from repro_torch.models.attention import chunked_attention

    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_chunk=q_chunk, kv_chunk=kv_chunk)


def flash_attention_dispatch(q, k, v, *, causal=True, window=None):
    """(B,Sq,H,D) x (B,Skv,K,D) -> (B,Sq,H,Dv)."""
    return flash_attention_tp(q, k, v, causal=causal, window=window, train=False)


def decode_attention_dispatch(q, k_cache, v_cache, *, cache_index, window=None):
    """(B,1,H,D) against (B,S,K,D) caches -> (B,1,H,Dv)."""
    return decode_attention_tp(q, k_cache, v_cache, cache_index=cache_index, window=window)


def local_decode(q, k_cache, v_cache, *, cache_index, window=None):
    """The unsharded decode: the decode kernel, or ``decode_attention_xla``
    for a windowed call."""
    if window is not None:
        from repro_torch.models.attention import decode_attention_xla

        return decode_attention_xla(q, k_cache, v_cache,
                                    cache_index=cache_index, window=window)
    return _decode.decode_attention_fwd(q, k_cache, v_cache,
                                        cache_index=cache_index)


def flash_attention_train_dispatch(q, k, v, *, causal=True, window=None):
    """Differentiable (B,Sq,H,D) x (B,Skv,K,D) -> (B,Sq,H,Dv)."""
    return flash_attention_tp(q, k, v, causal=causal, window=window, train=True)


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
    (b,d,n)), fp32, differentiable; under a mesh on each rank's d_inner
    shard (``mamba_scan_tp``)."""
    return mamba_scan_tp(x, dt, A, B, C, h0)


# the tensor-parallel attention's local bodies are local_attention and
# local_decode above
from .decode_attention.sharded import decode_attention_tp  # noqa: E402
from .flash_attention.sharded import flash_attention_tp  # noqa: E402
from .mamba_scan.sharded import mamba_scan_tp  # noqa: E402

DISPATCH = AttentionOps(flash_attention_dispatch, decode_attention_dispatch,
                        flash_attention_train_dispatch, mamba_scan_dispatch)
PLAIN = AttentionOps(_plain_prefill, _plain_decode, _plain_train,
                     _scan.mamba_scan_plain)


def train_step_launches(cfg, *, long_context: bool = False) -> dict:
    """{kernel name: launches} of one training step of the decoder LM
    ``cfg`` through ``DISPATCH`` on CUDA tensors, every kernel of
    ``KERNELS`` named.  An attention layer (GQA or MLA) with no window
    launches ``cfg.compute_dtype``'s flash forward, once more under
    ``cfg.remat`` (each pattern repeat's forward runs again in the
    backward), and its dq and dk/dv kernels once; a windowed one (its
    block's window, or ``long_context``'s) launches nothing, as it trains
    through the chunked flash.  A Mamba layer launches the scan kernel,
    again under remat; its backward is autograd through the plain scan.
    The MoE, MLPs, norms and the loss launch no kernel of these."""
    import torch

    from ..models.blocks import _window_for

    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: an encoder-decoder has no decoder pattern to count")
    dtype = getattr(torch, cfg.compute_dtype)
    forwards = 2 if cfg.remat else 1
    out = {kern.name: 0 for kern in KERNELS}
    for spec in cfg.pattern:
        if spec.mixer == "attn" and _window_for(cfg, spec, long_context) is None:
            out[_flash.forward_kernel(dtype).name] += forwards * cfg.n_repeats
            for kern in _flash.backward_kernels(dtype):
                out[kern.name] += cfg.n_repeats
        elif spec.mixer == "mamba":
            out[_scan.KERNEL.name] += forwards * cfg.n_repeats
    return out
