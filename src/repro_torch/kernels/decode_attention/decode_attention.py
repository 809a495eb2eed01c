"""Flash-decode: the CUDA kernel's wrapper and its plain version.

``decode_attention_fwd`` launches ``csrc/decode_attention_sm90.cu`` for
CUDA tensors and runs ``decode_attention_plain`` for CPU tensors.  Both compute
the reference package's Pallas ``decode_attention_fwd``: one query token
per (batch, q-head) against the cache, positions past ``cache_index``
(inclusive, one scalar for the batch) masked, GQA via h*K//H, fp32
softmax, output in the cache dtype.

The KV splits of a cluster are a launch parameter: ``splits`` (1..8; 0
is the kernel's own ``choose_splits``).  A call that names none reads it
from the tuning cache (``repro_torch.tune``, kernel ``decode``, backend
``"cuda"``), and without a cache, or on a miss, passes 0.  A count that
would leave a split shorter than one 32-key tile of this step's keys falls
to the tiles' count.

Under ``torch.func.vmap`` (``Service.execute_batch``) the call goes
through the custom op ``repro_torch::decode_attention_fwd``, whose vmap
rule folds the tasks into B and launches once, at the one
``cache_index`` of the whole batch (``kernels/batched.py``), reading the
cache at the folded batch.  Folding changes B, so the kernel may split
the cache into other KV splits and merge in another order than a task's
own launch: the results agree within the decode tolerance, not bit for
bit.
"""

from __future__ import annotations

import ctypes

import torch

from ...tune.cache import ConfigProbe, get_cache
from ...tune.space import DECODE_TILE, MAX_SPLITS, KernelConfigError, default_config
from .. import head_dims
from ..batched import fold, under_vmap, unfold
from ..build import CudaKernel

NEG_INF = -2.0e38

_p, _i = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "decode_attention_sm90.cu", "repro_decode_attention_fwd",
    [_p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DEFAULT_SPLITS = default_config("decode", "cuda")  # {"splits": 0}: choose_splits
_SPLITS_PROBE = ConfigProbe("decode", ("B", "S", "H", "K", "D", "Dv"), "cuda",
                            DEFAULT_SPLITS)


def decode_attention_plain(q, k_cache, v_cache, *, cache_index: int):
    """Masked softmax over the cache in fp32.  q (B,1,H,D), caches
    (B,S,K,D[v]) -> (B,1,H,Dv) in the cache dtype."""
    B, S, K, D = k_cache.shape
    H, Dv = q.shape[2], v_cache.shape[-1]
    qg = q.float().reshape(B, K, H // K, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * (D ** -0.5)
    pos = torch.arange(S, device=q.device)
    s = torch.where(pos <= cache_index, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-37)
    out = torch.einsum("bkgs,bskv->bkgv", p, v_cache.float()) / l
    return out.reshape(B, 1, H, Dv).to(v_cache.dtype)


def _check(q, k_cache, v_cache, cache_index):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention_fwd: q must be (B,1,H,D), got "
                         f"{tuple(q.shape)}")
    B, _, H, D = q.shape
    if (k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[3] != D
            or v_cache.shape[:3] != k_cache.shape[:3]):
        raise ValueError(f"decode_attention_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)} "
                         f"disagree")
    if H % k_cache.shape[2]:
        raise ValueError(f"decode_attention_fwd: {H} q-heads not a multiple "
                         f"of {k_cache.shape[2]} kv-heads")
    if not 0 <= cache_index < k_cache.shape[1]:
        raise ValueError(f"decode_attention_fwd: cache_index {cache_index} "
                         f"outside a cache of {k_cache.shape[1]} positions")


def decode_splits(dtype, B, S, H, K, D, Dv, cache_index, splits=None) -> int:
    """The KV splits a CUDA call launches: ``splits`` when given, else the
    tuning cache's for this shape, else 0 (the kernel's ``choose_splits``);
    a count past the 32-key tiles of the ``cache_index + 1`` keys falls to
    their count.  Raises :class:`KernelConfigError`, naming it, on a count
    the kernel does not take."""
    if splits is None:
        splits = _SPLITS_PROBE((B, S, H, K, D, Dv), dtype)["splits"]
        if splits == 0:
            return 0
    if isinstance(splits, bool) or not isinstance(splits, int) \
            or not 0 <= splits <= MAX_SPLITS:
        raise KernelConfigError(f"decode_attention_fwd: splits={splits!r}; the kernel "
                                f"takes 1..{MAX_SPLITS} KV splits, or 0 for its own count")
    return min(splits, max(1, (cache_index + 1) // DECODE_TILE)) if splits else 0


def _launch_tuned(q, k_cache, v_cache, out, cache_index, splits, stream):
    """Decode at the KV splits ``decode_splits`` resolves; a launch the
    kernel refuses raises :class:`KernelConfigError` naming the count."""
    B, _, H, D = q.shape
    _, S, K, Dv = v_cache.shape
    splits = decode_splits(q.dtype, B, S, H, K, D, Dv, cache_index, splits)
    try:
        KERNEL.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
                      B, S, H, K, D, cache_index, _DTYPES[q.dtype], splits, stream)
    except RuntimeError as e:
        if splits == 0:  # the kernel's own count: not a tuning matter
            raise
        raise KernelConfigError(
            f"decode_attention_fwd: splits={splits} at B={B}, H={H}, K={K}, D={D}, "
            f"cache_index {cache_index}: {e}") from e


def decode_attention_fwd(q, k_cache, v_cache, *, cache_index: int,
                         splits: int | None = None):
    """Returns (B,1,H,Dv) in the cache dtype.  ``cache_index`` is a Python
    int (last valid position, inclusive).

    CPU tensors go to the plain version; CUDA tensors to the kernel,
    which raises on what it does not take, at the KV splits
    ``decode_splits`` resolves (None reads the tuning cache).  Under vmap
    the call goes through the custom op, whose rule launches once for all
    the tasks."""
    if under_vmap(q, k_cache, v_cache):
        if torch.is_tensor(cache_index) and under_vmap(cache_index):
            raise ValueError("decode_attention_fwd under vmap: input cache_index "
                             "arrived batched; the kernel takes one cache_index "
                             "for the whole batch and cannot fold it")
        return _decode_op(q, k_cache, v_cache, int(cache_index), splits)
    cache_index = int(cache_index)
    _check(q, k_cache, v_cache, cache_index)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache,
                                      cache_index=cache_index)
    if (q.device.type != "cuda" or k_cache.device != q.device
            or v_cache.device != q.device):
        raise ValueError(f"decode_attention_fwd: q, caches on {q.device}, "
                         f"{k_cache.device}, {v_cache.device}; need one CUDA "
                         f"device")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention_fwd: dtypes {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}; the kernel takes "
                        f"one of float32, bfloat16")
    B, _, H, D = q.shape
    _, S, K, Dv = v_cache.shape
    head_dims.check("decode_attention_fwd", "decode", q.dtype, D, Dv)
    if B > 65535:
        raise ValueError(f"decode_attention_fwd: batch {B} (q {tuple(q.shape)}) "
                         "exceeds the grid's 65535")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("decode_attention_fwd: inputs must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention_fwd: the caches must start on a "
                         "16-byte boundary (the kernel copies 16 bytes at a time)")
    out = torch.empty((B, 1, H, Dv), dtype=v_cache.dtype, device=q.device)
    tuned = splits is not None or get_cache() is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tuned:
            _launch_tuned(q, k_cache, v_cache, out, cache_index, splits, stream)
        else:  # no cache, no count asked for: the kernel's own (0)
            KERNEL.launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                          out.data_ptr(), B, S, H, K, D, cache_index,
                          _DTYPES[q.dtype], 0, stream)
    return out


@torch.library.custom_op(
    "repro_torch::decode_attention_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k_cache, Tensor v_cache, int cache_index, "
           "int? splits=None) -> Tensor")
def _decode_op(q, k_cache, v_cache, cache_index, splits=None):
    return decode_attention_fwd(q, k_cache, v_cache, cache_index=cache_index, splits=splits)


@_decode_op.register_fake
def _(q, k_cache, v_cache, cache_index, splits=None):
    return q.new_empty((*q.shape[:3], v_cache.shape[3]), dtype=v_cache.dtype)


@_decode_op.register_vmap
def _(info, in_dims, q, k_cache, v_cache, cache_index, splits=None):
    n = info.batch_size
    q, k_cache, v_cache = fold("decode_attention_fwd", n, ("q", "k_cache", "v_cache"),
                               (q, k_cache, v_cache), in_dims[:3])
    out = decode_attention_fwd(q, k_cache, v_cache, cache_index=cache_index, splits=splits)
    return unfold(out, n), 0
