"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

``flash_attention_fwd`` launches ``csrc/flash_attention_sm90.cu`` for CUDA
bf16 tensors and ``csrc/flash_attention_sm90_fp32.cu`` for CUDA fp32 tensors
(both tensor cores and TMA; fp32 products as three tf32 products each), and
runs ``flash_attention_plain`` for CPU tensors.  All compute the reference
package's Pallas ``flash_attention_fwd``: GQA
attention (q-head h reads kv-head h*K//H) with scale D^-0.5, fp32 softmax,
the top-left causal mask ``k_pos <= q_pos``, and ``(out, lse)`` with
``lse = m + log(max(l, 1e-37))``.

``flash_attention_bwd`` launches ``csrc/flash_bwd_dq_sm90.cu`` then
``csrc/flash_bwd_dkv_sm90.cu`` for CUDA bf16 tensors,
``csrc/flash_bwd_dq_sm90_fp32.cu`` then ``csrc/flash_bwd_dkv_sm90_fp32.cu``
for CUDA fp32 tensors (all four tensor cores and TMA), and runs
``flash_attention_bwd_plain`` for CPU tensors.  All compute the reference's
Pallas ``flash_attention_bwd``: p recomputed from the forward's lse,
``Dvec = rowsum(dO * O)``, ``ds = p (dO V^T - Dvec) D^-0.5``, ``dq = ds K``,
``dk = ds^T Q``, ``dv = p^T dO``, all in fp32 (the bf16 kernels' products
take bf16 operands, with p and ds split into two bf16 terms each, and sum
in fp32; the fp32 kernels' products are three tf32 products each).

Every kernel's tiles are launch parameters.  The forwards take
``block_q`` (64 or 128 query rows of a q-head in a block) and ``block_k``
(keys a tile: 64 or 128 in bf16, 16, 32 or 64 in fp32); the backward
pairs take dq's ``dq_block_q`` and ``dq_block_k`` and dk/dv's
``dkv_block_k`` (keys a block) and ``dkv_block_q`` (queries a step).  A
call that names none reads them from the tuning cache
(``repro_torch.tune``, kernels ``flash_fwd`` and ``flash_bwd``, backend
``"cuda"``), and without a cache, or on a miss, runs each kernel's
untuned tiles (``repro_torch.tune.space.DEFAULTS``): the bf16 forward 64 x
64, the fp32 forward 64 x 32, the bf16 pair dq 64 x 64 and dk/dv 64 keys
x 32 queries, the fp32 pair dq 64 x 32 and dk/dv 64 x 16.  A training step
under ``repro_torch.tune.configure(path)`` runs the tuned pair.

Under ``torch.func.vmap`` (``Service.execute_batch``) the forward goes
through the custom op ``repro_torch::flash_attention_fwd`` and the
backward through ``repro_torch::flash_attention_bwd``, whose vmap rules
fold the tasks into B and launch once (the backward: one dq and one
dk/dv launch, lse and Dvec folded with B; ``kernels/batched.py``), so a
folded call reads the cache at its folded batch.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from ...tune.cache import ConfigProbe, get_cache
from ...tune.space import (KernelConfigError, default_config, flash_heads_a_block,
                           resolve_config, validate_config)
from .. import head_dims
from ..batched import fold, is_fake, under_transform, under_vmap, unfold, unwrapped
from ..build import CudaKernel

NEG_INF = -2.0e38

_p, _i = ctypes.c_void_p, ctypes.c_int
# the forward kernels take (q, k, v, out, lse, B, Sq, Skv, H, K, D, Dv,
# causal, block_q, block_k, stream)
_FWD_ARGS = [_p] * 5 + [_i] * 10 + [_p]
SM90_KERNEL = CudaKernel("flash_attention_sm90.cu",
                         "repro_flash_attention_fwd_sm90", _FWD_ARGS)
SM90_FP32_KERNEL = CudaKernel("flash_attention_sm90_fp32.cu",
                              "repro_flash_attention_fwd_sm90_fp32", _FWD_ARGS)
_DIMS = ("B", "Sq", "Skv", "H", "K", "D", "Dv")
# each dtype's untuned forward tiles, and the probe of the tuning cache that
# falls back to them
DEFAULT_TILES = default_config("flash_fwd", "cuda", "bfloat16")
FP32_TILES = default_config("flash_fwd", "cuda", "float32")
_FWD_DEFAULTS = {torch.bfloat16: (DEFAULT_TILES["block_q"], DEFAULT_TILES["block_k"]),
                 torch.float32: (FP32_TILES["block_q"], FP32_TILES["block_k"])}
(_BQ0, _BK0), (_FQ0, _FK0) = _FWD_DEFAULTS[torch.bfloat16], _FWD_DEFAULTS[torch.float32]
_TILES_PROBE = ConfigProbe("flash_fwd", _DIMS, "cuda", DEFAULT_TILES)
_FP32_TILES_PROBE = ConfigProbe("flash_fwd", _DIMS, "cuda", FP32_TILES)
# the backward pairs' tiles: (dq_block_q, dq_block_k, dkv_block_k,
# dkv_block_q), each dtype's untuned ones and its probe
BWD_TILE_NAMES = ("dq_block_q", "dq_block_k", "dkv_block_k", "dkv_block_q")
_BWD_DEFAULTS = {dt: tuple(default_config("flash_bwd", "cuda", name)[n] for n in BWD_TILE_NAMES)
                 for dt, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32"))}
_BWD_PROBES = {dt: ConfigProbe("flash_bwd", _DIMS, "cuda",
                               dict(zip(BWD_TILE_NAMES, _BWD_DEFAULTS[dt])))
               for dt in _BWD_DEFAULTS}
# resolved and checked tiles by what decides them: (kernel, dtype, D, Dv,
# q-heads a block, the tiles asked for, Sq <= 64, Skv <= 64)
_RESOLVED: dict[tuple, tuple] = {}
# the backward kernels all take (8 pointers, B, Sq, Skv, H, K, D, Dv,
# causal, their two tiles, stream): dq (block_q, block_k), dk/dv (block_k,
# block_q)
_BWD_ARGS = [_p] * 8 + [_i] * 10 + [_p]
DQ_SM90_KERNEL = CudaKernel("flash_bwd_dq_sm90.cu", "repro_flash_bwd_dq_sm90",
                            _BWD_ARGS)
DKV_SM90_KERNEL = CudaKernel("flash_bwd_dkv_sm90.cu",
                             "repro_flash_bwd_dkv_sm90", _BWD_ARGS)
DQ_SM90_FP32_KERNEL = CudaKernel("flash_bwd_dq_sm90_fp32.cu",
                                 "repro_flash_bwd_dq_sm90_fp32", _BWD_ARGS)
DKV_SM90_FP32_KERNEL = CudaKernel("flash_bwd_dkv_sm90_fp32.cu",
                                  "repro_flash_bwd_dkv_sm90_fp32", _BWD_ARGS)
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Masked softmax attention with materialised scores, in fp32.
    q (B,Sq,H,D), k (B,Skv,K,D), v (B,Skv,K,Dv) -> out (B,Sq,H,Dv) in
    q's dtype, lse (B,H,Sq) fp32."""
    B, Sq, H, D = q.shape
    Skv, K, Dv = v.shape[1], k.shape[2], v.shape[3]
    G = H // K
    qg = q.float().reshape(B, Sq, K, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (D ** -0.5)
    if causal:
        kpos = torch.arange(Skv, device=q.device)
        qpos = torch.arange(Sq, device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1).clamp_min(1e-37)
    out = torch.einsum("bkgqs,bskv->bqkgv", p, v.float())
    out = out / l.permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(l)).reshape(B, H, Sq)
    return out.reshape(B, Sq, H, Dv).to(q.dtype), lse


def _check(q, k, v, name="flash_attention_fwd"):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be 4-D (B,S,heads,head_dim)")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if H % k.shape[2]:
        raise ValueError(f"{name}: {H} q-heads not a multiple "
                         f"of {k.shape[2]} kv-heads")
    if Sq == 0 or k.shape[1] == 0:
        raise ValueError(f"{name}: empty sequence")


def _check_cuda(name, kind, q, k, v, *more):
    """What the kernels take: one CUDA device, one dtype (fp32 or bf16),
    head dims the ``kind`` ("flash_fwd" or "flash_bwd") of kernel takes
    (``head_dims``), contiguous tensors."""
    ts = (q, k, v) + more
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: inputs on "
                         f"{', '.join(str(t.device) for t in ts)}; need one "
                         "CUDA device")
    if any(t.dtype != q.dtype for t in ts) or q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtypes "
                        f"{', '.join(str(t.dtype) for t in ts)}; the kernel "
                        "takes one of float32, bfloat16")
    head_dims.check(name, kind, q.dtype, q.shape[3], v.shape[3])
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")


def forward_kernel(dtype) -> CudaKernel:
    """The forward kernel a CUDA call of ``dtype`` launches: the Hopper
    tensor-core kernel of bf16 or of fp32."""
    return SM90_KERNEL if dtype == torch.bfloat16 else SM90_FP32_KERNEL


def backward_kernels(dtype) -> tuple[CudaKernel, CudaKernel]:
    """The (dq, dk/dv) kernels a CUDA backward of ``dtype`` launches: the
    Hopper tensor-core pair of bf16 or of fp32."""
    if dtype == torch.bfloat16:
        return DQ_SM90_KERNEL, DKV_SM90_KERNEL
    return DQ_SM90_FP32_KERNEL, DKV_SM90_FP32_KERNEL


def _check_grid(name, q) -> None:
    if q.shape[0] > 65535:
        raise ValueError(f"{name}: batch {q.shape[0]} (q {tuple(q.shape)}) "
                         "exceeds the grid's 65535")


def _check_tma(name, *ts):
    """The Hopper kernels read their inputs by TMA, from 16-byte
    boundaries."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: {str(ts[0].dtype)[6:]} inputs must start "
                         "on 16-byte boundaries (the kernel reads them by "
                         "TMA)")


def _resolved(kernel, dtype, names, tiles, B, Sq, Skv, H, K, D, Dv):
    """``tiles`` (named ``names``) as ``resolve_config`` degrades them to
    what the shape can use, checked by ``validate_config``; memoized by
    what decides them."""
    key = (kernel, dtype, D, Dv, flash_heads_a_block(H, K), tiles, Sq <= 64, Skv <= 64)
    got = _RESOLVED.get(key)
    if got is None:
        shape = dict(zip(_DIMS, (B, Sq, Skv, H, K, D, Dv)))
        name = "float32" if dtype == torch.float32 else "bfloat16"
        cfg = resolve_config(kernel, shape, dict(zip(names, tiles)), "cuda", name)
        validate_config(kernel, shape, cfg, "cuda", name)
        got = _RESOLVED[key] = tuple(cfg[n] for n in names)
    return got


def forward_tiles(dtype, B, Sq, Skv, H, K, D, Dv, block_q=None, block_k=None):
    """(block_q, block_k) a CUDA forward of ``dtype`` launches: the ones
    given, else the tuning cache's for this shape, else the dtype's
    untuned tiles; a tile the shape cannot use falls to one it can
    (``resolve_config``).  Raises :class:`KernelConfigError`, naming the
    config, on a malformed tile or one the kernel is not built for."""
    default = _FWD_DEFAULTS[dtype]
    if block_q is None or block_k is None:
        probe = _FP32_TILES_PROBE if dtype == torch.float32 else _TILES_PROBE
        cfg = probe((B, Sq, Skv, H, K, D, Dv), dtype)
        block_q = cfg["block_q"] if block_q is None else block_q
        block_k = cfg["block_k"] if block_k is None else block_k
    if (block_q, block_k) == default:
        return default
    return _resolved("flash_fwd", dtype, ("block_q", "block_k"), (block_q, block_k),
                     B, Sq, Skv, H, K, D, Dv)


def _refused(kernel, tiles, q, v, e):
    """The :class:`KernelConfigError` of a launch the kernel refused."""
    B, Sq, H, D = q.shape
    _, Skv, K, Dv = v.shape
    return KernelConfigError(
        f"{kernel}: tiles {tiles} at (D, Dv) = ({D}, {Dv}), B={B}, Sq={Sq}, Skv={Skv}, "
        f"H={H}, K={K}: {e}")


def _launch_tuned(q, k, v, out, lse, causal, block_q, block_k, stream):
    """The forward at the tiles ``forward_tiles`` resolves; a launch the
    kernel refuses raises :class:`KernelConfigError` naming the tiles."""
    B, Sq, H, D = q.shape
    _, Skv, K, Dv = v.shape
    bq, bk = forward_tiles(q.dtype, B, Sq, Skv, H, K, D, Dv, block_q, block_k)
    try:
        forward_kernel(q.dtype).launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Sq, Skv, H, K, D, Dv, int(causal), bq, bk, stream)
    except RuntimeError as e:  # the kernel refused the tiles
        raise _refused("flash_attention_fwd", {"block_q": bq, "block_k": bk}, q, v, e) from e


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        block_q: int | None = None, block_k: int | None = None):
    """Returns (out (B,Sq,H,Dv) in q's dtype, lse (B,H,Sq) fp32).

    CPU tensors go to the plain version; CUDA tensors to the kernel of
    their dtype (``forward_kernel``), which raises on what it does not
    take, at the tiles ``forward_tiles`` resolves (``block_q``,
    ``block_k``: None reads the tuning cache).  Under vmap the call goes
    through the custom op, whose rule launches once for all the tasks;
    fake CUDA tensors (the dry run) go through it too, checked as the
    kernel checks them, and its fake impl runs."""
    if under_vmap(q, k, v):
        return _fwd_op(q, k, v, causal, block_q, block_k)
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    _check_cuda("flash_attention_fwd", "flash_fwd", q, k, v)
    if is_fake(q, k, v):
        return _fwd_op(q, k, v, causal, block_q, block_k)
    _check_tma("flash_attention_fwd", q, k, v)
    B, Sq, H, D = q.shape
    _, Skv, K, Dv = v.shape
    _check_grid("flash_attention_fwd", q)
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    tuned = block_q is not None or block_k is not None or get_cache() is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tuned:
            _launch_tuned(q, k, v, out, lse, causal, block_q, block_k, stream)
        elif q.dtype == torch.bfloat16:  # no cache, no tiles asked for: the untuned ones
            SM90_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               lse.data_ptr(), B, Sq, Skv, H, K, D, Dv, int(causal),
                               _BQ0, _BK0, stream)
        else:
            SM90_FP32_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    lse.data_ptr(), B, Sq, Skv, H, K, D, Dv, int(causal),
                                    _FQ0, _FK0, stream)
    return out, lse


@torch.library.custom_op(
    "repro_torch::flash_attention_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int? block_q=None, "
           "int? block_k=None) -> (Tensor, Tensor)")
def _fwd_op(q, k, v, causal, block_q=None, block_k=None):
    return flash_attention_fwd(q, k, v, causal=causal, block_q=block_q, block_k=block_k)


@_fwd_op.register_fake
def _(q, k, v, causal, block_q=None, block_k=None):
    _check_grid("flash_attention_fwd", q)
    B, Sq, H, _ = q.shape
    return (q.new_empty((B, Sq, H, v.shape[3])),
            q.new_empty((B, H, Sq), dtype=torch.float32))


def _grid_flops(q, k, v) -> int:
    """2 B H Sq Skv: a product's FLOPs a head-dim column over the full grid."""
    B, Sq, H, _ = q.shape
    return 2 * B * H * Sq * k.shape[1]


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd, get_raw=True)
def _(q, k, v, *args, out_val=None, **kwargs):
    """The plain forward's two products over the full grid, masked keys
    included: 2 B H Sq Skv (D + Dv)."""
    return _grid_flops(q, k, v) * (q.shape[3] + v.shape[3])


@_fwd_op.register_vmap
def _(info, in_dims, q, k, v, causal, block_q=None, block_k=None):
    n = info.batch_size
    q, k, v = fold("flash_attention_fwd", n, ("q", "k", "v"), (q, k, v), in_dims[:3])
    out, lse = flash_attention_fwd(q, k, v, causal=causal, block_q=block_q,
                                   block_k=block_k)
    return (unfold(out, n), unfold(lse, n)), (0, 0)


def flash_attention_bwd_plain(q, k, v, out, lse, g, *, causal: bool = True):
    """The backward recurrence with materialised scores, in fp32: p is
    recomputed from ``lse`` (not taken from autograd of the forward).
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, Sq, H, D = q.shape
    Skv, K, Dv = v.shape[1], k.shape[2], v.shape[3]
    G = H // K
    scale = D ** -0.5
    qg = q.float().reshape(B, Sq, K, G, D)
    gg = g.float().reshape(B, Sq, K, G, Dv)
    kf, vf = k.float(), v.float()
    dvec = (g.float() * out.float()).sum(-1)  # (B,Sq,H)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    if causal:
        kpos = torch.arange(Skv, device=q.device)
        qpos = torch.arange(Sq, device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
    p = torch.exp(s - lse.reshape(B, K, G, Sq)[..., None])
    dp = torch.einsum("bqkgv,bskv->bkgqs", gg, vf)
    dvec = dvec.permute(0, 2, 1).reshape(B, K, G, Sq)[..., None]
    ds = p * (dp - dvec) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(B, Sq, H, D)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    dv = torch.einsum("bkgqs,bqkgv->bskv", p, gg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def backward_tiles(dtype, B, Sq, Skv, H, K, D, Dv, dq_block_q=None, dq_block_k=None,
                   dkv_block_k=None, dkv_block_q=None):
    """(dq_block_q, dq_block_k, dkv_block_k, dkv_block_q) a CUDA backward of
    ``dtype`` launches: the ones given, else the tuning cache's
    ``flash_bwd`` entry for this shape, else the dtype's untuned tiles; a
    tile the shape cannot use falls to one it can (``resolve_config``).
    Raises :class:`KernelConfigError`, naming the config, on a malformed
    tile or one a kernel of the pair is not built for."""
    asked = (dq_block_q, dq_block_k, dkv_block_k, dkv_block_q)
    if None in asked:
        cfg = _BWD_PROBES[dtype]((B, Sq, Skv, H, K, D, Dv), dtype)
        asked = tuple(cfg[n] if t is None else t for n, t in zip(BWD_TILE_NAMES, asked))
    if asked == _BWD_DEFAULTS[dtype]:
        return asked
    return _resolved("flash_bwd", dtype, BWD_TILE_NAMES, asked, B, Sq, Skv, H, K, D, Dv)


def flash_attention_bwd(q, k, v, out, lse, g, *, causal: bool = True,
                        dq_block_q: int | None = None, dq_block_k: int | None = None,
                        dkv_block_k: int | None = None, dkv_block_q: int | None = None):
    """Gradients of ``flash_attention_fwd``'s out, given ``g`` = dL/dout
    and the forward's (out, lse).  Returns (dq, dk, dv) in the dtypes of
    q, k, v.

    CPU tensors go to the plain version (the tiles are not read); CUDA
    tensors to the dq kernel of their dtype (which also writes Dvec) and
    then its dk/dv kernel (``backward_kernels``), on the current stream,
    at the tiles ``backward_tiles`` resolves (None reads the tuning
    cache's ``flash_bwd`` entry); they raise on what the kernels do not
    take.  Under a function transform (a backward under ``torch.func.grad``
    or ``vmap(grad(...))`` meets its saved tensors wrapped) the call goes
    through the custom op, which unwraps them; under vmap its rule
    launches one dq and one dk/dv kernel for all the tasks.  Fake CUDA
    tensors (the dry run) go through the op as well, checked as the kernels
    check them, beside the Dvec scratch the launches allocate."""
    if under_transform(q, k, v, out, lse, g):
        # the kernels' gradients are not differentiated again: the saved
        # tensors still track the grad transform, and the op enters no
        # autograd.Function of its own
        with torch.no_grad():
            return _bwd_op(q, k, v, out, lse, g, causal, dq_block_q, dq_block_k,
                           dkv_block_k, dkv_block_q)
    q, k, v, out, lse, g = (unwrapped(t) for t in (q, k, v, out, lse, g))
    _check(q, k, v, "flash_attention_bwd")
    B, Sq, H, D = q.shape
    _, Skv, K, Dv = v.shape
    if (tuple(out.shape) != (B, Sq, H, Dv) or g.shape != out.shape
            or tuple(lse.shape) != (B, H, Sq)):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, g "
                         f"{tuple(g.shape)}, lse {tuple(lse.shape)} do not fit "
                         f"q {tuple(q.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal)
    _check_cuda("flash_attention_bwd", "flash_bwd", q, k, v, out, g)
    if lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise TypeError("flash_attention_bwd: lse must be contiguous float32 "
                        "on q's device")
    if is_fake(q, k, v, out, lse, g):
        dvec = torch.empty(lse.shape, dtype=torch.float32, device=q.device)  # as dq's launch
        grads = _bwd_op(q, k, v, out, lse, g, causal, dq_block_q, dq_block_k, dkv_block_k,
                        dkv_block_q)
        del dvec
        return grads
    _check_tma("flash_attention_bwd", q, k, v, out, g)
    asked = (dq_block_q, dq_block_k, dkv_block_k, dkv_block_q)
    if asked == (None,) * 4 and get_cache() is None:
        tiles = _BWD_DEFAULTS[q.dtype]  # no cache, no tiles asked for: the untuned ones
    else:
        tiles = backward_tiles(q.dtype, B, Sq, Skv, H, K, D, Dv, *asked)
    dq, dvec = bwd_dq_launch(q, k, v, out, lse, g, causal=causal, block_q=tiles[0],
                             block_k=tiles[1])
    dk, dv = bwd_dkv_launch(q, k, v, g, lse, dvec, causal=causal, block_k=tiles[2],
                            block_q=tiles[3])
    return dq, dk, dv


@torch.library.custom_op(
    "repro_torch::flash_attention_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor g, bool causal, "
           "int? dq_block_q=None, int? dq_block_k=None, int? dkv_block_k=None, "
           "int? dkv_block_q=None) -> (Tensor, Tensor, Tensor)")
def _bwd_op(q, k, v, out, lse, g, causal, dq_block_q=None, dq_block_k=None,
            dkv_block_k=None, dkv_block_q=None):
    return flash_attention_bwd(q, k, v, out, lse, g, causal=causal, dq_block_q=dq_block_q,
                               dq_block_k=dq_block_k, dkv_block_k=dkv_block_k,
                               dkv_block_q=dkv_block_q)


@_bwd_op.register_fake
def _(q, k, v, out, lse, g, causal, *tiles):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd, get_raw=True)
def _(q, k, v, *args, out_val=None, **kwargs):
    """The plain backward's five products over the full grid: s and dq, dk
    over D, dp and dv over Dv, 2 B H Sq Skv (3 D + 2 Dv)."""
    return _grid_flops(q, k, v) * (3 * q.shape[3] + 2 * v.shape[3])


_BWD_INPUTS = ("q", "k", "v", "out", "lse", "g")


@_bwd_op.register_vmap
def _(info, in_dims, q, k, v, out, lse, g, causal, dq_block_q=None, dq_block_k=None,
      dkv_block_k=None, dkv_block_q=None):
    n = info.batch_size
    folded = fold("flash_attention_bwd", n, _BWD_INPUTS, (q, k, v, out, lse, g), in_dims[:6])
    grads = flash_attention_bwd(*folded, causal=causal, dq_block_q=dq_block_q,
                                dq_block_k=dq_block_k, dkv_block_k=dkv_block_k,
                                dkv_block_q=dkv_block_q)
    return tuple(unfold(t, n) for t in grads), (0, 0, 0)


def _bwd_args(q, v, causal):
    B, Sq, H, D = q.shape
    _, Skv, K, Dv = v.shape
    return B, Sq, Skv, H, K, D, Dv, int(causal)


def bwd_dq_launch(q, k, v, out, lse, g, *, causal: bool = True, block_q: int | None = None,
                  block_k: int | None = None):
    """The dq kernel of q's dtype alone, on inputs ``flash_attention_bwd``
    has checked, at ``block_q`` x ``block_k`` (None: the untuned tile):
    returns (dq, Dvec (B,H,Sq) fp32).  A launch the kernel refuses raises
    :class:`KernelConfigError` naming the tiles."""
    default = _BWD_DEFAULTS[q.dtype]
    bq = default[0] if block_q is None else block_q
    bk = default[1] if block_k is None else block_k
    dq = torch.empty_like(q)
    dvec = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        try:
            backward_kernels(q.dtype)[0].launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                g.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
                *_bwd_args(q, v, causal), bq, bk,
                torch.cuda.current_stream(q.device).cuda_stream)
        except RuntimeError as e:
            if (bq, bk) == default[:2]:
                raise
            raise _refused("flash_attention_bwd dq", {"block_q": bq, "block_k": bk}, q, v,
                           e) from e
    return dq, dvec


def bwd_dkv_launch(q, k, v, g, lse, dvec, *, causal: bool = True, block_k: int | None = None,
                   block_q: int | None = None):
    """The dk/dv kernel of q's dtype alone, after ``bwd_dq_launch`` wrote
    ``dvec`` on the same stream, at ``block_k`` keys a block and
    ``block_q`` queries a step (None: the untuned tile): returns (dk,
    dv).  A launch the kernel refuses raises :class:`KernelConfigError`
    naming the tiles."""
    default = _BWD_DEFAULTS[q.dtype]
    bk = default[2] if block_k is None else block_k
    bq = default[3] if block_q is None else block_q
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        try:
            backward_kernels(q.dtype)[1].launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *_bwd_args(q, v, causal), bk, bq,
                torch.cuda.current_stream(q.device).cuda_stream)
        except RuntimeError as e:
            if (bk, bq) == default[2:]:
                raise
            raise _refused("flash_attention_bwd dk/dv", {"block_k": bk, "block_q": bq}, q,
                           v, e) from e
    return dk, dv
