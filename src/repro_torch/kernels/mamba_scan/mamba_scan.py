"""Mamba-1 selective scan: the CUDA kernel's wrapper and its plain
versions.

``mamba_scan_fwd`` launches ``csrc/mamba_scan_sm90.cu`` for CUDA tensors
and runs ``mamba_scan_plain`` for CPU tensors.  Both compute the reference
package's Pallas ``mamba_scan_pallas``: per batch b, channel d and state n,

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t
    y_t = sum_n C_t[n] * h_t[n]

from ``h0`` (zeros when it is None), everything in fp32, returning
``(y (b,s,d), h_final (b,d,n))``.

``mamba_scan_plain`` mirrors the reference's chunked oracle
(``mamba_scan_ref``): an outer loop over sequence chunks carries h, and
inside a chunk the linear recurrence is an associative scan of
``(exp(dt A), dt x B)`` pairs, with the reference's odd/even recursion
and combine, so the products come in the same order.  It never forms the
closed form ``exp(cumsum(dt A))``, whose inverse overflows once a chunk's
``sum dt A`` passes about -88.  ``mamba_scan_naive`` is the step-by-step
recurrence, for the tests.

Both read the tuning cache (``repro_torch.tune``) when the caller names
no value: the kernel's lanes a channel (``lanes``: kernel ``mamba``,
backend ``"cuda"``; 0, the kernel's own rule, without a cache or on a
miss) and the plain scan's ``chunk`` (kernel ``mamba``, backend
``"torch"``; 256 without one).  The card runs the plain scan in the
scan's backward (``ops.py``), so that is where its chunk counts there.
A folded call of ``Service.execute_batch`` reads the cache at its folded
batch.
"""

from __future__ import annotations

import ctypes

import torch

from ...tune.cache import ConfigProbe, get_cache
from ...tune.space import KernelConfigError, default_config
from ..build import CudaKernel

MAX_STATE = 32  # the kernel's limit on n: 2 lanes of 16 states a channel

_p, _i, _l = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel(
    "mamba_scan_sm90.cu", "repro_mamba_scan_fwd",
    [_p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
     _l, _l, _l, _l, _l, _l, _l, _l, _i, _p])
DEFAULT_LANES = default_config("mamba", "cuda")  # {"lanes": 0}: the kernel's rule
DEFAULT_CHUNK = default_config("mamba", "torch")  # {"chunk": 256}
_LANES_PROBE = ConfigProbe("mamba", ("b", "s", "d", "n"), "cuda", DEFAULT_LANES)
_CHUNK_PROBE = ConfigProbe("mamba", ("b", "s", "d", "n"), "torch", DEFAULT_CHUNK)


def _chunk_size(seq: int, target: int = 256) -> int:
    """Largest divisor of ``seq`` that is <= target."""
    c = min(seq, target)
    while seq % c:
        c -= 1
    return c


def _combine(left, right):
    aL, bL = left
    aR, bR = right
    return aL * aR, bL * aR + bR


def _slice(t, dim, start, stop=None, step=1):
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(even, odd, dim):
    """even[0], odd[0], even[1], ... along ``dim``; ``even`` may hold one
    more element than ``odd``."""
    n = odd.shape[dim]
    out = torch.stack([_slice(even, dim, 0, n), odd], dim + 1).flatten(dim, dim + 1)
    if even.shape[dim] > n:
        out = torch.cat([out, _slice(even, dim, n)], dim)
    return out


def associative_scan(a, b, dim):
    """Inclusive scan of the pairs (a, b) along ``dim`` under
    ``(aL, bL) . (aR, bR) = (aL aR, bL aR + bR)``: the odd/even recursion
    of ``jax.lax.associative_scan``, log depth."""
    n = a.shape[dim]
    if n < 2:
        return a, b
    odd = associative_scan(*_combine(
        (_slice(a, dim, 0, -1, 2), _slice(b, dim, 0, -1, 2)),
        (_slice(a, dim, 1, None, 2), _slice(b, dim, 1, None, 2))), dim)
    right = (_slice(a, dim, 2, None, 2), _slice(b, dim, 2, None, 2))
    if n % 2 == 0:
        even = _combine(tuple(_slice(t, dim, 0, -1) for t in odd), right)
    else:
        even = _combine(odd, right)
    even = tuple(torch.cat([_slice(t, dim, 0, 1), e], dim)
                 for t, e in zip((a, b), even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def mamba_scan_plain(x, dt, A, B, C, h0=None, *, chunk: int | None = None):
    """The chunked scan.  x, dt (b,s,d); A (d,n); B, C (b,s,n); h0 (b,d,n)
    or None.  ``chunk`` (None: the tuning cache's, else 256) falls to the
    largest divisor of s at most that size.  Returns (y (b,s,d), h_final
    (b,d,n)), fp32; differentiable."""
    b, s, d = x.shape
    n = A.shape[-1]
    if chunk is None:
        chunk = _CHUNK_PROBE((b, s, d, n), x.dtype)["chunk"]
    if isinstance(chunk, bool) or not isinstance(chunk, int) or chunk <= 0:
        raise KernelConfigError(f"mamba_scan_plain: chunk must be a positive int, "
                                f"got {chunk!r}")
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    c = _chunk_size(s, chunk)
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t0 in range(0, s, c):
        xc, dtc = x[:, t0:t0 + c], dt[:, t0:t0 + c]
        Bc, Cc = B[:, t0:t0 + c], C[:, t0:t0 + c]
        dA = torch.exp(dtc[..., None] * A)  # (b,c,d,n)
        dBx = (dtc * xc)[..., None] * Bc[:, :, None, :]
        accA, accB = associative_scan(dA, dBx, 1)
        h_all = accA * h[:, None] + accB  # (b,c,d,n)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, Cc))
        h = h_all[:, -1].clone()  # not a view that keeps h_all alive
    return torch.cat(ys, 1), h


def mamba_scan_naive(x, dt, A, B, C, h0=None):
    """The recurrence one step at a time (slow; for the tests)."""
    b, s, d = x.shape
    n = A.shape[-1]
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t, :, None] * A)
        h = h * dA + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return torch.stack(ys, 1), h


def _check(x, dt, A, B, C, h0):
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"mamba_scan_fwd: x must be (b,s,d) and A (d,n), got "
                         f"{tuple(x.shape)}, {tuple(A.shape)}")
    b, s, d = x.shape
    n = A.shape[1]
    want = {"dt": (dt, (b, s, d)), "A": (A, (d, n)), "B": (B, (b, s, n)),
            "C": (C, (b, s, n))}
    if h0 is not None:
        want["h0"] = (h0, (b, d, n))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"mamba_scan_fwd: {name} is {tuple(t.shape)}, "
                             f"expected {shape} from x {tuple(x.shape)}, "
                             f"A {tuple(A.shape)}")
    if s == 0 or d == 0 or n == 0 or b == 0:
        raise ValueError(f"mamba_scan_fwd: empty input, x {tuple(x.shape)}, "
                         f"A {tuple(A.shape)}")


def _rows(t, *, align=False):
    """``t`` as fp32 with unit stride along its last axis (a view where it
    has one already: the kernel takes the batch and time strides as
    given).  With ``align``, a view whose start or batch or time stride is
    off a 16-byte boundary is copied too, where the copy's rows are 16-byte
    aligned (a row width that is a multiple of 4 floats): the kernel copies
    such rows 16 bytes at a time, other rows 4 bytes at a time."""
    t = t.float()
    if t.stride(-1) != 1:
        return t.contiguous()
    if align and t.shape[-1] % 4 == 0 and (
            t.data_ptr() % 16 or any(st % 4 for st in t.stride()[:-1])):
        return t.clone(memory_format=torch.contiguous_format)  # a fresh, aligned block
    return t


def scan_lanes(dtype, b, s, d, n, lanes=None) -> int:
    """The lanes a channel a CUDA call launches: ``lanes`` when given, else
    the tuning cache's for this shape, else 0 (the kernel's ``geometry``).
    Raises :class:`KernelConfigError`, naming it, on a count the kernel
    does not take at state size ``n`` (1, 2 or 4 at n <= 16; 2 at
    n <= 32)."""
    if lanes is None:
        lanes = _LANES_PROBE((b, s, d, n), dtype)["lanes"]
    if lanes == 0 and not isinstance(lanes, bool):
        return 0
    allowed = (1, 2, 4) if n <= 16 else (2,)
    if isinstance(lanes, bool) or lanes not in allowed:
        raise KernelConfigError(f"mamba_scan_fwd: lanes={lanes!r} at state size {n}; "
                                f"the kernel takes {allowed} (or 0 for its own)")
    return lanes


def mamba_scan_fwd(x, dt, A, B, C, h0=None, *, lanes: int | None = None):
    """Returns (y (b,s,d), h_final (b,d,n)), fp32; inputs are cast to fp32
    as the reference's entry does.

    CPU tensors go to the plain version; CUDA tensors to the kernel,
    which raises on what it does not take, at the lanes a channel
    ``scan_lanes`` resolves (None reads the tuning cache).  x, dt, B and C
    may be strided views (slices of wider projections): the kernel reads
    them through their batch and time strides."""
    _check(x, dt, A, B, C, h0)
    if x.device.type == "cpu":
        return mamba_scan_plain(x, dt, A, B, C, h0)
    tensors = (x, dt, A, B, C) + (() if h0 is None else (h0,))
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"mamba_scan_fwd: inputs on "
                         f"{sorted({str(t.device) for t in tensors})}; need one "
                         f"CUDA device")
    b, s, d = x.shape
    n = A.shape[1]
    if n > MAX_STATE:
        raise ValueError(f"mamba_scan_fwd: state size {n}; the kernel takes "
                         f"at most {MAX_STATE}")
    if b > 65535:
        raise ValueError(f"mamba_scan_fwd: batch {b} exceeds the grid's 65535")
    if lanes is not None or get_cache() is not None:
        lanes = scan_lanes(x.dtype, b, s, d, n, lanes)
    else:
        lanes = 0  # no cache, no count asked for: the kernel's own (geometry)
    x, dt = (_rows(t, align=True) for t in (x, dt))
    B, C = _rows(B), _rows(C)
    A = A.float().contiguous()
    h0 = None if h0 is None else h0.float().contiguous()
    y = torch.empty((b, s, d), dtype=torch.float32, device=x.device)
    hf = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), hf.data_ptr(), b, s, d, n,
            x.stride(0), x.stride(1), dt.stride(0), dt.stride(1), B.stride(0), B.stride(1),
            C.stride(0), C.stride(1), lanes)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if lanes == 0:
            KERNEL.launch(*args, stream)
        else:
            try:
                KERNEL.launch(*args, stream)
            except RuntimeError as e:  # the kernel refused the tuned lanes
                raise KernelConfigError(f"mamba_scan_fwd: lanes={lanes} at ({b}, {s}, "
                                        f"{d}, {n}): {e}") from e
    return y, hf
