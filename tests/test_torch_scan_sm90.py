"""The arithmetic of the Hopper selective-scan kernel
(``csrc/mamba_scan_sm90.cu``), modelled on the CPU, against the JAX
package's Pallas scan (interpret mode) and the port's plain chunked scan;
the cost of its approximate exponential; and the wrapper's row alignment.

The model does what one thread of the kernel does for its channel (one
lane a channel, G = 1): A pre-scaled by log2(e) in fp32, then step by step
e = 2^(dt * A log2 e), flushed to 0 below 2^-126 as ``ex2.approx.ftz``
does, h = h e + (dt x) B and y = sum_n C h, all in fp32.

Tolerance: the reference suite's own, 1e-4 absolute and relative
(tests/test_kernels_mamba.py); against the plain version chip_smoke.py's
element check |got - ref| <= 1e-4 + 1e-4 |ref|.  ``ex2.approx.f32`` is
within about 2^-22 of 2^x (relative); the model with every exponential
off by 2^-21, in a fixed sign and in a random one, still holds 1e-4 at
s = 512 with softplus dt.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.mamba_scan import mamba_scan_pallas
from repro_torch.kernels.mamba_scan import mamba_scan_plain

scan_impl = sys.modules["repro_torch.kernels.mamba_scan.mamba_scan"]


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, as in the other
    tight-tolerance port tests; the previous count afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-4
LOG2E = torch.tensor(np.log2(np.e), dtype=torch.float32)
FTZ = 2.0 ** -126


def scan_model(x, dt, A, B, C, h0=None, *, exp_error=None):
    """One thread's arithmetic for every (b, channel): fp32 tensors x, dt
    (b,s,d), A (d,n), B, C (b,s,n), h0 (b,d,n) or None -> (y, h_final).
    ``exp_error`` (s, b, d, n) multiplies each exponential by 1 + it."""
    b, s, d = x.shape
    a2 = A * LOG2E
    h = torch.zeros((b, d, A.shape[1])) if h0 is None else h0.clone()
    ys = []
    for t in range(s):
        e = torch.exp2(dt[:, t, :, None] * a2)
        e = torch.where(e < FTZ, torch.zeros_like(e), e)
        if exp_error is not None:
            e = e * (1 + exp_error[t])
        h = h * e + (dt[:, t] * x[:, t])[..., None] * B[:, t, None, :]
        ys.append((C[:, t, None, :] * h).sum(-1))
    return torch.stack(ys, 1), h


def _inputs(b, s, d, n, seed, with_h0=False):
    """x, dt, A, B, C (and h0) as the reference's scan tests draw them: dt =
    softplus(normal), A = -exp(0.5 normal)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((b, s, d), np.float32),
              np.logaddexp(rng.standard_normal((b, s, d)), 0).astype(np.float32),
              -np.exp(rng.standard_normal((d, n)) * 0.5).astype(np.float32),
              rng.standard_normal((b, s, n), np.float32),
              rng.standard_normal((b, s, n), np.float32)]
    arrays.append(rng.standard_normal((b, d, n), np.float32) if with_h0 else None)
    return arrays


def _pallas(arrays):
    *args, h0 = arrays
    y, h = mamba_scan_pallas(*map(jnp.asarray, args),
                             None if h0 is None else jnp.asarray(h0), interpret=True)
    return np.asarray(y), np.asarray(h)


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


CASES = [
    # (b, s, d, n, with_h0)
    (2, 64, 32, 4, False),
    (1, 128, 64, 16, True),
    (2, 13, 96, 16, False),  # chip_smoke's ragged case
    (1, 40, 24, 32, True),  # two lanes a channel in the kernel
    (3, 1, 8, 3, True),  # one step; n not a multiple of 4
    (1, 37, 20, 1, False),
]


@pytest.mark.parametrize("b,s,d,n,with_h0", CASES)
def test_model_matches_the_pallas_kernel(b, s, d, n, with_h0):
    arrays = _inputs(b, s, d, n, 0, with_h0)
    y, h = scan_model(*_torch(arrays))
    y_ref, h_ref = _pallas(arrays)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(h.numpy(), h_ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,s,d,n,with_h0", CASES)
def test_model_holds_chip_smokes_check_against_the_plain_version(b, s, d, n, with_h0):
    args = _torch(_inputs(b, s, d, n, 1, with_h0))
    for got, ref in zip(scan_model(*args), mamba_scan_plain(*args)):
        worst = ((got - ref).abs() / (TOL + TOL * ref.abs())).max().item()
        assert worst <= 1.0, f"largest |err| / limit {worst:.3f}"


@pytest.fixture(scope="module")
def long_scan():
    """s = 512 with softplus dt (the serve prompt's length), and the
    Pallas kernel's outputs on it."""
    arrays = _inputs(1, 512, 32, 16, 2, True)
    return arrays, _pallas(arrays)


@pytest.mark.parametrize("sign", ["plus", "minus", "random"])
def test_an_exponential_off_by_2_to_the_minus_21_keeps_the_tolerance(long_scan, sign):
    arrays, (y_ref, h_ref) = long_scan
    args = _torch(arrays)
    shape = (512, 1, 32, 16)
    if sign == "random":
        signs = torch.from_numpy(np.random.default_rng(3).choice([-1.0, 1.0], shape)
                                 .astype(np.float32))
    else:
        signs = torch.full(shape, 1.0 if sign == "plus" else -1.0)
    y, h = scan_model(*args, exp_error=signs * 2.0 ** -21)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(h.numpy(), h_ref, atol=TOL, rtol=TOL)
    # the error it makes alone (0.11 of the check in a fixed sign) leaves
    # room for the kernel's other roundings
    y_exact, _ = scan_model(*args)
    worst = ((y - y_exact).abs() / (TOL + TOL * y_exact.abs())).max().item()
    assert worst < 0.25, worst


def test_rows_keeps_aligned_views_and_copies_misaligned_ones():
    rows = scan_impl._rows
    b, s, d = 2, 5, 8
    wide = torch.randn(b, s, 2 * d)
    view = wide[..., :d]  # the model's layout: aligned start, time stride 2d
    assert rows(view, align=True).data_ptr() == view.data_ptr()
    flat = torch.randn(b * s * d + 1)
    shifted = flat[1:].view(b, s, d)  # contiguous, 4 bytes past a boundary
    assert shifted.data_ptr() % 16
    got = rows(shifted, align=True)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got, shifted)
    odd = torch.randn(b, s, d + 1)[..., 1:]  # time stride d + 1 floats
    got = rows(odd, align=True)
    assert got.is_contiguous() and torch.equal(got, odd)
    # B and C are small: the kernel reads a misaligned view of them 4 bytes
    # at a time, and the wrapper does not copy it
    assert rows(shifted).data_ptr() == shifted.data_ptr()
    # rows whose width is not a multiple of 4 floats cannot be aligned
    ragged = torch.randn(b, s, 7)
    assert rows(ragged, align=True).data_ptr() == ragged.data_ptr()
    # a strided last axis is always copied
    t = torch.randn(b, d, s).transpose(1, 2)
    assert rows(t).is_contiguous() and torch.equal(rows(t), t)
