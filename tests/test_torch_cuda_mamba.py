"""The hand-written selective-scan kernel against its plain version, on
the card.

Marked ``cuda``: these need a CUDA device (and ``nvcc``, which builds the
kernel at first use) and skip elsewhere.  Run them on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_mamba.py

Tolerance: the reference's own 1e-4 absolute and relative
(``tests/test_kernels_mamba.py``).  Both sides compute in fp32; the
kernel steps through time one product at a time while the plain version
runs a log-depth scan inside each chunk, so they differ in rounding only.
"""

import sys

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels import mamba_scan as scan_mod
from repro_torch.kernels.mamba_scan import (KERNEL, mamba_scan_fwd,
                                            mamba_scan_plain)

# the module itself: the package's ``mamba_scan`` name is the function
scan_mod_impl = sys.modules["repro_torch.kernels.mamba_scan.mamba_scan"]

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _torch_threads():
    """Two intra-op threads for each test of this file, the previous count
    afterwards (set per test, not at import: every xdist worker imports
    every test file)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


TOL = 1e-4

CASES = [
    # (b, s, d, n, with_h0)
    (4, 512, 8192, 16, False),
    (2, 13, 96, 16, False),
    (2, 64, 32, 4, True),
    (1, 128, 64, 16, True),
    (2, 256, 16, 8, False),
    (3, 1, 40, 3, True),
    (1, 300, 200, 32, True),
    (2, 77, 130, 1, False),
    # the Hopper kernel's edges: one step at full width, a ragged last time
    # tile (16 steps a tile) and channel block (128 channels a block, 64 with
    # two lanes a channel), every state-size class
    (1, 1, 8192, 16, False),
    (4, 77, 8192, 16, True),
    (2, 50, 200, 4, False),
    (2, 33, 130, 32, True),
    (1, 17, 65, 9, True),
    (2, 16, 129, 1, True),
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(b, s, d, n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    x = randn(b, s, d)
    dt = torch.nn.functional.softplus(randn(b, s, d))
    A = -torch.exp(randn(d, n) * 0.5)
    return x, dt, A, randn(b, s, n), randn(b, s, n), randn(b, d, n)


@pytest.mark.parametrize("b,s,d,n,with_h0", CASES)
def test_kernel_matches_plain(device, b, s, d, n, with_h0):
    x, dt, A, B, C, h0 = _inputs(b, s, d, n, device)
    h0 = h0 if with_h0 else None
    before = KERNEL.launches
    y, hf = mamba_scan_fwd(x, dt, A, B, C, h0)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    y0, h0_ref = mamba_scan_plain(x, dt, A, B, C, h0)
    torch.testing.assert_close(y, y0, atol=TOL, rtol=TOL)
    torch.testing.assert_close(hf, h0_ref, atol=TOL, rtol=TOL)


def test_kernel_chains_through_h0(device):
    x, dt, A, B, C, _ = _inputs(2, 130, 96, 16, device, seed=1)
    y, h = mamba_scan_fwd(x, dt, A, B, C)
    y1, h1 = mamba_scan_fwd(x[:, :61], dt[:, :61], A, B[:, :61], C[:, :61])
    y2, h2 = mamba_scan_fwd(x[:, 61:], dt[:, 61:], A, B[:, 61:], C[:, 61:], h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=TOL, rtol=TOL)
    torch.testing.assert_close(h2, h, atol=TOL, rtol=TOL)


def test_kernel_reads_strided_views(device):
    """x, B and C as slices of wider projections (the model's layout)
    give bit-identical results to their contiguous copies."""
    b, s, d, n = 2, 37, 96, 16
    x, dt, A, B, C, h0 = _inputs(b, s, d, n, device, seed=2)
    xz = torch.cat([x, torch.zeros_like(x)], -1)
    proj = torch.cat([torch.zeros(b, s, 5, device=device), B, C], -1)
    xv, Bv, Cv = xz[..., :d], proj[..., 5:5 + n], proj[..., 5 + n:]
    assert not (xv.is_contiguous() or Bv.is_contiguous() or Cv.is_contiguous())
    got = mamba_scan_fwd(xv, dt, A, Bv, Cv, h0)
    ref = mamba_scan_fwd(x, dt, A, B, C, h0)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    # a view whose last axis is strided is copied, not misread
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert xt.stride(-1) != 1
    for a, r in zip(mamba_scan_fwd(xt, dt, A, B, C, h0), ref):
        assert torch.equal(a, r)


def test_kernel_reads_misaligned_views(device):
    """Views whose start or time stride is off a 16-byte boundary (the
    kernel's 16-byte copies need aligned rows): x and dt are copied by the
    wrapper, B and C read 4 bytes at a time; the results equal those of
    contiguous inputs bit for bit.  Rows of a width that is not a multiple
    of 4 floats take the kernel's 4-byte copies."""
    for d in (96, 37):
        b, s, n = 2, 45, 16
        x, dt, A, B, C, h0 = _inputs(b, s, d, n, device, seed=6)
        ref = mamba_scan_fwd(x, dt, A, B, C, h0)

        def shifted(t):
            flat = torch.empty(t.numel() + 1, device=device)
            out = flat[1:].view(t.shape)
            out.copy_(t)
            return out

        def odd_stride(t):
            wide = torch.zeros(*t.shape[:-1], t.shape[-1] + 1, device=device)
            wide[..., 1:] = t
            return wide[..., 1:]

        for make in (shifted, odd_stride):
            views = [make(t) for t in (x, dt, B, C)]
            assert all(v.data_ptr() % 16 for v in views)
            got = mamba_scan_fwd(views[0], views[1], A, views[2], views[3], h0)
            for a, r in zip(got, ref):
                assert torch.equal(a, r), (d, make.__name__)


def test_kernel_is_deterministic(device):
    x, dt, A, B, C, h0 = _inputs(4, 512, 8192, 16, device, seed=7)
    first = mamba_scan_fwd(x, dt, A, B, C, h0)
    again = mamba_scan_fwd(x, dt, A, B, C, h0)
    for a, r in zip(first, again):
        assert torch.equal(a, r)


def test_kernel_takes_bf16_inputs_as_fp32(device):
    x, dt, A, B, C, _ = _inputs(2, 40, 64, 16, device, seed=3)
    xb = x.bfloat16()
    y, h = mamba_scan_fwd(xb, dt, A, B, C)
    y0, h0 = mamba_scan_plain(xb.float(), dt, A, B, C)
    assert y.dtype == h.dtype == torch.float32
    torch.testing.assert_close(y, y0, atol=TOL, rtol=TOL)
    torch.testing.assert_close(h, h0, atol=TOL, rtol=TOL)


def test_training_scan_launches_the_kernel_and_grads_match_plain(device):
    x, dt, A, B, C, h0 = _inputs(2, 96, 64, 16, device, seed=4)
    leaves = [t.requires_grad_() for t in (x, dt, A, B, C, h0)]
    before = KERNEL.launches
    y, h = kernels.DISPATCH.scan(*leaves)
    assert KERNEL.launches == before + 1
    g_k = torch.autograd.grad(y.sum() + h.square().sum(), leaves)
    assert KERNEL.launches == before + 1  # the backward launches no kernel
    y_p, h_p = kernels.PLAIN.scan(*leaves)
    g_p = torch.autograd.grad(y_p.sum() + h_p.square().sum(), leaves)
    for a, r in zip(g_k, g_p):
        torch.testing.assert_close(a, r, atol=1e-3, rtol=1e-3)


def test_scan_raises_when_the_kernel_cannot_be_built(device, tmp_path,
                                                     monkeypatch):
    """No fallback: with no library built and no compiler, a scan on CUDA
    tensors raises instead of running the plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    fresh = build.CudaKernel(KERNEL.source.name, KERNEL.symbol, KERNEL.argtypes)
    monkeypatch.setattr(scan_mod_impl, "KERNEL", fresh)
    x, dt, A, B, C, _ = _inputs(1, 8, 32, 16, device, seed=5)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.DISPATCH.scan(x, dt, A, B, C)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        scan_mod.mamba_scan_fwd(x, dt, A, B, C)
    assert fresh.launches == 0
