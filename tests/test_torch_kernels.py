"""The port's plain attention versions against the JAX package's Pallas
kernels (interpret mode): flash prefill (out and lse) and flash decode.

Inputs are drawn with numpy and handed to both packages; bf16 cases round
the same fp32 draws to bf16 on both sides.  Tolerances: flash 2e-5 (fp32)
/ 2e-2 (bf16), decode 2e-5 / 3e-2 — the reference suites' own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import \
    decode_attention_fwd as jax_decode
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_fwd as jax_flash
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards (set per test, not at import: every xdist worker imports
    every test file).  On the CPUs these tests run on, torch's second
    thread has been seen under load to compute exp on its half of a
    tensor with errors far above an ulp, which breaks the tight
    tolerances here at random; with one thread it has not."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


F32, BF16 = "float32", "bfloat16"
_JNP = {F32: jnp.float32, BF16: jnp.bfloat16}
_TORCH = {F32: torch.float32, BF16: torch.bfloat16}

FLASH_CASES = [
    # (B, Sq, Skv, H, K, D, causal, dtype): the reference sweep ...
    (2, 128, 128, 4, 2, 64, True, F32),
    (1, 256, 256, 8, 8, 32, True, BF16),
    (2, 128, 256, 4, 1, 64, False, F32),
    (1, 512, 512, 2, 2, 128, True, F32),
    # ... ragged lengths (the reduced serve budget is 16 + 8 = 24) ...
    (2, 13, 13, 4, 2, 16, True, F32),
    (2, 24, 24, 4, 2, 32, True, BF16),
    # ... and causal Sq != Skv: the top-left mask k_pos <= q_pos
    (1, 64, 128, 4, 2, 32, True, F32),
]

DECODE_CASES = [
    # (B, S, H, K, D, cache_index, dtype): the reference sweep + ragged S
    (2, 128, 4, 2, 64, 100, F32),
    (1, 512, 8, 8, 32, 511, F32),
    (2, 256, 4, 1, 64, 7, F32),
    (1, 256, 8, 2, 128, 200, BF16),
    (2, 24, 4, 2, 16, 13, F32),
]


def _tol(dtype, bf16_tol):
    return bf16_tol if dtype == BF16 else 2e-5


def _pair(x, dtype):
    return jnp.asarray(x, _JNP[dtype]), torch.from_numpy(x).to(_TORCH[dtype])


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas(case):
    B, Sq, Skv, H, K, D, causal, dtype = case
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng.standard_normal((B, Sq, H, D), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, Skv, K, D), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, Skv, K, D), np.float32), dtype)
    out_j, lse_j = jax_flash(qj, kj, vj, causal=causal, interpret=True,
                             return_lse=True)
    out_t, lse_t = flash_attention_fwd(qt, kt, vt, causal=causal)
    assert out_t.dtype == _TORCH[dtype] and lse_t.dtype == torch.float32
    assert tuple(lse_t.shape) == (B, H, Sq)
    tol = _tol(dtype, 2e-2)
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_pallas(case):
    B, S, H, K, D, ci, dtype = case
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng.standard_normal((B, 1, H, D), np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, K, D), np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, K, D), np.float32), dtype)
    out_j = jax_decode(qj, kj, vj, cache_index=ci, interpret=True)
    out_t = decode_attention_fwd(qt, kt, vt, cache_index=ci)
    assert out_t.dtype == _TORCH[dtype]
    tol = _tol(dtype, 3e-2)
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), atol=tol, rtol=tol)


def test_decode_ignores_garbage_past_cache_index():
    """Entries past cache_index must not affect the output (999 garbage)."""
    B, S, H, K, D, ci = 1, 128, 2, 2, 32, 50
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, 1, H, D), np.float32)
    kc = rng.standard_normal((B, S, K, D), np.float32)
    vc = rng.standard_normal((B, S, K, D), np.float32)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[:, ci + 1:] = 999.0
    vc2[:, ci + 1:] = -999.0
    clean = decode_attention_fwd(*map(torch.from_numpy, (q, kc, vc)),
                                 cache_index=ci)
    dirty = decode_attention_fwd(*map(torch.from_numpy, (q, kc2, vc2)),
                                 cache_index=ci)
    np.testing.assert_allclose(dirty.numpy(), clean.numpy(), atol=1e-6)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(kc2), jnp.asarray(vc2),
                     cache_index=ci, interpret=True)
    np.testing.assert_allclose(dirty.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_wrappers_validate_inputs():
    q = torch.zeros(1, 4, 4, 32)
    kv = torch.zeros(1, 4, 3, 32)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_fwd(q, kv, kv)
    with pytest.raises(ValueError, match="cache_index"):
        decode_attention_fwd(torch.zeros(1, 1, 4, 32), torch.zeros(1, 8, 2, 32),
                             torch.zeros(1, 8, 2, 32), cache_index=8)


def test_cpu_calls_never_build_or_count_a_kernel():
    """The kernel modules import without nvcc and CPU tensors take the
    plain version: no library is loaded and no launch is counted."""
    for kernel in (flash_attention.SM90_FP32_KERNEL, decode_attention.KERNEL):
        before = kernel.launches
        if kernel is flash_attention.SM90_FP32_KERNEL:
            flash_attention_fwd(torch.ones(1, 3, 2, 32), torch.ones(1, 3, 2, 32),
                                torch.ones(1, 3, 2, 32))
        else:
            decode_attention_fwd(torch.ones(1, 1, 2, 32), torch.ones(1, 3, 2, 32),
                                 torch.ones(1, 3, 2, 32), cache_index=1)
        assert kernel.launches == before
        assert kernel._fn is None
        assert kernel.library_path().name.startswith(kernel.name + "-")


def test_kernels_build_inside_the_checkout():
    """Run from a source checkout, the libraries go to its ``build/``."""
    from pathlib import Path

    from repro_torch.kernels import build

    root = Path(__file__).resolve().parents[1]
    assert build.BUILD_DIR == root / "build" / "repro_torch_kernels"


def test_each_test_here_runs_on_one_intra_op_thread():
    """The file's fixture sets one thread for each of its tests, whatever a
    test of another file set before it in the same worker (a count set at
    import held only for the file imported last)."""
    assert torch.get_num_threads() == 1


if __name__ == "__main__":
    # The reproduction of the suspect that the thread pins answer: case 0 of
    # FLASH_CASES through the plain version at THREADS intra-op threads,
    # RUNS times, each run held bit for bit to one thread (out, lse and a
    # 2^20-element torch.exp) and to the Pallas kernel at 2e-5.  Run several
    # at once for load:  python tests/test_torch_kernels.py RUNS THREADS
    import sys

    runs, threads = int(sys.argv[1]), int(sys.argv[2])
    B, Sq, Skv, H, K, D, causal, _ = FLASH_CASES[0]
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s, np.float32)
               for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D)))
    out_j, lse_j = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, interpret=True, return_lse=True)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    grid = torch.linspace(-30.0, 5.0, 1 << 20)
    torch.set_num_threads(1)
    one = flash_attention_fwd(qt, kt, vt, causal=causal) + (torch.exp(grid),)
    torch.set_num_threads(threads)
    differ = beyond = 0
    for _ in range(runs):
        got = flash_attention_fwd(qt, kt, vt, causal=causal) + (torch.exp(grid),)
        differ += not all(torch.equal(a, b) for a, b in zip(got, one))
        beyond += not (np.allclose(got[0].numpy(), np.asarray(out_j), atol=2e-5, rtol=2e-5)
                       and np.allclose(got[1].numpy(), np.asarray(lse_j), atol=2e-5,
                                       rtol=2e-5))
    print(f"torch {torch.__version__}, {threads} threads, {runs} runs: {differ} differ "
          f"from one thread, {beyond} beyond 2e-5 of the Pallas kernel")


@pytest.mark.parametrize("kernel, dtype, D, Dv, takes", [
    # the bf16 forward: D == Dv in {32, 64, 96, 128}, and MLA's (96, 64)
    ("flash_fwd", torch.bfloat16, 96, 64, True),
    ("flash_fwd", torch.bfloat16, 96, 96, True),
    ("flash_fwd", torch.bfloat16, 128, 128, True),
    ("flash_fwd", torch.bfloat16, 64, 96, False),
    ("flash_fwd", torch.bfloat16, 128, 64, False),
    ("flash_fwd", torch.bfloat16, 80, 80, False),
    # the fp32 forward and the fp32 backward pair: the bf16 kernels' pairs,
    # phi-3's (96, 96) and MLA's (96, 64) included
    ("flash_fwd", torch.float32, 64, 64, True),
    ("flash_fwd", torch.float32, 96, 96, True),
    ("flash_fwd", torch.float32, 96, 64, True),
    ("flash_bwd", torch.bfloat16, 128, 128, True),
    ("flash_bwd", torch.float32, 96, 96, True),
    ("flash_bwd", torch.float32, 96, 64, True),
    ("flash_bwd", torch.float16, 96, 96, False),
    # decode: D == Dv in {32, 64, 96, 128}, both dtypes
    ("decode", torch.bfloat16, 96, 96, True),
    ("decode", torch.float32, 96, 96, True),
    ("decode", torch.float32, 32, 32, True),
    ("decode", torch.bfloat16, 96, 64, False),
    ("decode", torch.float16, 64, 64, False),
    # the bf16 backward pair: the bf16 forward's pairs, MLA's (96, 64) too
    ("flash_bwd", torch.bfloat16, 96, 96, True),
    ("flash_bwd", torch.bfloat16, 96, 64, True),
    ("flash_bwd", torch.bfloat16, 32, 32, True),
    ("flash_bwd", torch.bfloat16, 64, 96, False),
    ("flash_bwd", torch.bfloat16, 80, 80, False),
    ("flash_bwd", torch.float32, 128, 128, True),
    ("flash_bwd", torch.float32, 64, 64, True),
    # still refused on CUDA, in both dtypes: (96, 32), and D = 16 (the
    # reduced test configs' head dim, which runs on the CPU's plain versions)
    ("flash_fwd", torch.float32, 96, 32, False),
    ("flash_bwd", torch.float32, 96, 32, False),
    ("flash_fwd", torch.bfloat16, 96, 32, False),
    ("flash_fwd", torch.float32, 16, 16, False),
    ("flash_bwd", torch.float32, 16, 16, False),
    ("flash_fwd", torch.bfloat16, 16, 16, False),
    ("flash_bwd", torch.bfloat16, 16, 16, False),
    ("flash_fwd", torch.float32, 32, 32, True),
    ("flash_bwd", torch.float32, 32, 32, True),
])
def test_head_dim_rule_of_each_kernel(kernel, dtype, D, Dv, takes):
    from repro_torch.kernels import head_dims

    assert head_dims.takes(kernel, dtype, D, Dv) is takes
    if takes:
        head_dims.check("k", kernel, dtype, D, Dv)
    else:
        with pytest.raises(ValueError, match=f"D={D}, Dv={Dv}"):
            head_dims.check("k", kernel, dtype, D, Dv)


def test_cpu_tensors_take_any_head_dims():
    """The plain versions take any D and Dv: MLA's (96, 64) on the CPU
    never reaches the rule (and launches nothing)."""
    rng = np.random.default_rng(9)
    q, k = (torch.from_numpy(rng.standard_normal((1, 5, 2, 96), np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((1, 5, 2, 64), np.float32))
    before = flash_attention.SM90_FP32_KERNEL.launches
    out, _ = flash_attention_fwd(q, k, v, causal=True)
    assert tuple(out.shape) == (1, 5, 2, 64)
    assert flash_attention.SM90_FP32_KERNEL.launches == before
