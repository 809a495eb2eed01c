"""The chunked flash attention with its manual backward
(``repro_torch.kernels.flash_attention.chunked``) against the JAX
package's ``flash_attention_xla`` (``repro/kernels/flash_attention/xla.py``).

The forward within 2e-5 and ``jax.vjp``'s gradients within 1e-3, in fp32:
causal, non-causal and windowed; G = 1, 2 and 5; Sq != Skv; a prime
length (chunks of one position, as the reference's ``_pick_chunk``
gives); chunks smaller than the lengths.  ``torch.autograd.gradcheck`` in
float64 at a tiny size.  A ``saved_tensors_hooks`` count: the forward
saves q, k, v, out and lse and nothing else.  The forward is
``chunked_attention``'s arithmetic bit for bit where the chunks agree.
The windowed training path: the dispatch's differentiable windowed call
runs the chunked flash, and reduced jamba's ``train_loss(long_context=True)``
gradients stay within 1e-3 of ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro.kernels.flash_attention.xla import flash_attention_xla
from repro.models import build as jbuild
from repro_torch import kernels
from repro_torch.interop import params_from_jax
from repro_torch.kernels.flash_attention import chunked
from repro_torch.kernels.flash_attention.chunked import flash_attention_chunked
from repro_torch.models import build as tbuild
from repro_torch.models.attention import chunked_attention

FWD_TOL, GRAD_TOL, LOSS_TOL = 2e-5, 1e-3, 2e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (B, Sq, Skv, H, K, D, Dv, causal, window, q_chunk, kv_chunk)
CASES = {
    "causal G=1": (2, 32, 32, 3, 3, 8, 8, True, None, 8, 16),
    "causal G=2": (2, 40, 40, 4, 2, 16, 16, True, None, 16, 8),
    "causal G=5": (1, 24, 24, 10, 2, 8, 8, True, None, 512, 1024),
    "non-causal G=2": (2, 24, 24, 4, 2, 8, 8, False, None, 8, 8),
    "windowed G=2": (1, 48, 48, 4, 2, 8, 8, True, 7, 16, 16),
    "windowed non-causal G=5": (1, 32, 32, 5, 1, 8, 8, False, 9, 8, 32),
    "Sq != Skv causal": (2, 12, 36, 4, 2, 8, 8, True, None, 4, 12),
    "Sq != Skv non-causal": (1, 20, 8, 6, 3, 8, 16, False, None, 8, 8),
    "prime length": (1, 13, 13, 4, 2, 8, 8, True, None, 4, 8),
    "prime length windowed": (1, 17, 17, 2, 1, 8, 8, True, 5, 512, 1024),
}


def _inputs(B, Sq, Skv, H, K, D, Dv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, Dv), (B, Sq, H, Dv))]


@pytest.mark.parametrize("case", CASES)
def test_forward_and_gradients_match_flash_attention_xla(case):
    B, Sq, Skv, H, K, D, Dv, causal, window, qc, kc = CASES[case]
    q, k, v, g = _inputs(B, Sq, Skv, H, K, D, Dv)
    out_j, vjp = jax.vjp(lambda a, b, c: flash_attention_xla(a, b, c, causal, window, qc, kc),
                         *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention_chunked(*leaves, causal, window, qc, kc)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=FWD_TOL,
                               rtol=FWD_TOL, err_msg=f"{case} out")
    for name, t, want in zip(("dq", "dk", "dv"), leaves, grads_j):
        assert t.grad.dtype == torch.float32 and t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"{case} {name}")


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 3)])
def test_gradcheck_in_float64(causal, window):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((1, 5, 4, 3), (1, 5, 2, 3), (1, 5, 2, 3)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_attention_chunked(a, b, c, causal, window, 2, 3),
        (q, k, v), eps=1e-6, atol=1e-6)


def test_saves_only_q_k_v_out_and_lse():
    B, Sq, Skv, H, K, D, Dv = 1, 16, 16, 4, 2, 8, 8
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(B, Sq, Skv, H, K, D, Dv))
    for t in (q, k, v):
        t.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                  lambda t: t):
        out = flash_attention_chunked(q, k, v, True, 6, 4, 8)
    shapes = sorted(tuple(t.shape) for t in saved)
    assert len(saved) == 5, shapes
    assert shapes == sorted([tuple(q.shape), tuple(k.shape), tuple(v.shape),
                             tuple(out.shape), (B, K, H // K, Sq)])
    assert sum(t is q for t in saved) == sum(t is k for t in saved) == 1
    # autograd through chunked_attention keeps a chunk pair's scores and
    # probabilities: many more tensors
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                  lambda t: t):
        chunked_attention(q, k, v, causal=True, window=6, q_chunk=4, kv_chunk=8)
    assert len(saved) > 5 * 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_is_chunked_attentions_bit_for_bit(dtype):
    q, k, v, _ = (torch.from_numpy(a).to(dtype) for a in _inputs(2, 32, 32, 4, 2, 8, 8))
    for window, qc, kc in ((None, 8, 16), (5, 16, 8), (9, 512, 1024)):
        got = flash_attention_chunked(q, k, v, True, window, qc, kc)
        want = chunked_attention(q, k, v, causal=True, window=window, q_chunk=qc,
                                 kv_chunk=kc)
        assert got.dtype == dtype and torch.equal(got, want), (window, qc, kc)


def test_pick_chunk_is_the_references():
    from repro.kernels.flash_attention.xla import _pick_chunk

    for seq in range(1, 80):
        for target in (1, 3, 8, 512):
            assert chunked._pick_chunk(seq, target) == _pick_chunk(seq, target)


def test_windowed_training_dispatch_runs_the_chunked_flash(monkeypatch):
    """The dispatch's differentiable windowed call goes through the
    chunked flash at the tuning cache's chunks; the prefill call keeps
    ``chunked_attention``."""
    calls = []
    real = chunked.flash_attention_chunked

    def spy(*args):
        calls.append(args[3:])
        return real(*args)

    monkeypatch.setattr(chunked, "flash_attention_chunked", spy)
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True)
                  for a in _inputs(1, 24, 24, 4, 2, 8, 8))
    out = kernels.flash_attention_train_dispatch(q, k, v, causal=True, window=5)
    assert calls == [(True, 5, 512, 1024)]
    with torch.no_grad():
        prefill = kernels.flash_attention_dispatch(q, k, v, causal=True, window=5)
    assert len(calls) == 1 and torch.equal(prefill, out.detach())


def test_jamba_long_context_gradients_match_jax_grad():
    """Reduced jamba (window 32) at 48 tokens with ``long_context=True``:
    its attention layers train through the chunked flash's manual
    backward, the reference's through ``flash_attention_xla``'s."""
    arch = "jamba_1p5_large_398b"
    cfg_j, cfg_t = jcfgs.reduced(jcfgs.get(arch)), tcfgs.reduced(tcfgs.get(arch))
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    model.requires_grad_(True)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg_t.vocab_size, (2, 48)),
             "targets": rng.integers(0, cfg_t.vocab_size, (2, 48))}
    assert 48 > cfg_t.long_context_window
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: api_j.train_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                   long_context=True), has_aux=True)(params)
    named = dict(model.named_parameters())
    loss_t, _ = api_t.train_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 long_context=True)
    grads_t = dict(zip(named, torch.autograd.grad(loss_t, list(named.values()))))
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=LOSS_TOL, rtol=LOSS_TOL)
    ref = dict(params_from_jax(jax.tree.map(np.asarray, grads_j), cfg_t,
                               "cpu").named_parameters())
    for name, g in grads_t.items():
        np.testing.assert_allclose(g.numpy(), ref[name].detach().numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)
    assert any(".attn." in name for name in grads_t)
