"""Gradients of one training step of the families beyond GQA against the
JAX package at reduced size: minicpm3-4b (MLA), phi-3-vision-4.2b with
patch embeddings and whisper-tiny with encoder frames.

Both packages start from the JAX package's ``api.init(PRNGKey(0))``
parameters (through ``params_from_jax``) and take the same batch, made with
numpy: tokens, targets and, as the reference's own smoke batch does,
``patch_embeds`` for the vision model and ``enc_frames`` for whisper.  The
JAX gradients (``jax.value_and_grad`` of ``train_loss``, on its XLA backend
and on its Pallas kernels in interpret mode) go through the same
``params_from_jax`` mapping, so each port parameter meets the reference's
gradient of the same weight; they must agree within 1e-3 absolute and
relative, as qwen3's and llama's do (``test_torch_train.py``), and the
losses within 2e-4.  The port's side is ``loss_and_grads``, the training
step's own, through ``DISPATCH`` (the flash kernels' autograd rule, which
runs the plain forward and backward on the CPU).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro import kernels as jkernels
from repro.models import build as jbuild
from repro_torch.interop import params_from_jax
from repro_torch.models import build as tbuild
from repro_torch.runtime.train_loop import loss_and_grads


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards, as in the other tight-tolerance port tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ARCHS = ["minicpm3_4b", "phi3_vision_4p2b", "whisper_tiny"]
GRAD_TOL, LOSS_TOL = 1e-3, 2e-4
B, T = 2, 16


def _batch(cfg, seed):
    """numpy tokens, targets and the family's precomputed frontend input."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)),
             "targets": rng.integers(0, cfg.vocab_size, (B, T))}
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model), np.float32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patch_tokens, cfg.d_model), np.float32)
    return batch


def _backend(name):
    return (jkernels.backend("pallas", interpret=True) if name == "pallas"
            else contextlib.nullcontext())


@pytest.mark.parametrize("jax_backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_grads_match_jax(arch, jax_backend):
    cfg_j = jcfgs.reduced(jcfgs.get(arch))
    cfg_t = tcfgs.reduced(tcfgs.get(arch))
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    model.requires_grad_(True)
    batch = _batch(cfg_t, 7)
    with _backend(jax_backend):
        (loss_j, _), grads_j = jax.value_and_grad(
            lambda p: api_j.train_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
            has_aux=True)(params)
    loss_t, _, grads_t = loss_and_grads(
        api_t, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=LOSS_TOL, rtol=LOSS_TOL)
    ref = dict(params_from_jax(jax.tree.map(np.asarray, grads_j), cfg_t,
                               "cpu").named_parameters())
    assert ref.keys() == grads_t.keys()
    for name, g in grads_t.items():
        assert g.shape == ref[name].shape, name
        np.testing.assert_allclose(g.numpy(), ref[name].detach().numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"{arch} {name}")
    # every parameter takes part: the frontend's projection included
    assert all(float(g.abs().max()) > 0 for g in grads_t.values())
