"""How often jamba's MoE routing flips between two exact-in-intent paths,
read in the JAX package itself: the reduced jamba-1.5-large-398b (two
repeats of the period, 8 MoE layers of 4 experts, top-2, capacity 1.25)
prefilled once on its XLA backend and once on its Pallas kernels in
interpret mode, same weights and tokens.

Each MoE layer's routing is recorded by a wrapper around the reference's
``apply_moe`` (monkeypatched where ``repro.models.blocks`` calls it; the
reference is untouched) that routes the layer's input as ``apply_moe``
does and hands the choices out through ``jax.debug.callback``.  A
(token, choice) pair that differs is a first flip when the top-k choice
itself differs, else a drop: the same expert, kept by one path and
dropped by the other because a flip elsewhere in its routing group moved
the expert's slots.

In fp32 the two backends route identically.  In bf16 they do not, and
the flips compound down the stack: a flipped choice changes that token's
output by an expert's share, and the Mamba layers carry it to every later
token and MoE layer, so the first MoE layer flips least and the last
most.  This is the reference's own witness for the card's phase 19,
where the kernels and the plain versions of the served bf16 jamba are two
such paths.  ``python tests/test_torch_hybrid_routing.py`` prints the
shares by layer for three token seeds in both dtypes.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as jcfgs
import repro.models.blocks as jblocks
from repro import kernels as jkernels
from repro.models import build as jbuild
from repro.models.moe import expert_capacity, routing_group_size

ARCH = "jamba_1p5_large_398b"
B, S = 4, 128  # one routing group of 128 tokens a row (max_seq_len 128)
APPLY_MOE = jblocks.apply_moe


def _spy(seen):
    """``apply_moe`` that first records, for each (token, choice) of the
    layer's input, the chosen expert and whether it found a slot."""
    def spy(p, x, cfg):
        m = cfg.moe
        G = routing_group_size(cfg, x.shape[1])
        ng, C = x.shape[0] * (x.shape[1] // G), expert_capacity(cfg, G)
        logits = x.reshape(ng, G, -1).astype(jnp.float32) @ p["router"].astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
        onehot = jax.nn.one_hot(idx, m.n_experts)
        cm = onehot.transpose(0, 2, 1, 3).reshape(ng, m.top_k * G, m.n_experts)
        pos = (jnp.cumsum(cm, 1) - cm).reshape(ng, m.top_k, G, m.n_experts)
        kept = ((pos.transpose(0, 2, 1, 3) < C) * onehot).sum(-1) > 0
        jax.debug.callback(lambda i, k: seen.append((np.asarray(i), np.asarray(k))),
                           idx, kept, ordered=True)
        return APPLY_MOE(p, x, cfg)

    return spy


def _prefill(dtype, backend, seed, monkeypatch, hints=False):
    """The reduced jamba's prefill of B x S seeded tokens on ``backend``:
    [(choices (ng, G, k), kept (ng, G, k))] a MoE layer in call order, and
    with ``hints`` the reference's dispatch masks a layer."""
    import repro.models.moe as jmoe

    cfg = jcfgs.reduced(jcfgs.get(ARCH))
    cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    api = jbuild(cfg)
    params = api.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    seen, masks = [], []
    monkeypatch.setattr(jblocks, "apply_moe", _spy(seen))
    if hints:
        def hint(a, name):
            if name == "moe_dispatch":
                jax.debug.callback(lambda m: masks.append(np.asarray(m)), a, ordered=True)
            return a
        monkeypatch.setattr(jmoe, "shard_hint", hint)
    ctx = (jkernels.backend("pallas", interpret=True) if backend == "pallas"
           else contextlib.nullcontext())
    with ctx:
        logits, _ = api.prefill(params, {"tokens": jnp.asarray(tokens)})
        jax.block_until_ready(logits)
    jax.effects_barrier()
    n_moe = sum(s.mlp == "moe" for s in cfg.pattern) * cfg.n_repeats
    assert len(seen) == n_moe
    return seen, masks


def split(a, b):
    """[(first flips, drops, pairs)] a MoE layer between two prefills."""
    out = []
    for (ca, ka), (cb, kb) in zip(a, b, strict=True):
        flip = ca != cb
        out.append((int(flip.sum()), int((~flip & (ka != kb)).sum()), ca.size))
    return out


def test_recorded_routing_is_the_references(monkeypatch):
    """The recorded choices and slots give, layer by layer, the experts
    that the reference's own dispatch mask (its ``moe_dispatch`` sharding
    hint) sends each token to; some choices drop at capacity 1.25."""
    seen, masks = _prefill("float32", "xla", 0, monkeypatch, hints=True)
    dispatch = masks[0::2]  # each layer hints dispatch, then combine
    assert len(dispatch) == len(seen)
    E = dispatch[0].shape[2]
    for (choice, kept), mask in zip(seen, dispatch):
        sent = np.zeros(mask.shape[:3], bool)  # (ng, G, E)
        for k in range(choice.shape[-1]):
            sent |= (np.eye(E, dtype=bool)[choice[..., k]] & kept[..., k, None])
        np.testing.assert_array_equal(sent, mask.sum(-1) > 0)
    assert not all(kept.all() for _, kept in seen)


def test_fp32_backends_route_alike(monkeypatch):
    xla, _ = _prefill("float32", "xla", 0, monkeypatch)
    pallas, _ = _prefill("float32", "pallas", 0, monkeypatch)
    assert split(xla, pallas) == [(0, 0, c.size) for c, _ in xla]


def test_bf16_flips_compound_down_the_stack(monkeypatch):
    """In bf16 the backends' routing differs, the first MoE layer least
    and the last most, and most differing pairs are first flips."""
    xla, _ = _prefill("bfloat16", "xla", 0, monkeypatch)
    pallas, _ = _prefill("bfloat16", "pallas", 0, monkeypatch)
    layers = split(xla, pallas)
    shares = [f / n for f, _, n in layers]
    assert 0 < shares[0] < shares[-1]
    assert sum(d for _, d, _ in layers) < sum(f for f, _, _ in layers)


def main():
    mp = pytest.MonkeyPatch()
    for dtype in ("float32", "bfloat16"):
        for seed in range(3):
            layers = split(_prefill(dtype, "xla", seed, mp)[0],
                           _prefill(dtype, "pallas", seed, mp)[0])
            flips, drops, n = (sum(col) for col in zip(*layers))
            print(f"{dtype} seed {seed}: first flips {flips} of {n} ({flips / n:.4f}), "
                  f"drops {drops} ({drops / n:.4f}); first flips by layer "
                  + ", ".join(f"{f / m:.4f}" for f, _, m in layers), flush=True)
    mp.undo()


if __name__ == "__main__":
    main()
