"""Training programs under ``Service.execute_batch`` on the CPU: the
local-SGD round (``make_local_round_program``) of N tasks as one
``torch.func.vmap`` call, each task with its own weights, gradients,
AdamW state and delta, every kernel entry folded by its vmap rule.

Each family's reduced config runs its round through the reference's
``execute_batch`` (``jax.jit(jax.vmap(fn))`` on the XLA backend, the
reference's plain path) and through the port's, from the same converted
weights (``params_from_jax``), the port fed the reference's in-jit batches
through ``batch_fn``, as ``tests/test_torch_train.py`` holds one task: each
task's loss within the reference's local-SGD 1e-3.  Within the port, the
batched round is held to its per-task rounds (losses 1e-5, each delta
1e-3 relative in Frobenius norm) and padding to a bucket to the unpadded
call.  Then the parts under ``vmap(grad(...))`` against per-task
``grad``: the differentiable flash attention (one rule call a fold, the
forward and the dq/dk-dv pair), the scan with a batched ``A``, the chunked
loss, the expert products with the weights shared and batched, AdamW with
fp32, bf16 and int8 moments, and remat against no remat.

This file holds the dense (llama3.2-1B) and MLA (minicpm3) families;
``tests/test_torch_train_batched_families.py`` the MoE, Mamba and hybrid
ones.  The card's cases are in ``tests/test_torch_cuda_batched.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro.core import Service as JService
from repro.models import build as jbuild
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime.local_sgd import LocalSGDConfig as JLocalSGDConfig
from repro.runtime.local_sgd import _synthetic_batch
from repro.runtime.local_sgd import make_local_round_program as jround
from repro_torch.core import Service
from repro_torch.interop import params_from_jax
from repro_torch.kernels import batched
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import mamba_scan as tscan
from repro_torch.models import build as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.models.loss import token_nll
from repro_torch.optim import adamw_update, init_opt_state
from repro_torch.runtime.local_sgd import LocalSGDConfig, make_local_round_program
from repro_torch.runtime.train_loop import (TrainConfig, functional_loss_and_grads,
                                            loss_and_grads)


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards (as ``tests/test_torch_train.py`` sets it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


KW = dict(lr=2e-3, warmup_steps=1, total_steps=100, schedule="constant")
LKW = dict(inner_steps=2, n_shards=3, batch_per_shard=2, seq_len=16)
ROUND, N_TASKS = 1, 3
REF_LOSS_TOL = 1e-3  # the local-SGD losses of tests/test_torch_train.py
BATCHED_LOSS_TOL, DELTA_TOL = 1e-5, 1e-3


@functools.lru_cache(maxsize=None)
def models(arch, remat=False):
    """(reference api, reference params, port api, port model) of the
    reduced config, ``remat`` set on both."""
    cfg_j = jcfgs.reduced(jcfgs.get(arch)).replace(remat=remat)
    cfg_t = tcfgs.reduced(tcfgs.get(arch)).replace(remat=remat)
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    return api_j, params, api_t, model


def perm_of(cfg):
    return np.random.default_rng(0).permutation(cfg.vocab_size).astype("int32")


def reference_batch_fn(perm):
    """The reference round's in-jit batches, drawn on the host."""
    def batches(rnd, shard, h):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(TrainConfig().seed), rnd * 131 + h), shard)
        b = _synthetic_batch(key, jnp.asarray(perm), LKW["batch_per_shard"], LKW["seq_len"])
        return {k: np.array(v) for k, v in b.items()}
    return batches


def port_round(api_t, model, batch_fn=None):
    """The port's round program and N_TASKS mapping payloads of ``model``'s
    weights, shards 0..N-1 of round ROUND."""
    prog = make_local_round_program(api_t, TrainConfig(**KW), LocalSGDConfig(**LKW),
                                    perm_of(api_t.cfg), batch_fn=batch_fn, skeleton=model)
    weights = dict(model.named_parameters())
    return prog, [{"params": weights, "round": ROUND, "shard": i} for i in range(N_TASKS)]


def reference_losses(arch, remat=False):
    """The reference's round of each task through its ``execute_batch``."""
    api_j, params, api_t, _ = models(arch, remat)
    prog = jround(api_j, JTrainConfig(**KW), JLocalSGDConfig(**LKW), perm_of(api_t.cfg))
    payloads = [{"params": params, "round": jnp.asarray(ROUND), "shard": jnp.asarray(i)}
                for i in range(N_TASKS)]
    return [float(r["loss"]) for r in JService(None).execute_batch(prog, payloads)]


def worst_delta(a, b) -> float:
    """The largest ||a - b|| / ||b|| over the parameters' deltas."""
    return max(((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)).item() for k in b)


def against_reference(arch, remat=False):
    """The port's batched round against the reference's batched round on
    the same weights and batches: each task's loss within REF_LOSS_TOL.
    Returns the port's (batched, per-task) results and the rule calls."""
    _, _, api_t, model = models(arch, remat)
    prog, payloads = port_round(api_t, model, reference_batch_fn(perm_of(api_t.cfg)))
    svc = Service(None, device="cpu")
    batched.reset_rule_calls()
    bat = svc.execute_batch(prog, payloads)
    calls = dict(batched.RULE_CALLS)
    ref = reference_losses(arch, remat)
    for i, (got, want) in enumerate(zip(bat, ref)):
        assert abs(got["loss"].item() - want) <= REF_LOSS_TOL, (arch, i, got["loss"], want)
    per = [svc.execute(prog, p) for p in payloads]
    return bat, per, calls


def against_per_task(bat, per):
    """Batched against per-task, within the port: losses within
    BATCHED_LOSS_TOL, every delta within DELTA_TOL relative.  Returns the
    worst relative delta difference (reported by the assertion)."""
    worst = max(worst_delta(b["delta"], p["delta"]) for b, p in zip(bat, per))
    print(f"worst relative delta difference, batched vs per task: {worst:.3e}")
    for b, p in zip(bat, per):
        assert abs(b["loss"].item() - p["loss"].item()) <= BATCHED_LOSS_TOL
    assert worst <= DELTA_TOL, f"worst relative delta difference {worst:.3e}"
    return worst


def rule_calls_of(cfg):
    """One rule call a kernel launch of one task's round: each attention
    layer's forward (twice with remat) and backward pair, each Mamba
    layer's scan, per inner step."""
    n_attn = sum(s.mixer == "attn" for s in cfg.pattern) * cfg.n_layers // len(cfg.pattern)
    h = LKW["inner_steps"]
    return {"flash_attention_fwd": h * n_attn * (2 if cfg.remat else 1),
            "flash_attention_bwd": h * n_attn, "decode_attention_fwd": 0,
            "mamba_scan": h * (cfg.n_layers - n_attn) * (2 if cfg.remat else 1)}


@pytest.mark.parametrize("arch", ["llama3p2_1b", "minicpm3_4b"])
def test_batched_round_matches_the_reference_and_per_task(arch):
    bat, per, calls = against_reference(arch)
    assert calls == rule_calls_of(models(arch)[2].cfg)
    against_per_task(bat, per)
    assert all(torch.isfinite(b["loss"]) for b in bat)
    assert bat[0]["delta"].keys() == dict(models(arch)[3].named_parameters()).keys()


def test_padding_to_a_bucket_gives_the_unpadded_results():
    """3 tasks padded to 4 (the last repeated, computed and dropped) give
    the 3 tasks' results."""
    _, _, api_t, model = models("llama3p2_1b")
    prog, payloads = port_round(api_t, model)
    svc = Service(None, device="cpu")
    plain = svc.execute_batch(prog, payloads)
    padded = svc.execute_batch(prog, payloads, pad_to=4)
    assert len(padded) == N_TASKS
    for a, b in zip(padded, plain):
        assert abs(a["loss"].item() - b["loss"].item()) <= BATCHED_LOSS_TOL
        assert worst_delta(a["delta"], b["delta"]) <= DELTA_TOL


def test_an_lm_payload_and_its_mapping_give_one_result():
    """The per-task round takes an ``LM`` (as before) or the mapping of
    its weights, with the same result bit for bit; the payload's weights
    are only read."""
    _, _, api_t, model = models("llama3p2_1b")
    prog, payloads = port_round(api_t, model)
    before = {k: p.clone() for k, p in model.named_parameters()}
    a = prog.fn({"params": model, "round": ROUND, "shard": 1})
    b = prog.fn(payloads[1])
    assert torch.equal(a["loss"], b["loss"])
    assert all(torch.equal(a["delta"][k], b["delta"][k]) for k in before)
    assert all(torch.equal(p, before[k]) for k, p in model.named_parameters())
    no_skeleton = make_local_round_program(api_t, TrainConfig(**KW), LocalSGDConfig(**LKW),
                                           perm_of(api_t.cfg))
    with pytest.raises(ValueError, match="skeleton="):
        no_skeleton.fn(payloads[0])


def test_functional_gradients_equal_autograd_for_one_task():
    """The grad transform's gradients of one task are autograd's, bit for
    bit (silu's backward is the native kernel in both: the per-task round
    keeps its results); under vmap they agree with them to rounding."""
    from repro_torch.models.registry import skeleton

    _, _, api_t, model = models("llama3p2_1b")
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, api_t.cfg.vocab_size, (2, 12)))
    batch = {"tokens": tok, "targets": tok.roll(1, 1)}
    model.requires_grad_(True)
    try:
        want_loss, _, want = loss_and_grads(api_t, model, batch)
    finally:
        model.requires_grad_(False)
    weights = {k: p.detach() for k, p in model.named_parameters()}
    loss, _, got = functional_loss_and_grads(skeleton(model), weights, batch)
    assert torch.equal(loss, want_loss) and all(torch.equal(got[k], want[k]) for k in want)
    stacked = {k: torch.stack([p, p]) for k, p in weights.items()}
    vloss, _, vgot = torch.func.vmap(
        lambda w: functional_loss_and_grads(skeleton(model), w, batch))(stacked)
    torch.testing.assert_close(vloss, torch.stack([want_loss] * 2), atol=1e-6, rtol=0)
    for k in want:
        torch.testing.assert_close(vgot[k][1], want[k], atol=1e-6, rtol=1e-5)


# --------------------------------------------------------------------- #
# the parts under vmap(grad(...)) against per-task grad, on CPU tensors
# --------------------------------------------------------------------- #
def _randn(shape, seed, dtype=torch.float32):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


def _per_task_and_batched(f, args, argnums, in_dims=0, n=3):
    """(vmap(grad(f)) of the stacked args, [grad(f) of each of the n
    tasks' args])."""
    got = torch.func.vmap(torch.func.grad(f, argnums=argnums), in_dims=in_dims)(*args)
    dims = in_dims if isinstance(in_dims, tuple) else (in_dims,) * len(args)
    want = [torch.func.grad(f, argnums=argnums)(*(a if d is None else a[i]
                                                  for a, d in zip(args, dims)))
            for i in range(n)]
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_under_vmap_grad_folds_each_pass_once(dtype, causal):
    """The differentiable flash attention under vmap(grad): one rule call
    for the forward, one for the dq and dk/dv pair, whatever N; each task's
    gradients its own per-task ones, bit for bit (the rules run the plain
    versions on the folded batch)."""
    N, B, Sq, Skv, H, K, D = 3, 2, 13, 13 if causal else 21, 4, 2, 16
    q, k, v = (_randn((N, B, s, h, D), i, dtype)
               for i, (s, h) in enumerate(((Sq, H), (Skv, K), (Skv, K))))
    g = _randn((N, B, Sq, H, D), 7, dtype)

    def f(q, k, v, g):
        return (tflash.flash_attention(q, k, v, causal=causal).float() * g.float()).sum()

    batched.reset_rule_calls()
    got, want = _per_task_and_batched(f, (q, k, v, g), (0, 1, 2))
    assert batched.RULE_CALLS["flash_attention_fwd"] == 1
    assert batched.RULE_CALLS["flash_attention_bwd"] == 1
    for i, w in enumerate(want):
        for a, b in zip(got, w):
            assert torch.equal(a[i], b)
    assert batched.RULE_CALLS["flash_attention_bwd"] == 1  # per-task grads skip the ops


def test_scan_under_vmap_grad_with_a_batched_A():
    """The scan with each task's own A under vmap(grad): one fold, A's
    gradient (and every other) the per-task one."""
    N, b, s, d, n = 3, 2, 13, 8, 4
    x, Bm, C = _randn((N, b, s, d), 1), _randn((N, b, s, n), 2), _randn((N, b, s, n), 3)
    dt = torch.nn.functional.softplus(_randn((N, b, s, d), 4))
    A = -torch.exp(_randn((N, d, n), 5))

    def f(x, dt, A, B, C):
        y, h = tscan.mamba_scan(x, dt, A, B, C)
        return y.square().sum() + h.sum()

    batched.reset_rule_calls()
    got, want = _per_task_and_batched(f, (x, dt, A, Bm, C), (0, 1, 2, 3, 4))
    assert batched.RULE_CALLS["mamba_scan"] == 1
    for i, w in enumerate(want):
        for a, c in zip(got, w):
            assert torch.equal(a[i], c)


def test_scan_backward_is_the_plain_scans_vjp_in_every_mode():
    """The scan's backward (``torch.func.vjp`` of the plain chunked scan)
    under ``.backward()``, ``grad`` and autograd through the plain scan
    itself: one result, bit for bit."""
    b, s, d, n = 2, 40, 8, 4
    x, Bm, C = _randn((b, s, d), 1), _randn((b, s, n), 2), _randn((b, s, n), 3)
    dt = torch.nn.functional.softplus(_randn((b, s, d), 4))
    A, h0 = -torch.exp(_randn((d, n), 5)), _randn((b, d, n), 6)
    args = (x, dt, A, Bm, C, h0)

    def f(fn, *a):
        y, h = fn(*a)
        return y.square().sum() + h.square().sum()

    leaves = [t.clone().requires_grad_() for t in args]
    f(tscan.mamba_scan_plain, *leaves).backward()
    want = [t.grad for t in leaves]
    leaves = [t.clone().requires_grad_() for t in args]
    f(tscan.mamba_scan, *leaves).backward()
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    got = torch.func.grad(lambda *a: f(tscan.mamba_scan, *a), argnums=tuple(range(6)))(*args)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_token_nll_under_vmap_grad():
    """The chunked loss under vmap(grad), each task's table its own."""
    N, B, S, d, V = 3, 2, 24, 16, 50
    x, table = _randn((N, B, S, d), 1), _randn((N, V, d), 2)
    targets = torch.from_numpy(np.random.default_rng(3).integers(0, V, (N, B, S)))

    def f(x, table, t):
        return token_nll(x, table, t, 8).square().sum()

    got, want = _per_task_and_batched(f, (x, table, targets), (0, 1))
    for i, w in enumerate(want):
        for a, b in zip(got, w):
            torch.testing.assert_close(a[i], b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shared", [True, False], ids=["weights-shared", "weights-batched"])
def test_expert_matmul_under_vmap_grad(shared):
    """Shared weights take the folding rule (the tasks' slots side by
    side, gradients through its backward); batched weights the native
    product, bit for bit."""
    x = _randn((3, 4, 5, 6), 1)
    w = _randn((4, 6, 7), 2) if shared else _randn((3, 4, 6, 7), 2)

    def f(x, w):
        return tmoe.expert_matmul(x, w).square().sum()

    got, want = _per_task_and_batched(f, (x, w), (0, 1), in_dims=(0, None if shared else 0))
    for i, wt in enumerate(want):
        for a, b in zip(got, wt):
            if shared:
                torch.testing.assert_close(a[i], b, atol=1e-5, rtol=1e-5)
            else:
                assert torch.equal(a[i], b)


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_under_vmap_is_the_per_task_update(moments, master):
    """Moments and masters made from each task's parameters; two steps of
    the in-place update (clip included) of N tasks as one vmap call equal
    each task's own, bit for bit."""
    N = 3
    params = {"w": _randn((N, 4, 300), 1, torch.bfloat16), "b": _randn((N, 300), 2)}
    grads = [{"w": _randn((N, 4, 300), 3 + s, torch.bfloat16), "b": _randn((N, 300), 5 + s)}
             for s in range(2)]
    lrs = torch.tensor([1e-2, 2e-2, 3e-2])

    def run(p, g0, g1, lr):
        p = {k: t.clone() for k, t in p.items()}
        opt = init_opt_state(p, moment_dtype=moments, master_fp32=master)
        for g in (g0, g1):
            adamw_update({k: t.clone() for k, t in g.items()}, opt, p, lr=lr,
                         moment_dtype=moments, clip_norm=1.0)
        return p

    got = torch.func.vmap(run)(params, grads[0], grads[1], lrs)
    for i in range(N):
        want = run({k: t[i] for k, t in params.items()}, *({k: t[i] for k, t in g.items()}
                                                          for g in grads), lrs[i])
        for k in want:
            assert torch.equal(got[k][i], want[k]), (k, i)


def test_remats_backward_gives_the_kernels_plain_tensors(monkeypatch):
    """Remat under ``.backward()`` recomputes through ``torch.func.vjp``,
    whose backward runs after its transform has returned: the flash
    backward must still reach its kernel (here its plain version, which
    stands where the kernel takes ``data_ptr()``) with plain tensors, not
    the transform's wrappers."""
    import sys

    fa = sys.modules["repro_torch.kernels.flash_attention.flash_attention"]
    seen = []
    real = fa.flash_attention_bwd_plain

    def spy(*args, **kw):
        seen.append(any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in args))
        return real(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention_bwd_plain", spy)
    _, _, api_t, model = models("llama3p2_1b")
    m = api_t.init(torch.Generator().manual_seed(1))
    m.load_state_dict(model.state_dict())
    m.cfg = m.cfg.replace(remat=True)
    m.requires_grad_(True)
    tok = torch.from_numpy(np.random.default_rng(6).integers(0, api_t.cfg.vocab_size, (2, 12)))
    loss_and_grads(api_t, m, {"tokens": tok, "targets": tok})
    assert seen == [False] * api_t.cfg.n_layers


def test_remat_under_vmap_grad_matches_no_remat():
    """Remat's route (``_Remat``: the repeat's forward again under
    ``torch.func.vjp``) under vmap(grad): the forward launches twice an
    attention layer, the backward once, and the gradients equal remat
    off's within the reference's 1e-3."""
    from repro_torch.models.registry import skeleton

    _, _, api_t, model = models("llama3p2_1b")
    cfg = api_t.cfg
    remat_model = skeleton(model)
    remat_model.cfg = cfg.replace(remat=True)
    weights = {k: torch.stack([p, p * 0.99]) for k, p in model.named_parameters()}
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 2, 12)))
    batch = {"tokens": tok, "targets": tok.roll(1, -1)}
    runs = {}
    for remat, m in ((False, skeleton(model)), (True, remat_model)):
        batched.reset_rule_calls()
        runs[remat] = torch.func.vmap(
            lambda w, b: functional_loss_and_grads(m, w, b))(weights, batch)
        assert batched.RULE_CALLS["flash_attention_fwd"] == cfg.n_layers * (2 if remat else 1)
        assert batched.RULE_CALLS["flash_attention_bwd"] == cfg.n_layers
    torch.testing.assert_close(runs[True][0], runs[False][0], atol=1e-6, rtol=0)
    for k, g in runs[False][2].items():
        np.testing.assert_allclose(runs[True][2][k].numpy(), g.numpy(), atol=1e-3, rtol=1e-3,
                                   err_msg=k)
