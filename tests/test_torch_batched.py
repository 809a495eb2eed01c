"""Model programs under ``Service.execute_batch`` on the CPU: N tasks as
one ``torch.func.vmap`` call, every kernel entry folded by its vmap rule.

Each family's reduced config runs its generate program through the
reference's ``execute_batch`` (``jax.jit(jax.vmap(fn))``; the XLA backend,
and the Pallas-interpret backend for qwen3 and falcon-mamba) and through
the port's, each held to its own per-task run, and the port's batched
greedy tokens to the reference's where no step is a near-tie (a top-2
logit gap of at most the 2e-3 logit tolerance, as in
``tests/test_torch_serve.py``).  Parameters: the reference's
``api.init(PRNGKey(0))`` through ``params_from_jax``.  Then padding to a
bucket, an MoE batch in which one task's routing drops tokens and the
other's does not, each rule against per-task calls of its wrapper on CPU
tensors (bit-identical: the rule calls the plain versions), the rule
counters, and a batched ``A`` folding (an ill-shaped one raising by
name).

The card's cases (the folded launches against per-task launches) are in
``tests/test_torch_cuda_batched.py``, which imports no JAX.
"""

import contextlib
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.kernels as jkernels
import repro_torch.configs as tcfgs
from repro.core import Service as JService
from repro.models import build as jbuild
from repro.runtime.serve_loop import ServeConfig as JServeConfig
from repro.runtime.serve_loop import make_generate_program as jprogram
from repro_torch.core import Program, Service
from repro_torch.interop import params_from_jax
from repro_torch.kernels import batched
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import mamba_scan as tscan
from repro_torch.models import build as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.runtime.serve_loop import ServeConfig, make_generate_program


@pytest.fixture(autouse=True)
def _torch_threads():
    """One intra-op thread for each test of this file, the previous count
    afterwards (as ``tests/test_torch_serve.py`` sets it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


LOGIT_TOL = 2e-3
N_TASKS, B, PROMPT, NEW = 3, 2, 8, 3
SC = ServeConfig(max_new_tokens=NEW, prompt_len=PROMPT, batch_per_task=B)
JSC = JServeConfig(max_new_tokens=NEW, prompt_len=PROMPT, batch_per_task=B)
MAMBA_FAMILIES = ["falcon_mamba_7b", "jamba_1p5_large_398b"]
OTHER_FAMILIES = ["qwen3_1p7b", "llama4_maverick_400b_a17b", "arctic_480b",
                  "minicpm3_4b", "phi3_vision_4p2b", "whisper_tiny"]


@functools.lru_cache(maxsize=None)
def _models(arch):
    cfg_j, cfg_t = jcfgs.reduced(jcfgs.get(arch)), tcfgs.reduced(tcfgs.get(arch))
    api_j, api_t = jbuild(cfg_j), tbuild(cfg_t)
    params = api_j.init(jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg_t, "cpu")
    return api_j, params, api_t, model


def _payloads(cfg, n, seed):
    """``n`` tasks of B prompts of PROMPT tokens, with the seeded
    ``patch_embeds`` of a vision config and ``enc_frames`` of an
    encoder-decoder one."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = {"tokens": rng.integers(0, cfg.vocab_size, (B, PROMPT))}
        if cfg.frontend == "vision":
            p["patch_embeds"] = rng.standard_normal((B, cfg.n_patch_tokens, cfg.d_model),
                                                    np.float32)
        if cfg.is_encoder_decoder:
            p["enc_frames"] = rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model),
                                                  np.float32)
        out.append(p)
    return out


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _gaps(api, model, payload):
    """Top-2 logit gap of each prompt at each greedy step of the port's
    per-task generation: (B, NEW)."""
    lg, caches = api.prefill(model, payload, seq_budget=PROMPT + NEW)
    gaps = []
    for i in range(NEW):
        top2 = torch.topk(lg, 2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        lg, caches = api.decode(model, {"tokens": lg.argmax(-1).to(torch.int32)[:, None],
                                        "cache_index": PROMPT + i}, caches)
    return torch.stack(gaps, 1).cpu().numpy()


def _reference(api_j, params, payloads, backend):
    """The reference's generate program per task and through its
    ``execute_batch``: (per-task, batched) generated tokens."""
    ctx = (jkernels.backend("pallas", interpret=True) if backend == "pallas"
           else contextlib.nullcontext())
    svc = JService(None)
    with ctx:
        prog = jprogram(api_j, JSC, params)
        jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in payloads]
        per = [np.asarray(svc.execute(prog, p)["generated"]) for p in jp]
        bat = [np.asarray(r["generated"]) for r in svc.execute_batch(prog, jp)]
    return per, bat


def _family_case(arch, backend, seed=0):
    api_j, params, api_t, model = _models(arch)
    payloads = _payloads(api_t.cfg, N_TASKS, seed)
    ref_per, ref_bat = _reference(api_j, params, payloads, backend)
    for a, b in zip(ref_per, ref_bat):  # the reference's batched path as its own
        np.testing.assert_array_equal(b, a)

    prog = make_generate_program(api_t, SC, model)
    svc = Service(None, device="cpu")
    per = [svc.execute(prog, _torch(p))["generated"] for p in payloads]
    batched.reset_rule_calls()
    bat = svc.execute_batch(prog, [_torch(p) for p in payloads])
    calls = dict(batched.RULE_CALLS)
    for a, b in zip(per, bat):
        assert torch.equal(b["generated"], a)

    # one folded call of each rule a layer that has the kernel, whatever N
    cfg = api_t.cfg
    n_attn = sum(blk.mixer == "attn" for blk in cfg.pattern) * cfg.n_layers // len(cfg.pattern)
    # (MLA's absorbed decode has no kernel)
    assert calls["decode_attention_fwd"] == (0 if cfg.attention == "mla" else n_attn * NEW)
    assert calls["mamba_scan"] == cfg.n_layers - n_attn
    assert calls["flash_attention_fwd"] >= n_attn

    # the port's batched tokens against the reference's batched tokens, each
    # prompt up to its first near-tie
    compared = 0
    for p, got, want in zip(payloads, bat, ref_bat):
        gaps = _gaps(api_t, model, _torch(p))
        for row in range(B):
            upto = int(np.argmax(gaps[row] <= LOGIT_TOL)) if (gaps[row] <= LOGIT_TOL).any() \
                else NEW
            np.testing.assert_array_equal(got["generated"][row, :upto].numpy(),
                                          want[row, :upto], err_msg=f"{arch} row {row}")
            compared += upto
    assert compared >= N_TASKS * B * NEW // 2


@pytest.mark.parametrize("arch,backend", [(a, "xla") for a in MAMBA_FAMILIES]
                         + [("falcon_mamba_7b", "pallas")])
def test_mamba_families_run_batched_through_execute_batch(arch, backend):
    """The Mamba families' generate programs under the port's
    ``execute_batch``: before the scan's ``autograd.Function`` took the
    ``setup_context`` form, functorch refused it ("In order to use an
    autograd.Function with functorch transforms ... it must override the
    setup_context staticmethod")."""
    _family_case(arch, backend)


@pytest.mark.parametrize("arch,backend", [(a, "xla") for a in OTHER_FAMILIES]
                         + [("qwen3_1p7b", "pallas")])
def test_family_runs_batched_as_per_task(arch, backend):
    _family_case(arch, backend)


def test_padding_to_a_bucket_computes_and_drops_the_padding_rows(monkeypatch):
    """3 tasks padded to 4: the folded flash call sees 4 tasks' rows, the
    results are the 3 per-task ones."""
    _, _, api_t, model = _models("qwen3_1p7b")
    payloads = [_torch(p) for p in _payloads(api_t.cfg, 3, 5)]
    prog = make_generate_program(api_t, SC, model)
    svc = Service(None, device="cpu")
    per = [svc.execute(prog, p)["generated"] for p in payloads]
    seen = []
    plain = tflash.flash_attention_plain
    monkeypatch.setattr(sys.modules["repro_torch.kernels.flash_attention.flash_attention"],
                        "flash_attention_plain",
                        lambda q, *a, **kw: seen.append(q.shape[0]) or plain(q, *a, **kw))
    bat = svc.execute_batch(prog, payloads, pad_to=4)
    assert len(bat) == 3 and set(seen) == {4 * B}
    for a, b in zip(per, bat):
        assert torch.equal(b["generated"], a)


def _moe_program(api, model, drops):
    """The generate program, also returning each MoE layer's dropped
    (token, choice) count per prompt of the task, from its routing."""
    route = tmoe.MoE.route

    def tapped(self, x):
        r = route(self, x)
        onehot, keep = r[2], r[3]
        drops.append((onehot - keep).sum((1, 2, 3)))  # one per routing group
        return r

    gen = make_generate_program(api, SC, model).fn

    def fn(payload):
        drops.clear()
        tmoe.MoE.route = tapped
        try:
            out = gen(payload)
        finally:
            tmoe.MoE.route = route
        return dict(out, drops=torch.stack(drops))
    return Program(fn, name="generate_with_drops")


def test_moe_capacity_stays_per_task():
    """llama4 (reduced: 4 experts, top-1; capacity factor 2.0, so that 4
    of a group's 8 tokens fit an expert and seeded random prompts that
    drop nothing are common): task 0's prompts repeat one token, so every
    token of a routing group picks one expert and the capacity drops
    tokens; task 1's prompts drop none.  The batched run keeps each task's
    routing groups and capacity: drops and tokens equal the per-task run's
    exactly."""
    cfg = tcfgs.reduced(tcfgs.get("llama4_maverick_400b_a17b"))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=2.0))
    api_t = tbuild(cfg)
    model = api_t.init(torch.Generator().manual_seed(0))
    drops = []
    prog = _moe_program(api_t, model, drops)
    svc = Service(None, device="cpu")
    rng = np.random.default_rng(11)
    skewed = {"tokens": torch.full((B, PROMPT), 7, dtype=torch.int64)}
    rows = []  # seeded random prompts whose prefill drops nothing (a row is a group)
    for _ in range(200):
        cand = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT)))
        d = svc.execute(prog, {"tokens": cand})["drops"]
        rows += [cand[r] for r in range(B) if int(d[:, r].sum()) == 0]
        if len(rows) >= B:
            break
    assert len(rows) >= B
    clean = {"tokens": torch.stack(rows[:B])}
    tasks = [skewed, clean]
    per = [svc.execute(prog, t) for t in tasks]
    assert int(per[0]["drops"].sum()) > 0 and int(per[1]["drops"].sum()) == 0
    bat = svc.execute_batch(prog, tasks)
    for a, b in zip(per, bat):
        assert torch.equal(b["drops"], a["drops"])
        assert torch.equal(b["generated"], a["generated"])


# --------------------------------------------------------------------- #
# the rules against per-task calls of the wrappers, on CPU tensors
# --------------------------------------------------------------------- #
def _randn(shape, dtype, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("in_dims", [(0, 0, 0), (1, None, 0)], ids=["all", "moved-k-shared"])
def test_flash_rule_folds_the_tasks(dtype, in_dims):
    N, S, H, K, D = 3, 13, 4, 2, 16
    shapes = {0: (N, B, S, H, D), 1: (B, N, S, H, D)}
    q = _randn(shapes[in_dims[0]], dtype, 1)
    k = _randn((B, S, K, D), dtype, 2)  # in_dims None: one k for every task
    v = _randn((N, B, S, K, D), dtype, 3)
    if in_dims[1] is not None:
        k = _randn((N, B, S, K, D), dtype, 2)
    batched.reset_rule_calls()
    out, lse = torch.func.vmap(lambda a, b, c: tflash.flash_attention_fwd(a, b, c),
                               in_dims=in_dims)(q, k, v)
    assert batched.RULE_CALLS["flash_attention_fwd"] == 1
    for i in range(N):
        qi = q[i] if in_dims[0] == 0 else q[:, i]
        ki = k if in_dims[1] is None else k[i]
        want_out, want_lse = tflash.flash_attention_fwd(qi, ki, v[i])
        assert torch.equal(out[i], want_out) and torch.equal(lse[i], want_lse)
    assert batched.RULE_CALLS["flash_attention_fwd"] == 1  # per-task calls skip the op


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_decode_rule_folds_the_tasks_at_one_cache_index(dtype):
    N, S, H, K, D = 3, 20, 4, 2, 16
    q = _randn((N, B, 1, H, D), dtype, 4)
    kc, vc = _randn((N, B, S, K, D), dtype, 5), _randn((N, B, S, K, D), dtype, 6)
    batched.reset_rule_calls()
    out = torch.func.vmap(lambda a, b, c: tdecode.decode_attention_fwd(
        a, b, c, cache_index=11))(q, kc, vc)
    assert batched.RULE_CALLS["decode_attention_fwd"] == 1
    for i in range(N):
        assert torch.equal(out[i], tdecode.decode_attention_fwd(q[i], kc[i], vc[i],
                                                                cache_index=11))
    with pytest.raises(ValueError, match="input cache_index arrived batched"):
        torch.func.vmap(lambda a, b, c, ci: tdecode.decode_attention_fwd(
            a, b, c, cache_index=ci))(q, kc, vc, torch.arange(N))


def _scan_inputs(N, s=13, d=8, n=4):
    x = _randn((N, B, s, d), torch.float32, 7)
    dt = torch.nn.functional.softplus(_randn((N, B, s, d), torch.float32, 8))
    A = -torch.exp(_randn((d, n), torch.float32, 9))
    Bm, C = _randn((N, B, s, n), torch.float32, 10), _randn((N, B, s, n), torch.float32, 11)
    h0 = _randn((N, B, d, n), torch.float32, 12)
    return x, dt, A, Bm, C, h0


@pytest.mark.parametrize("in_dims", [(0, 0, 0, 0), (1, 0, None, 0)], ids=["all", "moved-x-shared-B"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-none", "h0"])
def test_scan_rule_folds_the_tasks(in_dims, with_h0):
    """The differentiable scan's Function (``mamba_scan``, DISPATCH's
    member) folds the tasks with its ``vmap`` staticmethod: inputs batched
    along another dim are moved, unbatched ones expanded."""
    N = 3
    x, dt, A, Bm, C, h0 = _scan_inputs(N)
    xs = x.transpose(0, 1).contiguous() if in_dims[0] == 1 else x
    Bs = Bm[0] if in_dims[2] is None else Bm
    batched.reset_rule_calls()
    if with_h0:
        y, hf = torch.func.vmap(lambda a, b, c, d, e: tscan.mamba_scan(a, b, A, c, d, e),
                                in_dims=(*in_dims, 0))(xs, dt, Bs, C, h0)
    else:
        y, hf = torch.func.vmap(lambda a, b, c, d: tscan.mamba_scan(a, b, A, c, d),
                                in_dims=in_dims)(xs, dt, Bs, C)
    assert batched.RULE_CALLS["mamba_scan"] == 1
    for i in range(N):
        Bi = Bm[0] if in_dims[2] is None else Bm[i]
        want_y, want_h = tscan.mamba_scan_fwd(x[i], dt[i], A, Bi, C[i],
                                              h0[i] if with_h0 else None)
        assert torch.equal(y[i], want_y) and torch.equal(hf[i], want_h)


@pytest.mark.parametrize("entry", ["mamba_scan", "DISPATCH.scan"])
def test_a_batched_A_raises_by_name(entry):
    """A batched ``A`` (each task's own weights, as a training task has
    them) folds: one rule call, one (d, n) matrix a folded batch row, each
    task's result its own per-task call's.  An ``A`` whose task shape is
    not (d, n) raises, naming A."""
    from repro_torch import kernels

    N = 3
    x, dt, A, Bm, C, _ = _scan_inputs(N)
    fn = tscan.mamba_scan if entry == "mamba_scan" else kernels.DISPATCH.scan
    As = torch.stack([A * (1.0 + 0.25 * i) for i in range(N)])
    batched.reset_rule_calls()
    y, hf = torch.func.vmap(fn, in_dims=(0, 0, 0, 0, 0, None))(x, dt, As, Bm, C, None)
    assert batched.RULE_CALLS["mamba_scan"] == 1
    for i in range(N):
        want_y, want_h = tscan.mamba_scan_fwd(x[i], dt[i], As[i], Bm[i], C[i])
        assert torch.equal(y[i], want_y) and torch.equal(hf[i], want_h)
    with pytest.raises(ValueError, match="mamba_scan_fwd: A is"):
        torch.func.vmap(fn, in_dims=(0, 0, 0, 0, 0, None))(
            x, dt, As[:, :5], Bm, C, None)


def test_per_task_calls_do_not_enter_the_ops():
    """Without vmap every wrapper runs as before: no rule is called."""
    _, _, api_t, model = _models("jamba_1p5_large_398b")
    batched.reset_rule_calls()
    prog = make_generate_program(api_t, SC, model)
    prog.fn(_torch(_payloads(api_t.cfg, 1, 3)[0]))
    assert not any(batched.RULE_CALLS.values())


def test_the_ops_are_registered_with_fake_implementations():
    """The flash and decode entries are ``torch.library`` ops with a fake (meta)
    implementation, so shape propagation needs no kernel."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q, k, v = torch.empty(2, 5, 4, 16), torch.empty(2, 5, 2, 16), torch.empty(2, 5, 2, 8)
        out, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, True)
        assert out.shape == (2, 5, 4, 8) and lse.shape == (2, 4, 5)
        o = torch.ops.repro_torch.decode_attention_fwd(q[:, :1], k, v, 3)
        assert o.shape == (2, 1, 4, 8)


def test_expert_products_fold_the_tasks_under_vmap():
    """The MoE expert products under vmap take their own rule (the tasks'
    slots side by side, the weights read once), and equal the per-task
    products up to the summation order of a longer GEMM."""
    x = _randn((3, 4, 5, 6), torch.float32, 13)
    w = _randn((4, 6, 7), torch.float32, 14)
    want = torch.stack([x[i] @ w for i in range(3)])
    for in_dims, xs in ((0, x), (1, x.transpose(0, 1).contiguous())):
        got = torch.func.vmap(lambda t: tmoe.expert_matmul(t, w), in_dims=in_dims)(xs)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(tmoe.expert_matmul(x[0], w), x[0] @ w)  # per task: the product
