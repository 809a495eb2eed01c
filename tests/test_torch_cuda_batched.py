"""Model programs under ``Service.execute_batch`` on the card: each
kernel entry folded by its vmap rule (``repro_torch/kernels/batched.py``)
launches once for N stacked tasks, and the folded launch equals N
per-task launches of the same kernel (flash forward and backward and the
scan bit for bit, decode within the reference's decode tolerance: folding
changes its KV split count); the differentiable flash attention under
``vmap(grad(...))`` launches its forward, dq and dk/dv once for N tasks;
the scan takes one ``A`` a batch row; a small fp32 qwen3's generate
program under ``execute_batch`` launches each kernel as often as one task
does.

Marked ``cuda``: these need a CUDA device (and ``nvcc``) and skip
elsewhere.  Run them on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_batched.py
"""

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfgs
from repro_torch.core import Service
from repro_torch.kernels import batched
from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import mamba_scan as tscan
from repro_torch.models import build as tbuild
from repro_torch.runtime.serve_loop import ServeConfig, make_generate_program

pytestmark = pytest.mark.cuda

LOGIT_TOL = 2e-3
N_TASKS, B, PROMPT, NEW = 3, 2, 8, 3
SC = ServeConfig(max_new_tokens=NEW, prompt_len=PROMPT, batch_per_task=B)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _one_launch(kern, entry, fn, *args):
    before, calls = kern.launches, batched.RULE_CALLS[entry]
    out = torch.func.vmap(fn)(*args)
    assert kern.launches == before + 1 and batched.RULE_CALLS[entry] == calls + 1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 512, 512, 16, 8, 128, 128, True),
                                   (2, 13, 13, 40, 40, 96, 64, True),
                                   (3, 64, 150, 6, 6, 64, 64, False)])
def test_card_folded_flash_is_bit_identical_to_per_task_launches(card, dtype, shape):
    B, Sq, Skv, H, K, D, Dv, causal = shape
    N = 4
    q = _card_randn((N, B, Sq, H, D), dtype, 1)
    k = _card_randn((N, B, Skv, K, D), dtype, 2)
    v = _card_randn((N, B, Skv, K, Dv), dtype, 3)
    out, lse = _one_launch(tflash.forward_kernel(dtype), "flash_attention_fwd",
                           lambda a, b, c: tflash.flash_attention_fwd(a, b, c, causal=causal),
                           q, k, v)
    for i in range(N):
        want_out, want_lse = tflash.flash_attention_fwd(q[i], k[i], v[i], causal=causal)
        assert torch.equal(out[i], want_out) and torch.equal(lse[i], want_lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_card_folded_decode_is_within_the_decode_tolerance(card, dtype):
    N, B, S, H, K, D, ci = 4, 4, 576, 16, 8, 128, 543
    q = _card_randn((N, B, 1, H, D), dtype, 4)
    kc, vc = _card_randn((N, B, S, K, D), dtype, 5), _card_randn((N, B, S, K, D), dtype, 6)
    got = _one_launch(tdecode.KERNEL, "decode_attention_fwd",
                      lambda a, b, c: tdecode.decode_attention_fwd(a, b, c, cache_index=ci),
                      q, kc, vc)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for i in range(N):
        want = tdecode.decode_attention_fwd(q[i], kc[i], vc[i], cache_index=ci)
        torch.testing.assert_close(got[i].float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("entry", ["mamba_scan", "DISPATCH.scan"])
def test_card_folded_scan_is_bit_identical_to_per_task_launches(card, entry):
    N, b, s, d, n = 4, 2, 300, 256, 16
    x = _card_randn((N, b, s, d), torch.float32, 7)
    dt = torch.nn.functional.softplus(_card_randn((N, b, s, d), torch.float32, 8))
    A = -torch.exp(_card_randn((d, n), torch.float32, 9) * 0.5)
    Bm, C = _card_randn((N, b, s, n), torch.float32, 10), _card_randn((N, b, s, n),
                                                                      torch.float32, 11)
    from repro_torch import kernels

    fn = tscan.mamba_scan if entry == "mamba_scan" else kernels.DISPATCH.scan
    y, hf = _one_launch(tscan.KERNEL, "mamba_scan",
                        lambda a, c, e, f: fn(a, c, A, e, f), x, dt, Bm, C)
    for i in range(N):
        want_y, want_h = tscan.mamba_scan_fwd(x[i], dt[i], A, Bm[i], C[i])
        assert torch.equal(y[i], want_y) and torch.equal(hf[i], want_h)


def _backward_launches(dtype):
    return tuple(k.launches for k in tflash.backward_kernels(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 512, 512, 16, 8, 128, 128, True),
                                   (2, 13, 13, 40, 8, 96, 64, True),
                                   (1, 64, 150, 6, 6, 64, 64, False)])
def test_card_folded_backward_is_bit_identical_to_per_task_launches(card, dtype, shape):
    """The backward entry under vmap: one dq and one dk/dv launch for N
    tasks (lse and Dvec folded with B), each task's gradients those of its
    own launches, bit for bit."""
    B, Sq, Skv, H, K, D, Dv, causal = shape
    N = 4
    q = _card_randn((N, B, Sq, H, D), dtype, 1)
    k = _card_randn((N, B, Skv, K, D), dtype, 2)
    v = _card_randn((N, B, Skv, K, Dv), dtype, 3)
    g = _card_randn((N, B, Sq, H, Dv), dtype, 4)
    out, lse = zip(*(tflash.flash_attention_fwd(q[i], k[i], v[i], causal=causal)
                     for i in range(N)))
    out, lse = torch.stack(out), torch.stack(lse)
    before, calls = _backward_launches(dtype), batched.RULE_CALLS["flash_attention_bwd"]
    got = torch.func.vmap(lambda *a: tflash.flash_attention_bwd(*a, causal=causal))(
        q, k, v, out, lse, g)
    assert _backward_launches(dtype) == tuple(n + 1 for n in before)
    assert batched.RULE_CALLS["flash_attention_bwd"] == calls + 1
    for i in range(N):
        want = tflash.flash_attention_bwd(q[i], k[i], v[i], out[i], lse[i], g[i],
                                          causal=causal)
        assert all(torch.equal(a[i], b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_card_training_under_vmap_grad_launches_one_tasks_count(card, dtype):
    """The differentiable flash attention under vmap(grad) on the card:
    one forward, one dq and one dk/dv launch for N tasks, each task's
    gradients within the backward check of per-task launches."""
    N, B, S, H, K, D = 4, 2, 256, 16, 8, 128
    q, k, v = (_card_randn((N, B, S, h, D), dtype, i) for i, h in ((1, H), (2, K), (3, K)))
    g = _card_randn((N, B, S, H, D), torch.float32, 4)

    def f(q, k, v, g):
        return (tflash.flash_attention(q, k, v).float() * g).sum()

    kerns = (tflash.forward_kernel(dtype),) + tflash.backward_kernels(dtype)
    before = tuple(kern.launches for kern in kerns)
    got = torch.func.vmap(torch.func.grad(f, argnums=(0, 1, 2)))(q, k, v, g)
    assert tuple(kern.launches for kern in kerns) == tuple(n + 1 for n in before)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for i in range(N):
        want = torch.func.grad(f, argnums=(0, 1, 2))(q[i], k[i], v[i], g[i])
        for a, b in zip(got, want):
            torch.testing.assert_close(a[i].float(), b.float(), atol=1e-4, rtol=tol)


def test_card_scan_takes_one_A_a_batch_row(card):
    """The scan kernel with A (b,d,n), read through its batch stride:
    within the scan check of the plain version, a ragged s too, and with
    every row's A the shared one, bit for bit the stride-0 launch."""
    for b, s, d, n in ((4, 512, 512, 16), (3, 77, 200, 16)):
        x = _card_randn((b, s, d), torch.float32, 21)
        dt = torch.nn.functional.softplus(_card_randn((b, s, d), torch.float32, 22))
        A = -torch.exp(_card_randn((b, d, n), torch.float32, 23) * 0.5)
        Bm, C = _card_randn((b, s, n), torch.float32, 24), _card_randn((b, s, n),
                                                                       torch.float32, 25)
        y, hf = tscan.mamba_scan_fwd(x, dt, A, Bm, C)
        want_y, want_h = tscan.mamba_scan_plain(x, dt, A, Bm, C)
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(hf, want_h, atol=1e-4, rtol=1e-4)
        shared = tscan.mamba_scan_fwd(x, dt, A[0], Bm, C)
        rows = tscan.mamba_scan_fwd(x, dt, A[0].expand(b, d, n), Bm, C)
        assert torch.equal(rows[0], shared[0]) and torch.equal(rows[1], shared[1])


def test_card_generate_program_under_execute_batch(card):
    """A small fp32 qwen3 (head dim 64, which the kernels take) through the
    generate program, per task and as one execute_batch on the card: the
    batched call launches each kernel as often as one task, and its tokens
    are the per-task ones wherever no step is a near-tie."""
    from repro_torch.kernels import KERNELS

    cfg = tcfgs.reduced(tcfgs.get("qwen3_1p7b")).replace(head_dim=64)
    api = tbuild(cfg)
    model = api.init(torch.Generator(device=card).manual_seed(0))
    rng = np.random.default_rng(9)
    payloads = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT)))}
                for _ in range(N_TASKS)]
    prog = make_generate_program(api, SC, model)
    svc = Service(None, device=card)
    per = []
    for p in payloads:
        for kern in KERNELS:
            kern.launches = 0
        per.append(svc.execute(prog, p))
        one = {kern.name: kern.launches for kern in KERNELS}
    for kern in KERNELS:
        kern.launches = 0
    bat = svc.execute_batch(prog, payloads)
    assert {kern.name: kern.launches for kern in KERNELS} == one
    assert one[tflash.SM90_FP32_KERNEL.name] == cfg.n_layers
    assert one[tdecode.KERNEL.name] == cfg.n_layers * NEW
    for p, a, b in zip(payloads, per, bat):
        gaps = _gaps(api, model, {"tokens": p["tokens"].to(card)})
        for row in range(B):
            near = gaps[row] <= LOGIT_TOL
            upto = int(np.argmax(near)) if near.any() else NEW
            assert torch.equal(b["generated"][row, :upto], a["generated"][row, :upto])


def _gaps(api, model, payload):
    """Top-2 logit gap of each prompt at each greedy step of the per-task
    generation: (B, NEW)."""
    lg, caches = api.prefill(model, payload, seq_budget=PROMPT + NEW)
    gaps = []
    for i in range(NEW):
        top2 = torch.topk(lg, 2, dim=-1).values
        gaps.append(top2[:, 0] - top2[:, 1])
        lg, caches = api.decode(model, {"tokens": lg.argmax(-1).to(torch.int32)[:, None],
                                        "cache_index": PROMPT + i}, caches)
    return torch.stack(gaps, 1).cpu().numpy()
