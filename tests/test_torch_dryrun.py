"""The port's dry run (``repro_torch.launch.dryrun``) on the reference's three
small-mesh cells, the sharded families' training cells cut in depth, and
three prefill cells, against the reference's own dry run of the same cells
(``tests/test_dryrun_small.py``'s: ``build_lowering`` + ``analyze``).

Each cell runs on fake ``cpu`` tensors over a fake process group of its
mesh's size, in one of four subprocesses (the reference's cells in four
more, with 8 and 16 placeholder devices, each on one core), four at a
time, batch 8, remat on the training cells:
- whisper-tiny ``train_4k`` on ("data", "model") = (2, 4);
- llama3.2-1B ``decode_32k`` and ``prefill_32k`` on (2, 4);
- qwen3-1.7B ``train_4k`` on ("pod", "data", "model") = (2, 2, 4);
- falcon-mamba-7b ``train_4k`` cut to 2 layers on (2, 4) (the scan on each
  rank's d_inner shard);
- arctic ``train_4k`` cut to 1 layer on (2, 4) (the expert-parallel MoE
  with its dense residual, int8 moments);
- llama4-maverick ``train_4k`` and ``prefill_32k`` cut to 2 layers (its
  pattern: a dense block, then an MoE block with a dense residual) on
  (2, 4);
- jamba-1.5-large ``train_4k`` and ``prefill_32k`` cut to 8 layers (its
  period: attention at layer 0, Mamba at 1-7, dense MLPs and MoE blocks
  alternating) on (2, 4).
Each reaches ``status: "ok"`` with peak memory, FLOPs and wire bytes above
0, the multi-pod cell reduces over "pod", and the per-device FLOPs of each
cell are held within 2% of the reference's ``hlo_dot_flops_per_device``,
once the terms where one side does work the other does not are reckoned
from the shapes and named (``_terms``; the serving cells take none):
- the reference's attention backward (its chunked XLA path) computes the
  scores and dp twice, in its dq pass and in its dk/dv pass: two products
  a call more than the port's plain backward and its kernels' formula,
  2 b h S^2 (2 hd) a call, for each attention layer of the pattern's
  repeats (a decoder layer's self and cross attention, an encoder layer's);
- both remat one repeat of the pattern at a time (the reference
  checkpoints its scan body), and the port recomputes the whole repeat,
  its last block's last products too, whose results only the repeat's
  output sums and the backward never reads: the reference's compiler
  drops them as dead.  A repeat's last block's MLP output product
  (2 tokens d_ff / tp d), or an MoE block's dense residual's and the
  combine of its experts' outputs (2 tokens d (E / tp) C), or, where the
  block has no MLP, its Mamba mixer's out_proj (2 tokens d_inner / tp d),
  once for each repeat.
Where "model" does not divide the vocabulary (whisper's 51865) the table
gradient's product covers d / data columns a rank, as the reference's does;
where it divides, the loss is vocabulary-parallel (qwen3).  Neither takes a
term.

And each cell's collectives are held to the reference's: the wire bytes a
device (the ring model of ``utils.op_stats``, which is the reference's) are
at most 1.05x the reference's in all, and kind by kind, all-reduce and
reduce-scatter together as reductions (a reduce-scatter and an all-gather
make one all-reduce), all-gather, all-to-all and collective-permute each
on its own.  A Shard -> Shard redistribution counts as the one all-to-all
it is on the card, not as DTensor's all-gather for gloo.

And a mesh-free training step's ``FlopCounterMode`` count equals a (1, 1)
dry run's per-device FLOPs.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

import repro_torch.configs as tcfgs
from repro_torch.kernels.flash_attention.sharded import plan_heads
from repro_torch.models.moe import expert_capacity, routing_group_size

ROOT = Path(__file__).resolve().parents[1]
TOL = 0.02
BATCH = 8
# name: (arch, shape, mesh, config overrides: the depth cut)
CELLS = {"whisper": ("whisper_tiny", "train_4k", (2, 4), {}),
         "llama": ("llama3p2_1b", "decode_32k", (2, 4), {}),
         "qwen3": ("qwen3_1p7b", "train_4k", (2, 2, 4), {}),
         "falcon_mamba": ("falcon_mamba_7b", "train_4k", (2, 4), {"n_layers": 2}),
         "arctic": ("arctic_480b", "train_4k", (2, 4), {"n_layers": 1}),
         "llama4": ("llama4_maverick_400b_a17b", "train_4k", (2, 4), {"n_layers": 2}),
         "jamba": ("jamba_1p5_large_398b", "train_4k", (2, 4), {"n_layers": 8}),
         "llama_prefill": ("llama3p2_1b", "prefill_32k", (2, 4), {}),
         "llama4_prefill": ("llama4_maverick_400b_a17b", "prefill_32k", (2, 4), {"n_layers": 2}),
         "jamba_prefill": ("jamba_1p5_large_398b", "prefill_32k", (2, 4), {"n_layers": 8})}
# the cells of each subprocess, longest first (alone, the reference's on one
# core each: its jamba train cell 75-110 s; the port's jamba cells 85-110 s
# each on the plain scan; the other groups 20-70 s; the multi-pod cell on 16
# placeholder devices)
RUNS = (("reference", ("jamba",)),
        ("port", ("jamba_prefill",)),
        ("port", ("jamba",)),
        ("reference", ("whisper", "llama", "falcon_mamba", "arctic")),
        ("reference", ("llama4", "llama_prefill", "llama4_prefill", "jamba_prefill")),
        ("port", ("qwen3", "falcon_mamba", "arctic", "whisper")),
        ("port", ("llama", "llama4", "llama_prefill", "llama4_prefill")),
        ("reference", ("qwen3",)))
WIRE = 1.05
# wire-byte kinds: the reference's opcodes each compares
KINDS = {"reductions": ("all-reduce", "reduce-scatter"), "all-gather": ("all-gather",),
         "all-to-all": ("all-to-all",), "collective-permute": ("collective-permute",)}
AXES = ("pod", "data", "model")

PORT = """
import json
from repro_torch.launch.dryrun import run_mesh
out = {{}}
for name, (arch, shape, mesh, over) in {cells!r}.items():
    out[name] = run_mesh(arch, shape, mesh, {axes!r}[-len(mesh):], device="cpu",
                         batch_override={batch},
                         train_overrides={{"remat": True, **over}} if shape.startswith("train")
                         else over)
print("RESULT" + json.dumps(out))
"""

REFERENCE = """
import os
# one core, each of the reference's runs its own: XLA's and LLVM's compile
# pools size themselves to it
cpus = sorted(os.sched_getaffinity(0))
os.sched_setaffinity(0, [cpus[-1 - {core} % len(cpus)]])
os.environ["DRYRUN_DEVICES"] = "{devices}"  # the placeholders repro.launch.dryrun makes
import json
import repro.launch.dryrun as dr
from repro.launch.mesh import make_mesh
out = {{}}
for name, (arch, shape, mesh, over) in {cells!r}.items():
    lowered, _ = dr.build_lowering(arch, shape, make_mesh(mesh, {axes!r}[-len(mesh):]),
                                   batch_override={batch},
                                   train_overrides={{"remat": True, **over}}
                                   if shape.startswith("train") else over)
    rec = dr.analyze(lowered, mesh=make_mesh(mesh, {axes!r}[-len(mesh):]))
    out[name] = {{"flops": rec["hlo_dot_flops_per_device"],
                  "collectives": rec["collectives"], "memory": rec["memory"]}}
print("RESULT" + json.dumps(out))
"""

MESH_FREE = """
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
import repro_torch.configs as cfgs
from repro_torch.launch.dryrun import faked, run_mesh
from repro_torch.utils.op_stats import EXTRA_FLOPS
from repro_torch.models import build
from repro_torch.models.layers import ShapeInit
from repro_torch.runtime.train_loop import TrainConfig, make_train_state, make_train_step
# no remat: FlopCounterMode's module tracker refuses the nested
# autograd.grad of remat's backward
over = {"n_layers": 2}
rec = run_mesh("qwen3_1p7b", "train_4k", (1, 1), ("data", "model"), device="cpu",
               batch_override=4, train_overrides=over)
api = build(cfgs.get("qwen3_1p7b").replace(**over))
with faked(FakeTensorMode(allow_non_fake_inputs=True)):
    state = make_train_state(api, TrainConfig(), params=api.init(ShapeInit("cpu")))
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in api.input_specs("train_4k", batch_override=4).items()}
    with FlopCounterMode(display=False, custom_mapping=EXTRA_FLOPS) as fc:
        make_train_step(api, TrainConfig())(state, batch)
print("RESULT" + json.dumps({"mesh_free": fc.get_total_flops(),
                             "dry_run": rec["dot_flops_per_device"]}))
"""


def _start(code: str):
    """``code`` in a subprocess on one thread of torch's (the reference's
    script pins itself to one core): the dry runs trace and compile, and
    run nothing that a pool as wide as the machine would speed up."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _result(proc, limit):
    try:
        out, err = proc.communicate(timeout=max(limit - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    line = next(s for s in out.splitlines() if s.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module")
def runs():
    return run_all()


def run_all():
    """Every cell of both packages, and the mesh-free comparison:
    {"port": {cell: record}, "reference": {cell: ...}, "mesh_free": ...}.
    ``RUNS``' subprocesses and the mesh-free comparison, four at a time in
    that order."""
    def code(kind, names, core):
        cells = {k: CELLS[k] for k in names}
        if kind == "port":
            return PORT.format(cells=cells, axes=AXES, batch=BATCH)
        devices = math.prod(CELLS[names[0]][2])
        assert all(math.prod(c[2]) == devices for c in cells.values())
        return REFERENCE.format(devices=devices, cells=cells, axes=AXES, batch=BATCH, core=core)

    for side in ("port", "reference"):  # each cell once a side
        assert sorted(k for kind, names in RUNS if kind == side for k in names) == sorted(CELLS)
    jobs = [(kind, code(kind, names, i)) for i, (kind, names) in enumerate(RUNS)] + [
        ("mesh_free", MESH_FREE)]
    limit = time.monotonic() + 900
    started = []

    def run(src):
        if time.monotonic() > limit:
            raise AssertionError("the dry runs did not finish in 900 s")
        proc = _start(src)
        started.append(proc)
        return _result(proc, limit)

    out = {"port": {}, "reference": {}}
    with ThreadPoolExecutor(4) as pool:
        futures = [(kind, pool.submit(run, src)) for kind, src in jobs]
        try:
            for kind, future in futures:
                if kind == "mesh_free":
                    out["mesh_free"] = future.result()
                else:
                    out[kind].update(future.result())
        finally:  # on a failure: nothing more starts, and nothing is left running
            for _, future in futures:
                future.cancel()
            for proc in started:
                if proc.poll() is None:
                    proc.kill()
    return out


def _terms(name):
    """{term: reference's FLOPs minus the port's}, per device, reckoned
    from the cell's shapes and its layer pattern."""
    arch, shape, mesh, over = CELLS[name]
    if not shape.startswith("train"):
        return {}
    cfg = tcfgs.get(arch).replace(**over)
    sizes = dict(zip(AXES[-len(mesh):], mesh))
    dp = sizes["data"] * sizes.get("pod", 1)
    tp = sizes["model"]
    b, S, d = BATCH // dp, 4096, cfg.d_model
    tokens = b * S
    plan = plan_heads(cfg.n_heads, cfg.n_kv_heads, tp)
    heads = (plan.Hp if plan else cfg.n_heads) // tp
    # the pattern's repeats (an encoder's layers repeat it too: every
    # encoder frame count is S), and the attention calls in them
    repeats = (cfg.n_layers + cfg.n_encoder_layers) // len(cfg.pattern)
    attention = sum(spec.mixer == "attn" for spec in cfg.pattern) * cfg.n_layers // len(
        cfg.pattern)
    calls = (attention * 2 + cfg.n_encoder_layers if cfg.is_encoder_decoder else attention)
    # the last products of a repeat's last block
    last = cfg.pattern[-1]
    if last.mlp == "dense":
        widths, combine = [cfg.d_ff], 0
    elif last.mlp == "moe":
        moe = cfg.moe
        widths = [moe.dense_residual_ff or cfg.d_ff] if moe.dense_residual else []
        C = expert_capacity(cfg, routing_group_size(cfg, S))
        combine = 2 * tokens * d * (moe.n_experts // tp) * C
    else:  # no MLP: the Mamba mixer's out_proj
        widths, combine = [cfg.d_inner], 0
    return {
        "attention backward: scores and dp once more": (
            calls * 2 * b * heads * S * S * (cfg.head_dim + cfg.head_dim)),
        "remat: a repeat's last products recomputed, dead to the backward": -repeats * (
            sum(2 * tokens * (w // tp) * d for w in widths) + combine),
    }


@pytest.mark.parametrize("name", list(CELLS))
def test_the_cell_runs_sharded(runs, name):
    rec = runs["port"][name]
    arch, shape, mesh, _ = CELLS[name]
    assert rec["n_chips"] == math.prod(mesh)
    assert rec["mesh_shape"] == list(mesh) and rec["device"] == "cpu"
    assert rec["memory"]["peak_bytes_per_device"] > rec["memory"]["argument_bytes"] > 0
    assert rec["dot_flops_per_device"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    assert rec["kernel_ops"] == {}  # cpu tensors: the plain versions


def test_the_multi_pod_cell_reduces_over_pod(runs):
    rec = runs["port"]["qwen3"]
    assert rec["mesh_axes"] == ["pod", "data", "model"]
    # the batch is split over ("pod", "data"): reductions over groups that span "pod"
    pod = {k: n for k, n in rec["collective_groups"].items()
           if k.split("@")[0] in ("all-reduce", "reduce-scatter") and "pod" in k}
    assert sum(pod.values()) > 0, rec["collective_groups"]


def _reckoned(runs, name):
    got = runs["port"][name]["dot_flops_per_device"]
    terms = _terms(name)
    reckoned = got + sum(terms.values())
    detail = ", ".join(f"{k}: {v:.4g}" for k, v in terms.items())
    return reckoned, runs["reference"][name]["flops"], (
        f"{name}: port {got:.6g}, reckoned {reckoned:.6g} ({detail})")


@pytest.mark.parametrize("name", list(CELLS))
def test_per_device_flops_are_the_references_within_2pct(runs, name):
    reckoned, want, detail = _reckoned(runs, name)
    assert abs(reckoned - want) <= TOL * want, f"{detail}, reference {want:.6g}"


def _wire_terms(name):
    """{kind: {term: the port's wire bytes a device the reference has no
    counterpart for}}, reckoned from the cell's shapes.  Only the serving
    step of one token takes a term: its products contract over "data" (the
    weights' rows, d, are over "data"), so each product's output, partial
    over "data", goes back to the rank's rows by a reduce-scatter, where
    the reference gathers the weights whole over "data" first (its
    all-gathers of f32[2048, 2048] and the like).  The normed input goes
    to d / data once for the attention and once for the MLP
    (``hints.contraction_layout``), one all-to-all each, as many as the
    reference's: no term."""
    arch, shape, mesh, over = CELLS[name]
    if not shape.startswith("decode"):
        return {}
    cfg = tcfgs.get(arch).replace(**over)
    sizes = dict(zip(AXES[-len(mesh):], mesh))
    D, tp = sizes["data"], sizes["model"]
    b, hd = BATCH // D, cfg.head_dim
    nbytes = {"bfloat16": 2, "float32": 4}[cfg.compute_dtype]
    n = cfg.n_layers // len(cfg.pattern)
    attention = n * sum(spec.mixer == "attn" for spec in cfg.pattern)
    dense = n * sum(spec.mlp == "dense" for spec in cfg.pattern)
    return {
        "reductions": {
            "the outputs reduce-scattered to the rows": (D - 1) * (
                attention * b * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd * nbytes
                + dense * 2 * b * (cfg.d_ff // tp) * nbytes
                + b * (cfg.vocab_size // tp) * 4)},  # the fp32 logits
    }


def _wire(collectives, ops):
    return sum(collectives["wire_bytes"].get(op, 0.0) for op in ops)


@pytest.mark.parametrize("name", list(CELLS))
def test_wire_bytes_are_at_most_the_references(runs, name):
    """A device's wire bytes at most 1.05x the reference's, in all and kind
    by kind, once the kind's named terms (``_wire_terms``) are taken off."""
    got, want = runs["port"][name]["collectives"], runs["reference"][name]["collectives"]
    assert got["total_wire_bytes"] <= WIRE * want["total_wire_bytes"], (
        f"{name}: port {got['wire_bytes']}, reference {want['wire_bytes']}")
    terms = _wire_terms(name)
    for kind, ops in KINDS.items():
        named = terms.get(kind, {})
        mine, theirs = _wire(got, ops) - sum(named.values()), _wire(want, ops)
        assert mine <= WIRE * theirs, (f"{name} {kind}: port {mine:.6g} less {named}, "
                                       f"reference {theirs:.6g}")


def test_a_mesh_free_steps_flop_count_is_a_one_rank_dry_runs(runs):
    free = runs["mesh_free"]
    assert free["mesh_free"] == free["dry_run"] > 0


PLACEMENTS = """
import json
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from repro_torch.kernels.flash_attention.sharded import flash_attention_tp
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding.hints import mesh_axes, reduce_partial, use_mesh
torch.manual_seed(0)
out = {}
with fake_world(4):
    mesh = make_mesh((1, 4), ("data", "model"), device_type="cpu")
    q = distribute_tensor(torch.randn(2, 64, 4, 32), mesh, [Replicate(), Shard(2)],
                          src_data_rank=None)
    k, v = (distribute_tensor(torch.randn(2, 64, 2, 32), mesh, [Replicate(), Replicate()],
                              src_data_rank=None) for _ in range(2))
    with use_mesh(mesh), mesh_axes(("data", "model")):
        out["attention"] = str(list(flash_attention_tp(q, k, v).placements))
    x = DTensor.from_local(torch.randn(2, 8), mesh, [Replicate(), Partial()]).requires_grad_()
    y = reduce_partial(x)
    g = DTensor.from_local(torch.randn(2, 8), mesh, [Replicate(), Partial()])
    (gx,) = torch.autograd.grad(y, x, g)
    out["forward"], out["backward"] = str(list(y.placements)), str(list(gx.placements))
print("RESULT" + json.dumps(out))
"""


def test_products_after_attention_and_norms_stay_tensor_parallel():
    """On a (1, 4) mesh: attention whose 2 kv heads the plan duplicates to
    4 hands back its 4 heads sharded over "model", not gathered (the
    output projection and its weight's gradient then run on each rank's
    heads); a residual norm's input with a partial sum over "model" is
    reduced first, and so is its gradient (the products that follow a
    norm, and the backward's, then keep their weights sharded)."""
    res = _result(_start(PLACEMENTS), time.monotonic() + 300)
    # the attention's output: batch over "data", heads over "model"
    assert res == {"attention": "[Shard(dim=0), Shard(dim=2)]",
                   "forward": "[Replicate(), Replicate()]",
                   "backward": "[Replicate(), Replicate()]"}, res
