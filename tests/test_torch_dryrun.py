"""The port's dry run (``repro_torch.launch.dryrun``) on the reference's three
small-mesh cells and two sharded families cut in depth, against the
reference's own dry run of the same cells (``tests/test_dryrun_small.py``'s:
``build_lowering`` + ``analyze``).

Each cell runs on fake ``cpu`` tensors over a fake process group of its
mesh's size, in one of two subprocesses (the reference's cells in two
more, with 8 and 16 placeholder devices), two at a time:
- whisper-tiny ``train_4k`` on ("data", "model") = (2, 4), batch 8, remat;
- llama3.2-1B ``decode_32k`` on (2, 4), batch 8;
- qwen3-1.7B ``train_4k`` on ("pod", "data", "model") = (2, 2, 4), batch 8,
  remat;
- falcon-mamba-7b ``train_4k`` cut to 2 layers on (2, 4), batch 8, remat
  (the scan on each rank's d_inner shard);
- arctic ``train_4k`` cut to 1 layer on (2, 4), batch 8, remat (the
  expert-parallel MoE with its dense residual, int8 moments).
Each reaches ``status: "ok"`` with peak memory, FLOPs and wire bytes above
0, the multi-pod cell reduces over "pod", and the per-device FLOPs of each
cell are held within 2% of the reference's ``hlo_dot_flops_per_device``,
once the terms where one side does work the other does not are reckoned
from the shapes and named (``_terms``):
- the reference's attention backward (its chunked XLA path) computes the
  scores and dp twice, in its dq pass and in its dk/dv pass: two products
  a call more than the port's plain backward and its kernels' formula;
- the port's remat recomputes the whole block, its last product too (the
  MLP's output product, an MoE block's dense residual's, or a Mamba
  block's out_proj), whose result the backward never reads: the
  reference's compiler drops that product as dead;
- where "model" does not divide the vocabulary (whisper's 51865), each
  rank takes the whole table, as the reference's does, but the reference
  splits the table gradient's columns between the "model" ranks, d / data
  a rank (the table's d is over "data"; its dot is f32[V, d / data] from
  the rank's rows, all-reduced over "data"), where the port's gradient
  covers all of d.
Where "model" divides the vocabulary the loss is vocabulary-parallel, as
the reference lays its logits out, and takes no term (qwen3).
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
from pathlib import Path

import pytest

import repro_torch.configs as tcfgs
from repro_torch.kernels.flash_attention.sharded import plan_heads

ROOT = Path(__file__).resolve().parents[1]
TOL = 0.02
BATCH = 8
# name: (arch, shape, mesh, config overrides: the depth cut)
CELLS = {"whisper": ("whisper_tiny", "train_4k", (2, 4), {}),
         "llama": ("llama3p2_1b", "decode_32k", (2, 4), {}),
         "qwen3": ("qwen3_1p7b", "train_4k", (2, 2, 4), {}),
         "falcon_mamba": ("falcon_mamba_7b", "train_4k", (2, 4), {"n_layers": 2}),
         "arctic": ("arctic_480b", "train_4k", (2, 4), {"n_layers": 1})}
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
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={devices}"
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
                  "collectives": rec["collectives"]["count"]}}
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
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
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
    """Every cell of both packages, and the mesh-free comparison:
    {"port": {cell: record}, "reference": {cell: ...}, "mesh_free": ...}.
    The multi-pod cell, the longest, and the two families' cells run in one
    process beside the others, which run one at a time: two processes at
    once."""
    def port(names):
        return PORT.format(cells={k: CELLS[k] for k in names}, axes=AXES, batch=BATCH)

    def reference(n, names):
        return REFERENCE.format(devices=n, cells={k: CELLS[k] for k in names}, axes=AXES,
                                batch=BATCH)

    limit = time.monotonic() + 900
    beside = _start(port(("qwen3", "falcon_mamba", "arctic")))
    out = {"port": {}, "reference": {}}
    try:
        for kind, code in (("port", port(("whisper", "llama"))),
                           ("reference", reference(8, ("whisper", "llama", "falcon_mamba",
                                                       "arctic"))),
                           ("reference", reference(16, ("qwen3",))),
                           ("mesh_free", MESH_FREE)):
            res = _result(_start(code), limit)
            if kind == "mesh_free":
                out["mesh_free"] = res
            else:
                out[kind].update(res)
        out["port"].update(_result(beside, limit))
        return out
    finally:
        if beside.poll() is None:
            beside.kill()


def _terms(name):
    """{term: reference's FLOPs minus the port's}, per device, reckoned
    from the cell's shapes."""
    arch, shape, mesh, over = CELLS[name]
    cfg = tcfgs.get(arch).replace(**over)
    sizes = dict(zip(AXES[-len(mesh):], mesh))
    dp = sizes["data"] * sizes.get("pod", 1)
    tp = sizes["model"]
    b, S, V, d = BATCH // dp, 4096, cfg.vocab_size, cfg.d_model
    if not shape.startswith("train"):
        return {}
    plan = plan_heads(cfg.n_heads, cfg.n_kv_heads, tp)
    heads = (plan.Hp if plan else cfg.n_heads) // tp
    calls = (0 if cfg.attention == "none" else
             cfg.n_layers * (2 if cfg.is_encoder_decoder else 1) + cfg.n_encoder_layers)
    blocks = cfg.n_layers + cfg.n_encoder_layers  # every encoder frame count is S too
    # a block's last product: its MLP's (an MoE block's dense residual), or
    # where the block has none, its Mamba mixer's out_proj
    last = cfg.d_ff if cfg.d_ff else cfg.d_inner
    tokens = b * S
    return {
        "attention backward: scores and dp once more": (
            calls * 2 * b * heads * S * S * (cfg.head_dim + cfg.head_dim)),
        "remat: the block's last product recomputed, dead to the backward": (
            -blocks * 2 * tokens * (last // tp) * d),
        "loss table gradient, a vocabulary 'model' does not divide: all of d a rank": (
            -2 * tokens * V * d * (1 - 1 / sizes["data"])) if V % tp else 0,
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
