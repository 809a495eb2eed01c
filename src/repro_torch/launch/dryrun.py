"""The dry run: one sharded step on fake tensors over a fake process group,
for every (arch x shape x mesh) cell: the reference package's
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell for a fleet of placeholder
devices.  The port runs the step itself, eagerly, on fake tensors
(``torch._subclasses.FakeTensorMode``: shapes, dtypes and devices, no
storage) as rank 0 of a fake process group as large as the production
mesh (16 x 16 cards, or 2 x 16 x 16), laid out by the port's specs
(``tree_partition_specs`` through ``distribute_model``, and the batch,
cache and optimizer specs).  ``utils.op_stats`` records what rank 0's
local ops do, so each cell gives, per device and with nothing allocated:

  * proof that the distribution is coherent (the step runs),
  * peak memory: the most bytes of local storages alive at once, the
    step's resident arguments included; training state is updated in
    place, so it counts once, as the reference's donation counts it,
  * matmul FLOPs (``torch.utils.flop_counter``'s registry and the
    kernels' own formulas: each kernel counts the full grid its plain
    version computes) and bytes accessed,
  * the collective schedule (the ``_c10d_functional`` ops DTensor and
    ``local_map`` issue),

all dumped as JSON for the roofline (``launch/roofline.py``).  On the
card (``--device cuda``, the default) the fake tensors are CUDA tensors
and each kernel wrapper enters its ``torch.library`` op, whose fake impl
runs: nothing is built or launched.  ``--device cpu`` runs the plain
versions instead, which count the same FLOPs.  There is no fallback: a
cell that cannot run on the device named fails, with the first op that
failed in its record.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_1p7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers the "fake" backend)
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils._pytree import tree_leaves

import repro_torch.configs as cfgs
from repro_torch.launch.mesh import HW, make_mesh
from repro_torch.models.layers import ShapeInit
from repro_torch.models.registry import SHAPES, ShapeCell, build, cell_applicable
from repro_torch.runtime.train_loop import TrainConfig, make_train_state, make_train_step
from repro_torch.sharding.hints import _zip_tree, mesh_axes, use_mesh
from repro_torch.sharding.specs import (cache_partition_specs, distribute, distribute_batch,
                                        distribute_model, mesh_sizes)
from repro_torch.utils.op_stats import OpStatsMode

OUT_DIR = os.path.join("build", "dryrun")


@dataclass
class Step:
    """One cell's step: ``fn(*args)`` on fake tensors, inside
    ``fake_mode``; ``args`` are the resident arguments (weights, optimizer
    state, batch, caches, the fp32 unembedding copy)."""
    fn: Callable
    args: tuple
    kind: str
    cfg: Any
    fake_mode: FakeTensorMode


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake default process group of ``world_size`` ranks, this process
    rank 0: collectives return at once and move nothing."""
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# DTensor's modules that ask funcol whether a compiler is tracing (a fake
# mode says yes): each holds its own name of the function
_TRACING_ASKERS = ("torch.distributed._functional_collectives",
                   "torch.distributed.tensor._dispatch",
                   "torch.distributed.tensor._redistribute",
                   "torch.distributed.tensor._decompositions")


@contextlib.contextmanager
def faked(fake_mode: FakeTensorMode):
    """``fake_mode`` entered, with DTensor running as in an eager step
    (torch 2.13; each patch only where its target exists, all restored on
    exit):

    - DTensor takes an active fake mode for a compiler's trace
      (``_are_we_tracing``): it then plans every redistribution anew, uncached,
      which took minutes an op on a 3-D mesh, and issues the collectives in
      their traced form.  The dry run models an eager step, so DTensor is
      told that nothing traces;
    - a strided shard's index arithmetic
      (``_StridedShard.local_shard_size_and_offset``) runs on real tensors
      under no mode: it reads offsets by ``.tolist()`` of an index tensor it
      makes, which the fake mode would make fake and refuse to read;
    - a Shard -> Shard redistribution over a fake group goes out as the
      one all-to-all it is on the card (``_dtensor::shard_dim_alltoall``),
      also on a ``cpu`` mesh: DTensor falls back there to an all-gather and
      a chunk, for gloo, which has no all-to-all.  A real group keeps the
      fallback."""
    import importlib
    import sys

    from torch.distributed.tensor import _collective_utils
    from torch.distributed.tensor.placement_types import _StridedShard

    patches = []
    for name in _TRACING_ASKERS:
        mod = importlib.import_module(name)
        if hasattr(mod, "_are_we_tracing"):
            patches.append((mod, "_are_we_tracing", mod._are_we_tracing, lambda: False))
    alltoall = getattr(_collective_utils, "shard_dim_alltoall", None)
    if alltoall is not None:
        @functools.wraps(alltoall)
        def as_on_the_card(input, gather_dim, shard_dim, mesh, mesh_dim):
            group = mesh.get_group(mesh_dim)
            if dist.get_backend(group) != "fake":
                return alltoall(input, gather_dim, shard_dim, mesh, mesh_dim)
            return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                         group.group_name)

        # every module of DTensor that holds the function by its own name
        patches += [(mod, "shard_dim_alltoall", alltoall, as_on_the_card)
                    for name, mod in list(sys.modules.items())
                    if name.startswith("torch.distributed.tensor")
                    and getattr(mod, "shard_dim_alltoall", None) is alltoall]
    index_math = _StridedShard.__dict__.get("local_shard_size_and_offset")
    if index_math is not None:
        @functools.wraps(index_math)
        def on_real_tensors(*args, **kwargs):
            with _disable_current_modes():
                return index_math(*args, **kwargs)

        patches.append((_StridedShard, "local_shard_size_and_offset", index_math,
                        on_real_tensors))
    for owner, attr, _, new in patches:
        setattr(owner, attr, new)
    try:
        with fake_mode:
            yield
    finally:
        for owner, attr, old, _ in patches:
            setattr(owner, attr, old)


def _fake_batch(specs: dict, device) -> dict:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in specs.items()}


def build_step(arch: str, shape_name: str | ShapeCell, mesh, *,
               train_overrides: dict | None = None, batch_override: int | None = None,
               opt_overrides: dict | None = None, device=None) -> Step:
    """The counterpart of ``build_lowering``: one cell's step on fake
    tensors on ``mesh`` (a ``DeviceMesh`` of the fake world, on
    ``device``, by default the mesh's device type).  ``shape_name`` names
    a cell of ``SHAPES``, or is a ``ShapeCell`` of its own."""
    cfg = cfgs.get(arch)
    if train_overrides:
        cfg = cfg.replace(**train_overrides)
    api = build(cfg)
    axes = tuple(mesh.mesh_dim_names)
    cell = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    device = torch.device(device or mesh.device_type)
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)  # the mesh's own tensors are real
    with faked(fake_mode):
        model = distribute_model(api.init(ShapeInit(device)), mesh)
        batch = _fake_batch(api.input_specs(shape_name, batch_override=batch_override), device)
        if cell.kind == "train":
            tc = TrainConfig(**(opt_overrides or {}))
            state = make_train_state(api, tc, params=model)
            return Step(make_train_step(api, tc, axes=axes), (state, batch), "train", cfg,
                        fake_mode)

        def on_mesh(fn):
            def run(model, batch, *rest):
                with use_mesh(mesh), mesh_axes(axes):
                    return fn(model, distribute_batch(batch, mesh), *rest)
            return run

        table = model.head().table_f32()  # resident beside the weights, as when serving
        if cell.kind == "prefill":
            def prefill(model, batch, table):
                return api.prefill(model, batch)

            return Step(on_mesh(prefill), (model, batch, table), "prefill", cfg, fake_mode)
        B = batch_override or cell.global_batch
        sizes = mesh_sizes(mesh)
        dp = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
        caches = api.make_caches(model, B, cell.seq_len)
        specs = cache_partition_specs(caches, axes, global_batch=B, dp_size=dp,
                                      axis_sizes=sizes)
        caches = _zip_tree(lambda t, spec: distribute(t, spec, mesh), caches, specs)
        # the last slot: every cache chunk holds keys, the reference's whole-cache work
        batch["cache_index"] = cell.seq_len - 1
        long_ctx = isinstance(shape_name, str) and shape_name.startswith("long")

        def decode(model, batch, caches, table):
            return api.decode(model, batch, caches, long_context=long_ctx)

        return Step(on_mesh(decode), (model, batch, caches, table), "decode", cfg, fake_mode)


def _local_storages(tree) -> dict:
    """{id: nbytes} of the local storages of a tree's tensors."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            out[id(s)] = s.nbytes()
    return out


def _resident(args) -> list:
    """The tensors of a step's arguments: a model's parameters and every
    tensor of the dicts and lists."""
    out = []
    for a in args:
        if isinstance(a, torch.nn.Module):
            out += list(a.parameters())
        elif isinstance(a, dict) and "params" in a:  # a training state
            out += list(a["params"].parameters()) + tree_leaves(a["opt"])
        else:
            out += tree_leaves(a)
    return out


def analyze(step: Step, *, mesh) -> dict:
    """Runs the step under ``OpStatsMode``; the record's per-device
    numbers."""
    resident = _resident(step.args)
    args_st = _local_storages(resident)
    with faked(step.fake_mode), OpStatsMode(resident) as mode:
        try:
            out = step.fn(*step.args)
        except Exception as e:
            e.failed_op = None if mode.last_op is None else str(mode.last_op)
            raise
        out_st = _local_storages(out)
    res = mode.result
    argument = sum(args_st.values())
    output = sum(n for k, n in out_st.items() if k not in args_st)
    return {
        "n_chips": int(mesh.size()),
        "mesh_shape": list(mesh.mesh.shape),
        "mesh_axes": list(mesh.mesh_dim_names),
        "device": str(next(t for t in resident if isinstance(t, torch.Tensor)).device),
        "memory": {
            "argument_bytes": int(argument),
            "output_bytes": int(output),
            "temp_bytes": int(res.peak_bytes - argument - output),
            "peak_bytes_per_device": int(res.peak_bytes),
            "hbm_bytes_per_device": int(HW["hbm_bytes"]),
        },
        # the local ops of one rank: per device, loops unrolled
        "dot_flops_per_device": res.dot_flops,
        "bytes_accessed_per_device": res.bytes_accessed,
        "kernel_ops": dict(res.kernel_ops),
        "kernel_flops_per_device": res.kernel_flops,
        "collectives": res.collectives.as_dict(),
        "collective_groups": dict(res.collective_groups),
    }


def run_mesh(arch: str, shape_name: str | ShapeCell, shape, axes=None, *,
             device: str = "cuda", **kw) -> dict:
    """One cell on a mesh of ``shape`` (e.g. (16, 16), a test-sized (2, 4),
    or (1, 1) beside one card's real step) in a fake world of its size:
    ``analyze``'s record, ``trace_s``, ``kind`` and the config's
    parameter counts."""
    with fake_world(math.prod(shape)):
        mesh = make_mesh(shape, axes, device_type=device)
        t0 = time.perf_counter()
        step = build_step(arch, shape_name, mesh, **kw)
        rec = analyze(step, mesh=mesh)
        rec["trace_s"] = time.perf_counter() - t0
    rec["kind"] = step.kind
    rec["params_total"], rec["params_active"] = step.cfg.param_counts()
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, train_overrides: dict | None = None,
             *, device: str = "cuda", **kw) -> dict:
    """One cell on the production mesh (16 x 16, or 2 x 16 x 16)."""
    rec = {"arch": arch, "shape": shape_name, "mesh": "multi" if multi_pod else "single"}
    ok, reason = cell_applicable(cfgs.get(arch), shape_name)
    if not ok:
        return {**rec, "status": "skipped", "reason": reason}
    if SHAPES[shape_name].kind == "train":
        # full block remat is the production policy at 4k x 256 batch
        train_overrides = {"remat": True, **(train_overrides or {})}
    shape = (2, 16, 16) if multi_pod else (16, 16)
    rec.update(run_mesh(arch, shape_name, shape, device=device,
                        train_overrides=train_overrides, **kw))
    rec["status"] = "ok"
    return rec


def _error(arch, shape, multi_pod, e) -> dict:
    return {"arch": arch, "shape": shape, "mesh": "multi" if multi_pod else "single",
            "status": "error", "error": repr(e), "failed_op": getattr(e, "failed_op", None),
            "traceback": traceback.format_exc()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", type=str, default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the device of the fake tensors (cuda: through the kernels' ops)")
    args = ap.parse_args(argv)

    archs = cfgs.ARCH_IDS if (args.all or args.arch is None) else [cfgs.canonical(args.arch)]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out_dir, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                path = os.path.join(args.out_dir, name + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip cached] {name}")
                    continue
                print(f"[dryrun] {name} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mp, device=args.device)
                except Exception as e:
                    rec = _error(arch, shape, mp, e)
                    failures += 1
                    print(f"  ERROR at {rec['failed_op']}: {e!r}"[:400])
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec.get("status") == "ok":
                    mem = rec["memory"]["peak_bytes_per_device"] / 2**30
                    print(f"  ok: trace {rec['trace_s']:.1f}s mem/dev {mem:.2f} GiB "
                          f"flops/dev {rec['dot_flops_per_device']:.4g} kernel ops "
                          f"{rec['kernel_ops']} collectives {rec['collectives']['count']}")
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
