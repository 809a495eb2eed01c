"""Path-based partition rules: the reference package's GSPMD layout policy,
over ``torch.distributed`` meshes.

Strategy (mesh axes ("pod", "data", "model")):
  * weights: tensor-parallel dim over "model", FSDP dim over "data",
    replicated over "pod" (pods are farm services; they sync gradients, or
    nothing at all in farm-mode training).
  * MoE experts: expert dim over "model" (expert parallelism).
  * activations / token batches: batch over ("pod", "data").
  * KV caches: batch over ("pod", "data"), sequence over "model"
    (flash-decode-style sequence sharding, for any head count); when the
    batch is too small (B = 1) the sequence is sharded over every
    available axis instead.

A spec is a :class:`PartitionSpec`, a tuple with one entry a tensor dim:
None (replicated), a mesh axis name, or a tuple of names (the dim split
over those axes, the first one major).  Rules key on the parameter's path
in the reference's tree (its last name, or a suffix such as ``mlp/wi``)
and rank.  A port parameter's path is its name with ``/`` in place of
``.`` (``repro_torch.interop``'s ``_source``: block ``l`` is the
reference's ``blocks/b{i}``, ``patch_proj`` its ``patch_proj/w``); the
port keeps one tensor a layer, so its specs are the reference's without
the stacked layer axis.  Caches are a list of one dict a layer, and their
specs the reference's without that axis too.

:func:`placements` turns a spec into ``torch.distributed.tensor``
placements on a ``DeviceMesh``, and :func:`distribute_model` places a
model's parameters by their specs, the reference's ``in_shardings``.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

AXES = ("pod", "data", "model")


class PartitionSpec(tuple):
    """``P("data", None)``: one entry a tensor dim (trailing dims
    replicated), as jax's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __getnewargs__(self):
        return tuple(self)


P = PartitionSpec


def _fsdp(axes):
    return "data" if "data" in axes else None


def _dp(axes):
    dp = tuple(a for a in ("pod", "data") if a in axes)
    return dp if dp else None


def _model(axes):
    return "model" if "model" in axes else None


def _serve_rules(axes):
    """Inference layouts: weights are consumed read-only every step, so the
    FSDP dim must NOT require per-step gathers.  Contract-dim sharding over
    (data x model) turns every projection into local-matmul + tiny
    activation reduction instead of a full weight all-gather per token."""
    d, m = _fsdp(axes), _model(axes)
    wide = tuple(a for a in (d, m) if a) or None  # ("data","model")
    return [
        ("embed/table", 2, P(m, d)),
        ("lm_head/table", 2, P(m, d)),
        ("wq", 2, P(None, wide)),
        ("wk", 2, P(None, wide)),
        ("wv", 2, P(None, wide)),
        ("wo", 2, P(wide, None)),
        ("wq_a", 2, P(None, wide)),
        ("wq_b", 2, P(None, wide)),
        ("wkv_a", 2, P(None, wide)),
        ("wkv_b", 2, P(None, wide)),
        ("mlp/wi", 2, P(None, wide)),
        ("mlp/wg", 2, P(None, wide)),
        ("mlp/wo", 2, P(wide, None)),
        ("residual/wi", 2, P(None, wide)),
        ("residual/wg", 2, P(None, wide)),
        ("residual/wo", 2, P(wide, None)),
        ("router", 2, P(None, None)),
        ("experts/wi", 3, P(m, None, d)),
        ("experts/wg", 3, P(m, None, d)),
        ("experts/wo", 3, P(m, d, None)),
        ("in_proj", 2, P(None, wide)),
        ("conv_w", 2, P(None, wide)),
        ("conv_b", 1, P(wide)),
        ("x_proj", 2, P(wide, None)),
        ("dt_proj_w", 2, P(None, wide)),
        ("dt_proj_b", 1, P(wide)),
        ("A_log", 2, P(wide, None)),
        ("D", 1, P(wide)),
        ("out_proj", 2, P(wide, None)),
        ("patch_proj/w", 2, P(None, wide)),
    ]


# (name predicate, base rank, spec) — first match wins.
def _rules(axes):
    d, m = _fsdp(axes), _model(axes)
    return [
        # embeddings / unembedding: vocab over model, d over fsdp
        ("embed/table", 2, P(m, d)),
        ("lm_head/table", 2, P(m, d)),
        # attention projections
        ("wq", 2, P(d, m)),
        ("wk", 2, P(d, m)),
        ("wv", 2, P(d, m)),
        ("wo", 2, P(m, d)),
        # MLA
        ("wq_a", 2, P(d, m)),
        ("wq_b", 2, P(d, m)),
        ("wkv_a", 2, P(d, m)),
        ("wkv_b", 2, P(d, m)),
        # dense MLP
        ("mlp/wi", 2, P(d, m)),
        ("mlp/wg", 2, P(d, m)),
        ("mlp/wo", 2, P(m, d)),
        ("residual/wi", 2, P(d, m)),
        ("residual/wg", 2, P(d, m)),
        ("residual/wo", 2, P(m, d)),
        # MoE: expert-parallel over model; ff over the fsdp axis
        ("router", 2, P(d, None)),
        ("experts/wi", 3, P(m, None, d)),
        ("experts/wg", 3, P(m, None, d)),
        ("experts/wo", 3, P(m, d, None)),
        # mamba
        ("in_proj", 2, P(d, m)),
        ("conv_w", 2, P(None, m)),
        ("conv_b", 1, P(m)),
        ("x_proj", 2, P(m, None)),
        ("dt_proj_w", 2, P(None, m)),
        ("dt_proj_b", 1, P(m)),
        ("A_log", 2, P(m, None)),
        ("D", 1, P(m)),
        ("out_proj", 2, P(m, d)),
        # vlm stub projection
        ("patch_proj/w", 2, P(d, m)),
    ]


def _rank(leaf) -> int:
    shape = getattr(leaf, "shape", leaf)
    return len(tuple(shape))


def param_spec(path: str, leaf, axes, *, mode: str = "train") -> P:
    """The spec of the parameter at ``path`` (the reference's ``/`` path):
    the first rule whose name matches, with a leading None for each dim
    beyond the rule's rank; replicated where no rule matches.  ``leaf`` is
    a tensor or a shape."""
    rank = _rank(leaf)
    last = path.split("/")[-1]
    rules = _serve_rules(axes) if mode == "serve" else _rules(axes)
    for name, base_rank, spec in rules:
        if "/" in name:
            if not path.endswith(name):
                continue
        elif last != name:
            continue
        extra = rank - base_rank
        if extra < 0:
            return P()
        return P(*([None] * extra), *spec)
    # norms, biases, scalars: replicated
    return P(*([None] * rank))


def sanitize_spec(spec: P, shape, axis_sizes: Mapping[str, int] | None) -> P:
    """Drop sharding on any dim the mesh cannot divide evenly (odd vocab
    sizes, int8 scale blocks, batch=1 long-context cells)."""
    if axis_sizes is None:
        return spec
    shape = tuple(shape)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        k = 1
        for a in names:
            k *= axis_sizes.get(a, 1)
        out.append(entry if k > 0 and dim % k == 0 else None)
    return P(*out)


def param_path(name: str, cfg) -> str:
    """The reference's path of the port parameter ``name`` (without the
    stacked index)."""
    from repro_torch.interop import _source

    return "/".join(_source(name, cfg)[0])


def _named(params) -> tuple[dict, object]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters()), params.cfg
    return dict(params), None


def tree_partition_specs(params, axes, axis_sizes: Mapping[str, int] | None = None,
                         mode: str = "train", *, cfg=None) -> dict:
    """{name: spec} of a model's parameters, or of a ``{name: tensor or
    shape}`` mapping of the model of ``cfg`` (``ModelAPI.param_specs()``)."""
    named, model_cfg = _named(params)
    cfg = cfg or model_cfg
    if cfg is None:
        raise ValueError("tree_partition_specs needs cfg for a mapping of parameters")
    return {name: sanitize_spec(param_spec(param_path(name, cfg), leaf, axes, mode=mode),
                                getattr(leaf, "shape", leaf), axis_sizes)
            for name, leaf in named.items()}


# --------------------------------------------------------------------- #
# batches and caches
# --------------------------------------------------------------------- #
def batch_spec(name: str, leaf, axes) -> P:
    dp = _dp(axes)
    rank = _rank(leaf) if hasattr(leaf, "shape") else 0
    if name == "cache_index" or rank == 0:
        return P()
    return P(dp, *([None] * (rank - 1)))


def distribute_batch(batch: Mapping, mesh) -> dict:
    """A batch's tensors (the same on every rank) as DTensors laid out by
    ``batch_spec`` on ``mesh``'s axes, the reference's batch
    ``in_shardings``; DTensors and other values stay as they are."""
    axes = mesh.mesh_dim_names
    return {k: distribute(v, batch_spec(k, v, axes), mesh)
            if isinstance(v, torch.Tensor) and not isinstance(v, DTensor) else v
            for k, v in batch.items()}


def batch_partition_specs(batch: Mapping, axes,
                          axis_sizes: Mapping[str, int] | None = None) -> dict:
    return {k: sanitize_spec(batch_spec(k, v, axes),
                             getattr(v, "shape", ()), axis_sizes)
            for k, v in batch.items()}


def _map_cache(fn, tree, prefix=""):
    if isinstance(tree, Mapping):
        return {k: _map_cache(fn, sub, f"{prefix}/{k}" if prefix else str(k))
                for k, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_cache(fn, sub, f"{prefix}/{i}" if prefix else str(i))
                for i, sub in enumerate(tree)]
    return fn(prefix, tree)


def cache_partition_specs(caches, axes, *, global_batch: int, dp_size: int,
                          axis_sizes: Mapping[str, int] | None = None):
    """Specs of a model's caches (``make_caches``: one dict a layer):
    (B, S, K, hd) kv, (B, S, latent) MLA, (B, di, n) and (B, W-1, di)
    Mamba states; the same tree of specs."""
    dp = _dp(axes)
    m = _model(axes)
    shard_batch = global_batch >= dp_size and dp is not None

    def spec(p, leaf):
        rank = _rank(leaf)
        bdim = dp if shard_batch else None
        if "c_kv" in p or "k_rope" in p:  # (B,S,latent)
            s = P(bdim, m, None)
        elif p.endswith("/k") or p.endswith("/v"):  # (B,S,K,hd)
            if shard_batch:
                s = P(bdim, m, None, None)
            else:
                # B too small: spread sequence across everything
                seq_axes = tuple(a for a in AXES if a in axes)
                s = P(None, seq_axes, None, None)
        elif p.endswith("ssm"):  # (B,di,n)
            s = P(bdim, m, None)
        elif p.endswith("conv"):  # (B,W-1,di)
            s = P(bdim, None, m)
        else:
            s = P(*([None] * rank))
        return sanitize_spec(s, leaf.shape, axis_sizes)

    return _map_cache(spec, caches)


# --------------------------------------------------------------------- #
# placements on a DeviceMesh
# --------------------------------------------------------------------- #
def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a named ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def placements(spec: P, mesh) -> list:
    """The ``Shard``/``Replicate`` placement of each of ``mesh``'s dims
    for a tensor laid out by ``spec``, as a list (``local_map`` reads a
    tuple as one placement list an output).  A dim split over several axes
    (``("data", "model")``) is sharded on each, major axis first, which
    must be their order in the mesh; axes the mesh lacks are ignored."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        entry = entry if isinstance(entry, tuple) else (entry,)
        present = [a for a in entry if a in names]
        idx = [names.index(a) for a in present]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {present} of dim {dim} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]} shards two dims")
            out[i] = Shard(dim)
    return out


def distribute(t: torch.Tensor, spec: P, mesh):
    """``t`` (the same full tensor on every rank) as a DTensor laid out by
    ``spec`` (sanitized for ``mesh``); each rank keeps its own shard and
    nothing is sent.  Where that shard is the whole of ``t`` (every dim it
    splits split over one rank) it is ``t`` itself, not a copy: a model
    distributed on a one-rank mesh holds its weights once."""
    spec = sanitize_spec(spec, t.shape, mesh_sizes(mesh))
    place = placements(spec, mesh)
    if all(p == Replicate() or mesh.size(i) == 1 for i, p in enumerate(place)):
        return DTensor.from_local(t.detach().contiguous(), mesh, place,
                                  run_check=False).requires_grad_(t.requires_grad)
    return distribute_tensor(t, mesh, place, src_data_rank=None)


@torch.no_grad()
def distribute_model(model: nn.Module, mesh, *, mode: str = "train") -> nn.Module:
    """Replaces each of ``model``'s parameters, in place, by a DTensor on
    ``mesh`` placed by its sanitized spec (:func:`tree_partition_specs` on
    the mesh's axes); returns the model."""
    specs = tree_partition_specs(model, mesh.mesh_dim_names, mesh_sizes(mesh), mode)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        setattr(module, leaf, nn.Parameter(distribute(p.detach(), specs[name], mesh),
                                           requires_grad=p.requires_grad))
    if hasattr(model, "refresh"):
        model.refresh()
    return model
