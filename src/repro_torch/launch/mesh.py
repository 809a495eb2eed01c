"""Mesh construction over ``torch.distributed``: the reference package's
``repro/launch/mesh.py``.

Meshes are ``DeviceMesh``es with named axes, the reference's ("pod",
"data", "model"): a production pod is 16 x 16 cards, and the multi-pod
layout 2 x 16 x 16 with a leading "pod" axis (pods sync rarely or never:
they are farm services, while "data" and "model" live on one fabric).
A mesh needs a process group whose world holds its ranks
(``torch.distributed.init_process_group``); one card makes a (1, 1) mesh.

Each run of two or more adjacent mesh dims of more than one rank each is
flattened as well (``flatten_runs``): DTensor then reduces a sum partial
over those dims in one all-reduce over their ranks, as XLA does, not in
one ring a dim.

Functions, not module constants: importing this module touches no
process group and no device.

``HW`` holds one NVIDIA H100 SXM's published peaks (NVIDIA's data sheet,
dense rates, at the card's 700 W power limit), the constants the dry run
and roofline read; ``HW_CARD`` names the card they were checked against,
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
printed it.
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh

from ..sharding.specs import AXES


def flatten_runs(mesh):
    """``mesh`` with each run of two or more adjacent dims, every one of
    more than one rank, flattened (``DeviceMesh._flatten``: a process group
    over the run's ranks, which DTensor looks up to reduce a sum partial
    over the run in one all-reduce).  Every rank of the mesh calls it."""
    names = tuple(mesh.mesh_dim_names)
    for i in range(len(names)):
        for j in range(i + 2, len(names) + 1):
            if all(mesh.size(k) > 1 for k in range(i, j)):
                mesh[names[i:j]]._flatten()
    return mesh


def make_mesh(shape, axes=None, *, device_type: str = "cuda"):
    """A mesh of ``shape`` over the whole world (e.g. (2, 2, 2) on 8
    ranks); ``axes`` default to the last ``len(shape)`` of ("pod", "data",
    "model").  Its runs of dims are flattened (``flatten_runs``)."""
    shape = tuple(shape)
    if axes is None:
        axes = AXES[-len(shape):]
    return flatten_runs(init_device_mesh(device_type, shape, mesh_dim_names=tuple(axes)))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, device_type=device_type)


HW = {
    # NVIDIA H100 SXM per-card constants used by the roofline
    "peak_flops_bf16": 989e12,  # FLOP/s, dense
    "hbm_bandwidth": 3.35e12,  # B/s
    "hbm_bytes": 80e9,  # 80 GB
    "nvlink_bandwidth": 450e9,  # B/s each way (NVLink 4, 900 GB/s both ways)
}
HW_CARD = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}
