"""Synchronous training on one device: the reference package's
``repro/runtime/train_loop.py``.

``make_train_step`` builds ``train_step(state, batch)``: forward, backward
(through the attention kernels' autograd rule) and AdamW, with optional
microbatch gradient accumulation.  Steps run eagerly.

``Trainer`` is the restartable driver: checkpoint/restore, deterministic
data (a restarted step re-reads identical batches), periodic
checkpoints.  A state is ``{"params": LM, "opt": {...}}``; the optimizer
writes the new weights into the model's parameters in place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.kernels import DISPATCH, AttentionOps
from repro_torch.models.registry import ModelAPI
from repro_torch.optim import adamw_update, init_opt_state
from repro_torch.optim.schedules import SCHEDULES
from repro_torch.sharding.hints import current_mesh, mesh_axes, use_mesh
from repro_torch.sharding.specs import distribute_batch


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    accum_steps: int = 1
    master_fp32: bool = False
    seed: int = 0
    # schedule extras (wsd)
    stable_steps: int = 0
    decay_steps: int = 100


def make_lr_fn(tc: TrainConfig) -> Callable:
    sched = SCHEDULES[tc.schedule]
    if tc.schedule == "wsd":
        return partial(sched, peak_lr=tc.lr, warmup_steps=tc.warmup_steps,
                       stable_steps=tc.stable_steps, decay_steps=tc.decay_steps)
    if tc.schedule == "cosine":
        return partial(sched, peak_lr=tc.lr, warmup_steps=tc.warmup_steps,
                       total_steps=tc.total_steps)
    return partial(sched, peak_lr=tc.lr)


def make_train_state(api: ModelAPI, tc: TrainConfig, *, params=None,
                     device=None) -> dict:
    """{"params": LM, "opt": AdamW state}.  Without ``params`` the model is
    initialised from ``tc.seed`` on ``device`` (``cuda:0`` by default).
    The model's parameters are made trainable, and its fp32 unembedding
    copy is dropped: training changes the table every step, and serving
    makes the copy again on first use."""
    if params is None:
        dev = resolve_device(device)
        params = api.init(torch.Generator(device=dev).manual_seed(tc.seed))
    params.requires_grad_(True)
    params.head().drop_f32()
    opt = init_opt_state(dict(params.named_parameters()),
                         moment_dtype=api.cfg.opt_state_dtype,
                         master_fp32=tc.master_fp32)
    return {"params": params, "opt": opt}


def loss_and_grads(api: ModelAPI, model, batch, *,
                   ops: AttentionOps = DISPATCH):
    """(loss, metrics, {name: grad}) of one batch."""
    named = dict(model.named_parameters())
    loss, metrics = api.train_loss(model, batch, ops=ops)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), metrics, dict(zip(named, grads))


def functional_loss_and_grads(model, params, batch, *, ops: AttentionOps = DISPATCH):
    """(loss, metrics, {name: grad}) of one batch on the weights ``params``
    ({name: tensor}), run in ``model``'s structure: ``torch.func.grad_and_value``
    of ``torch.func.functional_call``.  A function transform, so it also runs
    under ``torch.func.vmap``: N tasks, each with its own weights, as one call
    (a training program in ``Service.execute_batch``).  One task's gradients
    are ``loss_and_grads``' bit for bit (``models/layers.silu``)."""
    def loss_fn(p):
        return torch.func.functional_call(model, p, (batch,), {"ops": ops})

    grads, (loss, metrics) = torch.func.grad_and_value(loss_fn, has_aux=True)(params)
    return loss, metrics, grads


def make_train_step(api: ModelAPI, tc: TrainConfig, *, axes=None,
                    block_skip: bool = False) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; metrics are 0-d
    tensors (loss, grad_norm, lr; ce_loss and aux_loss without
    accumulation).  ``block_skip`` is the reference's keyword, accepted
    and discarded: its attention dispatch ignores it on both branches.

    With ``axes`` (mesh axis names, e.g. ``("data", "model")``) the step
    runs under ``mesh_axes(axes)``, so the sharding hints and the
    tensor-parallel attention see them, on the mesh of the model's
    parameters when they are DTensors (``distribute_model``), else the
    current mesh; the batch's tensors are laid out by their batch specs
    on it, and the metrics come back whole.  With ``axes=None`` the step
    is the single-device one."""
    del block_skip
    lr_fn = make_lr_fn(tc)
    cfg = api.cfg

    def train_step(state, batch):
        model, opt = state["params"], state["opt"]
        if tc.accum_steps <= 1:
            loss, metrics, grads = loss_and_grads(api, model, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            a = tc.accum_steps
            grads, loss, metrics = None, 0.0, {}
            for i in range(a):
                mb = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l, _, g = loss_and_grads(api, model, mb)
                if grads is None:
                    grads = {k: x.float() for k, x in g.items()}
                else:
                    for k, x in g.items():
                        grads[k] += x.float()
                loss = loss + l
            grads = {k: x / a for k, x in grads.items()}
            loss = loss / a
        _, opt, opt_metrics = adamw_update(
            grads, opt, dict(model.named_parameters()), lr=lr_fn(opt["step"]),
            b1=tc.b1, b2=tc.b2, weight_decay=tc.weight_decay,
            moment_dtype=cfg.opt_state_dtype, clip_norm=tc.clip_norm)
        return state, {"loss": loss, **metrics, **opt_metrics}

    if axes is None:
        return train_step

    def sharded_step(state, batch):
        param = next(state["params"].parameters())
        mesh = param.device_mesh if isinstance(param, DTensor) else current_mesh()
        with use_mesh(mesh), mesh_axes(axes):
            if mesh is not None:
                batch = distribute_batch(batch, mesh)
            state, metrics = train_step(state, batch)
        return state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}

    return sharded_step


class Trainer:
    """Restartable single-controller training driver."""

    def __init__(self, api: ModelAPI, tc: TrainConfig, dataset, *,
                 checkpointer=None, ckpt_every: int = 50,
                 train_step: Callable | None = None,
                 state: Any | None = None, device=None):
        self.api = api
        self.tc = tc
        self.dataset = dataset
        self.checkpointer = checkpointer
        self.ckpt_every = ckpt_every
        self.train_step = train_step or make_train_step(api, tc)
        self.state = (state if state is not None
                      else make_train_state(api, tc, device=device))
        self.device = self.state["params"].device
        self.start_step = 0
        self.metrics_log: list[dict] = []
        if checkpointer is not None:
            restored = checkpointer.restore_latest(self.state)
            if restored[0] is not None:
                self.start_step, self.state = restored

    def run(self, n_steps: int, *, preempt_at: int | None = None) -> list[dict]:
        """Run steps [start_step, start_step + n_steps).  ``preempt_at``
        simulates a node loss by raising after saving nothing (the restart
        test path)."""
        step = self.start_step
        end = step + n_steps
        while step < end:
            if preempt_at is not None and step >= preempt_at:
                raise KeyboardInterrupt(f"simulated preemption at step {step}")
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in self.dataset.batch_at(step).items()}
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
            metrics["step"] = step
            metrics["step_time_s"] = time.perf_counter() - t0
            self.metrics_log.append(metrics)
            step += 1
            if self.checkpointer is not None and step % self.ckpt_every == 0:
                self.checkpointer.save(step, self.state)
                self.start_step = step
        if self.checkpointer is not None:
            self.checkpointer.save(step, self.state)
            if hasattr(self.checkpointer, "wait"):
                self.checkpointer.wait()
        self.start_step = step
        return self.metrics_log
