"""Farm-mode training: the paper's task-parallel model applied to SGD
(the reference package's ``repro/runtime/local_sgd.py``).

Synchronous data-parallel training all-reduces every step — *not* a JJPF
workload.  Farm mode makes training a stream of **independent tasks**:

    task(r, i) = "starting from the round-r parameters, run H optimizer
                  steps on deterministic data shard i, return the delta"

Within a round, tasks are independent, so they are farmed over the
recruited services with JJPF's pull scheduling and rescheduling on
faults; the client merges the deltas with an outer optimizer (Nesterov
momentum, as in DiLoCo / local SGD) and starts the next round.

Task data.  The reference draws each batch with ``jax.random`` inside
its jitted round, which the port cannot reproduce.  Here batch h of task
(r, i) is drawn from ``np.random.default_rng((seed, r, i, h))`` with
``MarkovDataset`` semantics (``markov_batch``): still a pure function of
(seed, round, shard, step), so a rescheduled task recomputes
bit-identical gradients.  The batch source is injectable (``batch_fn``),
so a test can feed both packages the same batches.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import BasicClient, Program
from repro_torch.device import resolve_device
from repro_torch.models.registry import ModelAPI
from repro_torch.optim import adamw_update, init_opt_state
from .train_loop import TrainConfig, loss_and_grads, make_lr_fn


@dataclass(frozen=True)
class LocalSGDConfig:
    inner_steps: int = 4  # H
    outer_lr: float = 0.7
    outer_momentum: float = 0.9  # Nesterov outer optimizer (DiLoCo)
    n_shards: int = 4  # tasks per round
    batch_per_shard: int = 8
    seq_len: int = 64


def markov_batch(perm: np.ndarray, seed: int, rnd: int, shard: int, h: int,
                 batch: int, seq_len: int, noise: float = 0.05) -> dict:
    """Batch h of task (rnd, shard): ``next = perm[cur]`` with
    probability 1 - noise, else uniform; tokens and targets (B, S) int32."""
    rng = np.random.default_rng((seed, rnd, shard, h))
    V = perm.shape[0]
    toks = np.empty((batch, seq_len + 1), dtype=np.int32)
    toks[:, 0] = rng.integers(0, V, batch)
    flip = rng.random((batch, seq_len)) < noise
    rand = rng.integers(0, V, (batch, seq_len), dtype=np.int32)
    for t in range(seq_len):
        toks[:, t + 1] = np.where(flip[:, t], rand[:, t], perm[toks[:, t]])
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def make_local_round_program(api: ModelAPI, tc: TrainConfig,
                             ls: LocalSGDConfig, perm, *,
                             batch_fn: Callable | None = None) -> Program:
    """The ProcessIf: payload {params (an LM), round, shard} ->
    {delta {name: fp32 tensor}, loss}.  ``batch_fn(round, shard, h)``
    gives the inner batches (default ``markov_batch`` from ``tc.seed``).
    The task trains its own copy of the weights with its own AdamW state;
    the payload's model is only read."""
    lr_fn = make_lr_fn(tc)
    cfg = api.cfg
    perm = np.asarray(perm)
    if batch_fn is None:
        def batch_fn(rnd, shard, h):
            return markov_batch(perm, tc.seed, rnd, shard, h,
                                ls.batch_per_shard, ls.seq_len)

    def run_round(payload):
        params0 = payload["params"]
        rnd, shard = int(payload["round"]), int(payload["shard"])
        model = copy.deepcopy(params0)
        model.requires_grad_(True)
        named = dict(model.named_parameters())
        opt = init_opt_state(named, moment_dtype=cfg.opt_state_dtype)
        losses = []
        for h in range(ls.inner_steps):
            batch = {k: torch.as_tensor(v).to(model.device)
                     for k, v in batch_fn(rnd, shard, h).items()}
            loss, _, grads = loss_and_grads(api, model, batch)
            del batch
            adamw_update(grads, opt, named, lr=lr_fn(rnd * ls.inner_steps + h),
                         weight_decay=tc.weight_decay,
                         moment_dtype=cfg.opt_state_dtype,
                         clip_norm=tc.clip_norm)
            del grads
            losses.append(loss)
        del opt
        with torch.no_grad():
            delta = {k: p.float() - p0.float() for (k, p), p0 in
                     zip(named.items(), params0.parameters())}
        return {"delta": delta, "loss": torch.stack(losses).mean()}

    return Program(run_round, name="local_sgd_round")


class LocalSGDTrainer:
    """The farm-mode driver (client side)."""

    def __init__(self, api: ModelAPI, tc: TrainConfig, ls: LocalSGDConfig,
                 *, lookup, seed: int = 0, device=None):
        self.api = api
        self.tc = tc
        self.ls = ls
        self.lookup = lookup
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(api.cfg.vocab_size).astype("int32")
        self.program = make_local_round_program(api, tc, ls, self.perm)
        dev = resolve_device(device)
        params = api.init(torch.Generator(device=dev).manual_seed(tc.seed))
        params.head().drop_f32()  # the weights change every round
        self.params = params
        self.outer_velocity = {k: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device)
                               for k, p in params.named_parameters()}
        self.round = 0
        self.loss_history: list[float] = []
        self.farm_stats: list[dict] = []

    def run_round(self, *, timeout: float = 300.0) -> float:
        tasks = [{"params": self.params, "round": self.round, "shard": i}
                 for i in range(self.ls.n_shards)]
        out: list[Any] = []
        client = BasicClient(self.program, None, tasks, out,
                             lookup=self.lookup, lease_s=60.0)
        client.compute(timeout=timeout)
        self.farm_stats.append(client.stats())
        # merge: average deltas, Nesterov outer step
        mu, lr = self.ls.outer_momentum, self.ls.outer_lr
        with torch.no_grad():
            for k, p in self.params.named_parameters():
                avg = sum(o["delta"][k] for o in out) / len(out)
                v = mu * self.outer_velocity[k] + avg
                self.outer_velocity[k] = v
                p.copy_((p.float() + lr * (mu * v + avg)).to(p.dtype))
        loss = float(torch.stack([o["loss"] for o in out]).mean())
        if self.params.device.type == "cuda":
            # the deltas were made on the services' streams: finish reading
            # them before their memory can be handed out there again
            torch.cuda.synchronize(self.params.device)
        self.round += 1
        self.loss_history.append(loss)
        return loss

    def run(self, n_rounds: int, **kw) -> list[float]:
        for _ in range(n_rounds):
            self.run_round(**kw)
        return self.loss_history
