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

Batched rounds.  ``Service.execute_batch`` of the round program runs N
tasks (``{name: tensor}`` payloads, as ``LocalSGDTrainer`` sends them)
as one ``torch.func.vmap`` call of the same core that runs one task, as
the reference's ``execute_batch`` runs ``jax.vmap`` of its round: each
task with its own weights, gradients, AdamW state and delta, each
kernel launched as often for the N tasks as for one.  The batches are
drawn on the host first, from the stacked payload's rounds and shards
(``LocalRoundProgram.prepare_batched``); the reference draws them inside
its jit from traced values, which a numpy draw cannot do under vmap.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import BasicClient, Program
from repro_torch.core.skeletons import to_device
from repro_torch.device import resolve_device
from repro_torch.models.registry import ModelAPI
from repro_torch.models.registry import skeleton as model_skeleton
from repro_torch.optim import adamw_update, init_opt_state
from .train_loop import TrainConfig, functional_loss_and_grads, make_lr_fn


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


class LocalRoundProgram(Program):
    """The round program: ``fn`` runs one task; the batched callable
    (``Service.execute_batch``) reads the stacked payload's rounds and
    shards on the host, draws each task's batches there (``batch_fn``, a
    numpy draw that cannot run under vmap), and then runs the inner steps
    of all the tasks as one ``torch.func.vmap`` call."""

    def __init__(self, fn: Callable, batched: Callable, *, name: str):
        super().__init__(fn, name=name)
        self._batched = batched

    def prepare_batched(self, device: torch.device | None = None) -> Callable:
        def bound(stacked):
            return self._batched(stacked, device)
        return bound


def make_local_round_program(api: ModelAPI, tc: TrainConfig,
                             ls: LocalSGDConfig, perm, *,
                             batch_fn: Callable | None = None,
                             skeleton: torch.nn.Module | None = None) -> LocalRoundProgram:
    """The ProcessIf: payload {params, round, shard} -> {delta {name: fp32
    tensor}, loss}.  ``params`` is an ``LM``, or a ``{name: tensor}``
    mapping of its weights, as the reference's is a pytree; a mapping runs
    in the structure of ``skeleton`` (an ``LM`` of the config, whose
    weights are not read: a copy on the meta device is kept).
    ``batch_fn(round, shard, h)`` gives the inner batches (default
    ``markov_batch`` from ``tc.seed``).  The task trains its own copy of
    the weights with its own AdamW state; the payload's weights are only
    read.

    One core runs the H inner steps, for one task and, under
    ``torch.func.vmap``, for N tasks stacked by ``Service.execute_batch``
    (mapping payloads), each with its own weights, gradients, AdamW state
    and delta: the gradients are ``functional_loss_and_grads``, every
    kernel folds the N tasks into one launch by its vmap rule
    (``kernels/batched.py``)."""
    lr_fn = make_lr_fn(tc)
    cfg = api.cfg
    perm = np.asarray(perm)
    template = None if skeleton is None else model_skeleton(skeleton)
    if batch_fn is None:
        def batch_fn(rnd, shard, h):
            return markov_batch(perm, tc.seed, rnd, shard, h,
                                ls.batch_per_shard, ls.seq_len)

    def core(model, params0, batches, lrs):
        """H AdamW steps from ``params0`` on ``batches[h]`` at ``lrs[h]``."""
        params = {k: p.detach().clone() for k, p in params0.items()}
        opt = init_opt_state(params, moment_dtype=cfg.opt_state_dtype)
        losses = []
        for batch, lr in zip(batches, lrs):
            loss, _, grads = functional_loss_and_grads(model, params, batch)
            adamw_update(grads, opt, params, lr=lr, weight_decay=tc.weight_decay,
                         moment_dtype=cfg.opt_state_dtype, clip_norm=tc.clip_norm)
            del grads
            losses.append(loss)
        del opt
        with torch.no_grad():
            delta = {k: p.float() - params0[k].float() for k, p in params.items()}
        return {"delta": delta, "loss": torch.stack(losses).mean()}

    def structure(params):
        """(a skeleton of this call's own, the weights as a mapping)."""
        if isinstance(params, torch.nn.Module):
            return model_skeleton(params), dict(params.named_parameters())
        if template is None:
            raise ValueError("local_sgd_round: a {name: tensor} params payload needs "
                             "the program made with skeleton=")
        return copy.deepcopy(template), params

    def draws(rnd, shard, device):
        return [{k: torch.as_tensor(v).to(device) for k, v in batch_fn(rnd, shard, h).items()}
                for h in range(ls.inner_steps)]

    def run_round(payload):
        model, params0 = structure(payload["params"])
        rnd, shard = int(payload["round"]), int(payload["shard"])
        device = next(iter(params0.values())).device
        lrs = [lr_fn(rnd * ls.inner_steps + h) for h in range(ls.inner_steps)]
        return core(model, params0, draws(rnd, shard, device), lrs)

    def run_batched(stacked, device):
        rounds, shards = stacked["round"].tolist(), stacked["shard"].tolist()
        model, params0 = structure(stacked["params"])
        if device is not None:
            params0 = to_device(params0, device)
        device = next(iter(params0.values())).device
        tasks = [draws(r, i, device) for r, i in zip(rounds, shards)]
        batches = [{k: torch.stack([t[h][k] for t in tasks]) for k in tasks[0][h]}
                   for h in range(ls.inner_steps)]
        lrs = [torch.stack([lr_fn(r * ls.inner_steps + h) for r in rounds])
               for h in range(ls.inner_steps)]
        return torch.func.vmap(lambda p, b, lr: core(model, p, b, lr))(params0, batches, lrs)

    return LocalRoundProgram(run_round, run_batched, name="local_sgd_round")


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
        dev = resolve_device(device)
        params = api.init(torch.Generator(device=dev).manual_seed(tc.seed))
        params.head().drop_f32()  # the weights change every round
        self.params = params
        self.program = make_local_round_program(api, tc, ls, self.perm, skeleton=params)
        self.outer_velocity = {k: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device)
                               for k, p in params.named_parameters()}
        self.round = 0
        self.loss_history: list[float] = []
        self.farm_stats: list[dict] = []

    def run_round(self, *, timeout: float = 300.0) -> float:
        weights = dict(self.params.named_parameters())
        tasks = [{"params": weights, "round": self.round, "shard": i}
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
