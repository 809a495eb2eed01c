"""Serving as a task farm — the paper's workload, verbatim.

Batched generation requests are *embarrassingly parallel*: each task is
(prompt batch -> generated tokens), no cross-task state.  The farm:

    program  = prefill + N greedy decode steps (ONE program per task)
    services = devices running the program, each on its own CUDA stream
    client   = BasicClient with pull scheduling, elastic recruitment and
               rescheduling of failed requests

A payload is a dict of CPU tensors: the prompt ``tokens`` and whatever
else the model's prefill reads (whisper's ``enc_frames``, a vision
model's ``patch_embeds``).  The program moves every tensor to the
parameters' device and hands the whole payload to prefill, as the
reference does; ``serve_requests`` builds token-only tasks and brings the
generated tokens back to the CPU.  Decode writes its caches at
``prompt_len + i``, as the reference's program does, which ignores a
vision prefix: vision models are served text-only.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import BasicClient, Program
from repro_torch.models.registry import ModelAPI


@dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 8
    prompt_len: int = 16
    batch_per_task: int = 4
    greedy: bool = True  # the generate program is greedy; nothing reads this


def make_generate_program(api: ModelAPI, sc: ServeConfig, params) -> Program:
    """payload: {"tokens": (B, prompt_len), ...} -> {"generated": (B, N)}
    int32.

    ``params`` are closed over (weights are resident on the service's
    device; the task payload is only the request batch — matching JJPF,
    where the program ships once at recruit time and tasks stay small)."""
    budget = sc.prompt_len + sc.max_new_tokens
    device = params.device

    def generate(payload):
        batch = {k: v.to(device) if torch.is_tensor(v) else v
                 for k, v in payload.items()}
        logits, caches = api.prefill(params, batch, seq_budget=budget)
        toks = []
        for i in range(sc.max_new_tokens):
            nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
            batch = {"tokens": nxt, "cache_index": sc.prompt_len + i}
            logits, caches = api.decode(params, batch, caches)
            toks.append(nxt[:, 0])
        return {"generated": torch.stack(toks, dim=1)}  # (B, N)

    return Program(generate, name=f"generate[{api.cfg.name}]")


def serve_requests(api: ModelAPI, params, prompts, sc: ServeConfig, *,
                   lookup, timeout: float = 300.0):
    """Partition ``prompts`` (N, prompt_len) into farm tasks and run them.
    Returns (generated (N, max_new_tokens) int32 on the CPU, client stats)."""
    program = make_generate_program(api, sc, params)
    prompts = torch.as_tensor(prompts)
    n = prompts.shape[0]
    bs = sc.batch_per_task
    tasks = [{"tokens": prompts[i:i + bs]} for i in range(0, n, bs)]
    out: list = []
    client = BasicClient(program, None, tasks, out, lookup=lookup)
    client.compute(timeout=timeout)
    gen = torch.cat([o["generated"].cpu() for o in out], dim=0)
    return gen, client.stats()
