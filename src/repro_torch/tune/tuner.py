"""The kernel autotuner, expressed as a farm job: the engine dogfoods.

A config sweep is the purest embarrassingly-parallel workload in the
JJPF sense: N independent (build candidate, time it, report a number)
tasks with zero coupling.  So the tuner is a thin client of the farm
stack: each successive-halving round is one
:meth:`~repro_torch.farm.FarmScheduler.submit` of a ``host=True``
:class:`~repro_torch.core.skeletons.Program` whose body is
:func:`~repro_torch.tune.measure.measure_candidate`, and everything the
engine already does (batched leases, heterogeneity-aware sizing,
rate-straggler speculation, fault-recovery re-enqueue) applies to tuning
for free.

Successive halving: round 0 times *every* surviving candidate at a cheap
rep count, keeps the top ``1/eta``, and multiplies reps by ``eta`` each
round until ``<= finalists`` remain; the last round times the finalists
and the hand-picked default too, so the reported speedup compares equal
evidence.  Ranking is deterministic: ties break on the canonical config
tuple, and under ``sim://`` with the scripted cost model every
measurement is a pure function of (kernel, shape, config, seed), so
same-seed sweeps pick byte-identical winners no matter how the virtual
services race.

A real sweep on the card runs over a farm of *one* service: candidates
timed at once on one card would time each other.  Its winner and the
default are best re-timed one after the other by the caller
(``chip_smoke.py`` phase 23 does).

Results land in the :class:`~repro_torch.tune.cache.TuningCache`, which
the kernels' wrappers read: tuning here changes what serving and
training launch with zero call-site changes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .cache import TuningCache, get_cache
from .measure import measure_candidate
from .space import (default_backend, default_config, resolve_config,
                    search_space, validate_config)


def _rank_key(names):
    def key(entry):
        us, config = entry
        return (us, tuple(config[n] for n in names))
    return key


@dataclass
class TuneResult:
    """One kernel/shape sweep: the winner and how it was found."""

    kernel: str
    shape: dict
    dtype: str
    backend: str
    config: dict            # the winner
    us: float               # winner's final-round best-of time
    default_config: dict
    default_us: float       # default's final-round time (same reps)
    candidates: int         # statically-valid candidates entered
    pruned: int             # statically-invalid candidates never submitted
    failed: int             # tasks that returned ok=False
    rounds: list = field(default_factory=list)  # (n_candidates, reps)

    @property
    def speedup(self) -> float:
        return self.default_us / self.us if self.us > 0 else float("inf")

    def summary(self) -> dict:
        cfg = {k: int(v) for k, v in sorted(self.config.items())}
        return {"kernel": self.kernel, "dtype": self.dtype,
                "backend": self.backend, "shape": dict(sorted(
                    (k, int(v)) for k, v in self.shape.items())),
                "config": cfg, "us": round(self.us, 3),
                "default_config": dict(sorted(self.default_config.items())),
                "default_us": round(self.default_us, 3),
                "speedup": round(self.speedup, 4),
                "candidates": self.candidates, "pruned": self.pruned,
                "failed": self.failed, "rounds": self.rounds}


class KernelTuner:
    """Drives successive-halving sweeps over a farm.

    ``scheduler``  an existing :class:`~repro_torch.farm.FarmScheduler` to
                   submit rounds to (the tuner never shuts it down), OR
    ``lookup``     a lookup to build a private scheduler over (owned:
                   closed by :meth:`close`).
    ``cache``      the :class:`TuningCache` winners land in (default:
                   the process-wide active cache, if any).
    ``obs``        optional :class:`repro_torch.obs.Observability`: emits
                   ``tune-sweep`` / ``tune-round`` /
                   ``tune-candidate-failed`` / ``tune-winner`` recorder
                   events and the ``tune_*`` counters.
    """

    def __init__(self, lookup=None, *, scheduler=None, clock=None,
                 cache: TuningCache | None = None, obs=None,
                 max_batch: int = 4, **scheduler_knobs):
        from repro_torch.core.skeletons import Program

        if scheduler is None and lookup is None:
            raise ValueError("need a scheduler or a lookup")
        self._own_scheduler = scheduler is None
        if scheduler is None:
            from repro_torch.farm import FarmScheduler

            kw = dict(max_batch=max_batch, **scheduler_knobs)
            if clock is not None:
                kw["clock"] = clock
            if obs is not None:
                kw["obs"] = obs
            scheduler = FarmScheduler(lookup, **kw)
        self.scheduler = scheduler
        self.cache = cache if cache is not None else get_cache()
        self.obs = obs if obs is not None else scheduler.obs
        if self.obs is not None:
            reg = self.obs.registry
            self._m_timed = reg.counter("tune_candidates_timed")
            self._m_pruned = reg.counter("tune_candidates_pruned")
            self._m_failed = reg.counter("tune_candidates_failed")
            self._m_sweeps = reg.counter("tune_sweeps")
        self.program = Program(measure_candidate, name="tune-measure",
                               host=True)

    def close(self) -> None:
        if self._own_scheduler:
            self.scheduler.shutdown()

    def __enter__(self) -> "KernelTuner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------- one successive-halving sweep ------------------- #
    def tune(self, kernel: str, shape: dict, dtype: str = "float32",
             backend: str | None = None, *, seed: int = 0,
             base_reps: int = 2, full_reps: int = 5, eta: int = 3,
             finalists: int = 3, cost_model: str | None = None,
             device: str = "cuda", default: dict | None = None,
             save: bool = True) -> TuneResult:
        """Sweep ``kernel`` at ``shape`` and cache the winner.

        ``cost_model="scripted"`` routes every measurement through the
        deterministic analytic model (the ``sim://`` mode); ``None``
        times for real on ``device`` (the card unless it names the CPU) on
        whatever services the scheduler holds."""
        backend = backend or default_backend(kernel)
        # the baseline is the *effective* default: what an untuned
        # dispatch actually runs after its fallbacks
        default = resolve_config(
            kernel, shape,
            dict(default if default is not None
                 else default_config(kernel, backend, dtype)), backend, dtype)
        cands, pruned = search_space(kernel, shape, dtype, backend)
        if not cands:
            raise ValueError(f"no valid candidates for {kernel} at {shape}")
        names = sorted(cands[0])
        if self.obs is not None:
            self._m_sweeps.inc()
            self._m_pruned.inc(pruned)
            self.obs.event("tune-sweep", None, kernel, len(cands), pruned)

        survivors = cands
        rounds: list[tuple[int, int]] = []
        failed = 0
        reps = base_reps
        rnd = 0
        while True:
            last = len(survivors) <= finalists
            if last:
                reps = max(reps, full_reps)
                # time the hand-picked default at full reps alongside the
                # finalists, deduped, so speedup compares equal evidence
                pool = list(survivors)
                try:
                    validate_config(kernel, shape, default, backend, dtype)
                    if default not in pool:
                        pool.append(default)
                except Exception:
                    pass
            else:
                pool = survivors
            timed = self._measure_round(kernel, shape, dtype, pool, reps,
                                        seed, cost_model, rnd,
                                        backend=backend, device=device)
            failed += sum(1 for us, _ in timed if not math.isfinite(us))
            rounds.append((len(pool), reps))
            if last:
                break
            keep = max(finalists, len(survivors) // eta)
            ranked = sorted(timed, key=_rank_key(names))
            survivors = [cfg for _, cfg in ranked[:keep]]
            reps *= eta
            rnd += 1

        by_cfg = {tuple(cfg[n] for n in names): us for us, cfg in timed}
        ranked = sorted(((us, cfg) for us, cfg in timed
                         if cfg in survivors or cfg == default),
                        key=_rank_key(names))
        win_us, winner = next(((us, cfg) for us, cfg in ranked
                               if math.isfinite(us)), ranked[0])
        default_us = by_cfg.get(tuple(default.get(n, -1) for n in names),
                                float("inf"))

        result = TuneResult(
            kernel=kernel, shape=dict(shape), dtype=dtype, backend=backend,
            config=dict(winner), us=win_us, default_config=default,
            default_us=default_us, candidates=len(cands), pruned=pruned,
            failed=failed, rounds=rounds)
        if self.obs is not None:
            self.obs.event("tune-winner", None, kernel,
                           tuple(sorted(winner.items())), round(win_us, 3))
        if self.cache is not None:
            self.cache.put(kernel, shape, dtype, backend, winner, win_us,
                           meta={"speedup": round(result.speedup, 4),
                                 "seed": seed,
                                 "cost_model": cost_model or "measured"},
                           save=save)
        return result

    def _measure_round(self, kernel, shape, dtype, configs, reps, seed,
                       cost_model, rnd, *, backend=None, device="cuda"):
        """Submit one round as a farm job; returns [(us, config)] aligned
        to ``configs`` (results_in_order: task id == candidate index)."""
        payloads = [{"kernel": kernel, "shape": dict(shape), "dtype": dtype,
                     "backend": backend or default_backend(kernel),
                     "config": dict(cfg), "reps": int(reps),
                     "seed": int(seed), "device": device,
                     **({"cost_model": cost_model} if cost_model else {})}
                    for cfg in configs]
        if self.obs is not None:
            self.obs.event("tune-round", None, kernel, rnd, len(configs),
                           int(reps))
        job = self.scheduler.submit(self.program, payloads,
                                    name=f"tune-{kernel}-r{rnd}")
        out = []
        for cfg, res in zip(configs, job.results_in_order()):
            us = float(res["us"]) if res.get("ok") else float("inf")
            out.append((us, cfg))
            if self.obs is not None:
                self._m_timed.inc()
                if not res.get("ok"):
                    self._m_failed.inc()
                    self.obs.event("tune-candidate-failed", None, kernel,
                                   tuple(sorted(cfg.items())),
                                   res.get("error", ""))
        return out

    def tune_all(self, specs, **kw) -> list[TuneResult]:
        """Sweep a list of ``(kernel, shape)`` (or ``(kernel, shape,
        dtype)``) specs sequentially, sharing the farm."""
        results = []
        for spec in specs:
            kernel, shape, *rest = spec
            dtype = rest[0] if rest else "float32"
            results.append(self.tune(kernel, shape, dtype, **kw))
        return results
