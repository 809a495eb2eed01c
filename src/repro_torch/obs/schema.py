"""The documented shapes: event taxonomy and stats() key sets.

Every ``stats()`` surface in the engine grew up separately and the keys
drifted (``lock_wait_s`` here, ``wait_s`` there; per-shard vs summed
counters).  This module is the single source of truth: the benchmark
JSON consumers and the schema test (``tests/test_stats_schema.py``)
both read these sets, so a silent rename breaks loudly in CI instead of
silently zeroing a dashboard column.

``validate_stats_tree`` walks a FarmScheduler snapshot (the one shape
every front-end embeds) and raises ``SchemaError`` naming the first
surface whose keys drifted.
"""

from __future__ import annotations

#: version tag carried by ``FarmScheduler.stats()["schema"]``
STATS_SCHEMA = "jjpf.stats/v1"

#: trace-event taxonomy: kind -> (fields after (t, kind), emitted by).
#: One event per *batch* on hot paths; per-task detail rides in fields.
EVENT_KINDS = {
    # task lifecycle (repository)
    "task-submit": ("n, first_task_id", "TaskRepository.add_tasks"),
    "lease": ("service_id, ((task_id, attempt), ...)",
              "RepositoryShard lease paths"),
    "steal": ("service_id, shard_index, home_shard",
              "TaskRepository facade (sharded cross-shard lease)"),
    "speculate": ("service_id, task_id, attempt",
                  "RepositoryShard.try_speculate"),
    "complete": ("service_id, ((task_id, lease_start), ...)",
                 "RepositoryShard.complete_some"),
    "expire": ("(task_id, ...)", "RepositoryShard lease-deadline scan"),
    "expire-service": ("service_id, n", "TaskRepository.expire_service"),
    "task-fail": ("service_id, task_id", "TaskRepository.fail"),
    "cancel": ("n_dropped", "TaskRepository.cancel"),
    # dispatch (control threads)
    "dispatch": ("service_id, n", "ControlThread (batch handed to service)"),
    "drain": ("service_id, n, t_dispatch",
              "ControlThread (batch materialized; span = t_dispatch..t)"),
    # scheduler
    "recruit": ("service_id, speed_factor", "FarmScheduler pool join"),
    "service-dead": ("service_id", "FarmScheduler (liveness verdict)"),
    "service-lost": ("service_id", "FarmScheduler (never-recruited exit)"),
    "assign": ("service_id, job_id|None", "FarmScheduler rebalance diff"),
    "revoke": ("service_id, job_id", "FarmScheduler rebalance diff"),
    "rebalance": ("n_jobs, n_changed", "FarmScheduler._rebalance_locked"),
    "job-submit": ("job_id, weight", "FarmScheduler.submit"),
    "job-start": ("job_id", "FarmScheduler admission"),
    "job-end": ("job_id, state", "FarmScheduler._job_finished"),
    # transport
    "frame": ("service_id, bytes_out, bytes_in",
              "proc/tcp handle round-trip"),
    "reconnect": ("service_id", "proc/tcp handle reconnect"),
    "shm-ring": ("service_id, ring_bytes, inline_fallbacks",
                 "shm payload write (ring hit vs inline fallback)"),
}

# ------------------------------------------------------------------ #
# stats() key sets (one frozenset per surface)
# ------------------------------------------------------------------ #
LOCK_KEYS = frozenset({
    "lock_wait_s", "lock_hold_s", "lock_contentions", "lock_acquisitions"})

REPOSITORY_KEYS = frozenset({
    "tasks", "done", "cancelled", "pending", "leased", "reschedules",
    "peak_unfinished", "speculative_issues", "straggler_speculations",
    "service_rates", "per_service", "shards"}) | LOCK_KEYS

JOB_KEYS = frozenset({
    "job_id", "name", "state", "weight", "services", "service_time_s",
    "peak_unfinished", "submitted_at", "started_at", "finished_at",
    "tasks", "done", "pending", "leased", "cancelled", "reschedules",
    "speculative_issues", "straggler_speculations", "per_service",
    "shards"}) | LOCK_KEYS

#: ControlThread.snapshot() / engine["batching"][sid]
BATCHING_KEYS = frozenset({
    "batch", "max_batch", "last_latency_s", "throughput_ewma",
    "batches_recorded", "batches_dispatched", "cache_hits",
    "cache_misses"})

LEASE_TABLE_KEYS = frozenset({
    "speculative_issues", "straggler_speculations", "service_rates"})

ARBITER_KEYS = frozenset({"services", "solves", "memo_hits", "resorts"})

VIRTUAL_CLOCK_KEYS = frozenset({"now", "enrolled", "running"})

ENGINE_KEYS = frozenset({
    "schema", "services", "n_services", "running", "queued", "rebalances",
    "rebalance_requests", "revocations", "batching", "jobs", "arbiter"})

#: present only when an Observability bundle is attached to the engine
ENGINE_OPTIONAL_KEYS = frozenset({"metrics", "trace"})

RECORDER_KEYS = frozenset({
    "rings", "ring_size", "events_recorded", "events_retained",
    "events_dropped"})


class SchemaError(AssertionError):
    """A stats() surface drifted from the documented key set."""


def _check(surface: str, got: dict, expected: frozenset,
           optional: frozenset = frozenset()) -> None:
    keys = set(got)
    missing = expected - keys
    extra = keys - expected - optional
    if missing or extra:
        raise SchemaError(
            f"{surface}: stats keys drifted "
            f"(missing={sorted(missing)}, unexpected={sorted(extra)})")


def validate_repository_stats(stats: dict) -> None:
    _check("repository", stats, REPOSITORY_KEYS)


def validate_job_stats(stats: dict) -> None:
    _check("job", stats, JOB_KEYS)


def validate_batching_stats(stats: dict) -> None:
    _check("batching", stats, BATCHING_KEYS)


def validate_engine_stats(stats: dict) -> None:
    """Walk the whole engine snapshot tree (the shape every front-end
    embeds as ``stats()['engine']``)."""
    _check("engine", stats, ENGINE_KEYS, ENGINE_OPTIONAL_KEYS)
    if stats["schema"] != STATS_SCHEMA:
        raise SchemaError(f"engine: schema tag {stats['schema']!r} != "
                          f"{STATS_SCHEMA!r}")
    for sid, snap in stats["batching"].items():
        _check(f"engine.batching[{sid}]", snap, BATCHING_KEYS)
    for jid, jstats in stats["jobs"].items():
        _check(f"engine.jobs[{jid}]", jstats, JOB_KEYS)
    if stats["arbiter"] is not None:
        _check("engine.arbiter", stats["arbiter"], ARBITER_KEYS)
    if "trace" in stats:
        _check("engine.trace", stats["trace"], RECORDER_KEYS)
