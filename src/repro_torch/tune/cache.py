"""The persistent tuning cache every model path reads.

Tuned configs are keyed by ``(kernel, shape-bucket, dtype, backend)``:

    flash_fwd|B=4,D=128,Dv=128,H=16,K=8,Skv=512,Sq=512|bfloat16|cuda

The backend is ``"cuda"`` for the hand-written kernels' launch parameters
(the bf16 flash forward's tiles, decode's KV splits, the scan's lanes a
channel) and ``"torch"`` for the plain chunked paths the card runs
(``chunked_attention``'s chunks, ``mamba_scan_plain``'s chunk).  It is
never the reference package's ``"pallas"`` or ``"xla"``, so the two
packages' entries never mix in one file.

Sequence and batch dims are bucketed to the next power of two, so one
sweep at 512 covers every prompt length in (256, 512].  Head and feature
dims stay exact (they change the arithmetic intensity, not just the
tiling count).  A batched call of ``Service.execute_batch`` reads the
cache at its folded batch (the vmap rules fold the tasks into B before
the wrappers resolve their config).

Two layers:

* **in-process memo**: a kernel's wrapper asks its :class:`ConfigProbe`
  on every call; after the first lookup for a shape it is one dict
  probe, keyed on the call's raw dims before any dict or bucket string
  is built (``chip_smoke.py`` phase 23 holds that probe to 3% of a
  wrapper call's host time); :func:`best_config` memoizes the same way
  for callers that hold a shape dict;
* **JSON on disk**: human-readable, merged on write (read-modify-replace
  via ``os.replace``, newest ``tuned_at`` wins), so concurrent tuners on a
  shared filesystem never tear the file and at worst lose a race to a
  peer's *newer* result.

The process-wide active cache is installed with :func:`set_cache` /
:func:`configure`; ``JJPF_TUNE_CACHE`` in the environment auto-loads one
on first use.  With no cache installed every lookup returns the caller's
hand-picked default: dispatch behaves exactly as before this module
existed.
"""

from __future__ import annotations

import json
import os
import threading
import time

SCHEMA = "jjpf.tune/v1"


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


#: dims bucketed to the next power of two (sequence/batch-like); all
#: other dims are kept exact in the key
_BUCKETED = frozenset({"B", "b", "Sq", "Skv", "S", "s"})


def shape_bucket(shape: dict) -> str:
    """Canonical bucketed shape string (sorted ``k=v`` pairs)."""
    parts = []
    for name in sorted(shape):
        v = int(shape[name])
        if name in _BUCKETED and v > 0:
            v = _pow2_ceil(v)
        parts.append(f"{name}={v}")
    return ",".join(parts)


def cache_key(kernel: str, shape: dict, dtype: str, backend: str) -> str:
    return f"{kernel}|{shape_bucket(shape)}|{dtype}|{backend}"


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the dtype as a cache key
    names it, the same string for a torch dtype and a numpy name."""
    return str(dtype).rsplit(".", 1)[-1]


# one lock per cache file path, shared across TuningCache instances in
# this process so merge-on-write is atomic between threads too
_PATH_LOCKS: dict[str, threading.Lock] = {}
_PATH_LOCKS_GUARD = threading.Lock()


def _path_lock(path: str) -> threading.Lock:
    key = os.path.abspath(path)
    with _PATH_LOCKS_GUARD:
        return _PATH_LOCKS.setdefault(key, threading.Lock())


class TuningCache:
    """In-memory map of tuned configs with optional JSON persistence."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.Lock()
        self._data: dict[str, dict] = {}
        #: bumped on every mutation; :func:`best_config`'s memo checks it
        self.generation = 0
        self.hits = 0
        self.misses = 0
        if path and os.path.exists(path):
            self.load()

    # ---------------- in-memory ------------------------------------ #
    def lookup(self, kernel: str, shape: dict, dtype: str,
               backend: str) -> dict | None:
        """The tuned record (``{"config", "us", ...}``) or None."""
        rec = self._data.get(cache_key(kernel, shape, dtype, backend))
        if rec is None:
            self.misses += 1
            return None
        self.hits += 1
        return rec

    def put(self, kernel: str, shape: dict, dtype: str, backend: str,
            config: dict, us: float, *, meta: dict | None = None,
            save: bool = True) -> str:
        key = cache_key(kernel, shape, dtype, backend)
        rec = {"config": {k: int(v) for k, v in sorted(config.items())},
               "us": float(us), "kernel": kernel, "dtype": dtype,
               "backend": backend, "tuned_at": time.time()}
        if meta:
            rec["meta"] = meta
        with self._lock:
            self._data[key] = rec
            self.generation += 1
        if save and self.path:
            self.save()
        return key

    def __len__(self) -> int:
        return len(self._data)

    def entries(self) -> dict[str, dict]:
        with self._lock:
            return dict(self._data)

    # ---------------- disk ----------------------------------------- #
    def load(self) -> None:
        """Replace the in-memory map with the on-disk content."""
        with open(self.path) as f:
            doc = json.load(f)
        if doc.get("schema") != SCHEMA:
            raise ValueError(f"{self.path}: not a {SCHEMA} cache "
                             f"(schema={doc.get('schema')!r})")
        with self._lock:
            self._data = dict(doc.get("entries", {}))
            self.generation += 1

    def save(self) -> None:
        """Merge-on-write: re-read the file, overlay (newest ``tuned_at``
        wins per key), write a temp file, atomically replace.  Torn
        files are impossible; a concurrent writer's strictly-newer entry
        survives our write."""
        lock = _path_lock(self.path)
        with lock, self._lock:
            merged: dict[str, dict] = {}
            if os.path.exists(self.path):
                try:
                    with open(self.path) as f:
                        merged = dict(json.load(f).get("entries", {}))
                except (json.JSONDecodeError, OSError):
                    merged = {}
            for key, rec in self._data.items():
                cur = merged.get(key)
                if cur is None or cur.get("tuned_at", 0) <= rec.get(
                        "tuned_at", 0):
                    merged[key] = rec
            doc = {"schema": SCHEMA, "entries": dict(sorted(merged.items()))}
            tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
            self._data = merged
            self.generation += 1


# ---------------- the process-wide active cache ---------------------- #
_ACTIVE: TuningCache | None = None
_ACTIVE_SET = False  # distinguish "never configured" from "explicitly None"
_MEMO: dict[tuple, tuple[int, dict]] = {}


def set_cache(cache: TuningCache | None) -> TuningCache | None:
    """Install (or clear, with ``None``) the active cache; returns the
    previous one.  Clears the dispatch memo."""
    global _ACTIVE, _ACTIVE_SET
    prev = _ACTIVE
    _ACTIVE = cache
    _ACTIVE_SET = True
    _MEMO.clear()
    return prev


def configure(path: str) -> TuningCache:
    """Load (or create) a disk-backed cache at ``path`` and install it."""
    cache = TuningCache(path)
    set_cache(cache)
    return cache


def get_cache() -> TuningCache | None:
    """The active cache; on first call honors ``JJPF_TUNE_CACHE``."""
    global _ACTIVE, _ACTIVE_SET
    if not _ACTIVE_SET:
        _ACTIVE_SET = True
        path = os.environ.get("JJPF_TUNE_CACHE")
        if path:
            _ACTIVE = TuningCache(path)
    return _ACTIVE


def best_config(kernel: str, shape: dict, dtype: str, backend: str,
                default: dict) -> dict:
    """The tuned config for this call site, or ``default``.

    Called by the kernels' wrappers and the plain chunked paths on every
    call: returns ``default | cached_config`` (a cached entry may tune
    only a subset of the knobs).  Memoized per (raw shape, default)
    against the cache generation, so the steady-state cost is one dict
    probe and no bucket string is built."""
    cache = get_cache()
    if cache is None:
        return default
    memo_key = (kernel, tuple(shape.items()), dtype, backend,
                tuple(default.items()))
    hit = _MEMO.get(memo_key)
    if hit is not None and hit[0] == cache.generation:
        cache.hits += 1
        return hit[1]
    rec = cache.lookup(kernel, shape, dtype, backend)
    cfg = dict(default)
    if rec is not None:
        cfg.update(rec["config"])
    _MEMO[memo_key] = (cache.generation, cfg)
    return cfg


class ConfigProbe:
    """One call site's reading of the active cache: ``probe(dims, dtype)``
    returns :func:`best_config` of ``kernel`` at the shape whose dims
    ``names`` name, in ``dtype`` (a torch dtype or its name), on
    ``backend``, with ``default`` as the fallback, and the very
    ``default`` object when no cache is installed.

    The memo is keyed on ``(dims, dtype)`` as the caller has them, so a
    steady-state hit builds no shape dict, bucket string or dtype name:
    one tuple and one dict probe.  An entry holds the cache it was read
    from and that cache's generation, so installing another cache or
    putting an entry invalidates it; it counts a hit on the cache as
    :func:`best_config`'s memo does."""

    _LIMIT = 4096  # distinct call shapes kept before the memo starts over

    def __init__(self, kernel: str, names: tuple, backend: str, default: dict):
        self.kernel, self.names, self.backend = kernel, names, backend
        self.default = default
        self._memo: dict[tuple, tuple] = {}

    def __call__(self, dims: tuple, dtype) -> dict:
        cache = _ACTIVE if _ACTIVE_SET else get_cache()
        if cache is None:
            return self.default
        key = (dims, dtype)
        hit = self._memo.get(key)
        if hit is not None and hit[0] is cache and hit[1] == cache.generation:
            cache.hits += 1
            return hit[2]
        cfg = best_config(self.kernel, dict(zip(self.names, dims)),
                          dtype_name(dtype), self.backend, self.default)
        if len(self._memo) >= self._LIMIT:
            self._memo.clear()
        self._memo[key] = (cache, cache.generation, cfg)
        return cfg
