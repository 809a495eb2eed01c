"""repro_torch.tune: the kernel-autotuning farm.

The port's CUDA kernels shipped on hand-picked tiles; this package
expresses the config sweep as a farm job (the engine tuning the engine's
own hot paths):

* :mod:`~repro_torch.tune.space`: per-kernel search spaces with static
  pruning for Hopper (the kernels' own tile rules, a block's shared
  memory and registers): invalid candidates never reach a worker;
* :mod:`~repro_torch.tune.tuner`: :class:`KernelTuner` runs
  successive-halving rounds through the existing
  :class:`~repro_torch.farm.FarmScheduler`, deterministic under
  ``sim://`` with the scripted cost model;
* :mod:`~repro_torch.tune.cache`: the persistent :class:`TuningCache`
  (JSON on disk + in-process memo) keyed by
  ``(kernel, shape-bucket, dtype, backend)``, read by the kernels'
  wrappers and the plain chunked paths via :func:`best_config`: serving
  and training pick up tuned configs with zero call-site changes.

The tunable launch parameters: the flash forwards' ``block_q`` and
``block_k`` (``flash_fwd``, bf16 and fp32), the backward pairs'
``dq_block_q``, ``dq_block_k``, ``dkv_block_k`` and ``dkv_block_q``
(``flash_bwd``, bf16 and fp32: a training step reads them), decode's
``splits`` (``decode``) and the scan's ``lanes`` (``mamba``), backend
``"cuda"``; ``chunked_attention``'s
``q_chunk`` and ``kv_chunk`` (``xla_flash``) and ``mamba_scan_plain``'s
``chunk`` (``mamba``), backend ``"torch"``.

Quickstart::

    from repro_torch.tune import KernelTuner, configure

    configure("tune_cache.json")          # install the persistent cache
    with KernelTuner(lookup) as tuner:    # farm over one card's service
        r = tuner.tune("flash_fwd",
                       {"B": 4, "Sq": 512, "Skv": 512,
                        "H": 16, "K": 8, "D": 128, "Dv": 128}, "bfloat16")
    print(r.config, f"{r.speedup:.2f}x over default")
    # ...every later bf16 flash forward at this shape-bucket now runs
    # the tuned tiles.
"""

from .cache import (TuningCache, best_config, cache_key,  # noqa: F401
                    configure, dtype_name, get_cache, set_cache, shape_bucket)
from .measure import measure_candidate, scripted_cost_us  # noqa: F401
from .space import (DEFAULTS, KERNELS,  # noqa: F401
                    KernelConfigError, default_backend, default_config,
                    resolve_block, resolve_config, search_space, smem_bytes,
                    validate_config)
from .tuner import KernelTuner, TuneResult  # noqa: F401
