"""repro_torch.obs — the ``stats()`` key schema (``jjpf.stats/v1``).

The trace recorder, metrics registry and exporters of the reference
package are not ported yet; the engine takes ``obs=None``.
"""

from . import schema  # noqa: F401
