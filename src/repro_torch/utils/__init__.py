"""Analysis utilities: ``op_stats``, the per-device FLOPs, bytes,
collectives and peak memory of the ops a step dispatches."""
