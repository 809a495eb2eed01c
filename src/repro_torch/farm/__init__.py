"""repro_torch.farm — the multi-tenant farm scheduler.

JJPF's shared Jini pool, arbitrated: a persistent :class:`FarmScheduler`
owns every service registered with the lookup and divides the pool
across concurrent :class:`Job` s by weighted fair share, with admission
control, streaming submission under backpressure, and exactly-once
cancellation.  Runs over every transport (``inproc://``, ``proc://``,
``sim://``); deterministic under the virtual clock.

    sched = FarmScheduler(lookup, max_batch=8)
    heavy = sched.submit(program, tasks, weight=2.0)
    light = sched.submit(program).submit_stream(source, window=64)
    for tid, result in light.as_completed():
        ...
"""

from .arbiter import fair_assignment, jain_index  # noqa: F401
from .job import Job, JobCancelled, JobState  # noqa: F401
from .scheduler import FarmScheduler  # noqa: F401
