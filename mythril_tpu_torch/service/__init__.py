"""Persistent analysis service: `python -m mythril_tpu_torch serve`.

A long-lived daemon that owns the device for its lifetime and serves
analysis requests over a local HTTP/JSON API, amortizing process
startup, the kernels' build and arena allocation across requests — the
serving counterpart of the one-shot `analyze` pipeline. The port's copy
of the JAX package's service/, the single arena:

    jobs.py            job model, bounded queue, admission control
    lane_allocator.py  stripe packing over the fixed device arena
    engine.py          warm arena + continuous-batching wave loop +
                       overlapped host-analysis pool
    server.py          HTTP front, drain-on-SIGTERM wiring
    client.py          stdlib client (`submit`)
"""

from mythril_tpu_torch.service.engine import (  # noqa: F401
    AnalysisEngine,
    ServiceConfig,
)
from mythril_tpu_torch.service.jobs import (  # noqa: F401
    Job,
    JobQueue,
    JobState,
    QueueRefusal,
)
from mythril_tpu_torch.service.lane_allocator import LaneAllocator  # noqa: F401
