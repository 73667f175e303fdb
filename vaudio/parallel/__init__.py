"""Multi-stream / multi-chip parallelism.

The reference is single-process/single-GPU; its only scale axis is
"more concurrent streams" (SURVEY.md §5, BASELINE config 5: 8x concurrent
1080p streams over a multi-device mesh).  This module provides the SPMD
layers:

* :func:`make_batched_step` — ``vmap`` across streams within one chip;
* :func:`make_parallel_step` — ``shard_map`` over a 2-D
  ``('stream', 'cell')`` mesh: data parallelism across streams,
  plus tensor parallelism inside the synthesis (the 16 synthesis cells are
  sharded over ``'cell'`` and their spectra combined with a ``psum``);
* :func:`run_offline_parallel` — scan the sharded step over a batched clip;
* :mod:`vaudio.parallel.multihost` — per-host stream ingest for meshes
  that span processes (streams DP across hosts, frame bytes stay
  host-local);
* :class:`vaudio.parallel.hostpod.MultiHostPod` — the LIVE serving pod
  over a process-spanning mesh: per-host rings/push doors/leases/panel,
  one lockstep SPMD dispatch, per-slot params sharded with the streams.

No cross-stream communication exists in the workload, so the ``'stream'``
axis needs no collectives — exactly the embarrassingly-parallel layout the
survey prescribes; the ``'cell'`` axis demonstrates the model-parallel
decomposition of the synthesis contraction.
"""

from vaudio.parallel.hostpod import MultiHostPod
from vaudio.parallel.multihost import (
    MultiHostAuralizer,
    distribute_local_frames,
    init_distributed,
    local_stream_slice,
    make_multihost_mesh,
)
from vaudio.parallel.sharding import (
    init_carry_batch,
    make_batched_step,
    make_engine_parallel_step,
    make_parallel_chunk_step,
    make_parallel_step,
    make_stream_mesh,
    run_offline_parallel,
)

__all__ = [
    "MultiHostAuralizer",
    "MultiHostPod",
    "distribute_local_frames",
    "init_carry_batch",
    "init_distributed",
    "local_stream_slice",
    "make_batched_step",
    "make_engine_parallel_step",
    "make_multihost_mesh",
    "make_parallel_chunk_step",
    "make_parallel_step",
    "make_stream_mesh",
    "run_offline_parallel",
]
