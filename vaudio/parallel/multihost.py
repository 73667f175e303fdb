"""Multi-host ingest: scale the stream axis across hosts.

The reference is a single-process app fed by one camera
(video-auralizer/CameraModel.swift:12-37); its only scale axis is "more
streams" (SURVEY.md §5: the pipeline is embarrassingly parallel per
stream).  On a multi-host deployment that axis maps naturally onto
processes: every host captures/decodes its OWN streams (cameras, files,
sockets) and feeds only the mesh shard its local devices hold, so frame
bytes never cross hosts — the only cross-host traffic is XLA's SPMD
bookkeeping.  Layout rules:

* the ``'stream'`` mesh axis spans processes (outer axis, the inter-host
  network): pure data
  parallelism, zero collectives at step time;
* an optional ``'cell'`` tensor-parallel axis stays the MINOR axis so its
  psum (vaudio/parallel/sharding.py:113) stays on the intra-host
  interconnect, never the inter-host network.

The front door is :func:`distribute_local_frames`, built on
``jax.make_array_from_process_local_data``: each process passes the frames
for ITS streams, and the result is one global array laid out over the
mesh.  Everything here degrades gracefully to a single process (CI runs it
on the 8-virtual-device CPU mesh), so the multi-host path is exactly the
code the tests exercise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vaudio.config import AuralizerConfig
from vaudio.parallel.sharding import (init_carry_batch,
                                      make_parallel_chunk_step,
                                      make_stream_mesh)
from vaudio.runtime.step import StepCarry, default_params


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Initialize JAX's multi-process runtime (call ONCE, before any
    backend use, on every host).  No-op for single-process runs.

    Returns the process count.  On real deployments the three arguments
    usually come from the cluster environment and may all be ``None``
    (jax.distributed auto-detects SLURM, Kubernetes and similar
    cluster environments).
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    elif (num_processes is None and process_id is None
          and coordinator_address is None):
        # Auto-detect path: let jax.distributed recognize the cluster
        # environment.  Outside a recognized cluster (plain CI, a
        # laptop) initialize() raises — that is the single-process
        # case and must stay a no-op; an already-initialized runtime
        # is also fine.
        try:
            jax.distributed.initialize()
        except Exception:
            pass
    return jax.process_count()


def make_multihost_mesh(n_cell: int = 1) -> Mesh:
    """A ('stream', 'cell') mesh over ALL processes' devices.

    ``jax.devices()`` orders devices process-major, so reshaping to
    (n_stream, n_cell) keeps each process's devices contiguous along
    'stream' and keeps the 'cell' psum on the intra-host interconnect.
    """
    return make_stream_mesh(n_cell=n_cell)


def local_stream_slice(mesh: Mesh, n_streams: int) -> slice:
    """Which global stream indices THIS process must feed.

    Streams are block-distributed over the 'stream' axis; a process owns
    the rows its devices hold.  n_streams must be a multiple of the
    stream-axis size.
    """
    n_stream_shards = mesh.shape["stream"]
    if n_streams % n_stream_shards:
        raise ValueError(f"n_streams {n_streams} not divisible by "
                         f"stream-axis size {n_stream_shards}")
    per_shard = n_streams // n_stream_shards
    rows = mesh.devices[:, 0] if mesh.devices.ndim == 2 else mesh.devices
    pid = jax.process_index()
    mine = [i for i, d in enumerate(rows) if d.process_index == pid]
    if not mine:
        return slice(0, 0)
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(
            "process's stream rows are not contiguous; build the mesh with "
            "make_multihost_mesh so 'stream' is the process-major axis")
    return slice(mine[0] * per_shard, (mine[-1] + 1) * per_shard)


def distribute_local_frames(mesh: Mesh, local_frames,
                            n_streams: int) -> jax.Array:
    """Assemble the global (S, T, ...) frame array from per-process shards.

    Args:
      mesh: the ('stream', 'cell') mesh.
      local_frames: array of shape (S_local, T, ...) — the frames for the
        streams THIS process owns (see :func:`local_stream_slice`).  Frame
        bytes are placed directly on the process's local devices; nothing
        crosses hosts.
      n_streams: global stream count.
    Returns:
      A global jax.Array of shape (n_streams, T, ...) sharded P('stream').
    """
    local_frames = np.asarray(local_frames)
    spec = P("stream", *([None] * (local_frames.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    global_shape = (n_streams,) + local_frames.shape[1:]
    expect = local_stream_slice(mesh, n_streams)
    n_local = expect.stop - expect.start
    if local_frames.shape[0] != n_local:
        raise ValueError(
            f"this process owns {n_local} streams "
            f"(global rows {expect.start}:{expect.stop}), got "
            f"{local_frames.shape[0]}")
    return jax.make_array_from_process_local_data(
        sharding, local_frames, global_shape)


class MultiHostAuralizer:
    """Chunk-at-a-time multi-host sonification driver.

    Each host constructs one of these (same config, same n_streams) and
    repeatedly calls :meth:`step` with ITS streams' next T frames; the
    call is collective (every process must participate each step, like any
    SPMD program).  PCM for the local streams comes back host-local via
    ``local_audio``.

    Single-process this is simply the DP-chunked mesh pipeline
    (parallel.make_parallel_chunk_step) with explicit ingest plumbing —
    which is what CI exercises on the virtual CPU mesh.
    """

    def __init__(self, cfg: AuralizerConfig, n_streams: int,
                 mesh: Optional[Mesh] = None,
                 params: Optional[Dict[str, Any]] = None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else make_multihost_mesh()
        if self.mesh.shape.get("cell", 1) != 1:
            raise ValueError("MultiHostAuralizer is DP-only (n_cell=1); "
                             "use make_parallel_step for TP")
        self.n_streams = n_streams
        self.params = params if params is not None else default_params(cfg)
        self._step = make_parallel_chunk_step(cfg, self.mesh)
        self.local_slice = local_stream_slice(self.mesh, n_streams)
        carry = init_carry_batch(cfg, n_streams)
        sharding = NamedSharding(self.mesh, P("stream"))
        self.carry: StepCarry = jax.device_put(
            carry, jax.tree.map(lambda _: sharding, carry))

    @property
    def n_local_streams(self) -> int:
        return self.local_slice.stop - self.local_slice.start

    def step(self, local_frames) -> jax.Array:
        """Run one T-frame chunk; returns the GLOBAL pcm array
        (n_streams, T, hop[, ch]) still sharded over the mesh."""
        frames = distribute_local_frames(self.mesh, local_frames,
                                         self.n_streams)
        self.carry, out = self._step(self.carry, frames, self.params)
        return out["pcm"]

    def local_audio(self, pcm: jax.Array) -> np.ndarray:
        """Gather THIS process's streams' PCM to host memory:
        (S_local, T*hop) mono or (S_local, T*hop, ch)."""
        shards = {
            int(s.index[0].start or 0): np.asarray(s.data)
            for s in pcm.addressable_shards
        }
        rows = [shards[k] for k in sorted(shards)]
        local = np.concatenate(rows, axis=0)
        T, hop = local.shape[1], local.shape[2]
        if self.cfg.channels == 1:
            return local.reshape(local.shape[0], T * hop)
        return local.reshape(local.shape[0], T * hop, self.cfg.channels)
