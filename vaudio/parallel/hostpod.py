"""Multi-host serving pods: one pod whose slots span hosts.

:class:`vaudio.runtime.multistream.MultiStreamAuralizer` serves N streams
from ONE process; :mod:`vaudio.parallel.multihost` scales the *offline*
stream axis across processes.  This module closes the gap the round-3
roadmap left open ("a pod whose slots span hosts would need per-host push
doors + a process-spanning mesh"): a **live serving pod distributed over
a multi-host cluster**, keeping the reference's per-stream serving
semantics (SoundEngine.swift:171-189 ring contract, per-slot live params
SoundEngine.swift:66-75) while the dispatch is one SPMD program across
hosts.

Design — everything HOST-LOCAL except the dispatch:

* every process constructs the same :class:`MultiHostPod` (same config,
  same ``n_streams`` — the GLOBAL slot count) and owns the slots whose
  mesh rows live on its devices (:func:`~vaudio.parallel.multihost.
  local_stream_slice`);
* frame ingest, ring buffers, push doors, slot leases, the HTTP panel,
  metrics and checkpoints are per host and cover only the local slots —
  frame bytes and PCM never cross hosts (the multihost.py layout rule);
* each tick every host stacks its local frames and per-slot params,
  assembles the global batch with
  ``jax.make_array_from_process_local_data`` (purely local: each process
  contributes the shards its devices hold) and calls ONE jitted
  ``shard_map`` step over the ('stream',) mesh — pure DP, zero
  step-time collectives;
* per-slot :class:`~vaudio.config.LiveParams` survive distribution:
  params are *sharded over 'stream'* like the frames (each device reads
  only its own slots' values), so a host mutating a local slot's params
  never needs cross-host agreement;
* the ONLY cross-host coordination is lockstep itself: an SPMD dispatch
  needs every process, so (a) a tick always dispatches — idle/exhausted
  slots ride as masked black frames — and (b) "every source everywhere
  is exhausted" is decided by a tiny replicated-sum collective
  (:meth:`MultiHostPod._all_inactive`) so all hosts break on the SAME
  tick.

Static capacity: elastic resize needs all hosts to retrace together;
a multi-host pod's capacity is fixed at construction (scale by adding
pods — the fleet layer places across them).  :meth:`acquire_slot` still
leases local free slots; it just cannot grow past them.

Lifecycle contract (collective): construction, ``load_state`` and every
producer tick are SPMD — call them on every host.  ``stop()`` is
cooperative: call it on every host promptly (a lone host stopping while
others dispatch would wedge the others' collective); source exhaustion
needs no coordination — the shared ``_all_inactive`` sum ends every
host's loop on the same tick.

Single-process this degrades to the mesh pod over local devices (what CI
exercises on the 8-virtual-device CPU mesh); the genuinely multi-process
path is pinned by a 2-process Gloo CPU test
(tests/test_hostpod.py::TestTwoProcess).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vaudio.config import AuralizerConfig
from vaudio.parallel.multihost import local_stream_slice, \
    make_multihost_mesh
from vaudio.runtime.multistream import MultiStreamAuralizer, \
    _frame_sig, _fresh_rows, _normalize_frame, _zeros_like_frame


class MultiHostPod(MultiStreamAuralizer):
    """A serving pod whose slots span the processes of a multi-host mesh.

    Args:
      cfg: static configuration (identical on every host).
      n_streams: GLOBAL slot count — a multiple of the mesh's 'stream'
        axis.  This host serves only its local share (:attr:`local_slice`);
        every per-slot surface inherited from
        :class:`~vaudio.runtime.multistream.MultiStreamAuralizer`
        (``rings``, ``params``, ``arm_push``, ``acquire_slot``,
        ``stream_metrics``, the panel) indexes LOCAL slots 0..n_local-1.
      frame: an example frame (array or planar-YUV dict — e.g.
        ``np.zeros((h, w, 3), np.uint8)``) fixing the pod's static
        shape/dtype contract up front.  Multi-host pods cannot infer it
        from the first real frame: hosts must dispatch in lockstep from
        tick 0, before any host has necessarily seen a frame.
      mesh: a ('stream',)-or-('stream','cell') mesh spanning all
        processes (default :func:`make_multihost_mesh`).  DP-only:
        a 'cell' axis must be size 1.
      Other arguments match :class:`MultiStreamAuralizer`.  Not
        supported here: ``mesh``-mode shared params (params are per
        local slot), ``idle_shrink``/``max_streams`` (capacity is
        static), ``resize``.

    Every constructor runs the same collective array assembly, so
    construct the pod on all hosts together (like any SPMD program).
    """

    def __init__(self, cfg: AuralizerConfig = AuralizerConfig(),
                 n_streams: int = 2, *, frame,
                 mesh: Optional[Mesh] = None,
                 params=None, realtime: bool = False,
                 prefer_native: bool = True, chunk_frames: int = 1,
                 exit_when_exhausted: bool = True,
                 metrics_log: Optional[str] = None, engine=None,
                 lease_timeout: Optional[float] = None):
        mesh = mesh if mesh is not None else make_multihost_mesh()
        if "stream" not in mesh.shape:
            raise ValueError("mesh needs a 'stream' axis")
        if mesh.shape.get("cell", 1) != 1:
            raise ValueError(
                "multi-host pods are DP-only ('stream' axis); build the "
                "mesh with n_cell=1 (TP latency mode is single-host: "
                "make_parallel_step)")
        if n_streams % mesh.shape["stream"]:
            raise ValueError(
                f"n_streams {n_streams} not a multiple of the mesh "
                f"stream axis {mesh.shape['stream']}")
        self._gmesh = mesh
        #: GLOBAL slot count (``self.n_streams`` is the LOCAL count).
        self.global_streams = int(n_streams)
        #: Which global slots this process serves.
        self.local_slice = local_stream_slice(mesh, n_streams)
        n_local = self.local_slice.stop - self.local_slice.start
        if n_local == 0:
            raise ValueError(
                "this process owns no mesh devices on the 'stream' axis")
        # The replicated-scalar activity sum every host evaluates once
        # per tick (see _all_inactive).  Built before super().__init__
        # (which calls the overridden _build_step).
        self._active_sum = jax.jit(
            jnp.sum, out_shardings=NamedSharding(mesh, P()))
        super().__init__(
            cfg, n_streams=n_local, params=params, realtime=realtime,
            prefer_native=prefer_native, chunk_frames=chunk_frames,
            mesh=None,              # base mesh mode is single-host; ours
            exit_when_exhausted=exit_when_exhausted,  # replaces it fully
            metrics_log=metrics_log, engine=engine,
            max_streams=n_local,    # acquire_slot: lease, never grow
            lease_timeout=lease_timeout)
        # The static frame contract, fixed up front (dark lockstep ticks
        # need a zeros template before any real frame arrives).
        tmpl = _normalize_frame(frame)
        err = self.engine.frame_error(tmpl, self.cfg)
        if err is not None:
            raise ValueError(f"frame template rejected: {err}")
        self._template_sig = _frame_sig(tmpl)
        self._zeros = _zeros_like_frame(tmpl)
        if not self.engine.carry_static:
            # Frame-sized carries initialize eagerly from the template
            # (the single-host pod defers to the first dispatch).
            self._carry = self._shard_put(
                self.engine.init_carry_batch(self.n_streams, tmpl))
            self._carry_checked = True

    # -- global array plumbing ----------------------------------------------

    def _build_step(self):
        """One SPMD dispatch over the process-spanning mesh: the engine's
        raw per-frame/per-chunk step vmapped over the stream axis, with
        carry, frames AND per-slot params all sharded P('stream') — no
        step-time collectives (the DP layout of parallel.sharding)."""
        one = (self.engine.raw_chunk_step() if self.chunk_frames > 1
               else self.engine.raw_step())
        vstep = jax.vmap(one, in_axes=(0, 0, 0))
        sharded = jax.shard_map(
            vstep, mesh=self._gmesh,
            in_specs=(P("stream"), P("stream"), P("stream")),
            out_specs=(P("stream"), P("stream")),
            check_vma=False)
        return jax.jit(sharded, donate_argnums=(0,))

    def _shard_put(self, tree):
        """Local rows (leading axis = n_local) -> the global P('stream')
        array (leading axis = global_streams).  Purely local: each
        process contributes the shards its devices hold
        (``jax.make_array_from_process_local_data``)."""
        def put(x):
            x = np.asarray(x)
            spec = P("stream", *([None] * (x.ndim - 1)))
            return jax.make_array_from_process_local_data(
                NamedSharding(self._gmesh, spec), x,
                (self.global_streams,) + x.shape[1:])
        return jax.tree.map(put, tree)

    def _gather_local(self, x) -> np.ndarray:
        """This process's rows of a global P('stream') array, in global
        row order: (n_local, ...)."""
        shards = {int(s.index[0].start or 0): np.asarray(s.data)
                  for s in x.addressable_shards}
        return np.concatenate([shards[k] for k in sorted(shards)], axis=0)

    def _modify_local_rows(self, fn) -> None:
        """Rewrite this host's carry rows: gather local -> fn(host rows)
        -> reassemble.  No communication and no cross-host agreement
        needed — each process's global-array handle holds only its own
        shards, and DP math never reads another host's rows.  Caller
        holds ``_carry_lock``."""
        local = type(self._carry)(*[self._gather_local(x)
                                    for x in self._carry])
        self._carry = self._shard_put(fn(local))

    def _stack_params(self) -> Dict[str, jax.Array]:
        """Per-LOCAL-slot params stacked (base class), then assembled
        into global P('stream') leaves.  NOTE: optional array-valued
        params (pan_angles) change the jit signature — enable them on
        every slot of every HOST or none (cross-host divergence would
        compile different programs and wedge the dispatch)."""
        return self._shard_put(super()._stack_params())

    def _fetch_pcm(self, out) -> np.ndarray:
        return self._gather_local(out["pcm"])

    # -- lockstep ------------------------------------------------------------

    def _next_batch(self):
        """Always a full batch: multi-host ticks MUST dispatch (the step
        is collective), so when every local slot is dark this host rides
        the tick with masked black frames instead of skipping it."""
        tick = super()._next_batch()
        if tick is None:
            n = self.n_streams
            return [self._zeros] * n, [False] * n
        return tick

    def _all_inactive(self) -> bool:
        """Global exhaustion, decided collectively: every host sums the
        same global active-flag array once per tick, so every host sees
        the SAME verdict on the SAME tick and the loops break (or idle)
        together — the lockstep invariant of the SPMD dispatch."""
        flags = np.array([1 if a else 0 for a in self._active], np.int32)
        return int(self._active_sum(self._shard_put(flags))) == 0

    # -- capacity is static ----------------------------------------------------

    def resize(self, n_streams: int, timeout: float = 30.0) -> None:
        raise RuntimeError(
            "multi-host pods have static capacity: an elastic resize "
            "would need every host to retrace together; scale by adding "
            "pods (client.FleetClient places across them) or restart "
            "the pod at the new size")

    # -- carry surgery without collectives -------------------------------------

    def _apply_pending_sources(self) -> None:
        """Same contract as the base, but slot carry resets rewrite the
        host's LOCAL rows (an eager ``.at[].set`` on a non-addressable
        global array is not legal outside jit, and jitting it would be
        an unordered collective)."""
        with self._source_lock:
            items, self._pending_sources = self._pending_sources, []
        for slot, it, reset in items:
            self._sources[slot] = it
            self._active[slot] = True
            self.slot_errors[slot] = None
            if reset:
                with self._carry_lock:
                    def reset_row(local, s=slot):
                        fresh = _fresh_rows(local, 1)
                        return type(local)(*[
                            np.concatenate([x[:s], np.asarray(f1),
                                            x[s + 1:]])
                            for x, f1 in zip(local, fresh)])
                    self._modify_local_rows(reset_row)

    def stop(self) -> None:
        """Cooperative stop — call on EVERY host (see module docstring).
        Local effects match the base: rings cleared, OLA tails zeroed
        (via local-row rewrite), phases/spectra retained."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            if not self._thread.is_alive():
                self._thread = None
        self._running = False
        self.metrics.end_time = time.monotonic()
        if self._metrics_fh is not None:
            self._metrics_fh.close()
            self._metrics_fh = None
        for ring in self.rings:
            ring.reset()
        with self._carry_lock:
            if self._carry is not None:
                self._modify_local_rows(
                    lambda local: local._replace(
                        ola_tail=np.zeros_like(local.ola_tail)))

    # -- checkpoints (host-local slices) ---------------------------------------

    def snapshot_carry(self):
        """This HOST's slots' DSP carry (n_local leading axis) — the
        global carry is never materialized on one host (its shards live
        on other processes).  ``save_state`` therefore writes per-host
        files; ``load_state`` is collective (every host restores its own
        file together, like any SPMD call)."""
        with self._carry_lock:
            if self._carry is None:
                raise ValueError("no DSP carry yet")
            return type(self._carry)(*[self._gather_local(x)
                                       for x in self._carry])

    def metrics_dict(self) -> Dict[str, object]:
        """Base pod metrics for the LOCAL slots + the global placement
        facts (fleet clients see each host's door as a pod of n_local
        capacity)."""
        out = super().metrics_dict()
        out["global_streams"] = self.global_streams
        out["local_slots"] = [int(i) for i in
                              range(self.local_slice.start,
                                    self.local_slice.stop)]
        out["process_index"] = jax.process_index()
        out["process_count"] = jax.process_count()
        return out
