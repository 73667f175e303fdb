"""MultiStreamAuralizer — the multi-stream serving pod.

Covers: PCM equivalence of the batched pod against independent
single-stream runs (vmap and chunked modes, and the mesh-sharded modes on
the 8-device virtual mesh), uneven stream lengths (dark slots), per-slot
live params, live slot re-arming, and the static-shape contract.
"""

import time

import numpy as np
import pytest

from vaudio.config import AuralizerConfig, LiveParams
from vaudio.io import solid_color_frames
from vaudio.runtime import MultiStreamAuralizer, run_offline
from vaudio.runtime.chunked import run_offline_batched

HOP = 2048
COLORS = [
    [0.9, 0.2, 0.1],
    [0.1, 0.8, 0.3],
    [0.2, 0.3, 0.9],
    [0.8, 0.8, 0.1],
    [0.7, 0.1, 0.8],
    [0.1, 0.9, 0.9],
    [0.5, 0.5, 0.5],
    [0.9, 0.6, 0.2],
]


def clips(n_streams, n_frames, size=64):
    return [solid_color_frames(COLORS[s % len(COLORS)], width=size,
                               height=size, num_frames=n_frames)
            for s in range(n_streams)]


def wait_done(pod, timeout=120.0):
    t0 = time.monotonic()
    while pod.is_running:
        if time.monotonic() - t0 > timeout:
            pod.stop()
            raise TimeoutError("pod producer still running")
        time.sleep(0.005)
    pod.raise_if_failed()


class TestPodEquivalence:
    def test_matches_independent_offline_runs(self):
        cfg = AuralizerConfig()
        srcs = clips(3, 6)
        pod = MultiStreamAuralizer(cfg, n_streams=3)
        pod.start([iter(np.asarray(c)) for c in srcs])
        wait_done(pod)
        for s, clip in enumerate(srcs):
            ref, _, _ = run_offline(np.asarray(clip), cfg)
            got = pod.pull(s, 6 * HOP)
            np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4)
        assert pod.metrics.frames_processed == 18
        pod.stop()

    def test_chunked_matches_offline_batched(self):
        cfg = AuralizerConfig()
        srcs = clips(2, 6)
        pod = MultiStreamAuralizer(cfg, n_streams=2, chunk_frames=3)
        pod.start([iter(np.asarray(c)) for c in srcs])
        wait_done(pod)
        for s, clip in enumerate(srcs):
            ref, _, _ = run_offline_batched(np.asarray(clip), cfg, chunk=3)
            got = pod.pull(s, 6 * HOP)
            np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4)
        pod.stop()

    def test_uint8_frames(self):
        cfg = AuralizerConfig()
        clip = (np.asarray(clips(1, 4)[0]) * 255).astype(np.uint8)
        pod = MultiStreamAuralizer(cfg, n_streams=2)
        pod.start([iter(clip), iter(clip.copy())])
        wait_done(pod)
        ref, _, _ = run_offline(clip, cfg)
        np.testing.assert_allclose(pod.pull(0, 4 * HOP), np.asarray(ref),
                                   atol=2e-4)
        np.testing.assert_allclose(pod.pull(1, 4 * HOP), np.asarray(ref),
                                   atol=2e-4)
        pod.stop()


class TestPodMesh:
    @pytest.mark.parametrize("mesh_shape,chunk", [
        ((8, 1), 1),    # pure stream-DP
        ((4, 2), 1),    # DP x cell-TP (psum over the cell axis)
        ((8, 1), 2),    # DP chunk-batched (the throughput shape)
    ])
    def test_mesh_pod_matches_offline(self, mesh_shape, chunk):
        from vaudio.parallel import make_stream_mesh
        cfg = AuralizerConfig()
        mesh = make_stream_mesh(*mesh_shape)
        srcs = clips(8, 4)
        pod = MultiStreamAuralizer(cfg, n_streams=8, params=LiveParams(),
                                   chunk_frames=chunk, mesh=mesh)
        pod.start([iter(np.asarray(c)) for c in srcs])
        wait_done(pod)
        for s in (0, 3, 7):
            ref, _, _ = run_offline(np.asarray(srcs[s]), cfg)
            np.testing.assert_allclose(pod.pull(s, 4 * HOP),
                                       np.asarray(ref), atol=3e-4)
        pod.stop()

    def test_mesh_requires_shared_params(self):
        from vaudio.parallel import make_stream_mesh
        with pytest.raises(ValueError, match="shared LiveParams"):
            MultiStreamAuralizer(AuralizerConfig(), n_streams=8,
                                 mesh=make_stream_mesh(8, 1))


class TestPodLifecycle:
    def test_uneven_lengths_dark_slot(self):
        """A slot whose source ends goes dark: its ring receives exactly
        its own frames' hops, the surviving slot is unaffected (vmap
        independence), and the pod exits when every source is done."""
        cfg = AuralizerConfig()
        long_clip, short_clip = clips(2, 8)
        short_clip = short_clip[:4]
        pod = MultiStreamAuralizer(cfg, n_streams=2)
        pod.start([iter(np.asarray(long_clip)),
                   iter(np.asarray(short_clip))])
        wait_done(pod)
        assert pod.stream_metrics(0)["buffer_fill"] == 8
        assert pod.stream_metrics(1)["buffer_fill"] == 4
        assert not pod.stream_metrics(1)["active"]
        assert pod.metrics.frames_processed == 12
        ref, _, _ = run_offline(np.asarray(long_clip), cfg)
        np.testing.assert_allclose(pod.pull(0, 8 * HOP), np.asarray(ref),
                                   atol=2e-4)
        pod.stop()

    def test_mid_chunk_exhaust_writes_only_real_hops(self):
        cfg = AuralizerConfig()
        long_clip, short_clip = clips(2, 6)
        short_clip = short_clip[:4]      # ends mid-chunk (6 = 2 chunks of 3)
        pod = MultiStreamAuralizer(cfg, n_streams=2, chunk_frames=3)
        pod.start([iter(np.asarray(long_clip)),
                   iter(np.asarray(short_clip))])
        wait_done(pod)
        assert pod.stream_metrics(0)["buffer_fill"] == 6
        assert pod.stream_metrics(1)["buffer_fill"] == 4
        ref, _, _ = run_offline_batched(np.asarray(short_clip)[:4], cfg,
                                        chunk=3)
        np.testing.assert_allclose(pod.pull(1, 4 * HOP)[:4 * HOP],
                                   np.asarray(ref)[:4 * HOP], atol=2e-4)
        pod.stop()

    def test_replace_source_rearm(self):
        """A long-lived pod (exit_when_exhausted=False) idles after its
        sources end and serves a newly armed client on the same slot."""
        cfg = AuralizerConfig()
        first, second = clips(2, 3)
        pod = MultiStreamAuralizer(cfg, n_streams=1,
                                   exit_when_exhausted=False)
        pod.start([iter(np.asarray(first))])
        t0 = time.monotonic()
        while pod.stream_metrics(0)["buffer_fill"] < 3:
            pod.raise_if_failed()
            assert time.monotonic() - t0 < 120
            time.sleep(0.005)
        assert pod.is_running            # pod idles, does not exit
        pcm1 = pod.pull(0, 3 * HOP)
        ref1, _, _ = run_offline(np.asarray(first), cfg)
        np.testing.assert_allclose(pcm1, np.asarray(ref1), atol=2e-4)

        pod.replace_source(0, iter(np.asarray(second)), reset_carry=True)
        t0 = time.monotonic()
        while pod.stream_metrics(0)["buffer_fill"] < 3:
            pod.raise_if_failed()
            assert time.monotonic() - t0 < 120
            time.sleep(0.005)
        pcm2 = pod.pull(0, 3 * HOP)
        ref2, _, _ = run_offline(np.asarray(second), cfg)
        # reset_carry=True: the slot starts from a cold carry, so the
        # second client's PCM is exactly a fresh run's.
        np.testing.assert_allclose(pcm2, np.asarray(ref2), atol=2e-4)
        pod.stop()
        assert not pod.is_running

    def test_shape_mismatch_darkens_slot_only(self):
        """A slot feeding frames that violate the pod's static-shape
        contract goes dark LOUDLY (slot_errors + stream_metrics) but
        does not kill the other N-1 slots — slot isolation."""
        cfg = AuralizerConfig()
        a = np.asarray(clips(1, 4)[0])
        b = np.asarray(solid_color_frames([0.2, 0.9, 0.4], width=32,
                                          height=32, num_frames=4))
        pod = MultiStreamAuralizer(cfg, n_streams=2)
        pod.start([iter(a), iter(b)])
        wait_done(pod)
        pod.raise_if_failed()                  # pod itself survives
        m = pod.stream_metrics(1)
        assert m["active"] is False
        assert "signature" in m["error"]
        assert pod.stream_metrics(0)["error"] is None
        # The good slot delivered its full stream.
        assert pod.rings[0].available == 4
        pod.stop()

    def test_source_exception_darkens_slot_only(self):
        """A client source RAISING mid-stream darkens its slot and is
        recorded; the surviving slot completes, and a re-arm via
        replace_source clears the failure."""
        cfg = AuralizerConfig()
        good = np.asarray(clips(1, 4)[0])

        def bad_source():
            yield good[0]
            raise OSError("camera unplugged")

        pod = MultiStreamAuralizer(cfg, n_streams=2,
                                   exit_when_exhausted=False)
        pod.start([iter(good), bad_source()])
        t0 = time.monotonic()
        while (pod.slot_errors[1] is None
               or pod.rings[0].available < 4):
            pod.raise_if_failed()
            assert time.monotonic() - t0 < 120
            time.sleep(0.005)
        assert pod.is_running                  # pod still serving
        assert "camera unplugged" in pod.stream_metrics(1)["error"]

        pod.replace_source(1, iter(np.asarray(good.copy())),
                           reset_carry=True)
        t0 = time.monotonic()
        while pod.stream_metrics(1)["buffer_fill"] < 4:
            pod.raise_if_failed()
            assert time.monotonic() - t0 < 120
            time.sleep(0.005)
        assert pod.stream_metrics(1)["error"] is None
        pod.stop()


class TestPodResize:
    """Elastic capacity: MultiStreamAuralizer.resize grows/shrinks the
    slot count of a LIVE pod at a dispatch boundary; surviving slots'
    DSP carries ride along byte-continuously."""

    def _wait_fill(self, pod, slot, n, timeout=120.0):
        t0 = time.monotonic()
        while pod.stream_metrics(slot)["buffer_fill"] < n:
            pod.raise_if_failed()
            assert time.monotonic() - t0 < timeout
            time.sleep(0.005)

    def test_grow_live_preserves_serving_slot(self):
        """Resize 1→2 mid-stream: slot 0's PCM across the resize equals
        one uninterrupted offline run (the carry rides the batch-shape
        change untouched); the grown slot serves a fresh client."""
        cfg = AuralizerConfig()
        clip_a, clip_b = (np.asarray(c) for c in clips(2, 6))
        pod = MultiStreamAuralizer(cfg, n_streams=1,
                                   exit_when_exhausted=False)
        pod.start([iter(clip_a[:3])])
        self._wait_fill(pod, 0, 3)
        assert pod.is_running

        pod.resize(2)                      # blocks until applied
        assert pod.n_streams == 2
        assert len(pod.rings) == 2 and len(pod.params) == 2
        m = pod.stream_metrics(1)
        assert m["active"] is False and m["buffer_fill"] == 0

        # Continue slot 0 (same camera, carry continues) and arm the
        # new slot with a fresh client.
        pod.replace_source(0, iter(clip_a[3:]))
        pod.replace_source(1, iter(clip_b))
        self._wait_fill(pod, 0, 6)
        self._wait_fill(pod, 1, 6)
        ref_a, _, _ = run_offline(clip_a, cfg)
        ref_b, _, _ = run_offline(clip_b, cfg)
        np.testing.assert_allclose(pod.pull(0, 6 * HOP),
                                   np.asarray(ref_a), atol=2e-4)
        np.testing.assert_allclose(pod.pull(1, 6 * HOP),
                                   np.asarray(ref_b), atol=2e-4)
        pod.stop()

    def test_shrink_live_drops_highest_slots(self):
        cfg = AuralizerConfig()
        clip_a, clip_b, clip_c = (np.asarray(c) for c in clips(3, 3))
        pod = MultiStreamAuralizer(cfg, n_streams=3,
                                   exit_when_exhausted=False)
        pod.start([iter(clip_a), iter(clip_b), iter(clip_c)])
        for s in range(3):
            self._wait_fill(pod, s, 3)
        pcm0_before = pod.pull(0, HOP)     # partial drain pre-shrink
        pod.resize(1)
        assert pod.n_streams == 1
        assert len(pod.rings) == 1 and len(pod.params) == 1
        assert len(pod.slot_errors) == 1
        # Slot 0 survives: the rest of its buffered PCM is still there.
        ref_a, _, _ = run_offline(clip_a, cfg)
        got = np.concatenate([pcm0_before, pod.pull(0, 2 * HOP)])
        np.testing.assert_allclose(got, np.asarray(ref_a), atol=2e-4)
        # And it keeps serving after the shrink.
        pod.replace_source(0, iter(clip_a.copy()))
        self._wait_fill(pod, 0, 3)
        pod.stop()

    def test_resize_while_stopped_applies_immediately(self):
        cfg = AuralizerConfig()
        pod = MultiStreamAuralizer(cfg, n_streams=2)
        pod.resize(3)
        assert pod.n_streams == 3 and len(pod.rings) == 3
        srcs = clips(3, 4)
        pod.start([iter(np.asarray(c)) for c in srcs])
        wait_done(pod)
        for s, clip in enumerate(srcs):
            ref, _, _ = run_offline(np.asarray(clip), cfg)
            np.testing.assert_allclose(pod.pull(s, 4 * HOP),
                                       np.asarray(ref), atol=2e-4)
        pod.stop()

    def test_grow_chunked_pod(self):
        """Resize of a chunk-batched pod lands at a chunk boundary and
        the grown slot rides the chunk pipeline."""
        cfg = AuralizerConfig()
        clip_a, clip_b = (np.asarray(c) for c in clips(2, 4))
        pod = MultiStreamAuralizer(cfg, n_streams=1, chunk_frames=2,
                                   exit_when_exhausted=False)
        pod.start([iter(clip_a)])
        self._wait_fill(pod, 0, 4)
        pod.resize(2)
        assert pod.n_streams == 2
        pod.replace_source(1, iter(clip_b))
        self._wait_fill(pod, 1, 4)
        ref_b, _, _ = run_offline_batched(clip_b, cfg, chunk=2)
        np.testing.assert_allclose(pod.pull(1, 4 * HOP),
                                   np.asarray(ref_b), atol=2e-4)
        pod.stop()

    def test_grow_inherits_pan_angles_presence(self):
        """Growth must not break the cross-slot pan_angles-presence
        invariant (_stack_params): new slots copy slot 0's params."""
        cfg = AuralizerConfig()
        params = [LiveParams(stereo_width=0.5) for _ in range(2)]
        for p in params:
            p.pan_angles = np.zeros(cfg.num_cells, np.float32)
        pod = MultiStreamAuralizer(
            AuralizerConfig(channels=2), n_streams=2, params=params,
            exit_when_exhausted=False)
        clip = np.asarray(clips(1, 2)[0])
        pod.start([iter(clip), iter(clip.copy())])
        self._wait_fill(pod, 0, 2)
        pod.resize(3)
        assert pod.params[2] is not pod.params[0]
        assert pod.params[2].pan_angles is not None
        pod.replace_source(2, iter(clip.copy()))
        self._wait_fill(pod, 2, 2)         # dispatch survives stacking
        pod.stop()

    def test_resize_validation(self):
        from vaudio.parallel import make_stream_mesh
        pod = MultiStreamAuralizer(AuralizerConfig(), n_streams=2)
        with pytest.raises(ValueError, match=">= 1"):
            pod.resize(0)
        mesh_pod = MultiStreamAuralizer(
            AuralizerConfig(), n_streams=8, params=LiveParams(),
            mesh=make_stream_mesh(8, 1))
        with pytest.raises(ValueError, match="multiple"):
            mesh_pod.resize(4 + 8)         # 12 % 8 != 0


class TestSlotLeasing:
    """acquire_slot / release_slot — fleet allocation on top of the
    elastic resize: clients lease slots instead of tracking indices."""

    def _wait(self, cond, pod, timeout=120.0):
        t0 = time.monotonic()
        while not cond():
            pod.raise_if_failed()
            assert time.monotonic() - t0 < timeout
            time.sleep(0.005)

    def test_acquire_reuses_then_grows_then_caps(self):
        cfg = AuralizerConfig()
        clip = np.asarray(clips(1, 2)[0])
        pod = MultiStreamAuralizer(cfg, n_streams=2, max_streams=3,
                                   exit_when_exhausted=False)
        pod.start([iter(clip), iter(clip.copy())])
        # Both finite sources exhaust -> both slots free.
        self._wait(lambda: not any(pod._active), pod)
        assert pod.free_slots() == [0, 1]

        s0, ps0 = pod.acquire_slot()
        assert s0 == 0 and pod.push_sources[0] is ps0
        s1, ps1 = pod.acquire_slot()
        assert s1 == 1
        # No free slot left: grows to max_streams.
        s2, ps2 = pod.acquire_slot()
        assert s2 == 2 and pod.n_streams == 3
        # At capacity, everything leased.
        with pytest.raises(RuntimeError, match="at capacity"):
            pod.acquire_slot()

        # Leased slots actually serve: push frames, PCM arrives.
        for fr in clip:
            ps2.push(fr)
        self._wait(lambda: pod.stream_metrics(2)["buffer_fill"] >= 2,
                   pod)
        ref, _, _ = run_offline(clip, cfg)
        np.testing.assert_allclose(pod.pull(2, 2 * HOP),
                                   np.asarray(ref), atol=2e-4)
        pod.stop()

    def test_release_shrinks_trailing_and_reuses_holes(self):
        cfg = AuralizerConfig()
        clip = np.asarray(clips(1, 2)[0])
        pod = MultiStreamAuralizer(cfg, n_streams=1, max_streams=4,
                                   exit_when_exhausted=False)
        pod.start([iter(clip)])
        self._wait(lambda: not any(pod._active), pod)
        slots = [pod.acquire_slot()[0] for _ in range(3)]
        assert slots == [0, 1, 2] and pod.n_streams == 3

        # Trailing release with shrink returns the capacity.
        pod.release_slot(2, shrink=True)
        assert pod.n_streams == 2
        # Inner release leaves a hole that the next acquire reuses.
        pod.release_slot(0)
        self._wait(lambda: 0 in pod.free_slots(), pod)
        assert pod.n_streams == 2
        s, _ = pod.acquire_slot()
        assert s == 0 and pod.n_streams == 2
        pod.stop()

    def test_resize_lands_on_a_held_partial_chunk(self):
        """Review regression: a chunked pod idling on a PARTIAL chunk
        (push client paused mid-chunk) must still land a resize — the
        partial chunk is padded out and dispatched at the boundary
        instead of wedging every resize into TimeoutError."""
        cfg = AuralizerConfig()
        clip = np.asarray(clips(1, 4)[0])
        pod = MultiStreamAuralizer(cfg, n_streams=1, chunk_frames=3,
                                   exit_when_exhausted=False)
        pod.start([iter(())])
        ps = pod.arm_push(0, when_empty="dark")
        for fr in clip:      # 4 frames: one full chunk + a held partial
            ps.push(fr)
        # The full chunk dispatches on its own; frame 3 sits in the
        # partial chunk forever (the push slot idles dark).
        self._wait(lambda: pod.stream_metrics(0)["buffer_fill"] >= 3,
                   pod)
        pod.resize(2, timeout=60)      # must not TimeoutError
        assert pod.n_streams == 2
        # The padded dispatch delivered the partial chunk's REAL hop
        # (masked padding never reaches the ring).
        self._wait(lambda: pod.stream_metrics(0)["buffer_fill"] == 4,
                   pod)
        ref, _, _ = run_offline_batched(clip, cfg, chunk=3)
        np.testing.assert_allclose(pod.pull(0, 4 * HOP),
                                   np.asarray(ref), atol=2e-4)
        pod.stop()

    def test_release_gets_fresh_ring_contract(self):
        """Review regression: a re-leased slot must not serve the
        previous client's buffered PCM or inherit its warm-up/counter
        state (acquire_slot resets the ring fully)."""
        cfg = AuralizerConfig()
        clip = np.asarray(clips(1, 4)[0])
        pod = MultiStreamAuralizer(cfg, n_streams=1,
                                   exit_when_exhausted=False)
        pod.start([iter(())])
        slot, ps = pod.acquire_slot(when_empty="dark")
        for fr in clip:
            ps.push(fr)
        self._wait(lambda: pod.stream_metrics(0)["buffer_fill"] >= 4,
                   pod)
        pod.release_slot(slot)         # 4 hops left un-pulled
        self._wait(lambda: 0 in pod.free_slots(), pod)

        slot2, _ = pod.acquire_slot(when_empty="dark")
        assert slot2 == slot
        m = pod.stream_metrics(slot2)
        assert m["buffer_fill"] == 0   # previous client's PCM cleared
        assert m["warmed_up"] is False
        assert m["dropped_frames"] == 0
        pod.stop()

    def test_lease_timeout_reaps_dead_client(self):
        """A push-armed slot silent past lease_timeout is auto-released
        (dead-client reaping): the push stream closes, the slot drains
        dark, becomes free for the next lease, and the reap is counted.
        A slot still DELIVERING frames is never reaped."""
        cfg = AuralizerConfig()
        clip = np.asarray(clips(1, 2)[0])
        pod = MultiStreamAuralizer(cfg, n_streams=1, max_streams=2,
                                   exit_when_exhausted=False,
                                   lease_timeout=1.0)
        pod.start([iter(())])
        slot, ps = pod.acquire_slot(when_empty="dark")
        for fr in clip:                     # deliver, then go silent
            ps.push(fr)
        self._wait(lambda: pod.stream_metrics(0)["buffer_fill"] >= 2,
                   pod)
        # Client dies (no release): the reaper closes the lease.
        self._wait(lambda: pod.leases_reaped == 1, pod, timeout=30)
        self._wait(lambda: slot in pod.free_slots(), pod)
        assert pod.metrics_dict()["leases_reaped"] == 1
        # The slot is re-leasable after the reap.
        slot2, ps2 = pod.acquire_slot(when_empty="dark")
        assert slot2 == slot
        # A live client is NOT reaped while it keeps delivering: feed
        # frames for ~2x the timeout and assert the lease held.
        t0 = time.monotonic()
        while time.monotonic() - t0 < 2.2:
            ps2.push(clip[0])
            pod.raise_if_failed()
            time.sleep(0.05)
        assert not ps2.closed and pod.leases_reaped == 1
        m = pod.stream_metrics(slot2)
        assert m["idle_s"] < 1.0            # surfaced for observers
        pod.stop()

    def test_operator_door_unfed_is_not_reaped(self):
        """An operator-armed push door no client ever fed stays open
        past the timeout (an advertised door must outlive its wait for
        a first client); once fed and silent, it reaps like a lease."""
        cfg = AuralizerConfig()
        clip = np.asarray(clips(1, 2)[0])
        pod = MultiStreamAuralizer(cfg, n_streams=1,
                                   exit_when_exhausted=False,
                                   lease_timeout=0.5)
        pod.start([iter(())])
        ps = pod.arm_push(0, when_empty="dark")    # door, not a lease
        time.sleep(1.5)
        pod.raise_if_failed()
        assert not ps.closed and pod.leases_reaped == 0
        ps.push(clip[0])          # a client connects, pushes once, dies
        self._wait(lambda: pod.leases_reaped == 1, pod, timeout=30)
        assert ps.closed
        pod.stop()

    def test_lease_timeout_validation(self):
        with pytest.raises(ValueError, match="lease_timeout"):
            MultiStreamAuralizer(AuralizerConfig(), n_streams=1,
                                 lease_timeout=0.0)

    def test_max_streams_also_caps_resize(self):
        pod = MultiStreamAuralizer(AuralizerConfig(), n_streams=2,
                                   max_streams=3)
        with pytest.raises(ValueError, match="max_streams"):
            pod.resize(4)
        with pytest.raises(ValueError, match="max_streams"):
            MultiStreamAuralizer(AuralizerConfig(), n_streams=4,
                                 max_streams=2)


class TestIdleShrink:
    """idle_shrink: automatic capacity return — trailing free slots
    are shrunk away after the idle window (the third leg of the
    elastic loop: grow on acquire, reap dead clients, return the
    capacity)."""

    def _wait(self, cond, pod, timeout=120.0):
        t0 = time.monotonic()
        while not cond():
            pod.raise_if_failed()
            assert time.monotonic() - t0 < timeout
            time.sleep(0.005)

    def test_trailing_free_capacity_returns(self):
        """A released trailing lease is shrunk away after the window;
        a leased slot (open push arm, even with no frames yet) is
        NEVER shrunk; inner free holes are kept for reuse."""
        cfg = AuralizerConfig()
        pod = MultiStreamAuralizer(cfg, n_streams=1, max_streams=3,
                                   exit_when_exhausted=False,
                                   idle_shrink=1.0)
        pod.start([iter(())])
        s0, _ps0 = pod.acquire_slot(when_empty="dark")
        s1, _ps1 = pod.acquire_slot(when_empty="dark")
        s2, _ps2 = pod.acquire_slot(when_empty="dark")
        assert (s0, s1, s2) == (0, 1, 2) and pod.n_streams == 3
        # An inner release leaves a hole: nothing shrinks (slot 2 is
        # still leased) — the hole is reused by the next acquire.
        pod.release_slot(1)
        self._wait(lambda: 1 in pod.free_slots(), pod)
        time.sleep(2.2)
        pod.raise_if_failed()
        assert pod.n_streams == 3 and pod.auto_shrinks == 0
        s1b, _ = pod.acquire_slot(when_empty="dark")
        assert s1b == 1
        # Release the TRAILING leases: the idle window passes, the pod
        # shrinks to the last busy slot + 1 in ONE step.
        pod.release_slot(1)
        pod.release_slot(2)
        self._wait(lambda: pod.n_streams == 1, pod)
        assert pod.auto_shrinks == 1
        assert pod.metrics_dict()["auto_shrinks"] == 1
        # Slot 0's lease never lapsed (open push arm, zero frames).
        assert not pod.push_sources[0].closed
        pod.stop()

    def test_reap_then_shrink_full_loop(self):
        """lease_timeout + idle_shrink compose: a dead client's lease
        is reaped, its slot drains dark, and the idle window then
        returns the capacity — with zero operator calls."""
        cfg = AuralizerConfig()
        clip = np.asarray(clips(1, 2)[0])
        pod = MultiStreamAuralizer(cfg, n_streams=1, max_streams=2,
                                   exit_when_exhausted=False,
                                   lease_timeout=1.0, idle_shrink=1.0)
        pod.start([iter(clip)])        # slot 0: a finite pull source
        self._wait(lambda: not any(pod._active), pod)
        slot, ps = pod.acquire_slot(when_empty="dark")
        assert slot == 0               # reuses the free slot: no growth
        slot2, ps2 = pod.acquire_slot(when_empty="dark")
        assert slot2 == 1 and pod.n_streams == 2
        for fr in clip:                # client 1 delivers, then dies
            ps2.push(fr)
        keepalive = clip[0]
        t0 = time.monotonic()

        def alive_and(cond):
            # Keep lease 0 alive (fresh pushes) while waiting.
            ps.push(keepalive)
            return cond()
        self._wait(lambda: alive_and(lambda: pod.leases_reaped == 1),
                   pod, timeout=60)
        self._wait(lambda: alive_and(lambda: pod.n_streams == 1), pod,
                   timeout=60)
        assert pod.auto_shrinks == 1 and not ps.closed
        assert time.monotonic() - t0 < 60
        pod.stop()

    def test_validation(self):
        with pytest.raises(ValueError, match="idle_shrink"):
            MultiStreamAuralizer(AuralizerConfig(), n_streams=1,
                                 idle_shrink=0.0)

    def test_stale_auto_shrink_spares_fresh_lease(self):
        """A queued auto-shrink is RE-VALIDATED at apply time: a lease
        granted after the request was queued makes its slot non-free,
        so the shrink is dropped — the fresh lease survives and
        auto_shrinks stays 0 (the acquire-vs-auto-shrink race)."""
        import threading as _threading
        pod = MultiStreamAuralizer(AuralizerConfig(), n_streams=1,
                                   max_streams=2,
                                   exit_when_exhausted=False,
                                   idle_shrink=30.0)
        pod.start([iter(())])
        _s0, _ps0 = pod.acquire_slot(when_empty="dark")
        s1, ps1 = pod.acquire_slot(when_empty="dark")
        assert s1 == 1 and pod.n_streams == 2
        # Simulate the race: an auto-shrink request queued BEFORE the
        # trailing lease landed, consumed by the producer after.
        with pod._source_lock:
            pod._resize_req = (1, _threading.Event(), "auto")
        self._wait(lambda: pod._resize_req is None, pod)
        time.sleep(0.3)               # let the (dropped) apply settle
        pod.raise_if_failed()
        assert pod.n_streams == 2 and pod.auto_shrinks == 0
        assert not ps1.closed
        pod.stop()


class TestElasticStress:
    def test_concurrent_acquires_get_distinct_slots(self):
        """Two racing acquires must never lease the same slot (the
        lease lock), and growth stays within max_streams."""
        import concurrent.futures as cf
        cfg = AuralizerConfig()
        pod = MultiStreamAuralizer(cfg, n_streams=1, max_streams=8,
                                   exit_when_exhausted=False)
        pod.start([iter(())])
        try:
            with cf.ThreadPoolExecutor(6) as ex:
                got = list(ex.map(
                    lambda _: pod.acquire_slot(when_empty="dark")[0],
                    range(6)))
            assert sorted(got) == sorted(set(got)), got
            assert pod.n_streams <= 8
        finally:
            pod.stop()

    def test_random_ops_stress(self):
        """Seeded random acquire/release/resize/push churn against a
        LIVE pod: the producer must survive every interleaving and the
        per-slot lists must track n_streams (the resize ordering
        contract)."""
        import random
        rng = random.Random(1234)
        cfg = AuralizerConfig()
        frame = np.asarray(clips(1, 1)[0])[0]
        pod = MultiStreamAuralizer(cfg, n_streams=2, max_streams=5,
                                   exit_when_exhausted=False)
        pod.start([iter(()), iter(())])
        leases = {}
        try:
            for step in range(40):
                op = rng.choice(["acquire", "release", "resize",
                                 "push", "metrics"])
                if op == "acquire":
                    try:
                        slot, ps = pod.acquire_slot(when_empty="dark")
                        leases[slot] = ps
                    except RuntimeError:
                        pass                      # at capacity: fine
                elif op == "release" and leases:
                    slot = rng.choice(list(leases))
                    del leases[slot]
                    if slot < pod.n_streams:
                        pod.release_slot(slot,
                                         shrink=rng.random() < 0.5)
                    leases = {s: p for s, p in leases.items()
                              if s < pod.n_streams}
                elif op == "resize":
                    n = rng.randint(1, 5)
                    try:
                        pod.resize(n, timeout=60)
                    except ValueError:
                        pass
                    leases = {s: p for s, p in leases.items()
                              if s < pod.n_streams}
                elif op == "push" and leases:
                    slot = rng.choice(list(leases))
                    ps = leases[slot]
                    if not ps.closed:
                        ps.push(frame)
                else:
                    m = pod.metrics_dict()
                    assert len(m["slots"]) <= pod.n_streams + 1
                pod.raise_if_failed()
                # Ordering contract: lists never shorter than n_streams.
                n = pod.n_streams
                assert len(pod.rings) >= n and len(pod.params) >= n
                assert len(pod.push_sources) >= n
            assert pod.is_running
        finally:
            pod.stop()

    def test_random_ops_stress_with_auto_elasticity(self):
        """The same churn with the HANDS-OFF features live —
        lease_timeout reaping and idle_shrink capacity return running
        concurrently with explicit acquire/release/resize/push: the
        producer survives every interleaving, capacity stays within
        [1, max_streams], and the pod still serves at the end (a fresh
        lease processes frames)."""
        import random
        rng = random.Random(20260819)
        cfg = AuralizerConfig()
        frame = np.asarray(clips(1, 1)[0])[0]
        pod = MultiStreamAuralizer(cfg, n_streams=2, max_streams=5,
                                   exit_when_exhausted=False,
                                   lease_timeout=0.4, idle_shrink=0.4)
        pod.start([iter(()), iter(())])
        leases = {}
        try:
            for step in range(60):
                op = rng.choice(["acquire", "release", "resize",
                                 "push", "sleep", "metrics"])
                if op == "acquire":
                    try:
                        slot, ps = pod.acquire_slot(when_empty="dark")
                        leases[slot] = ps
                    except RuntimeError:
                        pass                      # at capacity: fine
                elif op == "release" and leases:
                    slot = rng.choice(list(leases))
                    del leases[slot]
                    if slot < pod.n_streams:
                        try:
                            pod.release_slot(slot)
                        except (TimeoutError, IndexError):
                            # A concurrent reap+auto-shrink can remove
                            # the slot between the guard and the call.
                            pass
                elif op == "resize":
                    try:
                        pod.resize(rng.randint(1, 5), timeout=60)
                    except ValueError:
                        pass
                elif op == "push" and leases:
                    slot = rng.choice(list(leases))
                    ps = leases[slot]
                    if not ps.closed:
                        ps.push(frame)
                elif op == "sleep":
                    # Long enough for reaps/shrinks to actually fire
                    # mid-churn, not just at the end.
                    time.sleep(0.5)
                else:
                    m = pod.metrics_dict()
                    assert 1 <= m["n_streams"] <= 5
                # Reaps/shrinks invalidate leases behind our back —
                # drop closed or out-of-range handles like a real
                # fleet client discovering a 404/closed push.
                leases = {s: p for s, p in leases.items()
                          if s < pod.n_streams and not p.closed}
                pod.raise_if_failed()
                # The producer applies auto-shrinks CONCURRENTLY with
                # these reads, so only race-safe bounds are asserted
                # here (the lists-vs-n_streams ordering contract is
                # pinned by the non-auto stress test, where every
                # resize is synchronous with this thread).
                assert 1 <= pod.n_streams <= 5
            assert pod.is_running
            # The pod still SERVES after all that churn: a fresh lease
            # accepts and processes frames.
            slot, ps = pod.acquire_slot(when_empty="dark")
            for _ in range(3):
                ps.push(frame)
            deadline = time.monotonic() + 120
            while pod.stream_metrics(slot)["buffer_fill"] < 1:
                pod.raise_if_failed()
                assert time.monotonic() < deadline
                time.sleep(0.01)
        finally:
            pod.stop()


class TestPodCLI:
    def test_pod_cli_writes_per_slot_wavs(self, tmp_path):
        """`vaudio pod --input a.npy --input b.npy` writes slotN.wav per
        input through the batched dispatch (CPU-forced subprocess)."""
        import os
        import subprocess
        import sys
        import wave

        a, b = clips(2, 5)
        pa, pb = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
        np.save(pa, np.asarray(a))
        np.save(pb, np.asarray(b))
        outdir = str(tmp_path / "pod_out")
        env = dict(os.environ, VAUDIO_PLATFORM="cpu",
                   JAX_COMPILATION_CACHE_DIR="/tmp/vaudio_test_jax_cache",
                   PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH",
                                                             ""))
        res = subprocess.run(
            [sys.executable, "-m", "vaudio", "pod", "--size", "64x64",
             "--input", pa, "--input", pb, "-o", outdir,
             "--chunk-frames", "2"],
            capture_output=True, timeout=600, env=env, cwd="/root/repo")
        assert res.returncode == 0, res.stderr.decode()[-800:]
        for i in range(2):
            with wave.open(os.path.join(outdir, f"slot{i}.wav")) as wv:
                assert wv.getnframes() == 5 * HOP
                assert wv.getframerate() == 44100
        assert b"pod: 10 frames over 2 streams" in res.stderr


    @pytest.mark.parametrize("model", ["auralizer", "orthomodes"])
    def test_pod_cli_mesh(self, tmp_path, model):
        """`vaudio pod --mesh 2` serves over a 2-device mesh at the CLI
        front door (both model families; CPU-forced subprocess with two
        virtual devices)."""
        import os
        import subprocess
        import sys
        import wave

        a, b = clips(2, 4)
        pa, pb = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
        np.save(pa, np.asarray(a))
        np.save(pb, np.asarray(b))
        outdir = str(tmp_path / "pod_out")
        # 4 devices with --mesh 2: the mesh must SUBSET the device
        # list, not reshape all of them (regression: a reshape crash
        # whenever the mesh used fewer devices than the host has).
        env = dict(os.environ, VAUDIO_PLATFORM="cpu",
                   VAUDIO_NUM_CPU_DEVICES="4",
                   JAX_COMPILATION_CACHE_DIR="/tmp/vaudio_test_jax_cache",
                   PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH",
                                                             ""))
        res = subprocess.run(
            [sys.executable, "-m", "vaudio", "pod", "--size", "64x64",
             "--input", pa, "--input", pb, "-o", outdir,
             "--mesh", "2", "--model", model],
            capture_output=True, timeout=600, env=env, cwd="/root/repo")
        assert res.returncode == 0, res.stderr.decode()[-800:]
        assert b"device mesh stream=2 cell=1 (2 of 4 devices)" \
            in res.stderr
        for i in range(2):
            with wave.open(os.path.join(outdir, f"slot{i}.wav")) as wv:
                assert wv.getnframes() == 4 * HOP

    def test_pod_cli_mesh_validation(self, tmp_path):
        """Bad --mesh values exit with a clear message, not a
        traceback: inputs not a multiple of DP, and zero axes."""
        import os
        import subprocess
        import sys

        clip = np.asarray(clips(1, 2)[0])
        paths = []
        for i in range(3):
            p = str(tmp_path / f"c{i}.npy")
            np.save(p, clip)
            paths.append(p)
        env = dict(os.environ, VAUDIO_PLATFORM="cpu",
                   VAUDIO_NUM_CPU_DEVICES="4",
                   PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH",
                                                             ""))
        res = subprocess.run(
            [sys.executable, "-m", "vaudio", "pod", "--size", "64x64",
             "-o", str(tmp_path / "o"), "--mesh", "2",
             "--input", paths[0], "--input", paths[1],
             "--input", paths[2]],
            capture_output=True, timeout=300, env=env, cwd="/root/repo")
        assert res.returncode != 0
        assert b"not a multiple of the --mesh stream axis" in res.stderr
        assert b"Traceback" not in res.stderr
        res = subprocess.run(
            [sys.executable, "-m", "vaudio", "pod", "--size", "64x64",
             "-o", str(tmp_path / "o"), "--mesh", "0",
             "--input", paths[0]],
            capture_output=True, timeout=300, env=env, cwd="/root/repo")
        assert res.returncode != 0
        assert b"axes must be >= 1" in res.stderr

    def test_pod_cli_encoded_video_inputs(self, tmp_path):
        """`vaudio pod --input a.mp4 --input b.mp4` — encoded clips are
        decoded in-process per slot (CPU-forced subprocess)."""
        import os
        import subprocess
        import sys
        import wave

        cv2 = pytest.importorskip("cv2")
        paths = []
        for i, color in enumerate([(255, 0, 0), (0, 0, 255)]):
            frames = np.stack([np.full((64, 64, 3), color, np.uint8)
                               for _ in range(5)])
            path = str(tmp_path / f"clip{i}.mp4")
            wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 30, (64, 64))
            if not wr.isOpened():
                pytest.skip("cv2 VideoWriter cannot encode mp4 here")
            for f in frames:
                wr.write(f[..., ::-1])
            wr.release()
            paths.append(path)
        outdir = str(tmp_path / "pod_out")
        env = dict(os.environ, VAUDIO_PLATFORM="cpu",
                   JAX_COMPILATION_CACHE_DIR="/tmp/vaudio_test_jax_cache",
                   PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH",
                                                             ""))
        res = subprocess.run(
            [sys.executable, "-m", "vaudio", "pod", "--size", "64x64",
             "--input", paths[0], "--input", paths[1], "-o", outdir,
             "--chunk-frames", "2"],
            capture_output=True, timeout=600, env=env, cwd="/root/repo")
        assert res.returncode == 0, res.stderr.decode()[-800:]
        for i in range(2):
            with wave.open(os.path.join(outdir, f"slot{i}.wav")) as wv:
                assert wv.getnframes() == 5 * HOP


class TestPodCLICheckpoint:
    def test_pod_split_across_two_cli_processes(self, tmp_path):
        """`vaudio pod --save-state` / `--load-state`: a pod split
        across two CLI processes produces the same PCM as one
        continuous run, per slot (CPU-forced subprocesses)."""
        import os
        import subprocess
        import sys
        import wave

        srcs = [np.asarray(c) for c in clips(2, 6)]
        env = dict(os.environ, VAUDIO_PLATFORM="cpu",
                   JAX_COMPILATION_CACHE_DIR="/tmp/vaudio_test_jax_cache",
                   PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH",
                                                             ""))

        def run_pod(inputs, outdir, *extra):
            paths = []
            for i, arr in enumerate(inputs):
                p = str(tmp_path / f"in_{outdir}_{i}.npy")
                np.save(p, arr)
                paths.append(p)
            args = [sys.executable, "-m", "vaudio", "pod", "--size",
                    "64x64", "-o", str(tmp_path / outdir), *extra]
            for p in paths:
                args += ["--input", p]
            res = subprocess.run(args, capture_output=True, timeout=600,
                                 env=env, cwd="/root/repo")
            assert res.returncode == 0, res.stderr.decode()[-800:]

        def pcm(outdir, slot):
            with wave.open(str(tmp_path / outdir / f"slot{slot}.wav")) \
                    as wv:
                return np.frombuffer(wv.readframes(wv.getnframes()),
                                     np.int16)

        ckpt = str(tmp_path / "pod.npz")
        run_pod([s[:3] for s in srcs], "first", "--save-state", ckpt)
        run_pod([s[3:] for s in srcs], "second", "--load-state", ckpt)
        run_pod(srcs, "whole")
        for slot in range(2):
            split = np.concatenate([pcm("first", slot),
                                    pcm("second", slot)])
            whole = pcm("whole", slot)
            assert split.shape == whole.shape
            assert np.array_equal(split, whole), \
                f"slot {slot} PCM not continuous across the checkpoint"


class TestPodCheckpoint:
    def test_save_load_continuity(self, tmp_path):
        """A pod split across two instances via save_state/load_state
        produces the same PCM as one continuous run, for every slot."""
        cfg = AuralizerConfig()
        srcs = [np.asarray(c) for c in clips(2, 6)]
        path = str(tmp_path / "pod.npz")

        pod1 = MultiStreamAuralizer(cfg, n_streams=2)
        pod1.start([iter(s[:3]) for s in srcs])
        wait_done(pod1)
        first = [pod1.pull(i, 3 * HOP) for i in range(2)]
        pod1.save_state(path)
        pod1.stop()

        pod2 = MultiStreamAuralizer(cfg, n_streams=2)
        pod2.load_state(path)
        pod2.start([iter(s[3:]) for s in srcs])
        wait_done(pod2)
        for i, clip in enumerate(srcs):
            ref, _, _ = run_offline(clip, cfg)
            got = np.concatenate([first[i], pod2.pull(i, 3 * HOP)])
            np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4)
        pod2.stop()

    def test_load_wrong_pod_size_raises(self, tmp_path):
        cfg = AuralizerConfig()
        path = str(tmp_path / "pod.npz")
        pod = MultiStreamAuralizer(cfg, n_streams=2)
        pod.save_state(path)
        with pytest.raises(ValueError, match="pod size"):
            MultiStreamAuralizer(cfg, n_streams=3).load_state(path)

    def test_metrics_log_jsonl(self, tmp_path):
        import json
        cfg = AuralizerConfig()
        log = str(tmp_path / "pod_metrics.jsonl")
        pod = MultiStreamAuralizer(cfg, n_streams=2, metrics_log=log)
        pod.start([iter(np.asarray(c)) for c in clips(2, 3)])
        wait_done(pod)
        pod.stop()
        records = [json.loads(line) for line in open(log)]
        assert len(records) == 3
        assert sum(r["frames"] for r in records) == 6
        assert all(len(r["slots"]) == 2 for r in records)


class TestTraceFlag:
    def test_pod_trace_writes_profile(self, tmp_path):
        """--trace DIR captures a jax.profiler trace of the run (the
        device-level observability surface, SURVEY.md §5)."""
        import os
        import subprocess
        import sys

        clip = np.asarray(clips(1, 3)[0])
        p = str(tmp_path / "c.npy")
        np.save(p, clip)
        tdir = str(tmp_path / "trace")
        env = dict(os.environ, VAUDIO_PLATFORM="cpu",
                   JAX_COMPILATION_CACHE_DIR="/tmp/vaudio_test_jax_cache",
                   PYTHONPATH="/root/repo:" + os.environ.get("PYTHONPATH",
                                                             ""))
        res = subprocess.run(
            [sys.executable, "-m", "vaudio", "pod", "--size", "64x64",
             "--input", p, "-o", str(tmp_path / "out"), "--trace", tdir],
            capture_output=True, timeout=600, env=env, cwd="/root/repo")
        assert res.returncode == 0, res.stderr.decode()[-800:]
        captured = [os.path.join(r, f) for r, _, fs in os.walk(tdir)
                    for f in fs]
        assert captured, "trace dir is empty"


class TestPodPerSlotParams:
    def test_stereo_width_per_slot(self):
        """Slot 1's live stereo_width=0 collapses ITS image to dual mono
        while slot 0 keeps the full pan law — per-slot control rides the
        stacked params axis with no recompile."""
        cfg = AuralizerConfig(channels=2)
        params = [LiveParams(), LiveParams(stereo_width=0.0)]
        clip = np.asarray(clips(1, 4)[0])
        pod = MultiStreamAuralizer(cfg, n_streams=2, params=params)
        pod.start([iter(clip), iter(clip.copy())])
        wait_done(pod)
        wide = pod.pull(0, 4 * HOP * 2).reshape(-1, 2)
        mono = pod.pull(1, 4 * HOP * 2).reshape(-1, 2)
        assert np.any(mono != 0.0)
        np.testing.assert_array_equal(mono[:, 0], mono[:, 1])
        assert not np.allclose(wide[:, 0], wide[:, 1], atol=1e-6)
        pod.stop()

    def test_param_field_mismatch_fails_loudly(self):
        cfg = AuralizerConfig()
        params = [LiveParams(pan_angles=np.linspace(0, np.pi / 2, 16)),
                  LiveParams()]
        clip = np.asarray(clips(1, 2)[0])
        pod = MultiStreamAuralizer(cfg, n_streams=2, params=params)
        pod.start([iter(clip), iter(clip.copy())])
        t0 = time.monotonic()
        while pod.is_running:
            assert time.monotonic() - t0 < 120
            time.sleep(0.005)
        with pytest.raises(RuntimeError, match="pod producer failed"):
            pod.raise_if_failed()
        pod.stop()
