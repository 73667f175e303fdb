"""Multi-chip sharding tests on the 8-device virtual CPU mesh
(SURVEY.md §4: shard_map configs tested without real accelerators)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vaudio.config import AuralizerConfig, LiveParams
from vaudio.parallel import (init_carry_batch, make_batched_step,
                             make_parallel_step, make_stream_mesh,
                             run_offline_parallel)
from vaudio.runtime import init_carry, make_step, run_offline


CFG = AuralizerConfig()
PARAMS = LiveParams().as_arrays()


@pytest.fixture(scope="module")
def frames8(request):
    rng = np.random.default_rng(42)
    return rng.uniform(0, 1, (8, 3, 64, 64, 3)).astype(np.float32)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


class TestBatchedStep:
    def test_matches_sequential(self, frames8):
        step1 = make_step(CFG, jit=False)
        stepN = make_batched_step(CFG, jit=True)
        carryN = init_carry_batch(CFG, 8)
        carryN, outN = stepN(carryN, jnp.asarray(frames8[:, 0]), PARAMS)
        for s in range(0, 8, 3):
            _, out1 = step1(init_carry(CFG), jnp.asarray(frames8[s, 0]),
                            PARAMS)
            np.testing.assert_allclose(np.asarray(outN["pcm"][s]),
                                       np.asarray(out1["pcm"]), atol=2e-4)


class TestParallelStep:
    @pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
    def test_matches_single_device(self, frames8, mesh_shape):
        n_stream, n_cell = mesh_shape
        mesh = make_stream_mesh(n_stream, n_cell)
        stepP = make_parallel_step(CFG, mesh)
        stepB = make_batched_step(CFG)
        carryP, outP = stepP(init_carry_batch(CFG, 8),
                             jnp.asarray(frames8[:, 0]), PARAMS)
        carryB, outB = stepB(init_carry_batch(CFG, 8),
                             jnp.asarray(frames8[:, 0]), PARAMS)
        np.testing.assert_allclose(np.asarray(outP["pcm"]),
                                   np.asarray(outB["pcm"]), atol=3e-4)
        np.testing.assert_array_equal(np.asarray(carryP.hues),
                                      np.asarray(carryB.hues))

    @pytest.mark.parametrize("flags", [
        {"channels": 2},
        {"enable_filters": True},
        {"channels": 2, "enable_filters": True},
        {"quirk_compat": False},
        {"linear_cell_grads": False},
    ], ids=lambda f: "+".join(f"{k}={v}" for k, v in f.items()))
    def test_flag_matrix_on_tp_mesh(self, frames8, flags):
        """Every config flag must survive the (4,2) DP+TP decomposition —
        the TP step is feature-complete, not a narrowed special case."""
        cfg = AuralizerConfig(**flags)
        params = dict(PARAMS)
        if flags.get("enable_filters"):
            # Make the filter actually bite so a TP-side omission would
            # show up as a mismatch.
            params["hp_cutoff"] = np.float32(500.0)
            params["hp_order"] = np.float32(2.0)
            params["lp_cutoff"] = np.float32(4000.0)
            params["lp_order"] = np.float32(1.0)
        mesh = make_stream_mesh(4, 2)
        stepP = make_parallel_step(cfg, mesh)
        stepB = make_batched_step(cfg)
        carryP, outP = stepP(init_carry_batch(cfg, 8),
                             jnp.asarray(frames8[:, 0]), params)
        carryB, outB = stepB(init_carry_batch(cfg, 8),
                             jnp.asarray(frames8[:, 0]), params)
        np.testing.assert_allclose(np.asarray(outP["pcm"]),
                                   np.asarray(outB["pcm"]), atol=3e-4)
        np.testing.assert_array_equal(np.asarray(carryP.hues),
                                      np.asarray(carryB.hues))

    def test_stereo_image_survives_tp(self, frames8):
        """An off-center hue field must produce L != R through the TP
        mesh (the pan law is sliced per cell shard)."""
        cfg = AuralizerConfig(channels=2)
        frame = np.zeros((64, 64, 3), np.float32)
        frame[:, 48:] = [1.0, 0.1, 0.1]   # color mass on the right
        frames = jnp.asarray(np.broadcast_to(frame, (8, 64, 64, 3)))
        mesh = make_stream_mesh(4, 2)
        step = make_parallel_step(cfg, mesh)
        carry, out = step(init_carry_batch(cfg, 8), frames, PARAMS)
        carry, out = step(carry, frames, PARAMS)  # past warm-up silence
        pcm = np.asarray(out["pcm"])              # (8, hop, 2)
        el = np.abs(pcm[0, :, 0]).sum()
        er = np.abs(pcm[0, :, 1]).sum()
        assert el > 0 and er > 0 and not np.isclose(el, er, rtol=1e-3)

    def test_collective_present_in_hlo(self):
        # The cell axis must introduce a real reduction collective.
        mesh = make_stream_mesh(2, 4)
        step = make_parallel_step(CFG, mesh, jit=False)
        carry = init_carry_batch(CFG, 2)
        frames = jnp.zeros((2, 64, 64, 3), jnp.float32)
        hlo = jax.jit(step).lower(carry, frames, PARAMS).as_text()
        assert "all_reduce" in hlo or "all-reduce" in hlo


class TestParallelChunked:
    def test_chunked_dp_matches_offline(self, frames8):
        """The DP x chunk-batched pipeline (one Pallas contraction per
        stream-chunk) must match the per-stream scan exactly."""
        mesh = make_stream_mesh(8, 1)
        audio_p, final, _ = run_offline_parallel(frames8, CFG, mesh, PARAMS,
                                              pipeline="chunked")
        audio_p = np.asarray(audio_p)
        assert audio_p.shape == (8, 3 * 2048)
        for s in (0, 7):
            a_ref, _, _ = run_offline(frames8[s], CFG, PARAMS)
            np.testing.assert_allclose(audio_p[s], np.asarray(a_ref),
                                       atol=3e-4)

    def test_debug_outputs_returned(self, frames8):
        """debug=True must actually RETURN the per-frame debug stacks
        (hues/spectrum), matching run_offline's contract — previously
        they were computed and silently discarded."""
        mesh = make_stream_mesh(8, 1)
        for pipeline in ("chunked", "scan"):
            _a, _f, dbg = run_offline_parallel(
                frames8, CFG, mesh, PARAMS, debug=True, pipeline=pipeline)
            assert "hues" in dbg, pipeline
            assert np.asarray(dbg["hues"]).shape[:2] == (8, 3), pipeline

    def test_auto_picks_chunked_on_dp_mesh(self, frames8):
        mesh = make_stream_mesh(8, 1)
        a1, _, _ = run_offline_parallel(frames8, CFG, mesh, PARAMS,
                                     pipeline="auto")
        a2, _, _ = run_offline_parallel(frames8, CFG, mesh, PARAMS,
                                     pipeline="chunked")
        np.testing.assert_allclose(np.asarray(a1), np.asarray(a2),
                                   atol=1e-6)

    def test_chunked_rejects_tp_mesh(self):
        from vaudio.parallel import make_parallel_chunk_step
        mesh = make_stream_mesh(4, 2)
        with pytest.raises(ValueError, match="DP-only"):
            make_parallel_chunk_step(CFG, mesh)


class TestOfflineParallel:
    def test_matches_offline_per_stream(self, frames8):
        mesh = make_stream_mesh(4, 2)
        audio_p, final, _ = run_offline_parallel(frames8, CFG, mesh, PARAMS)
        audio_p = np.asarray(audio_p)
        assert audio_p.shape == (8, 3 * 2048)
        for s in (0, 5):
            a_ref, _, _ = run_offline(frames8[s], CFG, PARAMS)
            np.testing.assert_allclose(audio_p[s], np.asarray(a_ref),
                                       atol=3e-4)

    def test_output_sharded_over_streams(self, frames8):
        mesh = make_stream_mesh(8, 1)
        audio_p, final, _ = run_offline_parallel(frames8, CFG, mesh, PARAMS)
        assert np.asarray(final.hues).shape == (8, 16)


class TestMultiHost:
    """Multi-host ingest layer (vaudio.parallel.multihost), exercised
    single-process on the virtual mesh — the same code path real
    deployments run, with process_count == 1."""

    def test_local_slice_covers_all_single_process(self):
        from vaudio.parallel import local_stream_slice, make_multihost_mesh
        mesh = make_multihost_mesh()
        sl = local_stream_slice(mesh, 16)
        assert (sl.start, sl.stop) == (0, 16)
        with pytest.raises(ValueError, match="divisible"):
            local_stream_slice(mesh, 9)

    def test_distribute_local_frames_sharding(self, frames8):
        from vaudio.parallel import (distribute_local_frames,
                                     make_multihost_mesh)
        mesh = make_multihost_mesh()
        arr = distribute_local_frames(mesh, frames8, 8)
        assert arr.shape == frames8.shape
        # One stream row per device.
        starts = sorted(int(s.index[0].start or 0)
                        for s in arr.addressable_shards)
        assert starts == list(range(8))
        with pytest.raises(ValueError, match="owns"):
            distribute_local_frames(mesh, frames8[:4], 8)

    def test_multihost_matches_offline(self, frames8):
        from vaudio.parallel import MultiHostAuralizer
        mh = MultiHostAuralizer(CFG, n_streams=8, params=PARAMS)
        assert mh.n_local_streams == 8
        pcm = mh.step(frames8)          # one 3-frame chunk per stream
        local = mh.local_audio(pcm)
        assert local.shape == (8, 3 * 2048)
        for s in (0, 7):
            a_ref, _, _ = run_offline(frames8[s], CFG, PARAMS)
            np.testing.assert_allclose(local[s], np.asarray(a_ref),
                                       atol=3e-4)

    def test_multihost_carry_persists_across_chunks(self, frames8):
        from vaudio.parallel import MultiHostAuralizer
        mh = MultiHostAuralizer(CFG, n_streams=8, params=PARAMS)
        a1 = mh.local_audio(mh.step(frames8))
        a2 = mh.local_audio(mh.step(frames8))
        full, _, _ = run_offline(
            np.concatenate([frames8[0], frames8[0]]), CFG, PARAMS)
        np.testing.assert_allclose(
            np.concatenate([a1[0], a2[0]]), np.asarray(full), atol=3e-4)

    def test_init_distributed_single_process_noop(self):
        from vaudio.parallel import init_distributed
        assert init_distributed() == jax.process_count() == 1

    def test_stereo_multihost(self, frames8):
        import dataclasses
        from vaudio.parallel import MultiHostAuralizer
        cfg = dataclasses.replace(CFG, channels=2)
        mh = MultiHostAuralizer(cfg, n_streams=8, params=PARAMS)
        local = mh.local_audio(mh.step(frames8))
        assert local.shape == (8, 3 * 2048, 2)
        assert np.all(np.isfinite(local))
