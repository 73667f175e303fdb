"""One process of a 2-process MultiHostPod CPU test (not a test module —
launched by tests/test_hostpod.py::TestTwoProcess as two real OS
processes talking through JAX's distributed runtime + Gloo CPU
collectives).

Usage: python hostpod_driver.py <process_id> <num_processes> <port> <outdir>

Each process forces the CPU backend through jax.config BEFORE any backend
touch (environment variables are read too late once jax is imported),
brings up 2 local
virtual CPU devices, joins the coordinator, and serves its half of a
4-slot global pod.  Every global slot is fed a deterministic solid-color
clip; each process writes ITS slots' pulled PCM to
``<outdir>/pcm_<global_slot>.npy`` for the parent to compare against
single-process offline runs.
"""

import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_cpu_collectives_implementation", "gloo")

import numpy as np  # noqa: E402

COLORS = [
    [0.9, 0.2, 0.1],
    [0.1, 0.8, 0.3],
    [0.2, 0.3, 0.9],
    [0.8, 0.8, 0.1],
]
N_FRAMES = 6
HOP = 2048


def clip(g):
    # 144x192: the smallest solid-color frame whose hue histogram passes
    # the count>20 gate (27 px/cell at mip 3) — each color sonifies to
    # DIFFERENT audio, so the parent's per-slot compare catches any
    # slot-routing / shard-gather mixups (at smaller sizes every hue is
    # gated invalid and all four clips yield byte-identical PCM).
    from vaudio.io import solid_color_frames
    return np.asarray(solid_color_frames(COLORS[g], width=192, height=144,
                                         num_frames=N_FRAMES))


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    outdir = sys.argv[4]
    jax.distributed.initialize(f"localhost:{port}", num_processes=nproc,
                               process_id=pid)
    assert jax.process_count() == nproc
    assert len(jax.devices()) == 2 * nproc

    from vaudio.config import AuralizerConfig
    from vaudio.parallel import MultiHostPod

    cfg = AuralizerConfig()
    n_global = 2 * nproc
    pod = MultiHostPod(cfg, n_global,
                       frame=np.zeros((144, 192, 3), np.float32),
                       chunk_frames=2)
    lo, hi = pod.local_slice.start, pod.local_slice.stop
    assert hi - lo == 2 and pod.n_streams == 2
    assert pod.metrics_dict()["global_streams"] == n_global

    pod.start([iter(clip(g)) for g in range(lo, hi)])
    t0 = time.monotonic()
    while pod.is_running:
        pod.raise_if_failed()
        if time.monotonic() - t0 > 500:
            raise TimeoutError("pod still running")
        time.sleep(0.01)
    pod.raise_if_failed()
    for i, g in enumerate(range(lo, hi)):
        np.save(f"{outdir}/pcm_{g}.npy", pod.pull(i, N_FRAMES * HOP))
    pod.stop()
    print(f"proc {pid}: slots {lo}:{hi} done", flush=True)


if __name__ == "__main__":
    main()
