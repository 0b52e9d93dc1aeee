"""Multi-host (multi-process) bring-up, exercised for real: two OS
processes join a localhost `jax.distributed` coordination service (DCN
analog), build one global 8-device mesh (4 CPU devices per process), run
the sharded renderer across it, and must produce images that are (a)
identical to each other and (b) bit-identical to the single-process render
of the same seed — the shard-invariant RNG contract (core/rng.py).

SURVEY.md §4.4 ("multi-host logic tested with jax.distributed on localhost
multi-process"); reference has no parallelism at all (camera.hpp:40-67).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
import jax
import numpy as np

pid = int(sys.argv[1]); port = sys.argv[2]; outdir = sys.argv[3]

from raytracing_tpu.parallel.mesh import initialize_distributed
ok = initialize_distributed(f"localhost:{port}", num_processes=2, process_id=pid)
assert ok, "distributed init failed"
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())
assert len(jax.local_devices()) == 4

from raytracing_tpu.models.scenes import build
from raytracing_tpu.parallel.multihost import global_mesh, render_sharded_distributed

scene, cfg = build("three_spheres", image_width=16, samples_per_pixel=4, max_depth=3)
mesh = global_mesh((4, 2), ("dp", "sp"))
img, segs = render_sharded_distributed(scene, cfg, mesh, seed=5)
np.save(os.path.join(outdir, f"img_{pid}.npy"), img)
with open(os.path.join(outdir, f"segs_{pid}.txt"), "w") as f:
    f.write(str(segs))
print("WORKER_OK", pid)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
class TestMultiHost:
    def test_two_process_render_bit_identical(self, tmp_path):
        port = _free_port()
        worker = tmp_path / "worker.py"
        worker.write_text(_WORKER)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = repo
        procs = [
            subprocess.Popen(
                [sys.executable, str(worker), str(i), str(port), str(tmp_path)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            )
            for i in range(2)
        ]
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=420)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            outs.append((p.returncode, out, err))
        for rc, out, err in outs:
            assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-2000:]}"
            assert "WORKER_OK" in out

        img0 = np.load(tmp_path / "img_0.npy")
        img1 = np.load(tmp_path / "img_1.npy")
        np.testing.assert_array_equal(img0, img1)

        # bit-identical to the single-process sharded render (8 virtual
        # devices in this test process, same mesh shape, same seed)
        from raytracing_tpu.models.scenes import build
        from raytracing_tpu.parallel.mesh import make_mesh
        from raytracing_tpu.parallel.shard import render_sharded

        scene, cfg = build(
            "three_spheres", image_width=16, samples_per_pixel=4, max_depth=3
        )
        mesh = make_mesh((4, 2), ("dp", "sp"))
        ref, segs_ref = render_sharded(scene, cfg, mesh, seed=5)
        np.testing.assert_array_equal(img0, ref)
        segs0 = int((tmp_path / "segs_0.txt").read_text())
        assert segs0 == segs_ref

    def test_kill_one_host_midrender_then_recover(self, tmp_path):
        """SURVEY §5 failure-detection: one host process dies mid-render
        (fault injected after the first sample window); the survivor
        stalls in the next collective and is reaped by the launcher,
        which relaunches the job. The relaunch resumes from process 0's
        window checkpoint, renders only the remaining windows, and the
        final image is identical to an uninterrupted render (global RNG
        sample ids make the chunked sum per-sample exact)."""
        port = _free_port()
        worker = tmp_path / "worker.py"
        worker.write_text(_KILL_WORKER)

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = repo

        def launch(port, kill_pid):
            e = dict(env)
            e["KILL_PID"] = str(kill_pid)
            return [
                subprocess.Popen(
                    [sys.executable, str(worker), str(i), str(port),
                     str(tmp_path)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, env=e,
                )
                for i in range(2)
            ]

        # attempt 1: process 1 self-kills after window 0 → process 0
        # cannot finish window 1 (its allgather needs process 1)
        procs = launch(port, kill_pid=1)
        rc1 = procs[1].wait(timeout=420)
        assert rc1 != 0, "fault injection did not fire"
        try:
            procs[0].wait(timeout=20)  # give it a moment to die or stall
        except subprocess.TimeoutExpired:
            pass
        procs[0].kill()  # launcher reaps the stalled survivor
        procs[0].communicate()
        procs[1].communicate()
        ck = np.load(tmp_path / "ck.npz")
        assert int(ck["next_window"]) == 1, "window-0 checkpoint missing"

        # attempt 2 (relaunch, fresh port): resumes at window 1
        procs = launch(_free_port(), kill_pid=-1)
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=420)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            outs.append((p.returncode, out, err))
        for rc, out, err in outs:
            assert rc == 0, f"relaunch failed rc={rc}\nstderr:{err[-2000:]}"
            assert "RESUMED_FROM 1" in out, out

        # identical to the uninterrupted single-process render
        from raytracing_tpu.models.scenes import build
        from raytracing_tpu.parallel.mesh import make_mesh
        from raytracing_tpu.parallel.shard import render_sharded

        scene, cfg = build(
            "three_spheres", image_width=16, samples_per_pixel=4, max_depth=3
        )
        mesh = make_mesh((8,), ("dp",))
        ref, segs_ref = render_sharded(scene, cfg, mesh, seed=5)
        img0 = np.load(tmp_path / "img_rec_0.npy")
        np.testing.assert_allclose(img0, ref, rtol=0, atol=1e-6)
        segs0 = int((tmp_path / "segs_rec_0.txt").read_text())
        assert segs0 == segs_ref


_KILL_WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1]); port = sys.argv[2]; outdir = sys.argv[3]
kill_pid = int(os.environ.get("KILL_PID", "-1"))

import jax
from raytracing_tpu.parallel.mesh import initialize_distributed
ok = initialize_distributed(f"localhost:{port}", num_processes=2, process_id=pid)
assert ok, "distributed init failed"

from raytracing_tpu.models.scenes import build
from raytracing_tpu.parallel.multihost import global_mesh, render_sharded_distributed

ckpt = os.path.join(outdir, "ck.npz")
resumed = 0
if os.path.exists(ckpt):
    with np.load(ckpt) as ck:
        resumed = int(ck["next_window"])
print("RESUMED_FROM", resumed, flush=True)

def cb(k):
    if pid == kill_pid and k == 0:
        os._exit(17)  # fault injection: die after window 0's checkpoint

scene, cfg = build("three_spheres", image_width=16, samples_per_pixel=4, max_depth=3)
mesh = global_mesh((8,), ("dp",))
img, segs = render_sharded_distributed(
    scene, cfg, mesh, seed=5, sample_chunk=2, checkpoint=ckpt, chunk_cb=cb)
np.save(os.path.join(outdir, f"img_rec_{pid}.npy"), img)
with open(os.path.join(outdir, f"segs_rec_{pid}.txt"), "w") as f:
    f.write(str(segs))
print("WORKER_OK", pid)
"""
