"""The bench harness itself (bench.py), at tiny shapes on the CPU: the
measurement functions run and count segments, the result line carries the
device fields, and the harness refuses to report without a GPU."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_fwd_bwd_counts_forward_segments():
    """The fwd+bwd sweep counts exactly the forward render's segments."""
    import bench

    r_bwd = bench.bench_fwd_bwd(width=16, spp=4, max_depth=3, spp_chunk=2,
                                reps=1)
    r_fwd = bench.bench_forward(width=16, spp=4, max_depth=3, reps=1)
    assert r_bwd["segments"] == r_fwd["segments"] > 0
    assert np.isfinite(r_bwd["rays_per_s"]) and r_bwd["spread"] >= 0


def test_forward_bench_runs():
    import bench

    r = bench.bench_forward(width=16, spp=2, max_depth=3, reps=2)
    assert r["segments"] > 0 and r["hit_method"] == "bvh"
    assert r["setup_seconds"] > 0 and r["seconds"] > 0


def test_result_line_carries_device_fields():
    import bench

    info = dict(platform="gpu", device_kind="NVIDIA H100 80GB HBM3",
                device_count=1, card="NVIDIA H100 80GB HBM3, 700.00 W")
    fwd = dict(rays_per_s=2.5e8, segments=10, seconds=1.0)
    bwd = dict(rays_per_s=1e8, segments=10, seconds=2.0)
    line = bench.result_line(info, fwd, bwd)
    for k, v in info.items():
        assert line[k] == v
    assert line["value"] == 2.5e8 and line["vs_baseline"] == 0.5
    assert line["rays_per_s_fwd_bwd"] == 1e8


def test_no_gpu_fails():
    import bench

    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.device_info()
