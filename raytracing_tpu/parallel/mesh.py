"""Device-mesh construction helpers.

The reference is single-threaded with zero parallelism (SURVEY.md §2.9); all
scaling in this framework is expressed as `jax.sharding.Mesh` axes:

  * ``dp`` — data parallel: pixel-tile × sample megabatch sharding (the
    analog of the reference's pixel loop, camera.hpp:40-49),
  * ``tp`` — tensor/scene parallel: primitives partitioned by range across
    chips with a psum-min closest-hit reduction (SURVEY.md §2.9 "TP analog"),
  * ``sp`` — sample parallel: samples-per-pixel split across chips (the
    "sequence" axis of this workload, SURVEY.md §5 long-context analog).

Multi-host bring-up goes through :func:`initialize_distributed`
(jax.distributed across hosts); within a host, NCCL collectives ride
NVLink, which joins every card to every other.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = ("dp",),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    ``make_mesh()`` → all devices on one ``dp`` axis.
    ``make_mesh((4, 2), ("dp", "tp"))`` → 4-way data × 2-way scene parallel.
    """
    devices = list(jax.devices() if devices is None else devices)
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    n = int(np.prod(axis_sizes))
    if n > len(devices):
        raise ValueError(f"mesh wants {n} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:n]).reshape(axis_sizes)
    return Mesh(dev_array, axis_names[: len(axis_sizes)])


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    strict: Optional[bool] = None,
    **kwargs,
) -> bool:
    """Multi-host bring-up (`jax.distributed.initialize`).

    Returns True when the distributed runtime is (now) initialized. With no
    explicit arguments this is best-effort auto-detection (cluster managers
    fill in the coordination service from the environment) and failures are
    swallowed — the single-process path keeps working. When ``coordinator``
    / ``num_processes`` / ``process_id`` are given explicitly, failures
    RAISE (a silently-degraded multi-host run is worse than a crash);
    override with ``strict=False``. Exercised for real by the 2-process
    localhost test in tests/test_multihost.py.
    """
    explicit = any(x is not None for x in (coordinator, num_processes, process_id))
    if strict is None:
        strict = explicit
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
        return True
    except Exception:
        if strict:
            raise
        return jax.process_count() > 1
