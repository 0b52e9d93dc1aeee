"""Differentiable rendering: gradients of image losses w.r.t. scene and
camera parameters.

Three gradient paths exist:

* ``gradients.render_once`` — autodiff through the whole integrator,
  closest-hit search included; the reference for the other two.
* ``replay.render_replay`` — decision replay: a forward pass records the
  winning primitive per (ray, bounce), then only the continuous math is
  re-traced and differentiated (the fwd+bwd path bench.py measures).
* ``replay_fast.replay_trace_fast`` — the same replay with one packed-table
  gather per bounce (tested bit-compatible in tests/test_replay_fast.py).
"""
from .gradients import camera_grad, mse_loss, render_once, scene_grad
from .replay import record_decisions, render_replay, replay_trace

__all__ = [
    "camera_grad",
    "mse_loss",
    "render_once",
    "scene_grad",
    "record_decisions",
    "render_replay",
    "replay_trace",
]
