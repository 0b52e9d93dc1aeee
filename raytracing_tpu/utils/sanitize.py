"""Numerical sanitizers — the "race detector" tier of this framework
(SURVEY.md §5). JAX's functional purity structurally excludes data races
(the reference's latent ones — the global ``std::rand()`` state,
rtweekend.hpp:26, and the static interval in write_color, color.hpp:45 —
have no analog here); what CAN go wrong on this codebase is numerical:
NaN/Inf escaping a masked lane, and out-of-bounds indices in the
gather-heavy paths (BVH node/prim links, texel fetches, texture-id
rewrites). This module provides both checks as opt-in wrappers:

  * :func:`nan_guard` — context manager enabling ``jax_debug_nans`` so the
    first NaN-producing primitive raises with a traceback.
  * :func:`checked` — ``checkify`` instrumentation (index + NaN + div
    checks) of any jittable function; returns (err, out) and ``err.throw()``
    raises with the failing check's location.

CI runs the wavefront integrator under both (tests/test_sanitize.py); the
Pallas sweep kernel gets the same service from interpret-mode runs
(tests/test_hit_triton.py).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import jax
from jax.experimental import checkify


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """Enable ``jax_debug_nans`` within the scope: any primitive producing
    NaN raises immediately (recompiles un-jitted on first failure for a
    precise stack)."""
    prev = jax.config.jax_debug_nans
    try:
        jax.config.update("jax_debug_nans", bool(enable))
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


ALL_CHECKS = checkify.index_checks | checkify.nan_checks | checkify.div_checks


def checked(fn: Callable, errors=ALL_CHECKS) -> Callable:
    """Instrument ``fn`` with checkify: out-of-bounds gathers (BVH links,
    texel/texture-id fetches), NaNs and div-by-zero become carried errors.

    Returns a function computing ``(err, out)``; call ``err.throw()`` to
    raise on failure. Compose with jit OUTSIDE: ``jax.jit(checked(f))``.
    """
    return checkify.checkify(fn, errors=errors)
