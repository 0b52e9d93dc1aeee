"""Small infrastructure: the dataclass pytree helper (core/pytree.py) and
the compile-cache location helper (utils/compile_cache.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracing_tpu.core import pytree


@pytree.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    tag: str = pytree.field(pytree_node=False, default="x")


def test_pytree_round_trip():
    p = _Pair(jnp.ones(2), jnp.zeros(3), tag="y")
    leaves, treedef = jax.tree.flatten(p)
    assert len(leaves) == 2
    back = jax.tree.unflatten(treedef, leaves)
    assert isinstance(back, _Pair) and back.tag == "y"
    np.testing.assert_array_equal(np.asarray(back.b), np.zeros(3))


def test_pytree_replace_and_frozen():
    p = _Pair(jnp.ones(2), jnp.zeros(3))
    q = p.replace(a=jnp.full(2, 5.0))
    assert float(q.a[0]) == 5.0 and float(p.a[0]) == 1.0 and q.tag == "x"
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.zeros(2)


def test_pytree_static_field_not_traced():
    seen = []

    @jax.jit
    def f(p):
        seen.append(type(p.tag))
        return p.a.sum() if p.tag == "x" else p.b.sum()

    assert float(f(_Pair(jnp.ones(2), jnp.ones(3)))) == 2.0
    assert float(f(_Pair(jnp.ones(2), jnp.ones(3), tag="z"))) == 3.0
    assert seen == [str, str]  # a static field stays a Python value


def test_pytree_grad_and_tree_map():
    p = _Pair(jnp.asarray([1.0, 2.0]), jnp.asarray([3.0]))
    g = jax.grad(lambda q: jnp.sum(q.a ** 2) + jnp.sum(q.b))(p)
    np.testing.assert_allclose(np.asarray(g.a), [2.0, 4.0])
    doubled = jax.tree.map(lambda x: 2 * x, p)
    assert float(doubled.b[0]) == 6.0


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from raytracing_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_default_is_repo_path(monkeypatch):
    import os

    from raytracing_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
