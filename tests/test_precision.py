"""No float32 product on the main path runs at default precision (on a
GPU the default may be TF32, about 10 mantissa bits)."""

import jax
from jax.extend import core as jex_core
import jax.numpy as jnp
import numpy as np
import pytest

_PRODUCTS = ("dot_general", "conv_general_dilated")


def _products(jaxpr):
    """Every dot_general / conv equation, recursing into sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in _PRODUCTS:
            yield eqn
        for p in eqn.params.values():
            subs = p if isinstance(p, (list, tuple)) else [p]
            for sub in subs:
                if isinstance(sub, jex_core.ClosedJaxpr):
                    yield from _products(sub.jaxpr)
                elif isinstance(sub, jex_core.Jaxpr):
                    yield from _products(sub)


def _assert_pinned(closed):
    eqns = list(_products(closed.jaxpr))
    for e in eqns:
        prec = e.params.get("precision")
        prec = prec if isinstance(prec, tuple) else (prec, prec)
        assert all(p is not None and p != jax.lax.Precision.DEFAULT
                   for p in prec), (e.primitive.name, prec)
    return len(eqns)


def _bench_step(res=64):
    import bench

    scene = bench.sphere_scene(res)
    return bench.make_steps(scene)


@pytest.mark.parametrize("cell", ["raster_interp_aa", "raster_interp_tex_aa"])
def test_bench_step_precision_pinned(cell):
    grad, args = _bench_step()[cell]
    _assert_pinned(jax.make_jaxpr(grad)(*map(jnp.asarray, args)))


def test_bench_step_onehot_precision_pinned():
    """At 512^2 (>= 131072 pixels) the backward's reductions take the
    one-hot product, as they do at bench.py's 2048^2; tracing only."""
    grad, args = _bench_step(512)["raster_interp_aa"]
    assert _assert_pinned(jax.make_jaxpr(grad)(*map(jnp.asarray, args))) > 0


@pytest.mark.parametrize("K", [1, 3, 16])
def test_scatter_onehot_precision_pinned(K):
    from nvdiffrast_tpu.ops.scatter import scatter_add_by_id

    ids = jnp.zeros((1000,), jnp.int32)
    vals = jnp.ones((K, 1000), jnp.float32)
    closed = jax.make_jaxpr(lambda i, v: scatter_add_by_id(
        i, v, 300, method="onehot"))(ids, vals)
    assert _assert_pinned(closed) == 1


def test_earth_step_precision_pinned():
    from nvdiffrast_tpu.models.fit_earth import EarthFitModel

    m = EarthFitModel(res=32, ref_res=64, tex_res=(48, 64), max_mip_level=3)
    mtx = jnp.asarray(m.random_mvp())
    n = _assert_pinned(jax.make_jaxpr(m._step)(m.params, m.opt_state, mtx))
    assert n > 0  # the clip transform and the downsample conv are seen
