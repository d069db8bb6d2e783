"""render_pipeline: the documented op composition, on both coverage
routes.

The binned kernel (interpret mode) and the XLA scan pick the same
winners on this tie-free sphere, so images agree to float precision and
gradients to summation order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nvdiffrast_tpu.ops.pipeline import render_pipeline
from nvdiffrast_tpu.ops.rasterize import rasterize
from nvdiffrast_tpu.ops.interpolate import interpolate
from nvdiffrast_tpu.ops.antialias import antialias
from nvdiffrast_tpu.models import primitives
from nvdiffrast_tpu.utils import camera

IMPL = "triton_interpret"


def _scene(B=1, seed=0, A=3):
    rng = np.random.default_rng(seed)
    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(8, 12)
    tri = jnp.asarray(pos_idx)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    poss = []
    for b in range(B):
        mvp = (camera.projection(x=0.4)
               @ camera.translate(0.05 * b, 0, -3.2)
               @ camera.random_rotation_translation(0.2, rng))
        poss.append((posw @ mvp.T).astype(np.float32))
    pos = jnp.asarray(np.stack(poss))
    attr = jnp.asarray(rng.standard_normal(
        (B, vtxp.shape[0], A)).astype(np.float32))
    return pos, tri, attr, jnp.asarray(col_idx)


def _composed(pos, tri, attr, res, cidx, boost=1.0):
    rast, _ = rasterize(None, pos, tri, res, grad_db=False, impl="xla")
    color, _ = interpolate(attr, rast, cidx)
    return antialias(color, rast, pos, tri, pos_gradient_boost=boost)


@pytest.mark.parametrize("B", [1, 2])
def test_pipeline_forward_parity(B):
    pos, tri, attr, cidx = _scene(B=B, seed=B)
    res = (48, 64)
    ref = _composed(pos, tri, attr, res, cidx)
    out = render_pipeline(pos, tri, attr, res, attr_idx=cidx, impl=IMPL)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("B,boost", [(1, 1.0), (2, 2.5)])
def test_pipeline_gradient_parity(B, boost):
    pos, tri, attr, cidx = _scene(B=B, seed=7 + B)
    res = (48, 64)

    def loss_ref(p, a):
        return jnp.mean(_composed(p, tri, a, res, cidx, boost) ** 2)

    def loss_fused(p, a):
        img = render_pipeline(p, tri, a, res, attr_idx=cidx, impl=IMPL,
                              pos_gradient_boost=boost)
        return jnp.mean(img ** 2)

    gc = jax.grad(loss_ref, argnums=(0, 1))(pos, attr)
    gf = jax.grad(loss_fused, argnums=(0, 1))(pos, attr)
    for n, a, b in zip(("g_pos", "g_attr"), gc, gf):
        assert float(jnp.abs(a).sum()) > 0, n
        # Silhouette position gradients carry 1/dy cancellation, so
        # f32 rounding differences of equal math show up at O(10) ULP
        # of the gradient scale.
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=1e-5, rtol=1e-4, err_msg=n)


def test_pipeline_broadcast_attr():
    pos, tri, attr, cidx = _scene(B=2, seed=11)
    attr1 = attr[:1]

    def loss_ref(a):
        return jnp.mean(_composed(pos, tri, a, (48, 64), cidx) ** 2)

    def loss_fused(a):
        img = render_pipeline(pos, tri, a, (48, 64), attr_idx=cidx,
                              impl=IMPL)
        return jnp.mean(img ** 2)

    gc = jax.grad(loss_ref)(attr1)
    gf = jax.grad(loss_fused)(attr1)
    np.testing.assert_allclose(np.asarray(gf), np.asarray(gc),
                               atol=1e-6, rtol=1e-5)


def test_pipeline_matches_explicit_composition():
    """render_pipeline is exactly the documented op composition."""
    pos, tri, attr, cidx = _scene(B=1, seed=2)
    res = (48, 64)
    rast, _ = rasterize(None, pos, tri, res, grad_db=False)
    color, _ = interpolate(attr, rast, cidx)
    ref = antialias(color, rast, pos, tri)
    out = render_pipeline(pos, tri, attr, res, attr_idx=cidx)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
