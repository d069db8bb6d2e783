"""Checks that need the card: the compiled coverage kernel (no
interpreter), float determinism and f32 edge arithmetic on the GPU.

Marked ``gpu``; they skip on other backends. chip_smoke.py runs them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nvdiffrast_tpu as dr
from nvdiffrast_tpu.models import primitives
from nvdiffrast_tpu.ops import rasterize as R
from nvdiffrast_tpu.utils import camera

pytestmark = pytest.mark.gpu


def _sphere(res=512):
    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(32, 64)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    mvp = camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
    pos = jnp.asarray((posw @ mvp.T)[None].astype(np.float32))
    col = jnp.asarray((vtxp * 0.5 + 0.5)[None].astype(np.float32))
    return pos, jnp.asarray(pos_idx), col, jnp.asarray(col_idx)


def test_gpu_kernel_matches_xla(gpu):
    pos, tri, _, _ = _sphere()
    r_k, db_k = dr.rasterize(None, pos, tri, (512, 512))  # compiled kernel
    r_x, db_x = dr.rasterize(None, pos, tri, (512, 512), impl="xla")
    np.testing.assert_array_equal(np.asarray(r_k[..., 3]),
                                  np.asarray(r_x[..., 3]))
    np.testing.assert_allclose(np.asarray(r_k), np.asarray(r_x), atol=1e-6)
    np.testing.assert_allclose(np.asarray(db_k), np.asarray(db_x), atol=1e-6)


def test_gpu_coverage_deterministic(gpu):
    pos, tri, _, _ = _sphere()
    ranges = jnp.array([[0, tri.shape[0]]], jnp.int32)
    f = jax.jit(lambda p: R._coverage(p, tri, (512, 512), ranges, None, 64))
    a, b = f(pos), f(pos)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_gpu_edge_coeffs_match_cpu(gpu):
    pos, tri, _, _ = _sphere()
    tv = np.asarray(pos[0][tri])
    e_gpu = np.asarray(jax.jit(R._edge_coeffs)(jnp.asarray(tv)))
    e_cpu = np.asarray(jax.jit(R._edge_coeffs)(
        jax.device_put(tv, jax.devices("cpu")[0])))
    np.testing.assert_array_equal(e_gpu.view(np.uint32),
                                  e_cpu.view(np.uint32))


def test_gpu_pipeline_gradients_finite(gpu):
    pos, tri, col, cidx = _sphere()

    def loss(p, c):
        return jnp.mean(dr.render_pipeline(p, tri, c, (512, 512),
                                           attr_idx=cidx) ** 2)

    gp, gc = jax.jit(jax.grad(loss, argnums=(0, 1)))(pos, col)
    assert np.isfinite(np.asarray(gp)).all() and np.abs(gp).sum() > 0
    assert np.isfinite(np.asarray(gc)).all() and np.abs(gc).sum() > 0
