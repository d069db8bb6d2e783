"""Rowband spatial sharding: sharded render == single-device render.

Runs on the 8 fake CPU devices from conftest. The viewport extension
makes band pixels bit-identical to full-image rows; antialias_sp's
halo boundary pass must reproduce the cross-band pairs exactly,
including gradients.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from nvdiffrast_tpu.parallel import make_mesh
from nvdiffrast_tpu.parallel.spatial import antialias_sp, make_sp_render
from nvdiffrast_tpu.ops.rasterize import rasterize
from nvdiffrast_tpu.ops.interpolate import interpolate
from nvdiffrast_tpu.ops.antialias import antialias
from nvdiffrast_tpu.models import primitives
from nvdiffrast_tpu.utils import camera


def _scene(B=1, seed=0):
    rng = np.random.default_rng(seed)
    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(8, 12)
    tri = jnp.asarray(pos_idx)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    poss = []
    for b in range(B):
        mvp = (camera.projection(x=0.4)
               @ camera.translate(0.1 * b, -0.05, -3.3)
               @ camera.random_rotation_translation(0.2, rng))
        poss.append((posw @ mvp.T).astype(np.float32))
    pos = jnp.asarray(np.stack(poss))
    col = jnp.asarray((vtxp * 0.5 + 0.5).astype(np.float32))
    return pos, tri, col, jnp.asarray(col_idx)


def test_viewport_band_bit_identical():
    """rasterize(viewport) on a band == the same rows of the full image."""
    pos, tri, col, cidx = _scene()
    H, W = 64, 96
    full, full_db = rasterize(None, pos, tri, (H, W))
    for n_bands in (2, 4):
        hb = H // n_bands
        for b in range(n_bands):
            band, band_db = rasterize(None, pos, tri, (hb, W),
                                      viewport=(b * hb, H))
            np.testing.assert_array_equal(np.asarray(band),
                                          np.asarray(full[:, b*hb:(b+1)*hb]))
            np.testing.assert_array_equal(
                np.asarray(band_db), np.asarray(full_db[:, b*hb:(b+1)*hb]))


def test_viewport_band_pallas_interpret():
    """The binned kernel's viewport path (traced y0) matches the XLA
    path."""
    pos, tri, col, cidx = _scene(seed=1)
    H, W = 64, 128
    hb = 32
    for b in (0, 1):
        bx, _ = rasterize(None, pos, tri, (hb, W), viewport=(b * hb, H),
                          impl="xla")
        bp, _ = rasterize(None, pos, tri, (hb, W), viewport=(b * hb, H),
                          impl="triton_interpret")
        # IDs (coverage) bit-identical; shading is the same XLA code.
        np.testing.assert_array_equal(np.asarray(bx[..., 3]),
                                      np.asarray(bp[..., 3]))
        np.testing.assert_allclose(np.asarray(bx), np.asarray(bp),
                                   atol=1e-4, rtol=1e-4)


def test_sp_render_matches_single_device():
    pos, tri, col, cidx = _scene()
    H, W = 64, 96
    mesh = make_mesh((4,), ("sp",), devices=jax.devices()[:4])
    render = make_sp_render(mesh, tri, cidx, (H, W))
    out_sp = render(pos, col)

    rast, _ = rasterize(None, pos, tri, (H, W), grad_db=False)
    img, _ = interpolate(jnp.broadcast_to(col[None], (1,) + col.shape),
                         rast, cidx)
    out_ref = antialias(img, rast, pos, tri)
    np.testing.assert_allclose(np.asarray(out_sp), np.asarray(out_ref),
                               atol=1e-5, rtol=1e-5)
    # The cross-band AA pairs must actually fire somewhere (else this
    # test proves nothing about the halo path).
    d = np.abs(np.asarray(img) - np.asarray(out_ref)).sum(-1)
    assert (d[:, [15, 16, 31, 32, 47, 48]] > 0).any()


def test_sp_gradients_match_single_device():
    pos, tri, col, cidx = _scene()
    H, W = 32, 64
    mesh = make_mesh((4,), ("sp",), devices=jax.devices()[:4])

    tgt = jnp.ones((1, H, W, 3), jnp.float32) * 0.3

    def loss_sp(pos, col):
        def band(pos, col):
            hb = H // 4
            y0 = jax.lax.axis_index("sp") * hb
            rast, _ = rasterize(None, pos, tri, (hb, W), grad_db=False,
                                viewport=(y0, H))
            img, _ = interpolate(
                jnp.broadcast_to(col[None], (1,) + col.shape), rast, cidx)
            out = antialias_sp(img, rast, pos, tri, "sp", H)
            return out

        out = jax.shard_map(band, mesh=mesh, in_specs=(P(), P()),
                            out_specs=P(None, "sp"), check_vma=False)(
                                pos, col)
        return jnp.sum((out - tgt) ** 2)

    def loss_ref(pos, col):
        rast, _ = rasterize(None, pos, tri, (H, W), grad_db=False)
        img, _ = interpolate(jnp.broadcast_to(col[None], (1,) + col.shape),
                             rast, cidx)
        out = antialias(img, rast, pos, tri)
        return jnp.sum((out - tgt) ** 2)

    gs = jax.jit(jax.grad(loss_sp, argnums=(0, 1)))(pos, col)
    gr = jax.jit(jax.grad(loss_ref, argnums=(0, 1)))(pos, col)
    assert float(jnp.abs(gr[0]).sum()) > 0
    np.testing.assert_allclose(np.asarray(gs[0]), np.asarray(gr[0]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gs[1]), np.asarray(gr[1]),
                               atol=1e-5, rtol=1e-5)


def test_sp_batched():
    pos, tri, col, cidx = _scene(B=2, seed=3)
    H, W = 32, 48
    mesh = make_mesh((2,), ("sp",), devices=jax.devices()[:2])
    render = make_sp_render(mesh, tri, cidx, (H, W))
    out_sp = render(pos, col)
    rast, _ = rasterize(None, pos, tri, (H, W), grad_db=False)
    img, _ = interpolate(jnp.broadcast_to(col[None], (2,) + col.shape),
                         rast, cidx)
    out_ref = antialias(img, rast, pos, tri)
    np.testing.assert_allclose(np.asarray(out_sp), np.asarray(out_ref),
                               atol=1e-5, rtol=1e-5)
