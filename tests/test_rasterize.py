import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nvdiffrast_tpu as dr
from nvdiffrast_tpu.ops import coord
from nvdiffrast_tpu.ops.binning import near_clip_cols


def _tri_setup():
    pos = jnp.array(
        [[[-0.8, -0.8, 0.0, 1.0],
          [0.8, -0.8, 0.0, 1.0],
          [-0.8, 0.8, 0.0, 1.0]]], jnp.float32)
    tri = jnp.array([[0, 1, 2]], jnp.int32)
    return pos, tri


def test_single_triangle_coverage_and_barys():
    pos, tri = _tri_setup()
    rast, rast_db = dr.rasterize(None, pos, tri, (64, 64))
    assert rast.shape == (1, 64, 64, 4)
    assert rast_db.shape == (1, 64, 64, 4)

    ids = np.asarray(coord.float_to_triidx(rast[..., 3]))
    covered = ids > 0
    # Analytic triangle area in pixels: ((1.6/2)*64)^2 / 2 = 1310.72.
    assert abs(covered.sum() - 1310.72) < 40

    r = np.asarray(rast[0])
    # Check barycentrics at an interior pixel against the analytic value.
    py, px = 16, 16
    fx = (2 * px + 1) / 64 - 1
    fy = (2 * py + 1) / 64 - 1
    # For this right triangle: b0 = 1 - (fx+0.8)/1.6 - (fy+0.8)/1.6 etc.
    u = (fx + 0.8) / 1.6
    v = (fy + 0.8) / 1.6
    b0_expect = 1.0 - u - v
    b1_expect = u
    np.testing.assert_allclose(r[py, px, 0], b0_expect, atol=1e-5)
    np.testing.assert_allclose(r[py, px, 1], b1_expect, atol=1e-5)
    # z/w = 0 everywhere for this triangle.
    np.testing.assert_allclose(r[py, px, 2], 0.0, atol=1e-6)

    # Empty pixels are all zero.
    assert np.all(r[60, 60] == 0.0)


def test_bary_derivatives_analytic():
    pos, tri = _tri_setup()
    _, rast_db = dr.rasterize(None, pos, tri, (64, 64))
    db = np.asarray(rast_db[0, 16, 16])
    # u spans 1.6 clip units over 64px * (2/64) clip/px -> du/dX per pixel
    # in the reference's convention: du/dX = xs * d(bary)/d(fx).
    # b1 = (fx+0.8)/1.6 -> db1/dfx = 0.625; rast_db stores (du/dX, du/dY,
    # dv/dX, dv/dY) with u=b0, v=b1, X in pixel units: xs=2/64.
    xs = 2 / 64
    np.testing.assert_allclose(db[2], 0.625 * xs, atol=1e-6)  # dv/dX
    np.testing.assert_allclose(db[3], 0.0, atol=1e-6)         # dv/dY
    np.testing.assert_allclose(db[0], -0.625 * xs, atol=1e-6)  # du/dX
    np.testing.assert_allclose(db[1], -0.625 * xs, atol=1e-6)  # du/dY


def test_depth_ordering():
    # Two overlapping triangles; nearer one (smaller z/w) must win.
    pos = jnp.array(
        [[[-0.5, -0.5, 0.5, 1.0], [0.5, -0.5, 0.5, 1.0], [0.0, 0.5, 0.5, 1.0],
          [-0.5, -0.5, -0.5, 1.0], [0.5, -0.5, -0.5, 1.0], [0.0, 0.5, -0.5, 1.0]]],
        jnp.float32)
    tri = jnp.array([[0, 1, 2], [3, 4, 5]], jnp.int32)
    rast, _ = dr.rasterize(None, pos, tri, (32, 32))
    ids = np.asarray(coord.float_to_triidx(rast[..., 3]))[0]
    interior = ids[16, 16]
    assert interior == 2  # triangle 1 (id 2) has z/w = -0.5 < 0.5


def test_depth_tie_lowest_id_wins():
    # Identical coplanar triangles -> deterministic lowest-index winner.
    pos = jnp.array(
        [[[-0.5, -0.5, 0.0, 1.0], [0.5, -0.5, 0.0, 1.0], [0.0, 0.5, 0.0, 1.0]]],
        jnp.float32)
    pos = jnp.concatenate([pos, pos], axis=1)
    tri = jnp.array([[0, 1, 2], [3, 4, 5]], jnp.int32)
    rast, _ = dr.rasterize(None, pos, tri, (32, 32))
    ids = np.asarray(coord.float_to_triidx(rast[..., 3]))[0]
    assert ids[16, 16] == 1


def test_instance_mode_batching():
    pos, tri = _tri_setup()
    pos2 = jnp.concatenate([pos, pos * jnp.array([0.5, 0.5, 1, 1])], axis=0)
    rast, _ = dr.rasterize(None, pos2, tri, (32, 32))
    ids = np.asarray(coord.float_to_triidx(rast[..., 3]))
    assert ids[0].sum() > ids[1].sum()  # smaller triangle covers fewer pixels


def test_range_mode():
    pos = jnp.array(
        [[-0.8, -0.8, 0.0, 1.0], [0.8, -0.8, 0.0, 1.0], [-0.8, 0.8, 0.0, 1.0],
         [0.8, 0.8, 0.0, 1.0]], jnp.float32)
    tri = jnp.array([[0, 1, 2], [1, 3, 2]], jnp.int32)
    ranges = jnp.array([[0, 1], [1, 1]], jnp.int32)
    rast, _ = dr.rasterize(None, pos, tri, (32, 32), ranges=ranges)
    ids = np.asarray(coord.float_to_triidx(rast[..., 3]))
    assert set(np.unique(ids[0])) <= {0, 1}
    assert set(np.unique(ids[1])) <= {0, 2}
    assert (ids[0] == 1).any() and (ids[1] == 2).any()


def _near_clip(v):
    """near_clip_cols on [1, 3, 4] vertices -> (sub [2, 3, 3] of (x, y, w),
    valid [2])."""
    x, y, w = (tuple(v[:, j, c] for j in range(3)) for c in (0, 1, 3))
    sx, sy, sw, valid = near_clip_cols(x, y, w)
    sub = np.stack([np.stack([np.stack([np.asarray(sx[s][j][0]),
                                        np.asarray(sy[s][j][0]),
                                        np.asarray(sw[s][j][0])])
                              for j in range(3)]) for s in range(2)])
    return sub, [bool(valid[s][0]) for s in range(2)]


def test_near_clip_subtris():
    # Triangle fully in front: one valid slot.
    v = jnp.array([[[0., 0., 0., 1.], [1., 0., 0., 1.], [0., 1., 0., 1.]]])
    sub, valid = _near_clip(v)
    assert valid[0] and not valid[1]
    np.testing.assert_allclose(sub[0], np.asarray(v[0][:, [0, 1, 3]]))

    # One vertex behind (two inside): quad -> 2 subtriangles.
    v1 = jnp.array([[[0., 0., 0., 1.], [1., 0., 0., 1.], [0., 1., 0., -1.]]])
    sub, valid = _near_clip(v1)
    assert valid[0] and valid[1]
    assert np.all(sub[:, :, 2] >= 0)

    # Two vertices behind (one inside): single clipped subtriangle.
    v2 = jnp.array([[[0., 0., 0., 1.], [1., 0., 0., -1.], [0., 1., 0., -1.]]])
    sub, valid = _near_clip(v2)
    assert valid[0] and not valid[1]
    assert np.all(sub[0, :, 2] >= 0)

    # All behind: no valid slots.
    v3 = jnp.array([[[0., 0., 0., -1.], [1., 0., 0., -1.], [0., 1., 0., -1.]]])
    sub, valid = _near_clip(v3)
    assert not valid[0] and not valid[1]


def test_grad_matches_finite_difference_interior():
    # Point-sampled coverage makes raw finite differences noisy; mask
    # the loss to interior pixels (eroded coverage held fixed) so only
    # the smooth barycentric dependence remains — then the analytic
    # gradient must match FD for ALL of x, y, w.
    pos, tri = _tri_setup()
    col = jnp.array([[[1., 0., 0.], [0., 1., 0.], [0., 0., 1.]]], jnp.float32)

    r0, _ = dr.rasterize(None, pos, tri, (48, 48))
    cov = np.asarray(r0[..., 3] > 0)[0]
    er = cov.copy()
    for s in (1, -1):
        er &= np.roll(cov, s, axis=0) & np.roll(cov, s, axis=1)
        er &= np.roll(np.roll(cov, s, axis=0), s, axis=1)
        er &= np.roll(np.roll(cov, s, axis=0), -s, axis=1)
    er &= np.roll(cov, 2, axis=0) & np.roll(cov, -2, axis=0)
    er &= np.roll(cov, 2, axis=1) & np.roll(cov, -2, axis=1)
    mask = jnp.asarray(er[None, :, :, None], jnp.float32)

    def loss(p):
        r, _ = dr.rasterize(None, p, tri, (48, 48))
        o, _ = dr.interpolate(col, r, tri)
        return jnp.sum((o * mask) ** 2) * 1e-2

    g = jax.grad(loss)(pos)
    eps = 1e-3
    for vi in range(3):
        for ci in (0, 1, 3):
            pp = pos.at[0, vi, ci].add(eps)
            pm = pos.at[0, vi, ci].add(-eps)
            fd = (loss(pp) - loss(pm)) / (2 * eps)
            np.testing.assert_allclose(
                np.asarray(g[0, vi, ci]), float(fd), rtol=0.03, atol=1e-4,
                err_msg=f"vertex {vi} coord {ci}")


def test_grad_db_flag():
    pos, tri = _tri_setup()

    def loss_db(p):
        r, rdb = dr.rasterize(None, p, tri, (16, 16), grad_db=True)
        return jnp.sum(rdb ** 2)

    def loss_nodb(p):
        r, rdb = dr.rasterize(None, p, tri, (16, 16), grad_db=False)
        return jnp.sum(rdb ** 2)

    g_db = jax.grad(loss_db)(pos)
    g_nodb = jax.grad(loss_nodb)(pos)
    assert np.abs(np.asarray(g_db)).sum() > 0
    # grad_db=False drops the rast_db path entirely.
    assert np.abs(np.asarray(g_nodb)).sum() == 0


def test_depth_peeler():
    # Two stacked triangles; peeling returns them nearest-first.
    pos = jnp.array(
        [[[-0.5, -0.5, 0.5, 1.0], [0.5, -0.5, 0.5, 1.0], [0.0, 0.5, 0.5, 1.0],
          [-0.5, -0.5, -0.5, 1.0], [0.5, -0.5, -0.5, 1.0], [0.0, 0.5, -0.5, 1.0]]],
        jnp.float32)
    tri = jnp.array([[0, 1, 2], [3, 4, 5]], jnp.int32)
    ctx = dr.RasterizeCudaContext()
    with dr.DepthPeeler(ctx, pos, tri, (32, 32)) as peeler:
        r1, _ = peeler.rasterize_next_layer()
        r2, _ = peeler.rasterize_next_layer()
        r3, _ = peeler.rasterize_next_layer()
    i1 = np.asarray(coord.float_to_triidx(r1[..., 3]))[0, 16, 16]
    i2 = np.asarray(coord.float_to_triidx(r2[..., 3]))[0, 16, 16]
    i3 = np.asarray(coord.float_to_triidx(r3[..., 3]))[0, 16, 16]
    assert (i1, i2, i3) == (2, 1, 0)


def test_peeler_guard():
    pos, tri = _tri_setup()
    ctx = dr.RasterizeCudaContext()
    with dr.DepthPeeler(ctx, pos, tri, (16, 16)):
        with pytest.raises(RuntimeError):
            dr.rasterize(ctx, pos, tri, (16, 16))


def test_jit_compatible():
    pos, tri = _tri_setup()

    @jax.jit
    def f(p):
        r, db = dr.rasterize(None, p, tri, (32, 32))
        return r, db

    r, db = f(pos)
    r2, db2 = dr.rasterize(None, pos, tri, (32, 32))
    # jit and eager may fuse differently -> tiny float differences.
    np.testing.assert_allclose(np.asarray(r), np.asarray(r2), atol=1e-6)
