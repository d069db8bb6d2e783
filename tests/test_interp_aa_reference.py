"""interpolate() and antialias() against the float64 NumPy references
in tests/_reference.py (forward values, and gradients that are linear
in the input and so follow from the reference exactly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _reference as ref
import nvdiffrast_tpu as dr
from nvdiffrast_tpu.models import primitives
from nvdiffrast_tpu.utils import camera


def _scene(res=(48, 64), B=1, seed=0, A=5):
    rng = np.random.default_rng(seed)
    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(8, 12)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    poss = []
    for b in range(B):
        mvp = (camera.projection(x=0.4)
               @ camera.translate(0.1 * b, -0.05, -3.2 + 0.2 * b)
               @ camera.random_rotation_translation(0.2, rng))
        poss.append((posw @ mvp.T).astype(np.float32))
    pos = jnp.asarray(np.stack(poss))
    tri = jnp.asarray(pos_idx)
    attr = rng.standard_normal((B, vtxp.shape[0], A)).astype(np.float32)
    rast, rast_db = dr.rasterize(None, pos, tri, res)
    return pos, tri, attr, rast, rast_db, np.asarray(col_idx)


# ---------------------------------------------------------------------------
# interpolate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("diff", [None, "all", [0, -1]])
def test_interpolate_forward_vs_reference(diff):
    _, _, attr, rast, rast_db, cidx = _scene()
    kw = dict(rast_db=rast_db, diff_attrs=diff) if diff else {}
    out, da = dr.interpolate(attr, rast, cidx, **kw)
    dl = {None: (), "all": range(5), (0, -1): (0, 4)}[
        tuple(diff) if isinstance(diff, list) else diff]
    want, want_da = ref.interpolate(attr, rast, cidx, rast_db, tuple(dl))
    np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)
    np.testing.assert_allclose(np.asarray(da), want_da, atol=1e-5)


def _interp_adjoint(attr, rast, rast_db, tri, gy, gda):
    """Exact gradients of sum(gy*out + gda*out_da) (all attrs diff)."""
    rast = np.asarray(rast, np.float64)
    db = np.asarray(rast_db, np.float64)
    B, H, W, _ = rast.shape
    A = attr.shape[-1]
    tid = rast[..., 3].astype(np.int64) - 1
    valid = (tid >= 0)[..., None]
    t = np.where(tid >= 0, tid, 0)
    bi = np.arange(B)[:, None, None]
    at = np.broadcast_to(np.asarray(attr, np.float64), (B,) + attr.shape[1:])
    a = [at[bi, tri[t, i]] for i in range(3)]
    u, v = rast[..., 0:1], rast[..., 1:2]
    gdx, gdy = gda[..., 0::2], gda[..., 1::2]
    c0 = db[..., 0:1] * gdx + db[..., 1:2] * gdy  # d out_da / d dsdu
    c1 = db[..., 2:3] * gdx + db[..., 3:4] * gdy  # d out_da / d dsdv
    w = [u * gy + c0, v * gy + c1, (1 - u - v) * gy - c0 - c1]
    g_attr = np.zeros((B,) + attr.shape[1:])
    for i in range(3):
        np.add.at(g_attr, (np.broadcast_to(bi, t.shape), tri[t, i]),
                  np.where(valid, w[i], 0))
    dsdu, dsdv = a[0] - a[2], a[1] - a[2]
    g_rast = np.zeros((B, H, W, 4))
    g_rast[..., 0] = np.sum(np.where(valid, gy * dsdu, 0), -1)
    g_rast[..., 1] = np.sum(np.where(valid, gy * dsdv, 0), -1)
    g_db = np.stack([np.sum(gdx * dsdu, -1), np.sum(gdy * dsdu, -1),
                     np.sum(gdx * dsdv, -1), np.sum(gdy * dsdv, -1)], -1)
    return g_attr, g_rast, np.where(valid, g_db, 0)


def _check(got, want, name):
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(want).sum() > 0, name
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5 * scale,
                               err_msg=name)


def test_interpolate_gradients_vs_reference():
    _, _, attr, rast, rast_db, cidx = _scene(B=2, seed=3)
    rng = np.random.RandomState(1)
    gy = rng.randn(*rast.shape[:3], attr.shape[-1]).astype(np.float32)
    gda = rng.randn(*rast.shape[:3], 2 * attr.shape[-1]).astype(np.float32)

    def loss(a, r, rdb):
        o, da = dr.interpolate(a, r, cidx, rast_db=rdb, diff_attrs="all")
        return jnp.sum(o * gy) + jnp.sum(da * gda)

    got = jax.grad(loss, argnums=(0, 1, 2))(attr, rast, rast_db)
    want = _interp_adjoint(attr, rast, rast_db, cidx, gy, gda)
    for n, g, w in zip(("g_attr", "g_rast", "g_rast_db"), got, want):
        _check(g, w, n)


def test_interpolate_broadcast_attr_vs_reference():
    _, _, attr, rast, rast_db, cidx = _scene(B=2, seed=1)
    attr1 = attr[:1]
    gy = np.random.RandomState(2).randn(
        *rast.shape[:3], attr.shape[-1]).astype(np.float32)
    g = jax.grad(lambda a: jnp.sum(dr.interpolate(a, rast, cidx)[0] * gy))(
        attr1)
    want = _interp_adjoint(attr1, rast, rast_db, cidx, gy,
                           np.zeros(rast.shape[:3] + (10,)))[0]
    _check(g, want.sum(axis=0, keepdims=True), "g_attr")


# ---------------------------------------------------------------------------
# antialias
# ---------------------------------------------------------------------------

def _aa_scene(res, B=1, seed=0):
    pos, tri, _, rast, _, cidx = _scene(res, B=B, seed=seed)
    _, vtxp, _, _ = primitives.uv_sphere(8, 12)
    col = np.broadcast_to((vtxp * 0.5 + 0.5)[None], (B,) + vtxp.shape)
    img, _ = dr.interpolate(col.astype(np.float32), rast, cidx)
    return pos, tri, rast, np.asarray(img)


def _assert_aa(out, want):
    """Equal to f32 precision, except at pixel pairs whose discrete
    decisions (depth order, edge crossing, |dc| window) sit within f32
    rounding of a tie: at most 0.1% of pixels."""
    diff = np.abs(np.asarray(out, np.float64) - want).max(-1)
    assert (diff > 1e-4).mean() <= 1e-3, (diff > 1e-4).sum()
    assert np.abs(np.asarray(out) - np.asarray(want)).max() < 1.0


@pytest.mark.parametrize("res", [(48, 64), (67, 130), (96, 256)])
def test_aa_forward_vs_reference(res):
    pos, tri, rast, img = _aa_scene(res)
    out = dr.antialias(img, rast, pos, tri)
    want = ref.antialias(img, rast, pos, tri)
    assert np.abs(want - img).max() > 0.05  # silhouettes were blended
    _assert_aa(out, want)


def test_aa_forward_batched_vs_reference():
    pos, tri, rast, img = _aa_scene((40, 72), B=3)
    _assert_aa(dr.antialias(img, rast, pos, tri),
               ref.antialias(img, rast, pos, tri))


def test_aa_range_mode_vs_reference():
    pos, tri, _, _ = _aa_scene((48, 64))
    p2 = pos[0]
    rast, _ = dr.rasterize(None, p2, tri, (48, 64),
                           ranges=np.array([[0, tri.shape[0]]], np.int32))
    img = np.random.RandomState(0).rand(1, 48, 64, 2).astype(np.float32)
    _assert_aa(dr.antialias(img, rast, p2, tri),
               ref.antialias(img, rast, p2, tri))


def test_aa_color_gradient_vs_reference():
    """antialias is linear in color: the color gradient is the adjoint
    of the reference's blend, probed column by column."""
    pos, tri, rast, img = _aa_scene((40, 48))
    gy = np.random.RandomState(4).randn(*img.shape).astype(np.float32)
    g = jax.grad(lambda c: jnp.sum(dr.antialias(c, rast, pos, tri) * gy))(
        img)
    N = img.shape[1] * img.shape[2]
    # Reference operator on one channel: out = M @ color.
    basis = np.eye(N).reshape(1, img.shape[1], img.shape[2], N)
    M = ref.antialias(basis, rast, pos, tri).reshape(N, N)
    want = np.stack([M.T @ gy[0, ..., c].reshape(N)
                     for c in range(img.shape[-1])], -1)
    _check(np.asarray(g).reshape(N, -1), want, "g_color")
