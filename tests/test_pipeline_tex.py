"""render_pipeline_textured against the composed ops, on both coverage
routes (the binned kernel in interpret mode, the XLA scan)."""

import numpy as np
import jax
import jax.numpy as jnp

import nvdiffrast_tpu as dr
from nvdiffrast_tpu.ops.pipeline_tex import render_pipeline_textured


def _scene(seed=0, B=2, V=50, T=40):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, (B, V, 4)).astype(np.float32)
    pos[..., 3] = rng.uniform(0.6, 1.8, (B, V))
    pos[0, :4, 3] = -0.2  # near-plane crossers
    tri = rng.randint(0, V, (T, 3)).astype(np.int32)
    uv = rng.uniform(-0.2, 1.2, (V, 2)).astype(np.float32)
    tex = rng.rand(1, 32, 64, 3).astype(np.float32)
    return (jnp.asarray(pos), jnp.asarray(tri), jnp.asarray(uv),
            jnp.asarray(tex))


def _composed(pos, tri, uv, tex, res, bm, fm, impl="xla"):
    rast, rast_db = dr.rasterize(None, pos, tri, res, grad_db=True,
                                 impl=impl)
    uvp, uv_da = dr.interpolate(uv, rast, tri, rast_db, diff_attrs="all")
    img = dr.texture(tex, uvp, uv_da=uv_da if "mipmap" in fm else None,
                     filter_mode=fm, boundary_mode=bm)
    return dr.antialias(img, rast, pos, tri)


def test_textured_pipeline_forward_parity():
    pos, tri, uv, tex = _scene()
    res = (48, 64)
    for bm in ("wrap", "clamp"):
        a = _composed(pos, tri, uv, tex, res, bm, "linear-mipmap-linear")
        b = render_pipeline_textured(pos, tri, uv, tex, res,
                                     boundary_mode=bm,
                                     impl="triton_interpret")
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=1e-5, rtol=1e-5)


def test_textured_pipeline_gradient_parity():
    pos, tri, uv, tex = _scene(seed=1)
    res = (48, 64)

    def loss_c(p, u, t):
        o = _composed(p, tri, u, t, res, "wrap", "linear-mipmap-linear")
        return jnp.sum(o ** 2 + 0.1 * o)

    def loss_f(p, u, t):
        o = render_pipeline_textured(p, tri, u, t, res,
                                     impl="triton_interpret")
        return jnp.sum(o ** 2 + 0.1 * o)

    gc = jax.grad(loss_c, argnums=(0, 1, 2))(pos, uv, tex)
    gf = jax.grad(loss_f, argnums=(0, 1, 2))(pos, uv, tex)
    # Same formulas on both routes (coverage differs only in how the
    # winners were found); f32 rounding of the backward, amplified at
    # ill-conditioned pixels by the 1/(at + 1e-6) pole, is bounded at
    # 5e-5 of scale.
    for n, a, b in zip(("g_pos", "g_uv", "g_tex"), gc, gf):
        scale = float(jnp.max(jnp.abs(a)))
        assert scale > 0, n
        d = float(jnp.max(jnp.abs(a - b)))
        assert d <= 5e-5 * scale, (n, d, scale)


def test_textured_pipeline_cube():
    """Cube-map branch (envphong shape): reflection-vector attrs,
    seamless cube sampling, AA — vs the composed ops, same impl."""
    rng = np.random.RandomState(5)
    B, V, T = 1, 40, 32
    pos = rng.uniform(-1, 1, (B, V, 4)).astype(np.float32)
    pos[..., 3] = rng.uniform(0.6, 1.8, (B, V))
    tri = rng.randint(0, V, (T, 3)).astype(np.int32)
    refl = rng.randn(V, 3).astype(np.float32)
    tex = rng.rand(1, 6, 16, 16, 3).astype(np.float32)
    pos, tri, refl, tex = (jnp.asarray(a) for a in (pos, tri, refl, tex))
    res = (48, 64)

    def loss_c(p, r, t):
        rast, rast_db = dr.rasterize(None, p, tri, res, grad_db=True,
                                     impl="triton_interpret")
        uvp, uv_da = dr.interpolate(r, rast, tri, rast_db,
                                    diff_attrs="all")
        img = dr.texture(t, uvp, uv_da=uv_da,
                         filter_mode="linear-mipmap-linear",
                         boundary_mode="cube")
        img = dr.antialias(img, rast, p, tri)
        return jnp.sum(img ** 2 + 0.1 * img)

    def loss_f(p, r, t):
        o = render_pipeline_textured(p, tri, r, t, res,
                                     boundary_mode="cube",
                                     impl="triton_interpret")
        return jnp.sum(o ** 2 + 0.1 * o)

    np.testing.assert_allclose(float(loss_f(pos, refl, tex)),
                               float(loss_c(pos, refl, tex)), rtol=1e-5)
    gc = jax.grad(loss_c, argnums=(0, 1, 2))(pos, refl, tex)
    gf = jax.grad(loss_f, argnums=(0, 1, 2))(pos, refl, tex)
    for n, a, b in zip(("g_pos", "g_refl", "g_tex"), gc, gf):
        assert float(jnp.abs(a).sum()) > 0, n
        scale = float(jnp.max(jnp.abs(a)))
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=1e-6 * max(scale, 1.0),
                                   rtol=1e-5, err_msg=n)


def test_textured_pipeline_minibatch_tex_and_boost():
    pos, tri, uv, _ = _scene(seed=2)
    rng = np.random.RandomState(3)
    tex = jnp.asarray(rng.rand(2, 16, 16, 3).astype(np.float32))
    res = (40, 48)

    def loss_c(p):
        o = _composed(p, tri, uv, tex, res, "clamp", "linear")
        return jnp.sum(o ** 2)

    def loss_f(p):
        o = render_pipeline_textured(p, tri, uv, tex, res,
                                     boundary_mode="clamp",
                                     filter_mode="linear",
                                     impl="triton_interpret")
        return jnp.sum(o ** 2)

    np.testing.assert_allclose(float(loss_f(pos)), float(loss_c(pos)),
                               rtol=1e-5)
    gc = jax.grad(loss_c)(pos)
    gf = jax.grad(loss_f)(pos)
    np.testing.assert_allclose(np.asarray(gf), np.asarray(gc),
                               atol=1e-6, rtol=1e-6)


def test_raster_bwd_matches_fd():
    """Position gradient of the barycentric channels (the rasterize
    backward rule, rasterize.cu:119-273) against central differences:
    small moves keep coverage fixed on this tie-free scene, so the
    loss is smooth in pos."""
    pos, tri, _, _ = _scene(seed=7, B=1)
    res = (48, 64)
    w = jnp.asarray(np.random.RandomState(11).randn(1, 48, 64, 4)
                    .astype(np.float32))

    def loss(p):
        rast, rast_db = dr.rasterize(None, p, tri, res, grad_db=True)
        return (jnp.sum(rast[..., :2] * w[..., :2])
                + 1e-3 * jnp.sum(rast_db * w))

    g = np.asarray(jax.grad(loss)(pos))
    ids = np.asarray(dr.rasterize(None, pos, tri, res)[0][..., 3])
    rng = np.random.RandomState(5)
    checked = 0
    for _ in range(40):
        v, c = rng.randint(pos.shape[1]), rng.choice([0, 1, 3])
        if abs(g[0, v, c]) < 1e-2:
            continue
        eps = 1e-4
        pp = pos.at[0, v, c].add(eps)
        pm = pos.at[0, v, c].add(-eps)
        ip = np.asarray(dr.rasterize(None, pp, tri, res)[0][..., 3])
        im = np.asarray(dr.rasterize(None, pm, tri, res)[0][..., 3])
        if (ip != ids).any() or (im != ids).any():
            continue  # coverage changed: not a smooth neighborhood
        fd = (float(loss(pp)) - float(loss(pm))) / (2 * eps)
        np.testing.assert_allclose(g[0, v, c], fd, rtol=3e-2,
                                   atol=3e-2 * np.abs(g).max())
        checked += 1
    assert checked >= 5
