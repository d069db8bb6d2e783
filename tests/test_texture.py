import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nvdiffrast_tpu as dr
from nvdiffrast_tpu.ops import texture as tx


def _checker(h, w, c=3):
    yy, xx = np.mgrid[0:h, 0:w]
    img = ((xx + yy) % 2).astype(np.float32)
    return jnp.asarray(np.stack([img] * c, axis=-1)[None])


def test_nearest_exact_texel_lookup():
    tex = jnp.arange(16, dtype=jnp.float32).reshape(1, 4, 4, 1)
    # uv at texel centers: (x+0.5)/4, (y+0.5)/4.
    uv = jnp.array([[[[0.125, 0.125], [0.875, 0.625]]]], jnp.float32)
    out = dr.texture(tex, uv, filter_mode="nearest")
    np.testing.assert_allclose(np.asarray(out[0, 0, 0, 0]), 0.0)
    np.testing.assert_allclose(np.asarray(out[0, 0, 1, 0]), 11.0)  # x=3, y=2


def test_linear_interpolation_midpoint():
    tex = jnp.array([[[[0.0], [1.0]], [[2.0], [3.0]]]], jnp.float32)  # 2x2
    # Center of texture = average of 4 texels.
    uv = jnp.array([[[[0.5, 0.5]]]], jnp.float32)
    out = dr.texture(tex, uv, filter_mode="linear")
    np.testing.assert_allclose(np.asarray(out[0, 0, 0, 0]), 1.5, atol=1e-6)


def test_boundary_wrap_vs_clamp_vs_zero():
    tex = jnp.array([[[[1.0], [2.0]], [[3.0], [4.0]]]], jnp.float32)
    uv = jnp.array([[[[-0.25, 0.25]]]], jnp.float32)  # left of texture
    out_w = dr.texture(tex, uv, filter_mode="linear", boundary_mode="wrap")
    out_c = dr.texture(tex, uv, filter_mode="linear", boundary_mode="clamp")
    out_z = dr.texture(tex, uv, filter_mode="linear", boundary_mode="zero")
    # wrap: u=-0.25 -> 0.75; in texel space u*2-0.5 = 1.0 lands exactly
    # on texel 1's center; v=0.25 -> texel row 0 -> value 2.0.
    np.testing.assert_allclose(np.asarray(out_w[0, 0, 0, 0]), 2.0, atol=1e-6)
    # clamp: u clamps to the left edge texel center, v pins to row 0 ->
    # corner texel 1.0.
    np.testing.assert_allclose(np.asarray(out_c[0, 0, 0, 0]), 1.0, atol=1e-6)
    # zero: u=-0.25*2-0.5=-1 -> texels off-left are zero; only partial.
    assert float(out_z[0, 0, 0, 0]) < float(out_c[0, 0, 0, 0])


def test_mip_construction_sizes():
    tex = jnp.ones((1, 8, 4, 3), jnp.float32)
    wrapper = dr.texture_construct_mip(tex)
    shapes = [lvl.shape for lvl in wrapper.levels]
    assert shapes == [(1, 4, 2, 3), (1, 2, 1, 3), (1, 1, 1, 3)]


def test_mip_construction_odd_raises():
    tex = jnp.ones((1, 6, 6, 1), jnp.float32)  # 6 -> 3 (odd, >1) fails
    with pytest.raises(ValueError):
        dr.texture_construct_mip(tex)
    # but limiting to 1 level works
    w = dr.texture_construct_mip(tex, max_mip_level=1)
    assert [lvl.shape for lvl in w.levels] == [(1, 3, 3, 1)]


def test_trilinear_selects_correct_level():
    # Base 4x4 = 1.0, level1 2x2 = avg (still 1.0), so craft custom mip
    # stack to distinguish levels.
    tex = jnp.ones((1, 4, 4, 1), jnp.float32)
    mip = [jnp.full((1, 2, 2, 1), 2.0), jnp.full((1, 1, 1, 1), 4.0)]
    uv = jnp.full((1, 1, 1, 2), 0.5, jnp.float32)
    # Bias selects level directly (BIAS_ONLY path).
    for bias, expect in [(0.0, 1.0), (1.0, 2.0), (2.0, 4.0), (0.5, 1.5), (1.5, 3.0)]:
        out = dr.texture(tex, uv, mip_level_bias=jnp.full((1, 1, 1), bias),
                         mip=mip, filter_mode="linear-mipmap-linear")
        np.testing.assert_allclose(np.asarray(out[0, 0, 0, 0]), expect,
                                   atol=1e-6, err_msg=f"bias={bias}")


def test_mipmap_nearest_floors_level():
    tex = jnp.ones((1, 4, 4, 1), jnp.float32)
    mip = [jnp.full((1, 2, 2, 1), 2.0), jnp.full((1, 1, 1, 1), 4.0)]
    uv = jnp.full((1, 1, 1, 2), 0.5, jnp.float32)
    out = dr.texture(tex, uv, mip_level_bias=jnp.full((1, 1, 1), 1.7),
                     mip=mip, filter_mode="linear-mipmap-nearest")
    np.testing.assert_allclose(np.asarray(out[0, 0, 0, 0]), 2.0, atol=1e-6)


def test_footprint_mip_level():
    # uv_da spanning one texel per pixel at level k -> flevel = k.
    tex = jnp.ones((1, 16, 16, 1), jnp.float32)
    mip = [jnp.full((1, 8, 8, 1), 2.0), jnp.full((1, 4, 4, 1), 3.0),
           jnp.full((1, 2, 2, 1), 4.0), jnp.full((1, 1, 1, 1), 5.0)]
    uv = jnp.full((1, 1, 1, 2), 0.5, jnp.float32)
    # d(s)/dX = 4/16 in uv units -> 4 texels/pixel -> level 2.
    uv_da = jnp.array([[[[4 / 16, 0.0, 0.0, 4 / 16]]]], jnp.float32)
    out = dr.texture(tex, uv, uv_da=uv_da, mip=mip,
                     filter_mode="linear-mipmap-linear")
    np.testing.assert_allclose(np.asarray(out[0, 0, 0, 0]), 3.0, atol=1e-5)


def test_texture_gradients_linear():
    key = jax.random.PRNGKey(0)
    tex = jax.random.uniform(key, (1, 8, 8, 2))
    uv = jnp.array([[[[0.31, 0.47], [0.66, 0.22]]]], jnp.float32)
    dy = jnp.ones((1, 1, 2, 2), jnp.float32)

    def loss(t, u):
        return jnp.sum(dr.texture(t, u, filter_mode="linear") * dy)

    g_tex, g_uv = jax.grad(loss, argnums=(0, 1))(tex, uv)
    eps = 1e-3
    # finite-difference uv gradient
    for ci in range(2):
        up = uv.at[0, 0, 0, ci].add(eps)
        um = uv.at[0, 0, 0, ci].add(-eps)
        fd = (loss(tex, up) - loss(tex, um)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(g_uv[0, 0, 0, ci]), float(fd),
                                   rtol=1e-2, atol=1e-4)
    # tex gradient sums to number of output elements (partition of unity)
    np.testing.assert_allclose(float(g_tex.sum()), 4.0, rtol=1e-5)


def test_mip_gradient_pulls_to_base():
    # Internal mip construction: base texture receives pulled gradients
    # (the reference's MipGradKernel semantics).
    tex = jnp.ones((1, 4, 4, 1), jnp.float32)
    uv = jnp.full((1, 1, 1, 2), 0.5, jnp.float32)
    bias = jnp.full((1, 1, 1), 2.0)  # sample the 1x1 top level only

    def loss(t):
        return jnp.sum(dr.texture(t, uv, mip_level_bias=bias,
                                  filter_mode="linear-mipmap-linear"))

    g = jax.grad(loss)(tex)
    # Top level texel = mean of all 16 base texels -> each grad 1/16.
    np.testing.assert_allclose(np.asarray(g), np.full((1, 4, 4, 1), 1 / 16),
                               rtol=1e-6)


def test_custom_mip_stack_gets_own_gradients():
    tex = jnp.ones((1, 4, 4, 1), jnp.float32)
    mip = [jnp.full((1, 2, 2, 1), 2.0), jnp.full((1, 1, 1, 1), 4.0)]
    uv = jnp.full((1, 1, 1, 2), 0.5, jnp.float32)
    bias = jnp.full((1, 1, 1), 2.0)

    def loss(t, m):
        return jnp.sum(dr.texture(t, uv, mip_level_bias=bias, mip=m,
                                  filter_mode="linear-mipmap-linear"))

    g_tex, g_mip = jax.grad(loss, argnums=(0, 1))(tex, mip)
    assert float(jnp.abs(g_tex).sum()) == 0.0  # no flow to base
    np.testing.assert_allclose(float(g_mip[1].sum()), 1.0, rtol=1e-6)


def test_cube_face_centers():
    # Face-center directions hit the center texel of the right face.
    tex = jnp.arange(6, dtype=jnp.float32).reshape(1, 6, 1, 1, 1)
    tex = jnp.broadcast_to(tex, (1, 6, 2, 2, 1)).reshape(1, 6, 2, 2, 1)
    dirs = np.array([
        [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
    ], np.float32)
    uv = jnp.asarray(dirs).reshape(1, 1, 6, 3)
    out = dr.texture(tex, uv, filter_mode="nearest", boundary_mode="cube")
    np.testing.assert_allclose(np.asarray(out[0, 0, :, 0]),
                               np.arange(6, dtype=np.float32))


def test_cube_seam_continuity():
    # Sampling across a cube edge must be continuous (seamless
    # filtering): walk a direction across the +x/+z edge.
    key = jax.random.PRNGKey(1)
    tex = jax.random.uniform(key, (1, 6, 8, 8, 1))
    angles = np.linspace(np.pi / 4 - 0.2, np.pi / 4 + 0.2, 81)
    dirs = np.stack([np.sin(angles), np.zeros_like(angles), np.cos(angles)],
                    axis=-1).astype(np.float32)
    uv = jnp.asarray(dirs).reshape(1, 1, -1, 3)
    out = np.asarray(dr.texture(tex, uv, filter_mode="linear",
                                boundary_mode="cube"))[0, 0, :, 0]
    steps = np.abs(np.diff(out))
    # No jump larger than a few times the typical step.
    assert steps.max() < 0.15, steps.max()


def test_cube_invalid_uv_zero():
    tex = jnp.ones((1, 6, 4, 4, 1), jnp.float32)
    uv = jnp.zeros((1, 1, 1, 3), jnp.float32)
    out = dr.texture(tex, uv, filter_mode="linear", boundary_mode="cube")
    np.testing.assert_allclose(np.asarray(out), 0.0)

    def loss(u):
        return jnp.sum(dr.texture(tex, u, filter_mode="linear",
                                  boundary_mode="cube"))

    g = jax.grad(loss)(uv)
    assert np.all(np.isfinite(np.asarray(g)))
    np.testing.assert_allclose(np.asarray(g), 0.0)


def test_cube_uv_gradient_finite_difference():
    key = jax.random.PRNGKey(2)
    tex = jax.random.uniform(key, (1, 6, 8, 8, 1))
    uv = jnp.array([[[[0.4, 0.3, 1.0]]]], jnp.float32)

    def loss(u):
        return jnp.sum(dr.texture(tex, u, filter_mode="linear",
                                  boundary_mode="cube"))

    g = jax.grad(loss)(uv)
    eps = 1e-3
    for ci in range(3):
        up = uv.at[0, 0, 0, ci].add(eps)
        um = uv.at[0, 0, 0, ci].add(-eps)
        fd = (loss(up) - loss(um)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(g[0, 0, 0, ci]), float(fd),
                                   rtol=2e-2, atol=1e-3)


def test_auto_filter_mode_selection():
    tex = jnp.ones((1, 4, 4, 1), jnp.float32)
    uv = jnp.full((1, 1, 1, 2), 0.5, jnp.float32)
    # auto without uv_da -> linear (no mip needed).
    out = dr.texture(tex, uv)
    assert out.shape == (1, 1, 1, 1)
    # auto with uv_da -> linear-mipmap-linear.
    uv_da = jnp.zeros((1, 1, 1, 4), jnp.float32)
    out2 = dr.texture(tex, uv, uv_da=uv_da)
    np.testing.assert_allclose(np.asarray(out2), 1.0)


def test_uv_da_gradient_through_mip_level():
    # Gradient of output w.r.t. uv_da via the footprint formula.
    tex = jnp.ones((1, 8, 8, 1), jnp.float32)
    mip = [jnp.full((1, 4, 4, 1), 2.0), jnp.full((1, 2, 2, 1), 3.0),
           jnp.full((1, 1, 1, 1), 4.0)]
    uv = jnp.full((1, 1, 1, 2), 0.5, jnp.float32)
    uv_da = jnp.array([[[[0.2, 0.01, 0.015, 0.25]]]], jnp.float32)

    def loss(da):
        return jnp.sum(dr.texture(tex, uv, uv_da=da, mip=mip,
                                  filter_mode="linear-mipmap-linear"))

    g = jax.grad(loss)(uv_da)
    eps = 1e-4
    for ci in range(4):
        up = uv_da.at[0, 0, 0, ci].add(eps)
        um = uv_da.at[0, 0, 0, ci].add(-eps)
        fd = (loss(up) - loss(um)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(g[0, 0, 0, ci]), float(fd),
                                   rtol=2e-2, atol=1e-4)


def test_minibatch_texture_broadcast():
    tex = jnp.stack([jnp.zeros((4, 4, 1)), jnp.ones((4, 4, 1))]).astype(jnp.float32)
    uv = jnp.full((2, 1, 1, 2), 0.5, jnp.float32)
    out = dr.texture(tex, uv, filter_mode="linear")
    np.testing.assert_allclose(np.asarray(out[:, 0, 0, 0]), [0.0, 1.0])


def test_earth_atlas_mip_rule_and_parity():
    """Reference earth-sample configuration: a 2048x1536 (w x h) atlas
    needs max_mip_level=9 — level 10 would be 4x3 which the odd-size
    rule rejects (reference texture.cpp:62-102; the earth sample passes
    max_mip_level=9 for exactly this reason, earth.py:73). A
    non-square 384x512 atlas then samples as the float64 reference."""
    import _reference as ref

    with pytest.raises(ValueError, match="not divisible by 2"):
        tx._mip_shapes(1536, 2048, -1)
    shapes = tx._mip_shapes(1536, 2048, 9)
    assert len(shapes) == 10 and shapes[-1] == (3, 4)

    rng = np.random.RandomState(1)
    tex = rng.rand(1, 384, 512, 3).astype(np.float32)
    H, W = 32, 64
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    uv = np.stack([0.55 + 0.1 * xx, 0.55 + 0.1 * yy], -1)[None]
    uv = uv.astype(np.float32)
    uv_da = np.full((1, H, W, 4), 3e-3, np.float32)
    out = dr.texture(tex, uv, uv_da=uv_da, filter_mode="linear-mipmap-linear",
                     boundary_mode="wrap", max_mip_level=7)
    want = ref.texture2d(tex, uv, uv_da=uv_da, max_mip_level=7,
                         filter_mode="linear-mipmap-linear")
    np.testing.assert_allclose(np.asarray(out), want, atol=2e-5)


@pytest.mark.parametrize("boundary_mode", ["wrap", "clamp", "zero"])
def test_texture_gradient_mixed_levels_vs_reference(boundary_mode):
    """Texture gradient for uvs outside [0, 1] and per-pixel mip levels
    spanning the whole pyramid: the adjoint of the reference's sampling
    weights, pulled back through the box-filter mips."""
    import _reference as ref

    rng = np.random.RandomState(3)
    B, H, W = 1, 20, 36
    tex = rng.rand(1, 32, 64, 3).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, (B, H, W, 2)).astype(np.float32)
    bias = np.linspace(0.0, 6.0, B * H * W).reshape(B, H, W)
    bias = bias.astype(np.float32)
    dy = rng.randn(B, H, W, 3).astype(np.float32)
    g = jax.grad(lambda t: jnp.sum(dr.texture(
        t, uv, mip_level_bias=bias, boundary_mode=boundary_mode) * dy))(tex)
    n = 32 * 64
    basis = np.eye(n).reshape(1, 32, 64, n)
    A = ref.texture2d(basis, uv, bias=bias, boundary=boundary_mode,
                      filter_mode="linear-mipmap-linear").reshape(-1, n)
    want = (A.T @ dy.reshape(-1, 3)).reshape(tex.shape)
    assert np.abs(want).sum() > 0
    np.testing.assert_allclose(np.asarray(g), want,
                               atol=1e-5 * np.abs(want).max())
