"""texture() against the float64 NumPy sampler in tests/_reference.py.

Forward values for every filter x boundary mode, minibatch textures,
bias-only mip selection, big textures and cube maps; gradients to the
texture (the adjoint of the reference's sampling weights) and to
uv / uv_da / bias (central differences of the reference, per pixel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _reference as ref
import nvdiffrast_tpu as dr


def _case(seed=0, B=2, H=33, W=47, th=32, tw=64, C=3, D=1):
    rng = np.random.RandomState(seed)
    tex = rng.rand(D, th, tw, C).astype(np.float32)
    uv = (rng.rand(B, H, W, 2) * 1.4 - 0.2).astype(np.float32)
    uv_da = (rng.randn(B, H, W, 4) * 0.02).astype(np.float32)
    bias = (rng.rand(B, H, W) * 2.0).astype(np.float32)
    return tex, uv, uv_da, bias


def _weights(fn, tex):
    """Sampling matrix A [N, texels] of a reference sampler that is
    linear in the texture: evaluate it on one-hot basis textures."""
    shape = tex.shape[1:-1]
    n = int(np.prod(shape))
    basis = np.eye(n).reshape((1,) + shape + (n,))
    return fn(basis).reshape(-1, n)


def _fd(fn, x, eps=1e-7):
    """Per-element central differences of a per-pixel-independent
    scalar field fn(x) -> [N] (all pixels perturbed at once)."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    flat = x.reshape(x.shape[0] * int(np.prod(x.shape[1:-1])), -1) \
        if x.ndim > 1 else x.reshape(-1, 1)
    gf = g.reshape(flat.shape)
    for k in range(flat.shape[1]):
        e = np.zeros_like(flat)
        e[:, k] = eps
        gf[:, k] = (fn((flat + e).reshape(x.shape))
                    - fn((flat - e).reshape(x.shape))) / (2 * eps)
    return g


def _close(got, want, rtol, name=""):
    got = np.asarray(got, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, atol=rtol * scale, err_msg=name)


@pytest.mark.parametrize("filter_mode", [
    "linear", "linear-mipmap-nearest", "linear-mipmap-linear"])
@pytest.mark.parametrize("boundary_mode", ["wrap", "clamp", "zero"])
def test_texture_forward_vs_reference(filter_mode, boundary_mode):
    tex, uv, uv_da, _ = _case()
    kw = dict(filter_mode=filter_mode, boundary_mode=boundary_mode)
    da = uv_da if "mipmap" in filter_mode else None
    out = dr.texture(tex, uv, uv_da=da, **kw)
    want = ref.texture2d(tex, uv, uv_da=da, filter_mode=filter_mode,
                         boundary=boundary_mode)
    np.testing.assert_allclose(np.asarray(out), want, atol=2e-5)


def test_texture_nearest_vs_reference():
    tex, uv, _, _ = _case(seed=4)
    for bm in ("wrap", "clamp", "zero"):
        out = dr.texture(tex, uv, filter_mode="nearest", boundary_mode=bm)
        want = ref.texture2d(tex, uv, filter_mode="nearest", boundary=bm)
        np.testing.assert_allclose(np.asarray(out), want, atol=1e-6,
                                   err_msg=bm)


def test_texture_minibatch_tex_vs_reference():
    tex, uv, uv_da, _ = _case(D=2, B=2)
    out = dr.texture(tex, uv, uv_da=uv_da,
                     filter_mode="linear-mipmap-linear")
    want = ref.texture2d(tex, uv, uv_da=uv_da,
                         filter_mode="linear-mipmap-linear")
    np.testing.assert_allclose(np.asarray(out), want, atol=2e-5)


def test_texture_bias_only_vs_reference():
    tex, uv, _, bias = _case()
    out = dr.texture(tex, uv, mip_level_bias=bias)
    want = ref.texture2d(tex, uv, bias=bias,
                         filter_mode="linear-mipmap-linear")
    np.testing.assert_allclose(np.asarray(out), want, atol=2e-5)


def _grad_check(tex, uv, uv_da, bias, boundary_mode, filter_mode,
                max_mip_level=None):
    """Gradients of sum(o^2 + 0.3 o) wrt tex, uv, uv_da, bias."""
    kw = dict(filter_mode=filter_mode, boundary_mode=boundary_mode)
    mml = -1 if max_mip_level is None else max_mip_level

    def loss(t, u, da, b):
        o = dr.texture(t, u, uv_da=da, mip_level_bias=b,
                       max_mip_level=max_mip_level, **kw)
        return jnp.sum(o ** 2 + 0.3 * o)

    args = [uv, uv_da, bias]
    live = [a is not None for a in args]
    grads = jax.grad(loss, argnums=tuple(
        [0] + [i + 1 for i in range(3) if live[i]]))(tex, *args)

    def sample(t, u, da, b):
        return ref.texture2d(t, u, uv_da=da, bias=b, filter_mode=filter_mode,
                             boundary=boundary_mode, max_mip_level=mml)

    o = sample(tex, uv, uv_da, bias)
    dy = (2 * o + 0.3).reshape(-1, o.shape[-1])
    A = _weights(lambda bt: sample(bt, uv, uv_da, bias), tex)
    g_tex = (A.T @ dy).reshape(tex.shape)
    _close(grads[0], g_tex, 1e-5, "g_tex")
    assert np.abs(g_tex).sum() > 0

    def per_pixel(i):
        def f(x):
            a = list(args)
            a[i] = x
            oo = sample(tex, *a)
            return np.sum(oo ** 2 + 0.3 * oo, axis=-1).reshape(-1)
        return f

    k = 1
    for i, name in enumerate(("g_uv", "g_uv_da", "g_bias")):
        if not live[i]:
            continue
        x = args[i] if args[i].ndim == 4 else args[i][..., None]
        want = _fd(lambda xx: per_pixel(i)(xx.reshape(args[i].shape)), x)
        _close(np.asarray(grads[k]).reshape(want.shape), want, 2e-3, name)
        assert np.abs(want).sum() > 0, name
        k += 1


@pytest.mark.parametrize("boundary_mode", ["wrap", "clamp", "zero"])
def test_texture_gradients_vs_reference(boundary_mode):
    tex, uv, uv_da, bias = _case(H=17, W=21)
    _grad_check(tex, uv, uv_da, bias, boundary_mode, "linear-mipmap-linear")


def test_texture_gradient_linear_vs_reference():
    tex, uv, _, _ = _case(H=17, W=21)
    _grad_check(tex, uv, None, None, "wrap", "linear")


def test_texture_big_texture_vs_reference():
    """1024^2 texture with a smooth minifying uv field: forward and
    uv / uv_da gradients (texture gradient checked at smaller sizes)."""
    rng = np.random.RandomState(0)
    tex = rng.rand(1, 1024, 1024, 3).astype(np.float32)
    H, W = 32, 48
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    uv = np.stack([0.3 + 0.2 * xx, 0.3 + 0.2 * yy], -1)[None]
    uv = uv.astype(np.float32)
    uv_da = np.broadcast_to(np.float32([3e-3, 1e-3, -5e-4, 2.5e-3]),
                            (1, H, W, 4)).copy()
    out = dr.texture(tex, uv, uv_da=uv_da, max_mip_level=4,
                     filter_mode="linear-mipmap-linear")
    want = ref.texture2d(tex, uv, uv_da=uv_da, max_mip_level=4,
                         filter_mode="linear-mipmap-linear")
    np.testing.assert_allclose(np.asarray(out), want, atol=2e-5)

    def loss(u, da):
        o = dr.texture(tex, u, uv_da=da, max_mip_level=4,
                       filter_mode="linear-mipmap-linear")
        return jnp.sum(o ** 2)

    g_uv, g_da = jax.grad(loss, argnums=(0, 1))(uv, uv_da)

    def field(u, da):
        o = ref.texture2d(tex, u, uv_da=da, max_mip_level=4,
                          filter_mode="linear-mipmap-linear")
        return np.sum(o ** 2, axis=-1).reshape(-1)

    _close(g_uv, _fd(lambda u: field(u, uv_da), uv), 2e-3, "g_uv")
    _close(g_da, _fd(lambda d: field(uv, d), uv_da), 2e-3, "g_uv_da")


def test_texture_fd_gradient():
    """Finite differences of the op itself (uv gradients, jitted)."""
    tex, uv, uv_da, _ = _case(H=9, W=11, th=16, tw=16)

    @jax.jit
    def loss(u):
        o = dr.texture(tex, u, uv_da=uv_da,
                       filter_mode="linear-mipmap-linear")
        return jnp.sum(o ** 2)

    g = jax.jit(jax.grad(loss))(uv)
    rng = np.random.RandomState(3)
    for _ in range(4):
        b, i, j, k = (rng.randint(s) for s in uv.shape)
        eps = 1e-3
        up = jnp.asarray(uv).at[b, i, j, k].add(eps)
        um = jnp.asarray(uv).at[b, i, j, k].add(-eps)
        fd = (float(loss(up)) - float(loss(um))) / (2 * eps)
        np.testing.assert_allclose(float(g[b, i, j, k]), fd, atol=2e-2,
                                   rtol=5e-2)


# ---------------------------------------------------------------------------
# Cube maps (directions whose footprints stay inside one face).
# ---------------------------------------------------------------------------

def _cube_case(seed=0, B=2, H=13, W=15, fw=16, C=3, D=1):
    rng = np.random.RandomState(seed)
    tex = rng.rand(D, 6, fw, fw, C).astype(np.float32)
    N = B * H * W
    axis = rng.randint(0, 3, N)
    d = rng.uniform(-0.6, 0.6, (N, 3))
    d[np.arange(N), axis] = rng.choice([-1.0, 1.0], N)
    d *= rng.uniform(0.5, 2.0, (N, 1))
    dirs = d.reshape(B, H, W, 3).astype(np.float32)
    dirs_da = (rng.randn(B, H, W, 6) * 0.05).astype(np.float32)
    return tex, dirs, dirs_da


@pytest.mark.parametrize("filter_mode", ["linear", "linear-mipmap-linear"])
def test_cube_forward_vs_reference(filter_mode):
    tex, dirs, dirs_da = _cube_case()
    da = dirs_da if "mipmap" in filter_mode else None
    out = dr.texture(tex, dirs, uv_da=da, filter_mode=filter_mode,
                     boundary_mode="cube", max_mip_level=2)
    want = ref.texture_cube(tex, dirs, da, filter_mode, max_mip_level=2)
    np.testing.assert_allclose(np.asarray(out), want, atol=2e-5)


def test_cube_minibatch_tex_vs_reference():
    tex, dirs, dirs_da = _cube_case(D=2, B=2, seed=1)
    out = dr.texture(tex, dirs, uv_da=dirs_da, boundary_mode="cube",
                     filter_mode="linear-mipmap-linear", max_mip_level=2)
    want = ref.texture_cube(tex, dirs, dirs_da, "linear-mipmap-linear",
                            max_mip_level=2)
    np.testing.assert_allclose(np.asarray(out), want, atol=2e-5)


def test_cube_big_face_vs_reference():
    tex, dirs, dirs_da = _cube_case(seed=3, fw=256, B=1)
    dirs_da = dirs_da * 0.2
    out = dr.texture(tex, dirs, uv_da=dirs_da, boundary_mode="cube",
                     filter_mode="linear-mipmap-linear", max_mip_level=5)
    want = ref.texture_cube(tex, dirs, dirs_da, "linear-mipmap-linear",
                            max_mip_level=5)
    np.testing.assert_allclose(np.asarray(out), want, atol=2e-5)


def test_cube_gradient_vs_reference():
    tex, dirs, dirs_da = _cube_case(seed=2, B=1)
    mode = "linear-mipmap-linear"

    def loss(t, u):
        o = dr.texture(t, u, uv_da=dirs_da, filter_mode=mode,
                       boundary_mode="cube", max_mip_level=2)
        return jnp.sum(o ** 2 + 0.2 * o)

    g_tex, g_dir = jax.grad(loss, argnums=(0, 1))(tex, dirs)

    def sample(t, u):
        return ref.texture_cube(t, u, dirs_da, mode, max_mip_level=2)

    o = sample(tex, dirs)
    dy = (2 * o + 0.2).reshape(-1, o.shape[-1])
    A = _weights(lambda bt: sample(bt, dirs), tex)
    _close(g_tex, (A.T @ dy).reshape(tex.shape), 1e-5, "g_tex")

    def field(u):
        oo = sample(tex, u)
        return np.sum(oo ** 2 + 0.2 * oo, axis=-1).reshape(-1)

    want = _fd(field, dirs)
    assert np.abs(want).sum() > 0
    _close(g_dir, want, 2e-3, "g_dir")
