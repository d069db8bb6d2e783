"""Differentiable texture sampling (2D + cube map, full mip pipeline).

Re-design of the reference texture op
(csrc/common/texture_kernel.cu, csrc/torch/torch_texture.cpp):

* The mip pyramid is a **flat-packed buffer** (all levels concatenated
  texel-major, like the reference's single mip tensor) so per-pixel
  mip levels become one big XLA gather with computed indices — no
  per-level branching.
* Mip construction is a differentiable average-pool chain, so JAX AD
  *is* the reference's MipGradKernel (the 4^-k gradient puller,
  texture_kernel.cu:843-900) — no hand-written backward needed.
* Every hand-written reference gradient kernel
  (texture_kernel.cu:905-1154: texel scatter, analytic uv grads,
  footprint/uv_da grads, mip-bias grads, the four cube-map gradient
  transforms) is the analytic VJP of the forward; implementing the
  forward faithfully in jnp makes JAX AD reproduce them all (the texel
  scatter is XLA's scatter-add: float atomics on a GPU, as in the
  reference).
* Seamless cube-map edge/corner filtering replaces the reference's
  48-entry constant LUTs (texture_kernel.cu:31-92) with a **geometric
  wrap**: an out-of-face texel's direction is reprojected through the
  cube parameterization to find its neighbor-face texel. Corner
  texels (no neighbor) use the average-of-three rule
  (texture_kernel.cu:591-639).

Filter modes: 'nearest', 'linear', 'linear-mipmap-nearest',
'linear-mipmap-linear' (enums match nvdiffrast/torch/ops.py:415-416).
Boundary modes: 'cube', 'wrap', 'clamp', 'zero' (ops.py:419-420).
"""

import jax
import jax.numpy as jnp

# Maximum number of mip levels (reference: csrc/common/texture.h:24).
MAX_MIP_LEVEL = 16

_FILTER_MODES = ("nearest", "linear", "linear-mipmap-nearest", "linear-mipmap-linear")
_BOUNDARY_MODES = ("cube", "wrap", "clamp", "zero")


# ---------------------------------------------------------------------------
# Mip pyramid.
# ---------------------------------------------------------------------------

def _mip_shapes(h, w, max_levels):
    """Level sizes [(h0,w0), (h1,w1), ...] following the reference rule.

    Each level halves every axis that is > 1; an axis that is odd and
    > 1 cannot be downsampled (reference: texture.cpp:62-102).
    """
    shapes = [(h, w)]
    level = 0
    while (h | w) > 1:
        level += 1
        if (w > 1 and (w & 1)) or (h > 1 and (h & 1)):
            raise ValueError(
                f"mip-map generation failed at level {level}: texture size "
                f"{w}x{h} is not divisible by 2; limit mip level count or "
                f"use power-of-two texture dimensions")
        if w > 1:
            w >>= 1
        if h > 1:
            h >>= 1
        shapes.append((h, w))
        if max_levels >= 0 and level == max_levels:
            break
        if level >= MAX_MIP_LEVEL:
            break
    return shapes


def _downsample2x(x):
    """One mip level: 2x2 box filter ([*, h, w, C]); 2x1/1x2 when degenerate."""
    h, w = x.shape[-3], x.shape[-2]
    lead = x.shape[:-3]
    C = x.shape[-1]
    if h > 1 and w > 1:
        x = x.reshape(lead + (h // 2, 2, w // 2, 2, C))
        return x.mean(axis=(-4, -2))
    if h > 1:
        x = x.reshape(lead + (h // 2, 2, w, C))
        return x.mean(axis=-3)
    x = x.reshape(lead + (h, w // 2, 2, C))
    return x.mean(axis=-2)


def build_mip_stack(tex, max_mip_level=-1, cube_mode=False):
    """Differentiably build mip levels 1..L from the base texture.

    Args:
      tex: [D, H, W, C] or cube [D, 6, H, W, C].
      max_mip_level: limit on constructed levels; -1 = down to 1x1.

    Returns:
      List of level arrays (base level NOT included), possibly empty.
    """
    if cube_mode:
        h, w = tex.shape[-3], tex.shape[-2]
        if h != w:
            raise ValueError("cube map faces must be square")
    else:
        h, w = tex.shape[-3], tex.shape[-2]
    shapes = _mip_shapes(h, w, max_mip_level)
    levels = []
    cur = tex
    for _ in shapes[1:]:
        cur = _downsample2x(cur)
        levels.append(cur)
    return levels


@jax.tree_util.register_pytree_node_class
class TextureMipWrapper:
    """Opaque mipmap stack (reference: csrc/torch/torch_types.h:28-35).

    A pytree of the constructed level arrays plus static metadata, so
    it can be passed through jit / pjit boundaries.
    """

    def __init__(self, levels=None, max_mip_level=-1, cube_mode=False):
        self.levels = list(levels) if levels is not None else []
        self.max_mip_level = int(max_mip_level)
        self.cube_mode = bool(cube_mode)

    def tree_flatten(self):
        return tuple(self.levels), (self.max_mip_level, self.cube_mode)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(list(children), aux[0], aux[1])


def texture_construct_mip(tex, max_mip_level=None, cube_mode=False):
    """Construct a mipmap stack for a texture.

    API parity with the reference (nvdiffrast/torch/ops.py:442-465).

    Args:
        tex: Texture tensor with the same constraints as in `texture()`.
        max_mip_level: If specified, limits the number of mipmaps constructed.
        cube_mode: Must be True for cube map textures.

    Returns:
        An opaque `TextureMipWrapper` usable as the `mip` argument of
        `texture()`.
    """
    assert cube_mode is True or cube_mode is False
    tex = jnp.asarray(tex, jnp.float32)
    if max_mip_level is None:
        max_mip_level = -1
    else:
        max_mip_level = int(max_mip_level)
        assert max_mip_level >= 0
    levels = build_mip_stack(tex, max_mip_level, cube_mode)
    return TextureMipWrapper(levels, max_mip_level, cube_mode)


# ---------------------------------------------------------------------------
# Cube map indexing (re-derivation of texture_kernel.cu:99-120).
# ---------------------------------------------------------------------------

def _cube_faceid(x, y, z):
    """Face index per the reference convention (non-differentiable)."""
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    z_major = az > jnp.maximum(ax, ay)
    y_major = (~z_major) & (ay > ax)
    x_major = ~(z_major | y_major)
    c = jnp.where(z_major, z, jnp.where(y_major, y, x))
    base = jnp.where(z_major, 4, jnp.where(y_major, 2, 0))
    face = base + (c < 0).astype(base.dtype)
    return face, x_major, y_major, z_major, c


def _cube_project(face_info, x, y, z):
    """(s, t) in [0,1]^2 on the selected face — differentiable in x,y,z.

    Sign conventions match indexCubeMap exactly:
      u-axis input: z (x-major), x (y-major / z-major);
      v-axis input: y (x-major / z-major), z (y-major);
      m0 flips sign on faces 0 and 5; m1 = -m except on face 2 (+y).
    """
    face, x_major, y_major, z_major, c = face_info
    u_in = jnp.where(x_major, z, x)
    v_in = jnp.where(y_major, z, y)
    # Gradient-safe reciprocal: |c| == 0 marks an invalid lookup (zero
    # vector); guard the division so no NaN leaks into AD.
    ok = jnp.abs(c) > 0
    m = 0.5 / jnp.where(ok, jnp.abs(c), 1.0)
    m0 = jnp.where((face == 0) | (face == 5), -m, m)
    m1 = jnp.where(face == 2, m, -m)
    s = u_in * m0 + 0.5
    t = v_in * m1 + 0.5
    finite = ok & jnp.isfinite(s) & jnp.isfinite(t)
    s = jnp.clip(jnp.where(finite, s, 0.0), 0.0, 1.0)
    t = jnp.clip(jnp.where(finite, t, 0.0), 0.0, 1.0)
    return s, t, finite


def _cube_face_direction(face, s, t):
    """Inverse of the face parameterization: texel (s, t) -> direction.

    Used to wrap out-of-face texels geometrically (replaces the
    c_cubeWrapMask LUTs). s, t may lie outside [0,1].
    """
    # Solve u_in * m0 + 0.5 = s with |c| = 1:
    #   u_in = (s - 0.5) / m0 where m0 = +-0.5 -> u_in = +-2 (s - 0.5).
    du = 2.0 * (s - 0.5)
    dv = 2.0 * (t - 0.5)
    # face -> (c-axis sign, u-input axis, v-input axis, m0 sign, m1 sign)
    # face 0 (+x): u_in=z (m0 -), v_in=y (m1 -)  => z=-du, y=-dv, x=+1
    # face 1 (-x): u_in=z (m0 +), v_in=y (m1 -)  => z=+du, y=-dv, x=-1
    # face 2 (+y): u_in=x (m0 +), v_in=z (m1 +)  => x=+du, z=+dv, y=+1
    # face 3 (-y): u_in=x (m0 +), v_in=z (m1 -)  => x=+du, z=-dv, y=-1
    # face 4 (+z): u_in=x (m0 +), v_in=y (m1 -)  => x=+du, y=-dv, z=+1
    # face 5 (-z): u_in=x (m0 -), v_in=y (m1 -)  => x=-du, y=-dv, z=-1
    one = jnp.ones_like(du)
    xs = jnp.stack([one, -one, du, du, du, -du])
    ys = jnp.stack([-dv, -dv, one, -one, -dv, -dv])
    zs = jnp.stack([-du, du, dv, -dv, one, -one])
    f = face[None]
    sel = jnp.arange(6).reshape((6,) + (1,) * face.ndim)
    pick = lambda a: jnp.sum(jnp.where(sel == f, a, 0.0), axis=0)
    return pick(xs), pick(ys), pick(zs)


def _cube_wrap_texel(face, ix, iy, w):
    """Map a (possibly out-of-face) texel to (face', ix', iy', valid).

    In-face texels pass through. Edge overflows reproject through the
    cube geometry. Diagonal (corner) overflows are invalid — the
    corner texel does not exist (valid=False), to be filled by the
    average-of-three rule.
    """
    ix_out = (ix < 0) | (ix >= w)
    iy_out = (iy < 0) | (iy >= w)
    corner = ix_out & iy_out
    inface = ~(ix_out | iy_out)

    wf = jnp.float32(w)
    s = (ix.astype(jnp.float32) + 0.5) / wf
    t = (iy.astype(jnp.float32) + 0.5) / wf
    dx, dy, dz = _cube_face_direction(face, s, t)
    finfo = _cube_faceid(dx, dy, dz)
    s2, t2, _ = _cube_project(finfo, dx, dy, dz)
    nface = finfo[0]
    # Texel centers land exactly on (k + 0.5)/w; round defensively.
    nix = jnp.round(s2 * wf - 0.5).astype(jnp.int32)
    niy = jnp.round(t2 * wf - 0.5).astype(jnp.int32)
    nix = jnp.clip(nix, 0, w - 1)
    niy = jnp.clip(niy, 0, w - 1)

    rface = jnp.where(inface, face, nface)
    rix = jnp.where(inface, jnp.clip(ix, 0, w - 1), nix)
    riy = jnp.where(inface, jnp.clip(iy, 0, w - 1), niy)
    return rface, rix, riy, ~corner


# ---------------------------------------------------------------------------
# Flat-packed pyramid addressing.
# ---------------------------------------------------------------------------

def _pack_pyramid(levels, cube_mode):
    """Concatenate levels into one flat [n_texels, C] buffer + metadata."""
    C = levels[0].shape[-1]
    flats = [lvl.reshape(-1, C) for lvl in levels]
    offsets = []
    off = 0
    heights = []
    widths = []
    for lvl in levels:
        h, w = lvl.shape[-3], lvl.shape[-2]
        offsets.append(off)
        heights.append(h)
        widths.append(w)
        off += flats[len(offsets) - 1].shape[0]
    flat = jnp.concatenate(flats, axis=0)
    meta = (jnp.asarray(offsets, jnp.int32), jnp.asarray(heights, jnp.int32),
            jnp.asarray(widths, jnp.int32))
    return flat, meta


def _gather(flat, idx, valid):
    """Row-gather [*, C] <- flat[NT, C]; invalid lanes give zeros.

    idx/valid are flat [N]-shaped (SoA) — one gather per texel corner.
    """
    idx_safe = jnp.where(valid, idx, 0)
    vals = flat[idx_safe]
    return jnp.where(valid[..., None], vals, 0.0)


# ---------------------------------------------------------------------------
# Samplers.
# ---------------------------------------------------------------------------

def _sample_nearest(flat, meta, uv, tz, D, boundary_mode, cube_mode):
    offs, hs, ws = meta
    level = jnp.zeros(uv.shape[:-1], jnp.int32)
    off = offs[0]
    h = hs[0].astype(jnp.float32)
    w = ws[0].astype(jnp.float32)
    hi = hs[0]
    wi = ws[0]

    if cube_mode:
        finfo = _cube_faceid(uv[..., 0], uv[..., 1], uv[..., 2])
        s, t, finite = _cube_project(finfo, uv[..., 0], uv[..., 1], uv[..., 2])
        face = finfo[0]
        iu = jnp.clip(jnp.floor(s * w).astype(jnp.int32), 0, wi - 1)
        iv = jnp.clip(jnp.floor(t * h).astype(jnp.int32), 0, hi - 1)
        zidx = tz * 6 + face
        idx = off + (zidx * hi + iv) * wi + iu
        return _gather(flat, idx, finite)

    u = uv[..., 0]
    v = uv[..., 1]
    if boundary_mode == "wrap":
        u = u - jnp.floor(u)
        v = v - jnp.floor(v)
    iu = jnp.floor(u * w).astype(jnp.int32)
    iv = jnp.floor(v * h).astype(jnp.int32)
    valid = jnp.ones(iu.shape, bool)
    if boundary_mode == "zero":
        valid = (iu >= 0) & (iu < wi) & (iv >= 0) & (iv < hi)
    iu = jnp.clip(iu, 0, wi - 1)
    iv = jnp.clip(iv, 0, hi - 1)
    idx = off + (tz * hi + iv) * wi + iu
    return _gather(flat, idx, valid)


def _linear_setup_2d(uv, level, meta, boundary_mode):
    """Per-pixel bilinear addressing for 2D textures at a given level.

    Returns per-corner flat indices/validity in (00, 10, 01, 11) order
    as tuples of [N] arrays (SoA). Matches indexTextureLinear
    (texture_kernel.cu:368-472) including the clamp trick that zeroes
    uv gradients at clamped edges (iu1 = iu0 when clamped).
    """
    offs, hs, ws = meta
    off = offs[level]
    hi = hs[level]
    wi = ws[level]
    h = hi.astype(jnp.float32)
    w = wi.astype(jnp.float32)

    u = uv[..., 0]
    v = uv[..., 1]
    if boundary_mode == "wrap":
        u = u - jnp.floor(u)
        v = v - jnp.floor(v)
    u = u * w - 0.5
    v = v * h - 0.5

    if boundary_mode == "clamp":
        u = jnp.clip(u, 0.0, w - 1.0)
        v = jnp.clip(v, 0.0, h - 1.0)
        clamp_u = (u == 0.0) | (u == w - 1.0)
        clamp_v = (v == 0.0) | (v == h - 1.0)
    else:
        clamp_u = jnp.zeros(u.shape, bool)
        clamp_v = clamp_u

    iu0 = jnp.floor(u).astype(jnp.int32)
    iv0 = jnp.floor(v).astype(jnp.int32)
    iu1 = iu0 + jnp.where(clamp_u, 0, 1)
    iv1 = iv0 + jnp.where(clamp_v, 0, 1)
    fu = u - iu0.astype(jnp.float32)
    fv = v - iv0.astype(jnp.float32)

    if boundary_mode == "wrap":
        iu0 = jnp.where(iu0 < 0, iu0 + wi, iu0)
        iv0 = jnp.where(iv0 < 0, iv0 + hi, iv0)
        iu1 = jnp.where(iu1 >= wi, iu1 - wi, iu1)
        iv1 = jnp.where(iv1 >= hi, iv1 - hi, iv1)

    if boundary_mode == "zero":
        u0_ok = (iu0 >= 0) & (iu0 < wi)
        u1_ok = (iu1 >= 0) & (iu1 < wi)
        v0_ok = (iv0 >= 0) & (iv0 < hi)
        v1_ok = (iv1 >= 0) & (iv1 < hi)
        valid4 = (u0_ok & v0_ok, u1_ok & v0_ok, u0_ok & v1_ok, u1_ok & v1_ok)
    else:
        ones = jnp.ones(u.shape, bool)
        valid4 = (ones, ones, ones, ones)

    iu0c = jnp.clip(iu0, 0, wi - 1)
    iu1c = jnp.clip(iu1, 0, wi - 1)
    iv0c = jnp.clip(iv0, 0, hi - 1)
    iv1c = jnp.clip(iv1, 0, hi - 1)
    idx4 = (iv0c * wi + iu0c, iv0c * wi + iu1c,
            iv1c * wi + iu0c, iv1c * wi + iu1c)
    return off, hi, wi, idx4, valid4, fu, fv


def _bilerp(q00, q10, q01, q11, fu, fv):
    """Four [*, C] corner texels in (00, 10, 01, 11) order."""
    fu = fu[..., None]
    fv = fv[..., None]
    top = q00 + fu * (q10 - q00)
    bot = q01 + fu * (q11 - q01)
    return top + fv * (bot - top)


def _sample_linear_level(flat, meta, uv, tz, D, level, boundary_mode,
                         cube_mode, cube_st=None):
    """Bilinear sample at per-pixel integer mip `level` (shape [N])."""
    offs, hs, ws = meta

    if cube_mode:
        s, t, finite, face = cube_st
        hi = hs[level]
        wi = ws[level]
        w = wi.astype(jnp.float32)
        h = hi.astype(jnp.float32)
        u = s * w - 0.5
        v = t * h - 0.5
        iu0 = jnp.floor(u).astype(jnp.int32)
        iv0 = jnp.floor(v).astype(jnp.int32)
        iu1 = iu0 + 1
        iv1 = iv0 + 1
        fu = u - iu0.astype(jnp.float32)
        fv = v - iv0.astype(jnp.float32)

        # Wrap each corner geometrically across face edges.
        f00, x00, y00, ok00 = _cube_wrap_texel(face, iu0, iv0, wi)
        f10, x10, y10, ok10 = _cube_wrap_texel(face, iu1, iv0, wi)
        f01, x01, y01, ok01 = _cube_wrap_texel(face, iu0, iv1, wi)
        f11, x11, y11, ok11 = _cube_wrap_texel(face, iu1, iv1, wi)

        off = offs[level]

        def addr(f, ix, iy):
            return off + ((tz * 6 + f) * hi + iy) * wi + ix

        ok00 = ok00 & finite
        ok10 = ok10 & finite
        ok01 = ok01 & finite
        ok11 = ok11 & finite
        q00 = _gather(flat, addr(f00, x00, y00), ok00)
        q10 = _gather(flat, addr(f10, x10, y10), ok10)
        q01 = _gather(flat, addr(f01, x01, y01), ok01)
        q11 = _gather(flat, addr(f11, x11, y11), ok11)
        # Cube-corner rule: a missing texel takes the average of the
        # other three (texture_kernel.cu:591-614).
        n_ok = (ok00.astype(jnp.float32) + ok10.astype(jnp.float32)
                + ok01.astype(jnp.float32) + ok11.astype(jnp.float32))
        n_ok = jnp.maximum(n_ok, 1.0)
        avg = (q00 + q10 + q01 + q11) / n_ok[..., None]

        def fix(q, ok):
            return jnp.where((finite & ~ok)[..., None], avg, q)

        return _bilerp(fix(q00, ok00), fix(q10, ok10), fix(q01, ok01),
                       fix(q11, ok11), fu, fv)

    off, hi, wi, idx4, valid4, fu, fv = _linear_setup_2d(
        uv, level, meta, boundary_mode)
    base = off + tz * hi * wi
    q = [_gather(flat, base + i, v) for i, v in zip(idx4, valid4)]
    return _bilerp(q[0], q[1], q[2], q[3], fu, fv)


# ---------------------------------------------------------------------------
# Mip level selection (re-derivation of calculateMipLevel,
# texture_kernel.cu:477-585). Differentiable in uv_da / bias / uv.
# ---------------------------------------------------------------------------

@jax.custom_jvp
def _sqrt_grad_safe(x):
    return jnp.sqrt(x)


@_sqrt_grad_safe.defjvp
def _sqrt_grad_safe_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = jnp.sqrt(x)
    # Zero derivative at x == 0 (the reference zeroes uv_da gradients
    # for degenerate footprints via its isfinite guard,
    # texture_kernel.cu:540-542).
    dy = jnp.where(x > 0, 0.5 / jnp.maximum(y, 1e-30), 0.0) * dx
    return y, dy


def _mip_level_from_footprint(uv_da, tex_w, tex_h):
    dsdx = uv_da[..., 0] * tex_w
    dsdy = uv_da[..., 1] * tex_w
    dtdx = uv_da[..., 2] * tex_h
    dtdy = uv_da[..., 3] * tex_h
    A = dsdx * dsdx + dtdx * dtdx
    B = dsdy * dsdy + dtdy * dtdy
    C = dsdx * dsdy + dtdx * dtdy
    l2b = 0.5 * (A + B)
    l2n = 0.25 * (A - B) * (A - B) + C * C
    l2a = _sqrt_grad_safe(l2n)
    # Floor at a tiny positive value: keeps log2 finite-gradient for
    # zero footprints (background pixels) — the later clamp-to-0 makes
    # the value identical either way.
    len_major_sqr = jnp.maximum(l2b + l2a, 1e-38)
    flevel = 0.5 * jnp.log2(len_major_sqr)
    # NaN -> 0 like the reference's fminf/fmaxf semantics; -inf (zero
    # footprint) and +inf are fixed by the later clamp.
    return jnp.where(jnp.isnan(flevel), 0.0, flevel)


def _cube_uv_da_to_st_da(uv, uv_da):
    """Map d{x,y,z}/d{X,Y} to d{s,t}/d{X,Y} via the face-projection JVP.

    Replaces indexCubeMapGradST (texture_kernel.cu:190-239): the
    Jacobian of the differentiable projection, evaluated with jax.jvp,
    so AD also reproduces indexCubeMapGrad2/Grad4 for the backward.
    """
    dvdX = uv_da[..., 0::2]  # [..., 3]
    dvdY = uv_da[..., 1::2]

    def proj(v3):
        finfo = _cube_faceid(v3[..., 0], v3[..., 1], v3[..., 2])
        # Differentiable (s, t) w/o the [0,1] clamp (the clamp is for
        # addressing only; footprint math uses the raw projection).
        face, x_major, y_major, z_major, c = finfo
        u_in = jnp.where(x_major, v3[..., 2], v3[..., 0])
        v_in = jnp.where(y_major, v3[..., 2], v3[..., 1])
        ok = jnp.abs(c) > 0
        m = 0.5 / jnp.where(ok, jnp.abs(c), 1.0)
        m0 = jnp.where((face == 0) | (face == 5), -m, m)
        m1 = jnp.where(face == 2, m, -m)
        st = jnp.stack([u_in * m0, v_in * m1], axis=-1)
        return jnp.where(ok[..., None], st, 0.0)

    _, dstdX = jax.jvp(proj, (uv,), (dvdX,))
    _, dstdY = jax.jvp(proj, (uv,), (dvdY,))
    res = jnp.stack([dstdX[..., 0], dstdY[..., 0],
                     dstdX[..., 1], dstdY[..., 1]], axis=-1)
    finite = jnp.all(jnp.isfinite(res), axis=-1, keepdims=True)
    return jnp.where(finite, res, 0.0)


# ---------------------------------------------------------------------------
# Public op.
# ---------------------------------------------------------------------------

def texture(tex, uv, uv_da=None, mip_level_bias=None, mip=None,
            filter_mode="auto", boundary_mode="wrap", max_mip_level=None):
    """Perform texture sampling (see `_texture_impl` for semantics)."""
    with jax.named_scope("nvdiffrast.texture"):
        return _texture_impl(tex, uv, uv_da, mip_level_bias, mip,
                             filter_mode, boundary_mode, max_mip_level)


def _texture_impl(tex, uv, uv_da=None, mip_level_bias=None, mip=None,
                  filter_mode="auto", boundary_mode="wrap",
                  max_mip_level=None):
    """Perform texture sampling.

    API parity with the reference op (nvdiffrast/torch/ops.py:345-439).

    Args:
        tex: Texture tensor, float32. 2D: [minibatch_size, tex_height,
            tex_width, tex_channels]; cube map: [minibatch_size, 6,
            tex_height, tex_width, tex_channels] with square faces and
            boundary_mode='cube'. Minibatch broadcasting supported.
        uv: Per-pixel texture coordinates: [minibatch_size, height,
            width, 2] (2D) or [..., 3] (cube).
        uv_da: (Optional) image-space derivatives of uv, last dim 4
            (2D) or 6 (cube).
        mip_level_bias: (Optional) per-pixel mip bias [minibatch_size,
            height, width]; used alone it selects the level directly.
        mip: (Optional) `TextureMipWrapper` from `texture_construct_mip`,
            or a list of custom mip tensors (base level excluded;
            gradients then flow to the list entries, not to `tex`).
        filter_mode: 'auto', 'nearest', 'linear',
            'linear-mipmap-nearest', 'linear-mipmap-linear'.
        boundary_mode: 'wrap', 'clamp', 'zero', or 'cube'.
        max_mip_level: limits constructed/used mip levels.

    Returns:
        [minibatch_size, height, width, tex_channels]. Cube map fetches
        with invalid uv (e.g. zero vectors) return zeros and propagate
        no gradients.
    """
    if filter_mode == "auto":
        filter_mode = ("linear-mipmap-linear"
                       if (uv_da is not None or mip_level_bias is not None)
                       else "linear")
    if filter_mode not in _FILTER_MODES:
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    if boundary_mode not in _BOUNDARY_MODES:
        raise ValueError(f"unknown boundary_mode {boundary_mode!r}")

    if max_mip_level is None:
        max_mip_level = -1
    else:
        max_mip_level = int(max_mip_level)
        assert max_mip_level >= 0

    tex = jnp.asarray(tex, jnp.float32)
    uv = jnp.asarray(uv, jnp.float32)
    cube_mode = boundary_mode == "cube"

    if cube_mode:
        if tex.ndim != 5 or tex.shape[1] != 6:
            raise ValueError("cube map texture must have shape [>0, 6, >0, >0, >0]")
        if tex.shape[2] != tex.shape[3]:
            raise ValueError("cube map texture must have square faces")
        if uv.shape[-1] != 3:
            raise ValueError("cube map sampling requires 3-channel uv")
    else:
        if tex.ndim != 4:
            raise ValueError("texture must have shape [>0, >0, >0, >0]")
        if uv.shape[-1] != 2:
            raise ValueError("2D texture sampling requires 2-channel uv")

    use_mip = "mipmap" in filter_mode
    if use_mip and uv_da is None and mip_level_bias is None:
        raise ValueError("mipmap filter modes require uv_da and/or mip_level_bias")
    # Mipping disabled via max level 0 -> simpler filtering internally
    # (reference: ops.py:411-412).
    if max_mip_level == 0 and use_mip:
        filter_mode = "linear"
        use_mip = False

    D = tex.shape[0]
    B, H, W = uv.shape[0], uv.shape[1], uv.shape[2]
    C = tex.shape[-1]
    N = B * H * W

    # Flat SoA pixel axis: every per-pixel quantity is [N]/[N, K].
    uv = uv.reshape(N, uv.shape[-1])
    if D == 1:
        tz = jnp.zeros((N,), jnp.int32)
    else:
        if D != B:
            raise ValueError("texture minibatch size must be 1 or match uv")
        tz = jnp.arange(N, dtype=jnp.int32) // (H * W)

    def unflatten(img):
        return img.reshape(B, H, W, C)

    # Assemble the level list.
    if use_mip:
        if mip is not None:
            if isinstance(mip, TextureMipWrapper):
                levels = [tex] + list(mip.levels)
                if mip.max_mip_level >= 0 and max_mip_level < 0:
                    max_mip_level = mip.max_mip_level
            elif isinstance(mip, (list, tuple)):
                levels = [tex] + [jnp.asarray(m, jnp.float32) for m in mip]
            else:
                raise TypeError("mip must be a TextureMipWrapper or list of arrays")
        else:
            levels = [tex] + build_mip_stack(tex, max_mip_level, cube_mode)
        mip_level_max = len(levels) - 1
    else:
        levels = [tex]
        mip_level_max = 0

    flat, meta = _pack_pyramid(levels, cube_mode)
    # Materialize the packed pyramid. Left to fuse, XLA compiles the mip
    # chain into every corner gather and into their transposed scatters:
    # on an H100 the 2048^2 trilinear fwd+bwd took 114 s to compile and
    # 142 ms to run, 31.5 s and 123 ms with the barrier.
    flat = jax.lax.optimization_barrier(flat)

    # ---- mip level selection (differentiable; shared by all paths) ----
    flevel = None
    if use_mip:
        tex_h = jnp.float32(tex.shape[-3])
        tex_w = jnp.float32(tex.shape[-2])
        if uv_da is not None:
            uv_da = jnp.asarray(uv_da, jnp.float32).reshape(N, -1)
            if cube_mode:
                st_da = _cube_uv_da_to_st_da(uv, uv_da)
            else:
                st_da = uv_da
            flevel = _mip_level_from_footprint(st_da, tex_w, tex_h)
        else:
            flevel = jnp.zeros(uv.shape[:-1], jnp.float32)
        if mip_level_bias is not None:
            mip_level_bias = jnp.asarray(mip_level_bias, jnp.float32)
            flevel = flevel + mip_level_bias.reshape(N)
        flevel = jnp.clip(flevel, 0.0, float(mip_level_max))

    # ---- nearest ----
    if filter_mode == "nearest":
        return unflatten(
            _sample_nearest(flat, meta, uv, tz, D, boundary_mode, cube_mode))

    cube_st = None
    if cube_mode:
        finfo = _cube_faceid(uv[..., 0], uv[..., 1], uv[..., 2])
        s, t, finite = _cube_project(finfo, uv[..., 0], uv[..., 1], uv[..., 2])
        cube_st = (s, t, finite, finfo[0])

    # ---- linear (no mip) ----
    if filter_mode == "linear":
        level0 = jnp.zeros(uv.shape[:-1], jnp.int32)
        return unflatten(_sample_linear_level(
            flat, meta, uv, tz, D, level0, boundary_mode, cube_mode, cube_st))

    level0 = jnp.floor(flevel).astype(jnp.int32)
    level0 = jnp.clip(level0, 0, mip_level_max)

    if filter_mode == "linear-mipmap-nearest":
        return unflatten(_sample_linear_level(
            flat, meta, uv, tz, D, level0, boundary_mode, cube_mode, cube_st))

    # ---- linear-mipmap-linear (trilinear) ----
    level1 = jnp.minimum(level0 + 1, mip_level_max)
    frac = flevel - level0.astype(jnp.float32)
    a = _sample_linear_level(flat, meta, uv, tz, D, level0,
                             boundary_mode, cube_mode, cube_st)
    b = _sample_linear_level(flat, meta, uv, tz, D, level1,
                             boundary_mode, cube_mode, cube_st)
    return unflatten(a + frac[..., None] * (b - a))
