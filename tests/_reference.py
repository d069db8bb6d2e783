"""Plain float64 NumPy references for the texture, interpolate and
antialias ops — written from the reference's documented semantics,
independent of the JAX code under test.

Texture: bilinear/trilinear/nearest sampling with wrap/clamp/zero
boundaries and box-filter mips (reference texture_kernel.cu
indexTextureLinear / calculateMipLevel); cube maps on face interiors.
Interpolate: out = b0*a0 + b1*a1 + (1-b0-b1)*a2 plus the image-space
derivative chain rule (interpolate.cu). Antialias: the forward
discontinuity analysis and blend of antialias.cu, pair by pair.
"""

import numpy as np


# ---------------------------------------------------------------------------
# Texture.
# ---------------------------------------------------------------------------

def mip_pyramid(tex, max_level=-1):
    """[D, h, w, C] -> list of levels (base first), 2x2 box averages."""
    levels = [np.asarray(tex, np.float64)]
    while True:
        t = levels[-1]
        h, w = t.shape[1:3]
        if (h | w) == 1 or (max_level >= 0 and len(levels) > max_level):
            return levels
        D, C = t.shape[0], t.shape[3]
        if h > 1 and w > 1:
            t = t.reshape(D, h // 2, 2, w // 2, 2, C).mean(axis=(2, 4))
        elif h > 1:
            t = t.reshape(D, h // 2, 2, w, C).mean(axis=2)
        else:
            t = t.reshape(D, h, w // 2, 2, C).mean(axis=3)
        levels.append(t)


def _corners(u, size, boundary):
    """Texel indices (i0, i1), weight of i1, and per-index validity for
    one axis; u in texture-coordinate units [0, 1]."""
    if boundary == "wrap":
        u = u - np.floor(u)
    x = u * size - 0.5
    if boundary == "clamp":
        x = np.clip(x, 0.0, size - 1.0)
    i0 = np.floor(x).astype(np.int64)
    f = x - i0
    i1 = i0 + 1
    if boundary == "wrap":
        i0 %= size
        i1 %= size
    ok0 = (i0 >= 0) & (i0 < size)
    ok1 = (i1 >= 0) & (i1 < size)
    if boundary == "clamp":
        i1 = np.minimum(i1, size - 1)
        ok0 = ok1 = np.ones_like(ok0)
    return i0, i1, f, ok0, ok1


def bilinear(level, z, u, v, boundary):
    """Sample level [D, h, w, C] at per-pixel (z, u, v) -> [N, C]."""
    h, w = level.shape[1:3]
    iu0, iu1, fu, oku0, oku1 = _corners(u, w, boundary)
    iv0, iv1, fv, okv0, okv1 = _corners(v, h, boundary)

    def tap(iv, iu, ok):
        val = level[z, np.clip(iv, 0, h - 1), np.clip(iu, 0, w - 1)]
        return np.where(ok[:, None], val, 0.0)

    q00 = tap(iv0, iu0, okv0 & oku0)
    q10 = tap(iv0, iu1, okv0 & oku1)
    q01 = tap(iv1, iu0, okv1 & oku0)
    q11 = tap(iv1, iu1, okv1 & oku1)
    fu = fu[:, None]
    fv = fv[:, None]
    top = q00 + fu * (q10 - q00)
    bot = q01 + fu * (q11 - q01)
    return top + fv * (bot - top)


def nearest(level, z, u, v, boundary):
    h, w = level.shape[1:3]
    if boundary == "wrap":
        u = u - np.floor(u)
        v = v - np.floor(v)
    iu = np.floor(u * w).astype(np.int64)
    iv = np.floor(v * h).astype(np.int64)
    ok = np.ones(u.shape, bool)
    if boundary == "zero":
        ok = (iu >= 0) & (iu < w) & (iv >= 0) & (iv < h)
    val = level[z, np.clip(iv, 0, h - 1), np.clip(iu, 0, w - 1)]
    return np.where(ok[:, None], val, 0.0)


def mip_level(st_da, tex_w, tex_h):
    """calculateMipLevel: log2 of the major axis of the footprint."""
    dsdx = st_da[:, 0] * tex_w
    dsdy = st_da[:, 1] * tex_w
    dtdx = st_da[:, 2] * tex_h
    dtdy = st_da[:, 3] * tex_h
    A = dsdx * dsdx + dtdx * dtdx
    B = dsdy * dsdy + dtdy * dtdy
    C = dsdx * dsdy + dtdx * dtdy
    major = 0.5 * (A + B) + np.sqrt(0.25 * (A - B) ** 2 + C * C)
    with np.errstate(divide="ignore"):
        return 0.5 * np.log2(np.maximum(major, 1e-300))


def texture2d(tex, uv, uv_da=None, bias=None, filter_mode="linear",
              boundary="wrap", max_mip_level=-1):
    """texture() on 2-D textures. tex [D, h, w, C]; uv [B, H, W, 2];
    uv_da [B, H, W, 4]; bias [B, H, W]. Returns [B, H, W, C] f64."""
    B, H, W = uv.shape[:3]
    N = B * H * W
    uvf = np.asarray(uv, np.float64).reshape(N, 2)
    D = tex.shape[0]
    z = (np.arange(N) // (H * W)) if D > 1 else np.zeros(N, np.int64)
    levels = mip_pyramid(tex, max_mip_level if "mipmap" in filter_mode
                         else 0)
    u, v = uvf[:, 0], uvf[:, 1]
    if filter_mode == "nearest":
        out = nearest(levels[0], z, u, v, boundary)
    elif filter_mode == "linear":
        out = bilinear(levels[0], z, u, v, boundary)
    else:
        fl = np.zeros(N)
        if uv_da is not None:
            fl = mip_level(np.asarray(uv_da, np.float64).reshape(N, 4),
                           tex.shape[2], tex.shape[1])
        if bias is not None:
            fl = fl + np.asarray(bias, np.float64).reshape(N)
        fl = np.clip(fl, 0.0, len(levels) - 1)
        l0 = np.floor(fl).astype(np.int64)
        l1 = np.minimum(l0 + 1, len(levels) - 1)
        samples = [bilinear(lv, z, u, v, boundary) for lv in levels]
        stack = np.stack(samples)  # [L, N, C]
        a = stack[l0, np.arange(N)]
        if filter_mode == "linear-mipmap-nearest":
            out = a
        else:
            b = stack[l1, np.arange(N)]
            out = a + (fl - l0)[:, None] * (b - a)
    return out.reshape(B, H, W, -1)


def cube_face_st(d):
    """Face index and (s, t) of direction d [N, 3] (indexCubeMap)."""
    x, y, zc = d[:, 0], d[:, 1], d[:, 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(zc)
    zmaj = az > np.maximum(ax, ay)
    ymaj = ~zmaj & (ay > ax)
    c = np.where(zmaj, zc, np.where(ymaj, y, x))
    face = np.where(zmaj, 4, np.where(ymaj, 2, 0)) + (c < 0)
    u_in = np.where(~(zmaj | ymaj), zc, x)
    v_in = np.where(ymaj, zc, y)
    m = 0.5 / np.abs(c)
    m0 = np.where((face == 0) | (face == 5), -m, m)
    m1 = np.where(face == 2, m, -m)
    return face, u_in * m0 + 0.5, v_in * m1 + 0.5


def texture_cube(tex, dirs, dirs_da=None, filter_mode="linear",
                 max_mip_level=-1):
    """Cube sampling for directions whose bilinear footprints stay
    inside one face (no seam wrapping). tex [D, 6, w, w, C]."""
    B, H, W = dirs.shape[:3]
    N = B * H * W
    d = np.asarray(dirs, np.float64).reshape(N, 3)
    D = tex.shape[0]
    zb = (np.arange(N) // (H * W)) if D > 1 else np.zeros(N, np.int64)
    face, s, t = cube_face_st(d)
    fw = tex.shape[2]
    flat = np.asarray(tex, np.float64).reshape(D * 6, fw, fw, -1)
    levels = mip_pyramid(flat, max_mip_level if "mipmap" in filter_mode
                         else 0)
    z = zb * 6 + face
    samples = np.stack([bilinear(lv, z, s, t, "clamp") for lv in levels])
    if filter_mode == "linear":
        return samples[0].reshape(B, H, W, -1)
    # Footprint: Jacobian of (s, t) along the direction derivatives,
    # by central differences of the projection.
    dd = np.asarray(dirs_da, np.float64).reshape(N, 3, 2)
    cols = []
    for k in range(2):
        h = 1e-7
        _, sp, tp = cube_face_st(d + h * dd[:, :, k])
        _, sm, tm = cube_face_st(d - h * dd[:, :, k])
        cols.append(((sp - sm) / (2 * h), (tp - tm) / (2 * h)))
    st_da = np.stack([cols[0][0], cols[1][0], cols[0][1], cols[1][1]], 1)
    fl = np.clip(mip_level(st_da, fw, fw), 0.0, len(levels) - 1)
    l0 = np.floor(fl).astype(np.int64)
    l1 = np.minimum(l0 + 1, len(levels) - 1)
    a = samples[l0, np.arange(N)]
    b = samples[l1, np.arange(N)]
    return (a + (fl - l0)[:, None] * (b - a)).reshape(B, H, W, -1)


# ---------------------------------------------------------------------------
# Interpolate.
# ---------------------------------------------------------------------------

def interpolate(attr, rast, tri, rast_db=None, diff_attrs=()):
    """attr [B or 1, V, A] or [V, A]; rast [B, H, W, 4]; tri [T, 3].
    Returns (out [B, H, W, A], out_da [B, H, W, 2*len(diff_attrs)])."""
    rast = np.asarray(rast, np.float64)
    attr = np.asarray(attr, np.float64)
    tri = np.asarray(tri)
    B, H, W, _ = rast.shape
    if attr.ndim == 2:
        attr = attr[None]
    attr = np.broadcast_to(attr, (B,) + attr.shape[1:])
    tid = rast[..., 3].astype(np.int64) - 1  # ids < 2^24 are exact
    valid = tid >= 0
    t = np.where(valid, tid, 0)
    b = np.arange(B)[:, None, None]
    a0 = attr[b, tri[t, 0]]
    a1 = attr[b, tri[t, 1]]
    a2 = attr[b, tri[t, 2]]
    u = rast[..., 0:1]
    v = rast[..., 1:2]
    out = np.where(valid[..., None], u * a0 + v * a1 + (1 - u - v) * a2, 0)
    da = []
    if len(diff_attrs):
        db = np.asarray(rast_db, np.float64)
        for j in diff_attrs:
            dsdu = a0[..., j] - a2[..., j]
            dsdv = a1[..., j] - a2[..., j]
            da.append(db[..., 0] * dsdu + db[..., 2] * dsdv)
            da.append(db[..., 1] * dsdu + db[..., 3] * dsdv)
    out_da = (np.where(valid[..., None], np.stack(da, -1), 0)
              if da else np.zeros((B, H, W, 0)))
    return out, out_da


# ---------------------------------------------------------------------------
# Antialias (forward), pair by pair as antialias.cu.
# ---------------------------------------------------------------------------

def _opposite(tri):
    """{(min(a,b), max(a,b)): set of opposite vertices} over all edges."""
    opp = {}
    for t in tri:
        for e in range(3):
            a, b, c = t[(e + 1) % 3], t[(e + 2) % 3], t[e]
            if len({a, b, c}) < 3:
                continue
            opp.setdefault((min(a, b), max(a, b)), set()).add(c)
    return opp


def antialias(color, rast, pos, tri):
    """Forward antialias of color [B, H, W, C] given rast, clip pos
    ([B, V, 4] or [V, 4]) and tri. Silhouette edges: edges with a
    single opposite vertex, or whose two opposite vertices lie on the
    same side of them in screen space (antialias.cu:300-371)."""
    color = np.asarray(color, np.float64)
    rast = np.asarray(rast, np.float64)
    pos = np.asarray(pos, np.float64)
    tri = np.asarray(tri)
    B, H, W, _ = color.shape
    if pos.ndim == 2:
        pos = np.broadcast_to(pos[None], (B,) + pos.shape)
    opp = _opposite(tri)
    out = color.copy()
    for b in range(B):
        sx = pos[b, :, 0] / pos[b, :, 3] * (0.5 * W)
        sy = pos[b, :, 1] / pos[b, :, 3] * (0.5 * H)
        ids = rast[b, ..., 3].astype(np.int64) - 1
        zs = rast[b, ..., 2]
        for d in (0, 1):
            for py in range(H - d):
                for px in range(W - 1 + d):
                    qy, qx = py + d, px + 1 - d
                    t0, t1 = ids[py, px], ids[qy, qx]
                    if t0 == t1:
                        continue
                    if t0 >= 0 and t1 >= 0:
                        t = t0 if zs[py, px] < zs[qy, qx] else t1
                    else:
                        t = t0 if t0 >= 0 else t1
                    is_t1 = t == t1
                    alpha = _pair_alpha(sx, sy, tri[t], opp, px, py, W, H,
                                        d, is_t1)
                    if alpha is None:
                        continue
                    c0 = color[b, py, px]
                    c1 = color[b, qy, qx]
                    if alpha > 0:
                        out[b, py, px] += alpha * (c1 - c0)
                    else:
                        out[b, qy, qx] += alpha * (c1 - c0)
    return out


def _pair_alpha(sx, sy, vt, opp, px, py, W, H, d, is_t1):
    """Blend weight of one pixel pair, or None when the chosen edge of
    triangle vt is not a silhouette crossing the pair's segment.

    Among the edges whose endpoints straddle the pair's axis, the one
    crossing furthest along the segment is chosen; it counts only if it
    is a silhouette (boundary edge, or both opposite vertices on one
    side: a fold) and steep enough for this pair direction."""
    fx = px + 0.5 - 0.5 * W + (1 - d) * is_t1
    fy = py + 0.5 - 0.5 * H + d * is_t1
    x = [sx[v] - fx for v in vt]
    y = [sy[v] - fy for v in vt]
    if d == 1:
        x, y = y, x
    ds = -1.0 if is_t1 else 1.0
    vals = []
    for e in range(3):
        i1, i2 = (e + 1) % 3, (e + 2) % 3
        if (y[i1] < 0) == (y[i2] < 0):
            vals.append(-np.inf)  # edge does not cross the axis line
        else:
            dx, dy = x[i2] - x[i1], y[i2] - y[i1]
            vals.append(ds * (x[i1] * dy - y[i1] * dx) / dy)
    if vals[2] > vals[0] and vals[2] > vals[1]:
        e = 2
    else:
        e = 1 if vals[1] > vals[0] else 0
    if vals[e] == -np.inf:
        return None
    i1, i2 = (e + 1) % 3, (e + 2) % 3
    if abs(y[i2] - y[i1]) < abs(x[i2] - x[i1]):
        return None  # too shallow for this pair direction
    others = opp.get((min(vt[i1], vt[i2]), max(vt[i1], vt[i2])), set())
    others = others - {vt[e]}
    if others:
        ov = next(iter(others))

        def side(v):
            return ((sx[vt[i2]] - sx[vt[i1]]) * (sy[v] - sy[vt[i1]])
                    - (sy[vt[i2]] - sy[vt[i1]]) * (sx[v] - sx[vt[i1]]))

        if (side(ov) < 0) != (side(vt[e]) < 0):
            return None  # interior edge: not a silhouette
    if not -0.0625 < vals[e] < 1.0625:
        return None
    return ds * (0.5 - min(max(vals[e], 0.0), 1.0))
