"""Differentiable antialiasing.

Re-design of the reference antialias op (csrc/common/antialias.cu,
csrc/torch/torch_antialias.cpp):

* The GPU edge hash becomes a sorted opposite-vertex table
  (:mod:`nvdiffrast_tpu.ops.topology`).
* The discontinuity + persistent-threads analysis kernels
  (antialias.cu:165-382) become **dense masked compute** over all
  horizontal and vertical pixel pairs — static shapes instead of
  dynamic work queues; inactive pairs simply contribute zero.
* The wing-sign silhouette test (antialias.cu:321-328) is
  **pixel-independent** — the pixel center cancels in the vertex
  differences — so it is precomputed per triangle into a sign bitmask,
  shrinking the per-pixel gather from 12 floats to 7.
* Data flow is flat-SoA: per-pixel state is [N] with the pixel axis
  major; the per-triangle screen geometry is one row-gather from a
  [7, T(+1)] table; neighbor access is a flat roll with border folding
  (border pixels see their own value, which disables the pair).
* Color updates use rolled adds instead of atomics; position
  gradients reduce pixels -> triangle rows (ops/scatter.py) then
  triangle -> vertex with a tiny scatter.

The per-pair analysis math (closer-triangle selection, wing-sign
silhouette test, rational edge argmax, crossing-point alpha) and the
backward formulas (color cross-gradients, analytic d(alpha)/d(p1,p2)
with copysign(1e-3, dy) regularization, |alpha| >= 0.5 saturation
kill) are exact re-derivations of antialias.cu:219-556.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .gather import table_take
from .scatter import scatter_add_by_id
from .topology import build_opposite_table

_F32_MAX = 3.402823466e38


def _int_zero_ct(x):
    return np.zeros(x.shape, dtype=jax.dtypes.float0)


@jax.tree_util.register_pytree_node_class
class TopologyHashWrapper:
    """Opaque topology table (reference: csrc/torch/torch_types.h:41-45)."""

    def __init__(self, op_table):
        self.op_table = op_table

    def tree_flatten(self):
        return (self.op_table,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


def antialias_construct_topology_hash(tri):
    """Construct a topology table for a triangle tensor.

    API parity with the reference (nvdiffrast/torch/ops.py:529-544).

    Args:
        tri: Triangle tensor with shape [num_triangles, 3], int32.

    Returns:
        An opaque `TopologyHashWrapper` usable as the `topology_hash`
        argument of `antialias()`.
    """
    tri = jnp.asarray(tri, jnp.int32)
    return TopologyHashWrapper(build_opposite_table(tri))


# ---------------------------------------------------------------------------
# Pointwise pair math. All inputs are same-shaped float32/int32/bool arrays; `d` and sizes
# are static Python values. Bit-faithful sign/rational comparisons
# follow antialias.cu:14-25.
# ---------------------------------------------------------------------------

def _same_sign(a, b):
    # Sign-BIT comparison via int32 bitcast — matches the reference's
    # __float_as_int test (antialias.cu:14-25) including on ±0.0
    # (reachable wing areas from degenerate opposite vertices), where
    # (a<0)==(b<0) would disagree.
    ai = jax.lax.bitcast_convert_type(a, jnp.int32)
    bi = jax.lax.bitcast_convert_type(b, jnp.int32)
    return (ai ^ bi) >= 0


def _rational_gt(n0, n1, d0, d1):
    return (n0 * d1 > n1 * d0) == _same_sign(d0, d1)


def _max_idx3(n0, n1, n2, d0, d1, d2):
    g10 = _rational_gt(n1, n0, d1, d0)
    g20 = _rational_gt(n2, n0, d2, d0)
    g21 = _rational_gt(n2, n1, d2, d1)
    return jnp.where(g20 & g21, 2, jnp.where(g10, 1, 0))


def pair_ids(idf0, idf1, z0, z1, T):
    """Triangle choice for a pixel pair (antialias.cu:243-257).

    `idf1`/`z1` are the neighbor pixel's values with image borders
    folded to the pixel's own values (disabling the pair). Triangle
    ids are float-exact (< 2^24, enforced at the rasterize boundary).

    Returns (tid, is_t1, active): clamped table id, whether the
    neighbor's triangle was selected, and the pair-active mask.
    """
    tri0 = idf0.astype(jnp.int32) - 1
    tri1 = idf1.astype(jnp.int32) - 1
    work = idf1 != idf0
    tsel = jnp.where(tri0 >= 0, tri0, tri1)
    both = (tri0 >= 0) & (tri1 >= 0)
    tsel = jnp.where(both, jnp.where(z0 < z1, tri0, tri1), tsel)
    is_t1 = tsel == tri1  # work guarantees tri0 != tri1 when it matters
    tri_ok = (tsel >= 0) & (tsel < T)
    active = work & tri_ok
    # Inactive pixels keep their (clamped) local id rather than a
    # shared dummy: gathered values are masked downstream, and
    # spatially coherent ids keep the gather's id-range skip tight.
    tid = jnp.where(tri_ok, tsel, 0)
    return tid, is_t1, active


def pair_alpha(t7, fx, fy, is_t1, active, d):
    """Edge crossing analysis for one pixel pair (antialias.cu:300-371).

    Args:
      t7: 7 gathered per-pixel arrays (sx0, sx1, sx2, sy0, sy1, sy2,
        sign bitmask) from the forward table.
      fx, fy: pixel-center coordinates relative to image center,
        *unshifted* (the is_t1 neighbor shift is applied here).
      is_t1, active: from `pair_ids`.
      d: 0 = horizontal pair (right neighbor), 1 = vertical (down).

    Returns (alpha, di): blend weight (0 when inactive) and the edge
    index used, needed again by the backward pass.
    """
    sx0, sx1, sx2, sy0, sy1, sy2, sbits = t7
    shift = is_t1.astype(jnp.float32)
    fxs = fx + shift * (1 - d)
    fys = fy + shift * d

    x0 = sx0 - fxs
    x1 = sx1 - fxs
    x2 = sx2 - fxs
    y0 = sy0 - fys
    y1 = sy1 - fys
    y2 = sy2 - fys

    sb = sbits.astype(jnp.int32)
    s0 = (sb & 1) != 0
    s1 = (sb & 2) != 0
    s2 = (sb & 4) != 0
    any_sil = s0 | s1 | s2

    # XY flip for horizontal edges (vertical pairs).
    if d == 1:
        x0, y0 = y0, x0
        x1, y1 = y1, x1
        x2, y2 = y2, x2

    dx0 = x2 - x1
    dx1 = x0 - x2
    dx2 = x1 - x0
    dy0 = y2 - y1
    dy1 = y0 - y2
    dy2 = y1 - y0

    ds = jnp.where(is_t1, -1.0, 1.0)
    d0 = ds * (x1 * dy0 - y1 * dx0)
    d1 = ds * (x2 * dy1 - y2 * dx1)
    d2 = ds * (x0 * dy2 - y0 * dx2)

    c0 = _same_sign(y1, y2)
    c1 = _same_sign(y2, y0)
    c2 = _same_sign(y0, y1)
    d0 = jnp.where(c0, -_F32_MAX, d0)
    d1 = jnp.where(c1, -_F32_MAX, d1)
    d2 = jnp.where(c2, -_F32_MAX, d2)
    dy0 = jnp.where(c0, 1.0, dy0)
    dy1 = jnp.where(c1, 1.0, dy1)
    dy2 = jnp.where(c2, 1.0, dy2)

    di = _max_idx3(d0, d1, d2, dy0, dy1, dy2)

    dc = jnp.full_like(d0, -_F32_MAX)
    use0 = (di == 0) & s0 & (jnp.abs(dy0) >= jnp.abs(dx0))
    use1 = (di == 1) & s1 & (jnp.abs(dy1) >= jnp.abs(dx1))
    use2 = (di == 2) & s2 & (jnp.abs(dy2) >= jnp.abs(dx2))
    dc = jnp.where(use0, d0 / dy0, dc)
    dc = jnp.where(use1, d1 / dy1, dc)
    dc = jnp.where(use2, d2 / dy2, dc)

    eps = 0.0625  # 1/16 pixel inaccuracy bound (antialias.cu:360)
    found = (dc > -eps) & (dc < 1.0 + eps)
    active = active & any_sil & found
    dcc = jnp.clip(dc, 0.0, 1.0)
    alpha = jnp.where(active, ds * (0.5 - dcc), 0.0)
    alpha = jnp.where(jnp.isfinite(alpha), alpha, 0.0)
    return alpha, di


def pair_pos_grad(t9, dd, ok, di, is_t1, fx, fy, d, W, H):
    """Analytic d(alpha)/d(p1,p2) routed into 9 per-triangle columns
    (antialias.cu:464-546). `t9` are the gathered clip-space rows
    (x, y, w per vertex); `dd` is the color-dot weight; `ok` masks
    pixels with real work; saturation kill is applied by the caller
    (it needs alpha).

    Returns a list of 9 arrays: column 3*vert + comp of the gradient
    table row.
    """
    # Edge vertices (antialias.cu:470-474): i1 = di+1, i2 = di+2 (mod 3).
    i1 = jnp.where(di < 2, di + 1, 0)
    i2 = jnp.where(i1 < 2, i1 + 1, 0)

    def vert(idx, comp):
        r = t9[0 + comp]
        r = jnp.where(idx == 1, t9[3 + comp], r)
        r = jnp.where(idx == 2, t9[6 + comp], r)
        return r

    p1x = vert(i1, 0)
    p1y = vert(i1, 1)
    p1w = vert(i1, 2)
    p2x = vert(i2, 0)
    p2y = vert(i2, 1)
    p2w = vert(i2, 2)

    shift = is_t1.astype(jnp.float32)
    pxh = 0.5 * W
    pyh = 0.5 * H
    fxs = fx + shift * (1 - d)
    fys = fy + shift * d

    if d == 1:
        p1x, p1y = p1y, p1x
        p2x, p2y = p2y, p2x
        pxh_, pyh_ = pyh, pxh
        fxs, fys = fys, fxs
    else:
        pxh_, pyh_ = pxh, pyh

    w1 = 1.0 / p1w
    w2 = 1.0 / p2w
    x1 = p1x * w1 * pxh_ - fxs
    y1 = p1y * w1 * pyh_ - fys
    x2 = p2x * w2 * pxh_ - fxs
    y2 = p2y * w2 * pyh_ - fys
    dxe = x2 - x1
    dye = y2 - y1
    db = x1 * dye - y1 * dxe

    ep = jnp.where(dye >= 0, 1e-3, -1e-3)  # copysign(1e-3, dy)
    iy = 1.0 / (dye + ep)

    dby = db * iy
    iw1 = -w1 * iy * dd
    iw2 = w2 * iy * dd
    gp1x = iw1 * pxh_ * y2
    gp2x = iw2 * pxh_ * y1
    gp1y = iw1 * pyh_ * (dby - x2)
    gp2y = iw2 * pyh_ * (dby - x1)
    gp1w = -(p1x * gp1x + p1y * gp1y) * w1
    gp2w = -(p2x * gp2x + p2y * gp2y) * w2

    if d == 1:
        gp1x, gp1y = gp1y, gp1x
        gp2x, gp2y = gp2y, gp2x

    # Route (g1, g2) into the per-triangle 9-column layout by edge
    # vertex index: column 3*vert + comp.
    g1 = [gp1x, gp1y, gp1w]
    g2 = [gp2x, gp2y, gp2w]
    cols = []
    for vtx in range(3):
        m1 = (i1 == vtx) & ok
        m2 = (i2 == vtx) & ok
        for comp in range(3):
            val = (jnp.where(m1, g1[comp], 0.0)
                   + jnp.where(m2, g2[comp], 0.0))
            cols.append(jnp.where(jnp.isfinite(val), val, 0.0))
    return cols


def decode_aux(aux):
    """Residual aux value -> (di, is_t1). aux = di + 4 * is_t1."""
    is_t1 = aux >= 3.5
    di = (aux - 4.0 * is_t1.astype(jnp.float32)).astype(jnp.int32)
    return di, is_t1


# ---------------------------------------------------------------------------
# Table construction.
# ---------------------------------------------------------------------------

def _build_tables(pos, tri, op_table, instance_mode, H, W):
    # H must be the FULL image height under spatial sharding (screen
    # scale) — callers pass Hf.
    """Per-triangle screen/clip tables (channel-major) + dummy column.

    Returns (ftable [7, (B*)T+1], btable [9, (B*)T+1], R, T).
    ftable: own-vertex screen (SX*3, SY*3) plus the per-triangle
    wing-sign bitmask (the silhouette test of antialias.cu:321-328 is
    pixel-independent: the pixel center cancels in the differences, so
    it is evaluated here once per triangle). The silhouette fold
    (missing opposite -> own vertex e) makes the wing sign match bb's,
    classifying boundary edges as silhouettes like the reference's
    hash-miss path.
    btable: raw clip (x, y, w) per vertex for the backward.
    """
    T = tri.shape[0]
    xh = 0.5 * W
    yh = 0.5 * H
    ov = jnp.where(op_table >= 0, op_table, tri)  # [T, 3]

    if instance_mode:
        tv = pos[:, tri]  # [B, T, 3, 4]
        o = pos[:, ov]
    else:
        tv = pos[tri]
        o = pos[ov]

    def screen(q):
        iw = 1.0 / q[..., 3]
        return q[..., 0] * iw * xh, q[..., 1] * iw * yh

    sx, sy = screen(tv)  # [.., T, 3]
    ox, oy = screen(o)

    bb = ((sx[..., 1] - sx[..., 0]) * (sy[..., 2] - sy[..., 0])
          - (sx[..., 2] - sx[..., 0]) * (sy[..., 1] - sy[..., 0]))
    a0 = ((sx[..., 1] - ox[..., 0]) * (sy[..., 2] - oy[..., 0])
          - (sx[..., 2] - ox[..., 0]) * (sy[..., 1] - oy[..., 0]))
    a1 = ((sx[..., 2] - ox[..., 1]) * (sy[..., 0] - oy[..., 1])
          - (sx[..., 0] - ox[..., 1]) * (sy[..., 2] - oy[..., 1]))
    a2 = ((sx[..., 0] - ox[..., 2]) * (sy[..., 1] - oy[..., 2])
          - (sx[..., 1] - ox[..., 2]) * (sy[..., 0] - oy[..., 2]))
    sbits = (_same_sign(a0, bb).astype(jnp.float32)
             + 2.0 * _same_sign(a1, bb).astype(jnp.float32)
             + 4.0 * _same_sign(a2, bb).astype(jnp.float32))

    ftable = jnp.concatenate([sx, sy, sbits[..., None]],
                             axis=-1).reshape(-1, 7).T
    btable = tv[..., jnp.array([0, 1, 3])].reshape(-1, 9).T
    R = ftable.shape[1]
    ftable = jnp.concatenate([ftable, jnp.zeros((7, 1), jnp.float32)], 1)
    btable = jnp.concatenate([btable, jnp.zeros((9, 1), jnp.float32)], 1)
    return ftable, btable, R, T


# ---------------------------------------------------------------------------
# Flat-roll helpers (XLA path).
# ---------------------------------------------------------------------------

def _roll_prev(x, stride):
    """x at the neighbor pixel (p + stride); tail garbage is masked."""
    return jnp.concatenate([x[stride:], x[-stride:]], axis=0)


def _roll_next(x, stride):
    """Scatter from p onto p + stride (zero-filled head)."""
    pad_shape = (stride,) + x.shape[1:]
    return jnp.concatenate([jnp.zeros(pad_shape, x.dtype), x[:-stride]],
                           axis=0)


def _pixel_grid(B, H, W, T, instance_mode, viewport=None):
    """(fx, fy, rofs, border_x, border_y) flat [N] arrays.

    viewport = (y0, full_height): the band holds rows [y0, y0+H) of a
    full_height image; fy is the global image-centered coordinate, and
    the band's top/bottom rows fold as borders (cross-band pairs are
    handled by the spatial-sharding boundary pass)."""
    y0, Hf = viewport if viewport is not None else (0, H)
    N = B * H * W
    pix = jnp.arange(N, dtype=jnp.int32)
    colp = pix % W
    rowp = (pix // W) % H
    fx = colp.astype(jnp.float32) + (0.5 - 0.5 * W)
    fy = (rowp + y0).astype(jnp.float32) + (0.5 - 0.5 * Hf)
    if instance_mode:
        rofs = (pix // (H * W)) * T
    else:
        rofs = jnp.zeros((N,), jnp.int32)
    return fx, fy, rofs, colp >= W - 1, rowp >= H - 1


def _fold_rolls(idf0, z0, B, H, W):
    """Border-folded neighbor id/z for both axes."""
    _, _, _, bx, by = _pixel_grid(B, H, W, 0, False)
    idfx = jnp.where(bx, idf0, _roll_prev(idf0, 1))
    idfy = jnp.where(by, idf0, _roll_prev(idf0, W))
    zx = _roll_prev(z0, 1)
    zy = _roll_prev(z0, W)
    return (idfx, zx), (idfy, zy)


# ---------------------------------------------------------------------------
# Forward / backward cores.
# ---------------------------------------------------------------------------

def _aa_forward_core(color, rast, pos, tri, op_table, viewport=None):
    instance_mode = pos.ndim > 2
    B, H, W, C = color.shape
    N = B * H * W
    Hf = viewport[1] if viewport is not None else H
    ftable, _, R, T = _build_tables(pos, tri, op_table, instance_mode, Hf, W)

    cflat = color.reshape(N, C)
    ccols = [cflat[:, c] for c in range(C)]
    rflat = rast.reshape(N, 4)
    idf0 = rflat[:, 3]
    z0 = rflat[:, 2]
    fx, fy, rofs, _, _ = _pixel_grid(B, H, W, T, instance_mode, viewport)
    nb = _fold_rolls(idf0, z0, B, H, W)

    sels = []
    rids = []
    for d in (0, 1):
        idf1, z1 = nb[d]
        tid, is_t1, active = pair_ids(idf0, idf1, z0, z1, T)
        sels.append((is_t1, active))
        rids.append(tid + rofs)

    # One batched table lookup for both axes.
    t7_all = table_take(ftable, jnp.concatenate(rids))
    t7s = (t7_all[:, :N], t7_all[:, N:])

    out = list(ccols)
    res = []
    for d in (0, 1):
        stride = 1 if d == 0 else W
        is_t1, active = sels[d]
        alpha, di = pair_alpha(
            [t7s[d][k] for k in range(7)], fx, fy, is_t1, active, d)
        apos = alpha > 0
        for c in range(C):
            contrib = alpha * (_roll_prev(ccols[c], stride) - ccols[c])
            out[c] = out[c] + jnp.where(apos, contrib, 0.0)
            out[c] = out[c] + _roll_next(
                jnp.where(apos, 0.0, contrib), stride)
        aux = di.astype(jnp.float32) + 4.0 * is_t1.astype(jnp.float32)
        res.extend([alpha, aux])
    return jnp.stack(out, axis=-1).reshape(B, H, W, C), tuple(res)


def _aa_backward_core(dy, color, rast, pos, tri, op_table, residuals,
                      viewport=None):
    (al0, ax0, al1, ax1) = residuals
    instance_mode = pos.ndim > 2
    B, H, W, C = color.shape
    N = B * H * W
    Hf = viewport[1] if viewport is not None else H
    V = pos.shape[1] if instance_mode else pos.shape[0]

    _, btable, R, T = _build_tables(pos, tri, op_table, instance_mode, Hf, W)

    cflat = color.reshape(N, C)
    ccols = [cflat[:, c] for c in range(C)]
    rflat = rast.reshape(N, 4)
    idf0 = rflat[:, 3]
    dyf = dy.reshape(N, C)
    dycols = [dyf[:, c] for c in range(C)]
    fx, fy, rofs, _, _ = _pixel_grid(B, H, W, T, instance_mode,
                                     viewport)
    nb = _fold_rolls(idf0, rflat[:, 2], B, H, W)

    rids = []
    oks = []
    decs = []
    for d, (al, ax) in enumerate(((al0, ax0), (al1, ax1))):
        di, tri1 = decode_aux(ax)
        idf1, _ = nb[d]
        idf = jnp.where(tri1, idf1, idf0)
        tsel = idf.astype(jnp.int32) - 1
        ok = (al != 0.0) & (tsel >= 0) & (tsel < T)
        tid = jnp.where(ok, tsel, 0)
        rids.append(tid + rofs)
        oks.append(ok)
        decs.append((di, tri1))

    t9_all = table_take(btable, jnp.concatenate(rids))
    t9s = (t9_all[:, :N], t9_all[:, N:])

    gcols = list(dycols)
    gvals = []
    for d, (al, ax) in enumerate(((al0, ax0), (al1, ax1))):
        stride = 1 if d == 0 else W
        di, tri1 = decs[d]
        apos = al > 0
        dd = jnp.zeros((N,), jnp.float32)
        for c in range(C):
            pdy = jnp.where(apos, dycols[c],
                            _roll_prev(dycols[c], stride))
            v = al * pdy
            gcols[c] = gcols[c] - v + _roll_next(v, stride)
            dd = dd + pdy * (_roll_prev(ccols[c], stride) - ccols[c])
        dd = jnp.where(al != 0.0, dd, 0.0)
        # Saturated alpha kills position gradients
        # (antialias.cu:542-546).
        keep = oks[d] & (dd != 0.0) & (jnp.abs(al) < 0.5)
        cols = pair_pos_grad([t9s[d][k] for k in range(9)], dd, keep,
                             di, tri1, fx, fy, d, W, Hf)
        gvals.append(jnp.stack(cols, axis=0))  # [9, N]

    g_color = jnp.stack(gcols, axis=-1).reshape(B, H, W, C)
    rid2 = jnp.concatenate(rids)
    gval2 = jnp.concatenate(gvals, axis=1)  # [9, 2N]

    # Pixels -> triangle rows, both axes in one reduction.
    gt = scatter_add_by_id(rid2, gval2, R)
    gt = gt.reshape(-1, T, 3, 3)  # [B?, T, vert, (x, y, w)]

    gv = jnp.zeros(gt.shape[:-1] + (4,), jnp.float32)
    gv = gv.at[..., 0].set(gt[..., 0])
    gv = gv.at[..., 1].set(gt[..., 1])
    gv = gv.at[..., 3].set(gt[..., 2])
    if instance_mode:
        g_pos = jnp.zeros((B, V, 4), jnp.float32).at[:, tri].add(
            gv, mode="drop")
    else:
        g_pos = jnp.zeros((V, 4), jnp.float32).at[tri].add(
            gv[0], mode="drop")
    return g_color, g_pos


# ---------------------------------------------------------------------------
# custom_vjp wiring + public op.
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(6, 7))
def _antialias_prim(color, rast, pos, tri, op_table, y0, pos_gradient_boost,
                    full_height):
    vp = None if full_height is None else (y0, full_height)
    out, _ = _aa_forward_core(color, rast, pos, tri, op_table, vp)
    return out


def _antialias_prim_fwd(color, rast, pos, tri, op_table, y0,
                        pos_gradient_boost, full_height):
    vp = None if full_height is None else (y0, full_height)
    out, res = _aa_forward_core(color, rast, pos, tri, op_table, vp)
    return out, (color, rast, pos, tri, op_table, y0, res)


def _antialias_prim_bwd(pos_gradient_boost, full_height, saved, dy):
    color, rast, pos, tri, op_table, y0, res = saved
    vp = None if full_height is None else (y0, full_height)
    g_color, g_pos = _aa_backward_core(dy, color, rast, pos, tri, op_table,
                                       res, vp)
    if pos_gradient_boost != 1.0:
        g_pos = g_pos * pos_gradient_boost
    g_rast = jnp.zeros_like(rast)
    g_y0 = None if y0 is None else _int_zero_ct(y0)
    return (g_color, g_rast, g_pos, _int_zero_ct(tri), _int_zero_ct(op_table),
            g_y0)


_antialias_prim.defvjp(_antialias_prim_fwd, _antialias_prim_bwd)


def antialias(color, rast, pos, tri, topology_hash=None,
              pos_gradient_boost=1.0, viewport=None):
    """Perform antialiasing.

    API parity with the reference op (nvdiffrast/torch/ops.py:489-526).

    Silhouette edge classification is based on vertex indices: a vertex
    shared by multiple triangles must use the same index everywhere,
    otherwise edges are classified as silhouettes (same caveat as the
    reference).

    Args:
        color: Input image [minibatch_size, height, width, channels].
        rast: Main output tensor from `rasterize()`.
        pos: Vertex position tensor used in rasterization.
        tri: Triangle tensor used in rasterization.
        topology_hash: (Optional) `TopologyHashWrapper` from
            `antialias_construct_topology_hash()`.
        pos_gradient_boost: (Optional) multiplier for gradients
            propagated to `pos`.
        viewport: extension for spatial sharding: (y0, full_height)
            marks `color`/`rast` as rows [y0, y0 + H) of a taller
            image. Cross-band pixel pairs are NOT evaluated here — use
            parallel.spatial's boundary pass for them.

    Returns:
        Antialiased image, same shape as `color`.
    """
    color = jnp.asarray(color, jnp.float32)
    rast = jnp.asarray(rast, jnp.float32)
    pos = jnp.asarray(pos, jnp.float32)
    tri = jnp.asarray(tri, jnp.int32)

    # Host-side shape validation (reference: torch_antialias.cpp:79-86).
    if color.ndim != 4 or rast.ndim != 4 or rast.shape[3] != 4:
        raise ValueError(
            f"antialias: color must be [minibatch, H, W, C] and rast "
            f"[minibatch, H, W, 4]; got {color.shape}, {rast.shape}")
    if color.shape[:3] != rast.shape[:3]:
        raise ValueError(
            f"antialias: color {color.shape} and rast {rast.shape} "
            f"minibatch/resolution mismatch")
    if pos.ndim not in (2, 3) or pos.shape[-1] != 4:
        raise ValueError(
            f"antialias: pos must be [V, 4] or [minibatch, V, 4]; "
            f"got {pos.shape}")
    if pos.ndim == 3 and pos.shape[0] != color.shape[0]:
        # The instance-mode row lookup indexes a [minibatch*T] table; a
        # mismatched pos minibatch would silently gather clamped rows.
        raise ValueError(
            f"antialias: instanced pos minibatch {pos.shape[0]} != "
            f"color minibatch {color.shape[0]}")
    if tri.ndim != 2 or tri.shape[1] != 3:
        raise ValueError(
            f"antialias: tri must be [num_triangles, 3]; got {tri.shape}")

    if topology_hash is not None:
        assert isinstance(topology_hash, TopologyHashWrapper)
        op_table = topology_hash.op_table
    else:
        op_table = build_opposite_table(tri)

    if viewport is None:
        y0, full_h = None, None
    else:
        y0 = jnp.asarray(viewport[0], jnp.int32)
        full_h = int(viewport[1])

    with jax.named_scope("nvdiffrast.antialias"):
        return _antialias_prim(color, rast, pos, tri, op_table, y0,
                               float(pos_gradient_boost), full_h)
