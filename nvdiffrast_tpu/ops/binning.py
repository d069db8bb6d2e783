"""Triangle setup and screen-tile binning for the binned coverage kernel.

Plain XLA, backend-neutral. Produces what ``coverage_kernel`` walks:

* **Records**, one per triangle, 16 float32 each:
    [0:9]   edge functions, affine (c, d/dfx, d/dfy) x 3 — the
            winding-normalized parent edges (interior > 0);
    [9:12]  z plane (affine);
    [12:15] w plane (affine);
    [15]    triangle_id + 1 as float (exact for ids < 2^24), or 1e30
            when the triangle is culled.
  The near-plane clip is an affine per-pixel cut test
  ``pw >= eps * (a0 + a1 + a2)`` in the kernel; no subtriangles are
  materialized (the clip polygon only bounds the screen AABB).
* **CSR segments** (``csr_layout``): every record is classified by the
  screen tiles its AABB touches into one of ``nty*ntx`` tile segments
  (AABB inside one tile), ``nty`` band segments (one tile row, several
  columns) or one global segment. Segments are laid out contiguously
  in GROUP-record groups with a group AABB each, so a tile's program
  walks exactly its own, its band's and the global segment — the
  static-shape equivalent of CudaRaster's per-tile triangle lists
  (csrc/common/cudaraster/impl/CoarseRaster.inl:388-601) with no
  atomic allocators.

Both coverage routes read the same records: the kernel through the CSR
segments, the XLA scan (``rasterize._coverage_xla``) directly, so their
triangle setup is one computation.
"""

import jax
import jax.numpy as jnp

GROUP = 8

BIG = 1e30
ID_INVALID = 1e30
ID_VALID_THRESH = 1e29


def _cdiv(a, b):
    return -(-a // b)


# Per-edge error bound, in units of the coefficient magnitude sum
# |c0| + |cx| + |cy|:
#   construction — each coefficient is rasterize._dop's correctly-
#     rounded f32 difference of exact f64 products: <= (0.5 + 2^-29)
#     ulp32; 1.01 * 2^-24 * |c| covers it.
#   evaluation — three f32 roundings of (c0 + cx*fx) + cy*fy at
#     |fx|, |fy| <= 1 (any contraction scheme only removes roundings),
#     plus the rounding of fx/fy themselves: 3 * 2^-24 * sum.
_SLOP_KAPPA = (1.01 + 3.0) * 2.0 ** -24
# Subnormal floor: the half-ulp construction/eval roundings never fall
# below ~2^-150 absolute regardless of |c|.
_SLOP_ABS_FLOOR = 3.0 * 2.0 ** -126
# Safety margin on the perturbation geometry.
_SLOP_MARGIN = 1.25


def gather_tri_cols(pos, tri):
    """Vertex coordinates as per-coordinate flats.

    pos: [B, V, 4] or [V, 4]; tri: [T, 3].
    Returns (x, y, z, w): tuples of 3 arrays [.., T] (vertex j of the
    triangle).
    """
    pt = jnp.swapaxes(pos, -1, -2)  # [.., 4, V]
    g = [jnp.take(pt, tri[:, j], axis=-1) for j in range(3)]  # [.., 4, T]
    return tuple(tuple(gj[..., c, :] for gj in g) for c in range(4))


def edge_coeffs_cols(x, y, w):
    """rasterize._edge_coeffs on coordinate flats: e[k] = (c0, cx, cy)
    for edge k opposite vertex k ((1,2), (2,0), (0,1)). Bitwise equal
    to the tensor form (same _dop calls)."""
    from .rasterize import _dop

    def edge(j, kk):
        c0 = _dop(x[j], y[kk], x[kk], y[j])
        cx = _dop(y[j], w[kk], w[j], y[kk])
        cy = _dop(w[j], x[kk], x[j], w[kk])
        return (c0, cx, cy)

    return (edge(1, 2), edge(2, 0), edge(0, 1))


def coverage_slop(e_coef):
    """Sound binning expansion (clip-fraction units) per triangle.

    The kernel's coverage test evaluates the f32 record coefficients,
    not exact edge lines, so the coverable set is contained in
    ``{a_k >= -E_k for all k}`` where ``E_k`` bounds edge k's combined
    construction + evaluation rounding. Displacing each edge line by
    E_k moves each coverage-polytope vertex (the intersection of edge
    lines k, l) by at most
    ``(E_k*|grad_l| + E_l*|grad_k|) / |cross(grad_k, grad_l)|``.
    The max over the three vertex pairs bounds how far claimable
    pixels extend beyond the projected triangle, so binning by AABB +
    slop is sound against the kernel's own arithmetic. The near-clip
    cut / pw > 0 / |pz| <= pw tests only shrink coverage.

    Args:
      e_coef: edge coefficients from edge_coeffs_cols.
    Returns:
      [..] f32 slop; large (possibly inf -> caller clips) for slivers.
    """
    def edge(k):
        c0, cx, cy = e_coef[k]
        ek = (_SLOP_KAPPA * (jnp.abs(c0) + jnp.abs(cx) + jnp.abs(cy))
              + _SLOP_ABS_FLOOR)
        return ek, jnp.sqrt(cx * cx + cy * cy), cx, cy

    e = [edge(0), edge(1), edge(2)]
    slop = jnp.zeros(e_coef[0][0].shape, jnp.float32)
    for k in range(3):
        ek, gk, cxk, cyk = e[k]
        el, gl, cxl, cyl = e[(k + 1) % 3]
        d = jnp.abs(cxk * cyl - cyk * cxl)
        delta = jnp.where(d > 0, (ek * gl + el * gk)
                          / jnp.maximum(d, 1e-38), BIG)
        slop = jnp.maximum(slop, delta)
    return _SLOP_MARGIN * slop


def near_clip_cols(x, y, w):
    """Clip each triangle against the w >= eps plane into at most 2
    subtriangles, on coordinate flats (x, y, w only — the AABB never
    reads z). Only the near plane needs clipping: x/y are bounded by the
    pixel grid and z by the per-fragment test (the reference's
    barycentric clipper: cudaraster/impl/Util.inl:134-160).

    Returns (sx, sy, sw, valid): s*[slot][vert] flats ([.., T]) for the
    2 subtriangle slots, and valid[slot] bools.
    """
    from .rasterize import _W_CLIP_EPS

    inside = [wj >= _W_CLIP_EPS for wj in w]
    n_in = (inside[0].astype(jnp.int32) + inside[1].astype(jnp.int32)
            + inside[2].astype(jnp.int32))

    i0, i1, i2 = inside
    k_one = jnp.where(i0, 0, jnp.where(i1, 1, 2))
    k_two = jnp.where(~i2, 0, jnp.where(~i0, 1, 2))
    k = jnp.where(n_in == 1, k_one, jnp.where(n_in == 2, k_two, 0))

    def rot(vals, j):
        # r_j = vals[(k + j) % 3] via selects (take_along_axis analog).
        return jnp.where(k == 0, vals[j % 3],
                         jnp.where(k == 1, vals[(j + 1) % 3],
                                   vals[(j + 2) % 3]))

    r = [tuple(rot(c, j) for c in (x, y, w)) for j in range(3)]

    def isect(p, q):
        denom = q[2] - p[2]
        safe = jnp.where(jnp.abs(denom) > 0, denom, 1.0)
        t = jnp.clip((_W_CLIP_EPS - p[2]) / safe, 0.0, 1.0)
        return tuple(pc + t * (qc - pc) for pc, qc in zip(p, q))

    i01 = isect(r[0], r[1])
    i02 = isect(r[0], r[2])
    i12 = isect(r[1], r[2])

    case_one = n_in == 1
    case_two = n_in == 2

    # c==3: (r0, r1, r2); c==1: (r0, i01, i02); c==2: (r0, r1, i12).
    s0 = [r[0],
          tuple(jnp.where(case_one, a, b) for a, b in zip(i01, r[1])),
          tuple(jnp.where(case_one, a, jnp.where(case_two, b, c))
                for a, b, c in zip(i02, i12, r[2]))]
    s1 = [r[0], i12, i02]

    sx = [[v[0] for v in s0], [v[0] for v in s1]]
    sy = [[v[1] for v in s0], [v[1] for v in s1]]
    sw = [[v[2] for v in s0], [v[2] for v in s1]]
    valid = [n_in > 0, case_two]
    return sx, sy, sw, valid


def aabb_cols(clip, ok_tri, slop, H, W, y0, Hf):
    """Screen AABB per record in band-local pixel-index units (empty if
    culled or off screen): union of the clip polygon's two slots plus a
    half-pixel guard band and the coverage slop. y0/Hf: row offset and
    full image height of the viewport (band rows cover [y0, y0 + H))."""
    sx, sy, sw, svalid = clip
    gx = 0.5 + jnp.clip(slop * (W * 0.5), 0.0, 1e9)
    gy = 0.5 + jnp.clip(slop * (Hf * 0.5), 0.0, 1e9)
    y0f = jnp.asarray(y0, jnp.float32)

    boxes = []
    for s in range(2):
        pxs = []
        pys = []
        for v in range(3):
            wv = jnp.maximum(sw[s][v], 1e-12)
            pxs.append(jnp.clip((sx[s][v] / wv + 1.0) * (W * 0.5) - 0.5,
                                -1e9, 1e9))
            pys.append(jnp.clip((sy[s][v] / wv + 1.0) * (Hf * 0.5) - 0.5
                                - y0f, -1e9, 1e9))
        xmin = jnp.minimum(jnp.minimum(pxs[0], pxs[1]), pxs[2]) - gx
        xmax = jnp.maximum(jnp.maximum(pxs[0], pxs[1]), pxs[2]) + gx
        ymin = jnp.minimum(jnp.minimum(pys[0], pys[1]), pys[2]) - gy
        ymax = jnp.maximum(jnp.maximum(pys[0], pys[1]), pys[2]) + gy
        onscreen = ((xmax >= -0.5) & (xmin <= W - 0.5)
                    & (ymax >= -0.5) & (ymin <= H - 0.5))
        ok = svalid[s] & ok_tri & onscreen
        boxes.append((jnp.where(ok, xmin, BIG), jnp.where(ok, ymin, BIG),
                      jnp.where(ok, xmax, -BIG), jnp.where(ok, ymax, -BIG),
                      ok))
    (a0, b0, c0, d0, k0), (a1, b1, c1, d1, k1) = boxes
    return (jnp.minimum(a0, a1), jnp.minimum(b0, b1),
            jnp.maximum(c0, c1), jnp.maximum(d0, d1), k0 | k1)


def build_records(pos, tri):
    """Channel-major records [.., 16, T] (see module docstring) plus
    the clip polygon, the cull mask and the coverage slop."""
    x, y, z, w = gather_tri_cols(pos, tri)
    e = edge_coeffs_cols(x, y, w)
    # Plane coefficients: z(fx, fy) = sum_i z_i * a_i(fx, fy) is affine,
    # likewise w. An elementwise 3-term sum (a float32 dot may run in
    # TF32 on a GPU).
    zc = tuple(z[0] * e[0][c] + z[1] * e[1][c] + z[2] * e[2][c]
               for c in range(3))
    wc = tuple(w[0] * e[0][c] + w[1] * e[1][c] + w[2] * e[2][c]
               for c in range(3))
    # Winding normalization by the sign of the homogeneous area form
    # pD = a_0 at vertex 0 = det[(x, y, w) of v0, v1, v2]: edge
    # interiors become positive and the interpolated w positive (the
    # reference swaps v1/v2 instead, TriangleSetup.inl:130-137); pD == 0
    # is a degenerate triangle. A mesh edge shared by two triangles gets
    # bitwise opposite coefficients on the two sides (_dop is odd and
    # the sign flip is exact), so with the exclusive tie rule
    # (rasterize._tie_bits) each pixel on it is claimed once.
    # The barrier pins po to ONE evaluation: XLA otherwise re-fuses pD's
    # mul-add chain into
    # each of the 15 record rows with per-site FMA contraction, and on
    # an exactly-degenerate triangle (pD = +-1 ulp of noise) the sign
    # can differ BETWEEN ROWS — breaking the exact-negation pairing of
    # shared/opposed edges that the watertight tie rule requires.
    pD = e[0][0] * w[0] + e[0][1] * x[0] + e[0][2] * y[0]
    po = jax.lax.optimization_barrier(jnp.where(pD < 0, -1.0, 1.0))

    clip = near_clip_cols(x, y, w)

    def dup(j, k):
        return (x[j] == x[k]) & (y[j] == y[k]) & (w[j] == w[k])

    # Cull triangles with a bitwise-duplicate (x,y,w) vertex pair: their
    # exact-zero edge row would leave coverage to the tie rule.
    valid = ((pD != 0.0) & ~(dup(0, 1) | dup(1, 2) | dup(2, 0))
             & (clip[3][0] | clip[3][1]))

    T = x[0].shape[-1]
    idf = jnp.broadcast_to(jnp.arange(T, dtype=jnp.float32) + 1.0,
                           x[0].shape)
    rows = [jnp.where(valid, e[k][c] * po, 0.0)
            for k in range(3) for c in range(3)]
    rows += [jnp.where(valid, zc[c] * po, 0.0) for c in range(3)]
    rows += [jnp.where(valid, wc[c] * po, 0.0) for c in range(3)]
    rows.append(jnp.where(valid, idf, ID_INVALID))
    return jnp.stack(rows, axis=-2), clip, valid, coverage_slop(e)


def _stable_order(key, n_key):
    """Stable ascending order of small-int keys (invalid = n_key).

    Packs (key, slot) into ONE int32 and runs a single-operand
    lax.sort; falls back to argsort when the pack would overflow int31.

    Returns (order [S] int32, key_sorted [S] int32).
    """
    S = key.shape[0]
    ib = max(1, (S - 1).bit_length())
    if (n_key + 1) << ib <= (1 << 31):
        packed = jax.lax.sort(key << ib | jnp.arange(S, dtype=jnp.int32))
        return packed & ((1 << ib) - 1), packed >> ib
    order = jnp.argsort(key, stable=True)
    return order, key[order]


def csr_layout(rec_cm, aabb, nty, ntx, tile_h, tile_w):
    """Per-tile CSR record segments.

    Args:
      rec_cm: [16, S] float32 channel-major records.
      aabb: (xmin, ymin, xmax, ymax, ok) per record, band-local pixel
        units.
      nty, ntx: tile grid; tile_h, tile_w: tile size in pixels.

    Returns:
      rec: [S_pad, 16] laid-out records (invalid padding slots).
      gaabb: [S_pad/GROUP, 4] group AABBs (xmin, ymin, xmax, ymax).
      gstart: [n_seg] int32 segment starts in groups; segment k is
        tile k for k < nty*ntx, then the nty bands, then global.
      gcnt: [n_seg] int32 segment lengths in groups.
    """
    xmin, ymin, xmax, ymax, ok = aabb
    S = rec_cm.shape[-1]

    def tix(v, n, scale):
        return jnp.clip(jnp.floor((v + 0.5) / scale).astype(jnp.int32),
                        0, n - 1)

    band0 = tix(ymin, nty, tile_h)
    band1 = tix(ymax, nty, tile_h)
    tx0 = tix(xmin, ntx, tile_w)
    tx1 = tix(xmax, ntx, tile_w)
    nk0 = nty * ntx
    n_seg = nk0 + nty + 1  # tiles, bands, global

    local = (band0 == band1) & (tx0 == tx1)
    bandonly = (band0 == band1) & ~local
    key = jnp.where(local, band0 * ntx + tx0,
                    jnp.where(bandonly, nk0 + band0, nk0 + nty))
    key = jnp.where(ok, key, n_seg)
    order, key_sorted = _stable_order(key, n_seg)

    # seg0[k] = first sorted position of segment k.
    seg0 = jnp.searchsorted(
        key_sorted, jnp.arange(n_seg + 1, dtype=jnp.int32),
        side="left").astype(jnp.int32)
    counts = jnp.diff(seg0)  # [n_seg]
    gcnt = -(-counts // GROUP)  # groups per segment
    gstart = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(gcnt)])  # [n_seg+1]

    # Slot -> segment at group granularity: a max-scatter of segment ids
    # at their start groups + cummax reproduces
    # searchsorted(gstart, j, 'right') - 1 with [ng]-sized work.
    ng = _cdiv(S, GROUP) + n_seg  # static upper bound
    k_g = jax.lax.cummax(
        jnp.full((ng,), -1, jnp.int32).at[gstart].max(
            jnp.arange(n_seg + 1, dtype=jnp.int32), mode="drop"))
    kc = jnp.clip(k_g, 0, n_seg - 1)
    r0 = (jnp.arange(ng, dtype=jnp.int32) - gstart[kc]) * GROUP
    valid_g = k_g < n_seg

    def expand(a):  # [ng] -> [ng * GROUP]
        return jnp.broadcast_to(a[:, None], (ng, GROUP)).reshape(-1)

    r = expand(r0) + jnp.arange(ng * GROUP, dtype=jnp.int32) % GROUP
    valid_slot = expand(valid_g) & (r < expand(counts[kc]))
    src = order[jnp.clip(expand(seg0[kc]) + r, 0, S - 1)]

    safe = jnp.zeros((16,), jnp.float32).at[15].set(ID_INVALID)
    rec = jnp.where(valid_slot[:, None], rec_cm[:, src].T, safe)

    def greduce(v, fill, red):
        return red(jnp.where(valid_slot, v[src], fill).reshape(ng, GROUP),
                   axis=1)

    gaabb = jnp.stack([greduce(xmin, BIG, jnp.min),
                       greduce(ymin, BIG, jnp.min),
                       greduce(xmax, -BIG, jnp.max),
                       greduce(ymax, -BIG, jnp.max)], axis=-1)
    return rec, gaabb, gstart[:n_seg], gcnt
