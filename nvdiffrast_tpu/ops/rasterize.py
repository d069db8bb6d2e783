"""Differentiable rasterization.

Replaces the reference's CudaRaster 4-stage atomic pipeline
(csrc/common/cudaraster/**) with a two-phase design:

1. **Geometry phase** (vectorized XLA, ``binning.build_records``):
   gather triangle vertices and precompute per-triangle *affine*
   edge/plane coefficients: each homogeneous edge function
   ``a_i(fx, fy)`` is affine in the pixel-center clip coordinates
   (the bilinear terms cancel), so per-pixel coverage costs 2 FMAs/edge.
   The near plane is an affine per-fragment cut test, so no
   subtriangles are materialized.

2. **Pixel phase**: a ``lax.scan`` over triangle chunks carrying a
   running ``(depth, id)`` minimum per pixel — the deterministic-ROP
   equivalent of the reference's atomicMin+tiebreak
   (csrc/common/cudaraster/impl/FineRaster.inl:152-172) with *lowest
   triangle index wins depth ties* (deterministic by construction,
   no atomics). On a GPU the binned coverage kernel
   (``coverage_kernel.py``) replaces the scan: one program per pixel
   tile walks only the triangles binned to it.

The final per-pixel shading (barycentrics + image-space derivatives)
and the backward pass replicate the reference math exactly:
csrc/common/rasterize.cu:15-114 (forward) and :119-273 (backward,
including the ``copysign(1e-6, at)`` inverse-area regularization).

Outputs match the reference op (nvdiffrast/torch/ops.py:93-135):
``rast[..., :] = (u, v, z/w, triangle_id+1)`` and
``rast_db[..., :] = (du/dX, du/dY, dv/dX, dv/dY)``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import binning, coord


def _int_zero_ct(x):
    """Zero cotangent for an integer-dtype primal (float0 convention)."""
    return np.zeros(x.shape, dtype=jax.dtypes.float0)

# Triangles are clipped against w >= _W_CLIP_EPS (near plane guard).
_W_CLIP_EPS = 1e-9

# Default number of subtriangles processed per scan step in the XLA
# brute-force pixel phase.
_DEFAULT_CHUNK = 64

_INT32_MAX = jnp.iinfo(jnp.int32).max

# Rational-depth sentinel; matches binning.BIG.
_RAT_BIG = 1e30


# ---------------------------------------------------------------------------
# Context shims (API parity only — no context object is needed).
# ---------------------------------------------------------------------------

class RasterizeCudaContext:
    """Stateless rasterizer context for API parity with the reference.

    The reference context owns a per-device CudaRaster instance
    (nvdiffrast/torch/ops.py:47-68); here all state lives in traced
    arrays, so this object only tracks the active depth peeler guard.
    """

    def __init__(self, device=None):
        self.device = device
        self.active_depth_peeler = None


class RasterizeGLContext(RasterizeCudaContext):
    """Deprecated alias (reference: nvdiffrast/torch/ops.py:550-559)."""

    def __init__(self, output_db=True, mode="automatic", device=None):
        import warnings

        warnings.warn(
            "RasterizeGLContext has been deprecated and uses RasterizeCudaContext internally",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(device=device)

    def set_context(self):
        pass

    def release_context(self):
        pass


# ---------------------------------------------------------------------------
# Geometry phase.
# ---------------------------------------------------------------------------

def _dop(a, b, c, d):
    """Deterministic, correctly-rounded f32 difference of products
    fl(a*b - c*d) via f64: both f32 products are EXACT in f64 (24+24
    <= 53 mantissa bits), so the single f64 subtraction rounds once —
    and fma contraction of the lowering cannot change the result
    (contracting an exact product is a no-op). This is immune to the
    backend's jit-vs-eager fma contraction asymmetry, which the
    earlier optimization_barrier / bitcast pins were NOT (XLA:CPU
    erases both before LLVM emission and contracts inside the fusion
    — measured: fl(a*b) - fl(c*d) gives 0 eagerly, +-1 ulp jitted for
    a*b == c*d). The final f64->f32 convert double-rounds, which is
    deterministic and within 0.5+eps ulp of exact.

    The x64 context only affects tracing; staged programs keep their
    f64 ops regardless of the caller's config.
    """
    with jax.enable_x64(True):
        f64 = functools.partial(jax.lax.convert_element_type,
                                new_dtype=np.float64)
        r = jax.lax.convert_element_type(
            f64(a) * f64(b) - f64(c) * f64(d), np.float32)
    return r


def _edge_coeffs(sub):
    """Affine coefficients of the homogeneous edge functions.

    For vertices p_i and pixel-center clip coords (fx, fy), with
    p_i' = (x_i - fx*w_i, y_i - fy*w_i), the edge function
    a_0 = p1'.x*p2'.y - p1'.y*p2'.x expands to an *affine* function
        a_0(fx, fy) = (x1*y2 - x2*y1) + fx*(y1*w2 - w1*y2) + fy*(w1*x2 - x1*w2)
    (the fx*fy terms cancel). Same cyclically for a_1, a_2.

    Args:
      sub: [..., 3, 4] vertices.

    Returns:
      [..., 3, 3] coefficients: [edge, (const, fx, fy)].

    Every coefficient is computed by _dop — the correctly-rounded f32
    difference of products — which gives two properties the watertight
    tie rule is built on, with no operand-ordering tricks:

    * Exact negation symmetry: the two triangles sharing a mesh edge
      compute the coefficient with operands swapped, and correct
      rounding is odd (fl(-x) = -fl(x)), so the two sides see BITWISE
      opposite values (see binning.build_records). A plain f32 expression does
      not have this: backends contract ``fl(a*b) - fl(c*d)`` into
      ``fma(a, b, -fl(c*d))`` (measured on XLA:CPU — ~30% of opposed
      pairs off by 1 ulp), and do so under jit but not eagerly,
      breaking jit/eager determinism too (test_jit_compatible).
    * A bitwise-duplicate (x, y, w) vertex pair gets exact-zero
      coefficients (a*b - a*b is exactly 0 in f64); such degenerate
      triangles are culled (binning.build_records) because an
      all-zero edge row would otherwise leave coverage to the tie rule
      + noise rows.

    Correct rounding also kills the coverage-polytope drift that plain
    construction had: the computed edge line is within 0.5 ulp OF THE
    COEFFICIENT of exact, where the plain difference was off by the
    rounding of the PRODUCTS — ~1 px of polytope displacement for
    cancelling slivers (see binning.coverage_slop).

    The tensor form of binning.edge_coeffs_cols (same _dop calls).
    """
    def cols(c):
        return tuple(sub[..., j, c] for j in range(3))

    e = binning.edge_coeffs_cols(cols(0), cols(1), cols(3))
    return jnp.stack([jnp.stack(ek, axis=-1) for ek in e], axis=-2)


def _tie_bits(ecoef):
    """Exclusive ownership rule for pixels exactly on an edge (a == 0).

    P(grad) = (cy > 0) | (cy == 0 & cx > 0) on the winding-normalized
    gradient: complementary between the two sides of a shared edge
    (their gradients are exact negations), so boundary pixels are
    covered exactly once — the top-left-rule equivalent
    (impl/Util.inl:304-309).
    """
    cx = ecoef[..., 1]
    cy = ecoef[..., 2]
    return (cy > 0) | ((cy == 0) & (cx > 0))


# ---------------------------------------------------------------------------
# Pixel phase: brute-force chunked scan (XLA reference path).
# ---------------------------------------------------------------------------

def _band_centers(resolution, viewport):
    """Pixel-center clip coords of a row band.

    viewport = (y0, full_height) renders rows [y0, y0+H) of a
    full_height-tall image (y0 may be traced — spatial sharding);
    None = full image. Band coords are bit-identical to the same rows
    of a full-image render (integer row index offset before scaling),
    preserving watertightness across band boundaries.
    """
    H, W = resolution
    y0, Hf = viewport if viewport is not None else (0, H)
    xs, xo, ys, yo = coord.pixel_scale_offset(Hf, W)
    fx = jnp.arange(W, dtype=jnp.float32) * jnp.float32(xs) + jnp.float32(xo)
    rows = jnp.arange(H, dtype=jnp.int32) + y0
    fy = rows.astype(jnp.float32) * jnp.float32(ys) + jnp.float32(yo)
    return fx, fy


def _coverage_xla(ecoef, zcoef, wcoef, valid, tri_ids, batch_shape, resolution,
                  peel_depth=None, chunk=_DEFAULT_CHUNK, viewport=None):
    """Scan triangle chunks, carrying the per-pixel (depth, id) minimum.

    Coverage per triangle is the winding-normalized parent edge test
    plus the affine *near-clip cut test* ``pw >= eps * (a0+a1+a2)``:
    since a_i = lambda_i * pD / w_hit, positive normalized edge values
    select exactly the front-side (w_hit > 0) ray hits, and the cut
    test trims hits with w_hit < eps — equivalent to rasterizing the
    geometrically clipped triangle (reference clips to subtriangles
    instead: cudaraster/impl/Util.inl:134-160) with no subtriangle
    machinery at all.

    Args:
      ecoef: [B, S, 3, 3] edge coefficients (or [S, 3, 3] shared).
      zcoef, wcoef: [B, S, 3] or [S, 3] plane coefficients.
      valid: [B, S] bool triangle validity (includes range masks).
      tri_ids: [S] int32 triangle index of each record.
      batch_shape: B.
      resolution: (H, W).
      peel_depth: optional [B, H, W] depth of previous peel layer; a
        fragment is culled when depth <= peel_depth (reference:
        csrc/common/cudaraster/impl/FineRaster.inl:349).

    Returns:
      idbuf: [B, H, W] int32 parent triangle index, -1 if empty.
      zbuf: [B, H, W] float32 internal depth (+inf if empty).
    """
    H, W = resolution
    B = batch_shape
    S = tri_ids.shape[0]

    fx, fy = _band_centers(resolution, viewport)
    fx = fx[None, :]  # [1, W]
    fy = fy[:, None]  # [H, 1]

    n_chunks = -(-S // chunk)
    S_pad = n_chunks * chunk
    pad = S_pad - S

    def pad_s(a, axis):
        if pad == 0:
            return a
        cfg = [(0, 0)] * a.ndim
        cfg[axis] = (0, pad)
        return jnp.pad(a, cfg)

    shared_geom = ecoef.ndim == 3  # range mode: geometry shared across batch
    s_axis = 0 if shared_geom else 1
    ecoef = pad_s(ecoef, s_axis)
    zcoef = pad_s(zcoef, s_axis)
    wcoef = pad_s(wcoef, s_axis)
    valid = pad_s(valid, 1)
    tri_ids = pad_s(tri_ids, 0)
    if pad:
        # Padded slots are invalid.
        valid = valid.at[:, S:].set(False)

    def reshape_chunks(a, axis):
        shape = list(a.shape)
        shape[axis:axis + 1] = [n_chunks, chunk]
        return a.reshape(shape)

    ecoef_c = reshape_chunks(ecoef, s_axis)
    zcoef_c = reshape_chunks(zcoef, s_axis)
    wcoef_c = reshape_chunks(wcoef, s_axis)
    valid_c = reshape_chunks(valid, 1)
    ids_c = reshape_chunks(tri_ids, 0)

    if shared_geom:
        xs = (jnp.moveaxis(ecoef_c, 0, 0), jnp.moveaxis(zcoef_c, 0, 0),
              jnp.moveaxis(wcoef_c, 0, 0), jnp.moveaxis(valid_c, 1, 0), ids_c)
    else:
        xs = (jnp.moveaxis(ecoef_c, 1, 0), jnp.moveaxis(zcoef_c, 1, 0),
              jnp.moveaxis(wcoef_c, 1, 0), jnp.moveaxis(valid_c, 1, 0), ids_c)

    # Rational depth carry: (numerator, denominator>0, id). Matches the
    # binned kernel's initialization (BIG, 1, invalid).
    zbuf0 = jnp.full((B, H, W), _RAT_BIG, jnp.float32)
    wbuf0 = jnp.ones((B, H, W), jnp.float32)
    idbuf0 = jnp.full((B, H, W), _INT32_MAX, jnp.int32)

    def step(carry, xc):
        zbuf, wbuf, idbuf = carry
        ec, zc, wc, vd, ids = xc
        # ec: [B, C, 3, 3] or [C, 3, 3]; vd: [B, C]; ids: [C].
        if shared_geom:
            ec_ = ec[None]
            zc_ = zc[None]
            wc_ = wc[None]
        else:
            ec_, zc_, wc_ = ec, zc, wc

        def affine(cf):
            # cf: [b, C, 3] -> [b, C, H, W]
            return (cf[..., 0, None, None]
                    + cf[..., 1, None, None] * fx[None, None]
                    + cf[..., 2, None, None] * fy[None, None])

        a0 = affine(ec_[..., 0, :])
        a1 = affine(ec_[..., 1, :])
        a2 = affine(ec_[..., 2, :])
        # Edge coefficients arrive winding-normalized (interior > 0);
        # pixels exactly on an edge go to exactly one owner (_tie_bits).
        tb = _tie_bits(ec_)[..., None, None]  # [b, C, 3, 1, 1]
        covered = (((a0 > 0) | ((a0 == 0) & tb[..., 0, :, :]))
                   & ((a1 > 0) | ((a1 == 0) & tb[..., 1, :, :]))
                   & ((a2 > 0) | ((a2 == 0) & tb[..., 2, :, :])))

        z = affine(zc_)
        w = affine(wc_)
        # Near-clip cut test (inclusive on the cut line — a silhouette
        # edge, no neighbor to hand pixels to).
        cut_ok = w - _W_CLIP_EPS * (a0 + a1 + a2) >= 0
        # Fragment z-clip (geometric clip in the reference's
        # TriangleSetup; per-fragment here, exact for the z planes).
        # All depth comparisons are cross-multiplied rationals, never
        # divided — the same compare primitive the binned kernel uses.
        # Note the merge ORDER differs (pairwise tree here, sequential
        # in the kernel), so f32 cross-product rounding can pick
        # different winners at (near-)tied depths; the parity sweep
        # tolerates exactly those z-fight pixels.
        frag_ok = covered & cut_ok & (w > 0) & (jnp.abs(z) <= w)
        frag_ok &= vd[:, :, None, None]
        if peel_depth is not None:
            # Peel cull compares the fragment's ROUNDED depth fl(z/w)
            # against the previous layer's recorded fl(z/w) — the same
            # value the same fragment produced there, so a layer's
            # winner is culled in the next layer EXACTLY, independent
            # of how the z/w plane coefficients were built. A rational
            # z > peel*w test is a knife edge at exact equality for
            # every previously-won pixel: the rounding of peel*w
            # decides it, and any 1-ulp coefficient difference between
            # builders lets the same fragment reappear. The reference
            # culls on the rounded f32 depth buffer value too
            # (FineRaster.inl:349). w <= 0 lanes divide to garbage but
            # are already false in frag_ok (NaN compares false).
            frag_ok &= z / w > peel_depth[:, None]

        zn = jnp.where(frag_ok, z, _RAT_BIG)
        wd = jnp.where(frag_ok, w, 1.0)
        ids_b = jnp.where(frag_ok, ids[None, :, None, None], _INT32_MAX)

        # Deterministic rational (z/w, id) lexicographic min over the
        # chunk: pairwise tree reduction (same compare as the kernel's
        # sequential merge).
        def merge(a, b):
            az_, aw_, ai_ = a
            bz_, bw_, bi_ = b
            lhs = az_ * bw_
            rhs = bz_ * aw_
            take_a = (lhs < rhs) | ((lhs == rhs) & (ai_ < bi_))
            return (jnp.where(take_a, az_, bz_),
                    jnp.where(take_a, aw_, bw_),
                    jnp.where(take_a, ai_, bi_))

        cur = (zn, wd, ids_b)
        while cur[0].shape[1] > 1:
            n = cur[0].shape[1]
            half = n // 2
            lo = tuple(v[:, :half] for v in cur)
            hi = tuple(v[:, half:2 * half] for v in cur)
            tail = tuple(v[:, 2 * half:] for v in cur)  # odd leftover
            merged = merge(lo, hi)
            if n % 2:
                merged = merge(merged, tail)  # idempotent min: safe
            cur = merged
        dz, dw, di = (v[:, 0] for v in cur)

        zbuf, wbuf, idbuf = merge((zbuf, wbuf, idbuf), (dz, dw, di))
        return (zbuf, wbuf, idbuf), None

    (zbuf, wbuf, idbuf), _ = jax.lax.scan(step, (zbuf0, wbuf0, idbuf0), xs)
    empty = idbuf == _INT32_MAX
    idbuf = jnp.where(empty, -1, idbuf)
    zbuf = jnp.where(empty, jnp.inf, zbuf / wbuf)
    return idbuf, zbuf


# ---------------------------------------------------------------------------
# Per-pixel shading: triangle-ID buffer -> (u, v, z/w, id) + bary derivatives.
# Math is an exact re-derivation of csrc/common/rasterize.cu:15-114.
# ---------------------------------------------------------------------------

def _shade(pos, tri, idbuf, resolution, instance_mode, viewport=None):
    H, W = resolution
    Hf = viewport[1] if viewport is not None else H
    B = idbuf.shape[0]

    valid = idbuf >= 0
    tid = jnp.where(valid, idbuf, 0)

    vidx = tri[tid]  # [B, H, W, 3]
    if instance_mode:
        # pos: [B, V, 4] — per-image vertices.
        p = jax.vmap(lambda pb, vb: pb[vb])(pos, vidx)  # [B, H, W, 3, 4]
    else:
        p = pos[vidx]  # [B, H, W, 3, 4]

    p0, p1, p2 = p[..., 0, :], p[..., 1, :], p[..., 2, :]

    fx, fy = _band_centers(resolution, viewport)
    fx = fx[None, None, :]
    fy = fy[None, :, None]

    def shifted(q):
        return q[..., 0] - fx * q[..., 3], q[..., 1] - fy * q[..., 3]

    p0x, p0y = shifted(p0)
    p1x, p1y = shifted(p1)
    p2x, p2y = shifted(p2)

    a0 = p1x * p2y - p1y * p2x
    a1 = p2x * p0y - p2y * p0x
    a2 = p0x * p1y - p0y * p1x

    iw = 1.0 / (a0 + a1 + a2)
    b0 = a0 * iw
    b1 = a1 * iw

    z = p0[..., 2] * a0 + p1[..., 2] * a1 + p2[..., 2] * a2
    w = p0[..., 3] * a0 + p1[..., 3] * a1 + p2[..., 3] * a2
    zw = z / w

    # Clamps to avoid NaNs (reference: rasterize.cu:86-91).
    b0 = jnp.clip(b0, 0.0, 1.0)
    b1 = jnp.clip(b1, 0.0, 1.0)
    bs = 1.0 / jnp.maximum(b0 + b1, 1.0)
    b0 = b0 * bs
    b1 = b1 * bs
    zw = jnp.clip(zw, -1.0, 1.0)

    idf = coord.triidx_to_float(tid + 1)

    # Bary pixel differentials (reference: rasterize.cu:96-113).
    xs, _, ys, _ = coord.pixel_scale_offset(Hf, W)
    dfxdx = xs * iw
    dfydy = ys * iw
    da0dx = p2[..., 1] * p1[..., 3] - p1[..., 1] * p2[..., 3]
    da0dy = p1[..., 0] * p2[..., 3] - p2[..., 0] * p1[..., 3]
    da1dx = p0[..., 1] * p2[..., 3] - p2[..., 1] * p0[..., 3]
    da1dy = p2[..., 0] * p0[..., 3] - p0[..., 0] * p2[..., 3]
    da2dx = p1[..., 1] * p0[..., 3] - p0[..., 1] * p1[..., 3]
    da2dy = p0[..., 0] * p1[..., 3] - p1[..., 0] * p0[..., 3]
    datdx = da0dx + da1dx + da2dx
    datdy = da0dy + da1dy + da2dy
    dudx = dfxdx * (b0 * datdx - da0dx)
    dudy = dfydy * (b0 * datdy - da0dy)
    dvdx = dfxdx * (b1 * datdx - da1dx)
    dvdy = dfydy * (b1 * datdy - da1dy)

    vmask = valid[..., None]
    out = jnp.where(vmask, jnp.stack([b0, b1, zw, idf], axis=-1), 0.0)
    out_db = jnp.where(vmask, jnp.stack([dudx, dudy, dvdx, dvdy], axis=-1), 0.0)
    return out.astype(jnp.float32), out_db.astype(jnp.float32)


# ---------------------------------------------------------------------------
# Backward: exact re-derivation of csrc/common/rasterize.cu:119-273.
# ---------------------------------------------------------------------------

def _rasterize_bwd_math(pos, tri, out, dy, ddb, resolution, instance_mode,
                        enable_db, viewport=None):
    """NHWC wrapper over _rasterize_bwd_cols (standalone-op boundary)."""
    B = out.shape[0]
    H, W = resolution
    N = B * H * W
    dy2 = dy.reshape(N, 4)
    ddb_cols = None
    if enable_db:
        ddb2 = ddb.reshape(N, 4)
        ddb_cols = (ddb2[:, 0], ddb2[:, 1], ddb2[:, 2], ddb2[:, 3])
    return _rasterize_bwd_cols(
        pos, tri, out[..., 3].reshape(N), dy2[:, 0], dy2[:, 1], ddb_cols,
        resolution, B, instance_mode, viewport=viewport)


def _raster_grad_pixel_cols(pos, tri, idf, dyx, dyy, ddb_cols, resolution,
                            B, instance_mode, viewport=None):
    """Per-pixel vertex-position gradient columns (rasterize.cu:119-273).

    The math of _rasterize_bwd_cols WITHOUT the final scatter: returns
    (g [9, N] channel-major pixel gradients, rid [N] table rows with
    invalid pixels routed to the dummy row R, R, T) so callers that
    merge several gradient streams into one reduction can concatenate
    these rows with theirs.
    """
    H, W = resolution
    enable_db = ddb_cols is not None
    T = tri.shape[0]
    N = B * H * W

    # Per-triangle vertex table, channel-major: (x, y, w) x 3 vertices.
    if instance_mode:
        tv = pos[:, tri]  # [B, T, 3, 4]
    else:
        tv = pos[tri]  # [T, 3, 4]
    tbl = tv[..., jnp.array([0, 1, 3])].reshape(-1, 9).T  # [9, (B*)T]
    R = tbl.shape[1]
    tbl = jnp.concatenate([tbl, jnp.zeros((9, 1), jnp.float32)], axis=1)

    idbuf = coord.float_to_triidx(idf).reshape(N) - 1
    valid = idbuf >= 0
    tid = jnp.where(valid, idbuf, 0)
    if instance_mode:
        boff = (jnp.arange(N, dtype=jnp.int32) // (H * W)) * T
        rid = jnp.where(valid, tid + boff, R)
    else:
        rid = jnp.where(valid, tid, R)

    from .gather import table_take
    g9 = table_take(tbl, rid)  # [9, N] channel-major

    def vcol(i):
        return g9[i]

    x0, y0, w0 = vcol(0), vcol(1), vcol(2)
    x1, y1, w1 = vcol(3), vcol(4), vcol(5)
    x2, y2, w2 = vcol(6), vcol(7), vcol(8)

    vp_y0, Hf = viewport if viewport is not None else (0, H)
    xs, xo, ys, yo = coord.pixel_scale_offset(Hf, W)
    pix = jnp.arange(N, dtype=jnp.int32)
    fx = (pix % W).astype(jnp.float32) * xs + xo
    fy = ((pix // W) % H + vp_y0).astype(jnp.float32) * ys + yo

    p0x = x0 - fx * w0
    p0y = y0 - fy * w0
    p1x = x1 - fx * w1
    p1y = y1 - fy * w1
    p2x = x2 - fx * w2
    p2y = y2 - fy * w2

    a0 = p1x * p2y - p1y * p2x
    a1 = p2x * p0y - p2y * p0x
    a2 = p0x * p1y - p0y * p1x

    # Inverse area with epsilon (~1 pixel in 1k x 1k image).
    at = a0 + a1 + a2
    ep = jnp.where(at >= 0, 1e-6, -1e-6)  # copysign(1e-6, at)
    iw = 1.0 / (at + ep)

    b0 = a0 * iw
    b1 = a1 * iw
    # Materialize the terms every output column shares: left to fuse,
    # XLA recomputes the whole expression inside each of the 9 column
    # kernels (and its GPU compile time grows with it).
    iw, b0, b1, p0x, p0y, p1x, p1y, p2x, p2y = jax.lax.optimization_barrier(
        (iw, b0, b1, p0x, p0y, p1x, p1y, p2x, p2y))

    gb0 = dyx * iw
    gb1 = dyy * iw
    gbb = gb0 * b0 + gb1 * b1
    gp0x = gbb * (p2y - p1y) - gb1 * p2y
    gp1x = gbb * (p0y - p2y) + gb0 * p2y
    gp2x = gbb * (p1y - p0y) - gb0 * p1y + gb1 * p0y
    gp0y = gbb * (p1x - p2x) + gb1 * p2x
    gp1y = gbb * (p2x - p0x) - gb0 * p2x
    gp2y = gbb * (p0x - p1x) + gb0 * p1x - gb1 * p0x
    gp0w = -fx * gp0x - fy * gp0y
    gp1w = -fx * gp1x - fy * gp1y
    gp2w = -fx * gp2x - fy * gp2y

    if enable_db:
        d0, d1, d2, d3 = ddb_cols
        dfxdX = (2.0 / W) * iw
        dfydY = (2.0 / Hf) * iw
        d0 = d0 * dfxdX
        d1 = d1 * dfydY
        d2 = d2 * dfxdX
        d3 = d3 * dfydY

        da0dX = y1 * w2 - y2 * w1
        da1dX = y2 * w0 - y0 * w2
        da2dX = y0 * w1 - y1 * w0
        da0dY = x2 * w1 - x1 * w2
        da1dY = x0 * w2 - x2 * w0
        da2dY = x1 * w0 - x0 * w1
        datdX = da0dX + da1dX + da2dX
        datdY = da0dY + da1dY + da2dY

        x01 = x0 - x1
        x12 = x1 - x2
        x20 = x2 - x0
        y01 = y0 - y1
        y12 = y1 - y2
        y20 = y2 - y0
        w01 = w0 - w1
        w12 = w1 - w2
        w20 = w2 - w0

        a0p1 = fy * x2 - fx * y2
        a0p2 = fx * y1 - fy * x1
        a1p0 = fx * y2 - fy * x2
        a1p2 = fy * x0 - fx * y0

        wdudX = 2.0 * b0 * datdX - da0dX
        wdudY = 2.0 * b0 * datdY - da0dY
        wdvdX = 2.0 * b1 * datdX - da1dX
        wdvdY = 2.0 * b1 * datdY - da1dY

        c0 = iw * (d0 * wdudX + d1 * wdudY + d2 * wdvdX + d3 * wdvdY)
        cx = c0 * fx - d0 * b0 - d2 * b1
        cy = c0 * fy - d1 * b0 - d3 * b1
        cxy = iw * (d0 * datdX + d1 * datdY)
        czw = iw * (d2 * datdX + d3 * datdY)
        c0, cx, cy, cxy, czw = jax.lax.optimization_barrier(
            (c0, cx, cy, cxy, czw))

        gp0x = gp0x + c0 * y12 - cy * w12 + czw * p2y + d3 * w2
        gp1x = gp1x + c0 * y20 - cy * w20 - cxy * p2y - d1 * w2
        gp2x = gp2x + c0 * y01 - cy * w01 + cxy * p1y - czw * p0y + d1 * w1 - d3 * w0
        gp0y = gp0y + cx * w12 - c0 * x12 - czw * p2x - d2 * w2
        gp1y = gp1y + cx * w20 - c0 * x20 + cxy * p2x + d0 * w2
        gp2y = gp2y + cx * w01 - c0 * x01 - cxy * p1x + czw * p0x - d0 * w1 + d2 * w0
        gp0w = gp0w + cy * x12 - cx * y12 - czw * a1p0 + d2 * y2 - d3 * x2
        gp1w = gp1w + cy * x20 - cx * y20 - cxy * a0p1 - d0 * y2 + d1 * x2
        gp2w = (gp2w + cy * x01 - cx * y01 - cxy * a0p2 - czw * a1p2
                + d0 * y1 - d1 * x1 - d2 * y0 + d3 * x0)

    # Per-pixel gradients, channel-major [9, N]: (x, y, w) per vertex.
    cols = [gp0x, gp0y, gp0w, gp1x, gp1y, gp1w, gp2x, gp2y, gp2w]
    # NaN/Inf guard: masked lanes computed with dummy geometry.
    cols = [jnp.where(valid & jnp.isfinite(c), c, 0.0) for c in cols]
    g = jnp.stack(cols, axis=0)
    return g, rid, R, T


def _rasterize_bwd_cols(pos, tri, idf, dyx, dyy, ddb_cols, resolution, B,
                        instance_mode, viewport=None):
    """Vertex position gradients (re-derivation of rasterize.cu:119-273).

    Data flow: per-pixel state lives in flat [N] SoA vectors, the
    per-triangle vertex data is one row-gather from a [9, T(+1)] table,
    and the pixel->vertex reduction is two-level (pixels -> triangle
    table, then triangles -> vertices).

    Flat boundary: `idf` is the rast id channel [N]; `dyx`/`dyy` the
    bary cotangents [N]; `ddb_cols` the 4 db cotangent columns or None.
    """
    from .scatter import scatter_add_by_id

    g, rid, R, T = _raster_grad_pixel_cols(
        pos, tri, idf, dyx, dyy, ddb_cols, resolution, B, instance_mode,
        viewport)
    if instance_mode:
        V = pos.shape[1]
    else:
        V = pos.shape[0]

    # Level 1: pixels -> per-triangle gradient table.
    gt = scatter_add_by_id(rid, g, R)  # [(B*)T, 9]

    # Level 2: triangle table -> vertex gradients (tiny scatter).
    gt = gt.reshape(-1, T, 3, 3)  # [B?, T, vert, (x, y, w)]
    gv = jnp.zeros(gt.shape[:-1] + (4,), jnp.float32)
    gv = gv.at[..., 0].set(gt[..., 0])
    gv = gv.at[..., 1].set(gt[..., 1])
    gv = gv.at[..., 3].set(gt[..., 2])
    if instance_mode:
        grad = jnp.zeros((B, V, 4), jnp.float32)
        grad = grad.at[:, tri].add(gv, mode="drop")
        return grad
    else:
        grad = jnp.zeros((V, 4), jnp.float32)
        grad = grad.at[tri].add(gv[0], mode="drop")
        return grad


# ---------------------------------------------------------------------------
# Core forward (coverage + shade), used by the custom_vjp primitive.
# ---------------------------------------------------------------------------

_IMPLS = ("auto", "xla", "triton_interpret")


def _target_platform():
    """Platform the computation is placed on: the `jax.default_device`
    in effect, else the default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def _use_kernel(impl):
    """Coverage route: the binned kernel on a GPU ('auto'), the XLA
    scan ('xla', and 'auto' elsewhere), or the kernel in the Pallas
    interpreter ('triton_interpret', for tests without a GPU)."""
    if impl not in _IMPLS:
        raise ValueError(f"rasterize: impl must be one of {_IMPLS}; "
                         f"got {impl!r}")
    return impl == "triton_interpret" or (
        impl == "auto" and _target_platform() == "gpu")


def _coverage(pos, tri, resolution, ranges, peel_depth, chunk, impl="auto",
              viewport=None):
    """Per-pixel winning triangle index ([B, H, W] int32, -1 if empty)
    and depth z/w ([B, H, W] f32, +inf if empty), by either route."""
    instance_mode = pos.ndim > 2
    T = tri.shape[0]

    if _use_kernel(impl):
        from .coverage_kernel import coverage_binned

        return coverage_binned(
            pos, tri, resolution, ranges, peel_depth, viewport=viewport,
            interpret=(impl == "triton_interpret"))

    if T >= (1 << 17):
        import warnings

        warnings.warn(
            f"rasterize: the XLA coverage path evaluates all {T} "
            f"triangles at every pixel (O(T*N)); at this size that takes "
            f"seconds to minutes per call. On a GPU, impl='auto' runs "
            f"the binned coverage kernel instead.", stacklevel=3)

    B = pos.shape[0] if instance_mode else ranges.shape[0]
    # The kernel's records, one per triangle: winding-normalized parent
    # edge and plane coefficients and the cull flag. The near-clip cut
    # is an affine per-fragment test inside _coverage_xla.
    rec = jnp.swapaxes(binning.build_records(pos, tri)[0], -1, -2)
    ecoef_f = rec[..., :9].reshape(rec.shape[:-1] + (3, 3))  # [.., T, 3, 3]
    zc_f = rec[..., 9:12]
    wc_f = rec[..., 12:15]
    sval_f = rec[..., 15] < binning.ID_VALID_THRESH

    tri_ids = jnp.arange(T, dtype=jnp.int32)

    if instance_mode:
        valid_f = sval_f  # [B, T]
    else:
        # Range mode: triangle t live for image b iff start <= t < start+count.
        start = ranges[:, 0:1]
        count = ranges[:, 1:2]
        t_ar = jnp.arange(T, dtype=jnp.int32)[None, :]
        rmask = (t_ar >= start) & (t_ar < start + count)  # [B, T]
        valid_f = sval_f[None, :] & rmask

    return _coverage_xla(
        ecoef_f, zc_f, wc_f, valid_f, tri_ids, B, resolution,
        peel_depth=peel_depth, chunk=chunk, viewport=viewport)


def _rasterize_fwd_core(pos, tri, resolution, ranges, peel_depth, chunk,
                        impl="auto", viewport=None):
    idbuf, zbuf = _coverage(pos, tri, resolution, ranges, peel_depth, chunk,
                            impl, viewport)
    out, out_db = _shade(pos, tri, idbuf, resolution, pos.ndim > 2,
                         viewport=viewport)
    return out, out_db, zbuf


# ---------------------------------------------------------------------------
# custom_vjp wiring.
# ---------------------------------------------------------------------------

@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 6, 7, 8, 9))
def _rasterize_prim(pos, tri, resolution, ranges, peel_depth, y0, grad_db,
                    chunk, impl, full_height):
    vp = None if full_height is None else (y0, full_height)
    out, out_db, zbuf = _rasterize_fwd_core(
        pos, tri, resolution, ranges, peel_depth, chunk, impl, viewport=vp)
    return out, out_db, zbuf


def _rasterize_prim_fwd(pos, tri, resolution, ranges, peel_depth, y0,
                        grad_db, chunk, impl, full_height):
    vp = None if full_height is None else (y0, full_height)
    out, out_db, zbuf = _rasterize_fwd_core(
        pos, tri, resolution, ranges, peel_depth, chunk, impl, viewport=vp)
    return (out, out_db, zbuf), (pos, tri, out, ranges, peel_depth, y0)


def _rasterize_prim_bwd(resolution, grad_db, chunk, impl, full_height, res,
                        cts):
    pos, tri, out, ranges, peel_depth, y0 = res
    dy, ddb, _dz = cts
    vp = None if full_height is None else (y0, full_height)
    instance_mode = pos.ndim > 2
    g_pos = _rasterize_bwd_math(
        pos, tri, out, dy, ddb if grad_db else None, resolution,
        instance_mode, enable_db=grad_db, viewport=vp)
    g_ranges = None if ranges is None else _int_zero_ct(ranges)
    g_tri = _int_zero_ct(tri)
    g_peel = None if peel_depth is None else jnp.zeros_like(peel_depth)
    g_y0 = None if y0 is None else _int_zero_ct(y0)
    return (g_pos, g_tri, g_ranges, g_peel, g_y0)


_rasterize_prim.defvjp(_rasterize_prim_fwd, _rasterize_prim_bwd)


# ---------------------------------------------------------------------------
# Public op.
# ---------------------------------------------------------------------------

def _check_rasterize_args(pos, tri, resolution, ranges):
    """Host-side argument validation.

    Mirrors the reference's NVDR_CHECK blocks
    (csrc/torch/torch_rasterize.cpp:50-57): shape/dtype checks always;
    triangle-index range checks when values are concrete (skipped for
    tracers — under jit the gathers clamp, matching device behavior).
    """
    if pos.ndim not in (2, 3) or pos.shape[-1] != 4 or pos.shape[-2] == 0:
        raise ValueError(
            "rasterize: pos must be [num_vertices, 4] (range mode) or "
            f"[minibatch, num_vertices, 4] (instanced); got {pos.shape}")
    if tri.ndim != 2 or tri.shape[1] != 3:
        raise ValueError(
            f"rasterize: tri must be [num_triangles, 3]; got {tri.shape}")
    if tri.shape[0] >= (1 << 24):
        # Reference capacity bar: 2^24 subtriangles
        # (csrc/common/cudaraster/impl/Constants.hpp:30). The binned
        # kernel's triangle-id records share the same contract; fail
        # loudly instead of silently degrading to an O(T*N) scan.
        raise ValueError(
            f"rasterize: triangle count {tri.shape[0]} exceeds the "
            f"2**24 capacity limit (reference parity: CR_MAXSUBTRIS)")
    h, w = resolution
    if h <= 0 or w <= 0:
        raise ValueError(f"rasterize: invalid resolution {resolution}")
    if pos.ndim == 2:
        if ranges is None or ranges.ndim != 2 or ranges.shape[1] != 2:
            raise ValueError(
                "rasterize: range mode requires ranges [minibatch, 2]; "
                f"got {None if ranges is None else ranges.shape}")
    if not isinstance(tri, jax.core.Tracer) and tri.size:
        # numpy (not jnp) so the reduction never joins an ambient trace.
        import numpy as np

        tri_np = np.asarray(tri)
        v = pos.shape[-2]
        tmin = int(tri_np.min())
        tmax = int(tri_np.max())
        if tmin < 0 or tmax >= v:
            raise ValueError(
                f"rasterize: triangle indices out of range [0, {v}): "
                f"min {tmin}, max {tmax}")


def rasterize(glctx, pos, tri, resolution, ranges=None, grad_db=True,
              chunk=_DEFAULT_CHUNK, impl="auto", viewport=None):
    """Rasterize triangles.

    API parity with the reference op (nvdiffrast/torch/ops.py:93-135).

    Args:
        glctx: Rasterizer context (`RasterizeCudaContext`) or None —
            kept for API parity only.
        pos: Vertex position tensor, float32. Instanced mode:
            [minibatch_size, num_vertices, 4]; range mode:
            [num_vertices, 4] (with `ranges` supplied).
        tri: Triangle tensor, [num_triangles, 3], int32.
        resolution: Output resolution as (height, width).
        ranges: Range mode only: [minibatch_size, 2] int32 tensor of
            (start, count) into `tri`. Ignored in instanced mode.
        grad_db: Propagate gradients of image-space bary derivatives
            into `pos` in the backward pass.
        chunk: Triangles per scan step of the brute-force pixel phase.
        impl: coverage route: 'auto' (the binned kernel on a GPU, the
            XLA scan elsewhere) | 'xla' | 'triton_interpret' (the kernel
            in the Pallas interpreter; for tests without a GPU).
        viewport: extension for spatial sharding: (y0, full_height)
            renders rows [y0, y0 + height) of a full_height-tall image
            (y0 may be a traced scalar, e.g. from jax.lax.axis_index).
            Band pixels are bit-identical to the same rows of the full
            render.

    Returns:
        (rast, rast_db): both [minibatch_size, height, width, 4];
        rast = (u, v, z/w, triangle_id+1 encoded as float);
        rast_db = (du/dX, du/dY, dv/dX, dv/dY).
    """
    if glctx is not None:
        assert isinstance(glctx, RasterizeCudaContext)
        if glctx.active_depth_peeler is not None:
            raise RuntimeError(
                "Cannot call rasterize() during depth peeling operation, "
                "use rasterize_next_layer() instead")
    assert grad_db is True or grad_db is False
    pos = jnp.asarray(pos, jnp.float32)
    tri = jnp.asarray(tri, jnp.int32)
    resolution = tuple(int(x) for x in resolution)
    instance_mode = pos.ndim > 2
    if not instance_mode:
        if ranges is None:
            raise ValueError("range mode requires `ranges` (pos is 2D)")
        ranges = jnp.asarray(ranges, jnp.int32)
    else:
        # Full-window placeholder (the binned kernel masks ids against it).
        ranges = jnp.broadcast_to(
            jnp.array([[0, tri.shape[0]]], jnp.int32), (pos.shape[0], 2))
    _check_rasterize_args(pos, tri, resolution, ranges)
    if viewport is None:
        y0, full_h = None, None
    else:
        y0 = jnp.asarray(viewport[0], jnp.int32)
        full_h = int(viewport[1])

    with jax.named_scope("nvdiffrast.rasterize"):
        out, out_db, _zbuf = _rasterize_prim(
            pos, tri, resolution, ranges, None, y0, bool(grad_db),
            int(chunk), impl, full_h)
    return out, out_db


class DepthPeeler:
    """Depth peeling context manager (reference: nvdiffrast/torch/ops.py:141-204).

    Rasterizes multiple depth layers; each `rasterize_next_layer` culls
    fragments at depths <= the previous layer's depth buffer.
    """

    def __init__(self, glctx, pos, tri, resolution, ranges=None, grad_db=True,
                 chunk=_DEFAULT_CHUNK, impl="auto"):
        if glctx is not None:
            assert isinstance(glctx, RasterizeCudaContext)
        assert grad_db is True or grad_db is False
        self.raster_ctx = glctx
        self.pos = jnp.asarray(pos, jnp.float32)
        self.tri = jnp.asarray(tri, jnp.int32)
        self.resolution = tuple(int(x) for x in resolution)
        instance_mode = self.pos.ndim > 2
        if not instance_mode:
            if ranges is None:
                raise ValueError("range mode requires `ranges`")
            self.ranges = jnp.asarray(ranges, jnp.int32)
        else:
            self.ranges = jnp.broadcast_to(
                jnp.array([[0, self.tri.shape[0]]], jnp.int32),
                (self.pos.shape[0], 2))
        _check_rasterize_args(self.pos, self.tri, self.resolution, self.ranges)
        self.grad_db = grad_db
        self.chunk = int(chunk)
        self.impl = impl
        self.peeling_idx = None
        self._peel_depth = None

    def __enter__(self):
        if self.raster_ctx is None:
            raise RuntimeError("Cannot re-enter a terminated depth peeling operation")
        if self.raster_ctx.active_depth_peeler is not None:
            raise RuntimeError(
                "Cannot have multiple depth peelers active simultaneously "
                "in a rasterization context")
        self.raster_ctx.active_depth_peeler = self
        self.peeling_idx = 0
        self._peel_depth = None
        return self

    def __exit__(self, *args):
        assert self.raster_ctx.active_depth_peeler is self
        self.raster_ctx.active_depth_peeler = None
        self.raster_ctx = None
        self.pos = None
        self.tri = None
        self.resolution = None
        self.ranges = None
        self.grad_db = None
        self.peeling_idx = None
        self._peel_depth = None
        return None

    def rasterize_next_layer(self):
        """Rasterize the next depth layer.

        Returns:
          (rast, rast_db) as in `rasterize()`.
        """
        assert self.raster_ctx.active_depth_peeler is self
        assert self.peeling_idx >= 0
        peel = self._peel_depth if self.peeling_idx > 0 else None
        out, out_db, zbuf = _rasterize_prim(
            self.pos, self.tri, self.resolution, self.ranges, peel, None,
            bool(self.grad_db), self.chunk, self.impl, None)
        self._peel_depth = jax.lax.stop_gradient(zbuf)
        self.peeling_idx += 1
        return out, out_db
