"""Binned coverage kernel for NVIDIA GPUs (Pallas, Triton route).

The rasterizer's pixel phase as one GPU program per (image, pixel
tile). The program walks its tile's CSR record segments (its own, its
tile row's, and the global one; see ``binning.csr_layout``) with a
``fori_loop``, skips every GROUP-record group whose AABB misses the
tile, and keeps the per-pixel lexicographic ``(z/w, id)`` minimum in
registers. Each fragment runs the same tests as the XLA reference
``rasterize._coverage_xla``: winding-normalized edge functions with the
exclusive tie rule (``_tie_bits``), the affine near-clip cut test, the
z-clip, the range-mode id window and the depth-peel cull, merged with
the same cross-multiplied depth compare and lowest-id tie rule. No
atomics: every pixel is owned by one program, so the result is
deterministic. ``idbuf`` and ``zbuf`` are written once at the end;
shading stays in XLA (``rasterize._shade``).

Pixel centers are computed by the caller with ``_band_centers`` and
read here, so both paths test bitwise-identical centers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import binning
from .binning import BIG, GROUP, ID_INVALID, ID_VALID_THRESH

# Pixel tile of one program (powers of two).
TILE_H = 32
TILE_W = 32
NUM_WARPS = 4


def _div_rn(a, b):
    """Correctly rounded f32 a / b. The f64 quotient of two f32 values
    rounds to the same f32 as the IEEE f32 quotient (53 >= 2*24 + 2),
    which the Triton route's f32 division (an approximation) does not
    promise. The XLA path divides in plain IEEE f32."""
    with jax.enable_x64(True):
        f64 = functools.partial(jax.lax.convert_element_type,
                                new_dtype=np.float64)
        return jax.lax.convert_element_type(f64(a) / f64(b), np.float32)


def _make_kernel(tile_h, tile_w, ntx, nty, eps, has_peel, geom_per_image):
    nk0 = nty * ntx

    def kernel(*refs):
        (gstart_ref, gcnt_ref, gaabb_ref, rec_ref, ranges_ref, fx_ref,
         fy_ref, *rest) = refs
        if has_peel:
            peel_ref, id_ref, z_ref = rest
            peel = peel_ref[...]
        else:
            id_ref, z_ref = rest
        b = pl.program_id(0)
        ty = pl.program_id(1)
        tx = pl.program_id(2)
        bb = b if geom_per_image else 0

        fx = fx_ref[pl.ds(tx * tile_w, tile_w)][None, :]  # [1, TW]
        fy = fy_ref[pl.ds(ty * tile_h, tile_h)][:, None]  # [TH, 1]
        # Tile bounds in pixel-index units (group AABB test).
        ty0 = (ty * tile_h).astype(jnp.float32)
        ty1 = ty0 + float(tile_h - 1)
        tx0 = (tx * tile_w).astype(jnp.float32)
        tx1 = tx0 + float(tile_w - 1)
        # Range-mode triangle window as float id bounds (ids are +1).
        start_f = ranges_ref[b, 0].astype(jnp.float32) + 1.0
        end_f = start_f + ranges_ref[b, 1].astype(jnp.float32)

        def record(r, carry):
            az, aw, aid = carry

            def s(i):
                return rec_ref[bb, r, i]

            def aff(i):
                return s(i) + s(i + 1) * fx + s(i + 2) * fy

            def tie(i):  # rasterize._tie_bits, scalar per edge
                return (s(i + 2) > 0) | ((s(i + 2) == 0) & (s(i + 1) > 0))

            a0 = aff(0)
            a1 = aff(3)
            a2 = aff(6)
            cov = (((a0 > 0) | ((a0 == 0) & tie(0)))
                   & ((a1 > 0) | ((a1 == 0) & tie(3)))
                   & ((a2 > 0) | ((a2 == 0) & tie(6))))
            pz = aff(9)
            pw = aff(12)
            idf = s(15)
            ok = (cov & (pw - eps * (a0 + a1 + a2) >= 0) & (pw > 0)
                  & (jnp.abs(pz) <= pw))
            ok &= (idf < ID_VALID_THRESH) & (idf >= start_f) & (idf < end_f)
            if has_peel:
                # Rounded-depth peel cull, as in _coverage_xla.
                ok &= _div_rn(pz, pw) > peel
            pzc = jnp.where(ok, pz, BIG)
            pwc = jnp.where(ok, pw, 1.0)
            idc = jnp.where(ok, idf, ID_INVALID)
            lhs = pzc * aw
            rhs = az * pwc
            better = (lhs < rhs) | ((lhs == rhs) & (idc < aid))
            return (jnp.where(better, pzc, az), jnp.where(better, pwc, aw),
                    jnp.where(better, idc, aid))

        def group(g, carry):
            hit = ((gaabb_ref[bb, g, 0] <= tx1) & (gaabb_ref[bb, g, 2] >= tx0)
                   & (gaabb_ref[bb, g, 1] <= ty1)
                   & (gaabb_ref[bb, g, 3] >= ty0))

            def sweep(c):
                for k in range(GROUP):
                    c = record(g * GROUP + k, c)
                return c

            return jax.lax.cond(hit, sweep, lambda c: c, carry)

        shape = (tile_h, tile_w)
        carry = (jnp.full(shape, BIG, jnp.float32),
                 jnp.ones(shape, jnp.float32),
                 jnp.full(shape, ID_INVALID, jnp.float32))
        for seg in (ty * ntx + tx, nk0 + ty, nk0 + nty):
            g0 = gstart_ref[bb, seg]
            carry = jax.lax.fori_loop(g0, g0 + gcnt_ref[bb, seg], group,
                                      carry)
        az, aw, aid = carry
        valid = aid < ID_VALID_THRESH
        id_ref[...] = jnp.where(valid, aid.astype(jnp.int32) - 1, -1)
        z_ref[...] = jnp.where(valid, _div_rn(az, aw), jnp.inf)

    return kernel


def coverage_binned(pos, tri, resolution, ranges, peel_depth=None,
                    viewport=None, interpret=False, tile=(TILE_H, TILE_W)):
    """Binned coverage: per-pixel winning triangle and depth.

    Args:
      pos: [B, V, 4] (instance mode) or [V, 4] (range mode).
      tri: [T, 3] int32.
      resolution: (H, W).
      ranges: [B, 2] int32 (start, count) triangle windows; instance
        mode passes the full window [0, T).
      peel_depth: optional [B, H, W] previous-layer depth (z/w, +inf
        where empty); fragments with depth <= peel are culled.
      viewport: optional (y0, full_height): rows [y0, y0 + H) of a
        full_height-tall image (y0 may be traced).
      interpret: run the kernel in the Pallas interpreter (tests on
        machines without a GPU).
      tile: (tile_h, tile_w) pixels per program, powers of two.

    Returns:
      idbuf: [B, H, W] int32 triangle index, -1 where empty.
      zbuf: [B, H, W] float32 depth z/w, +inf where empty.
    """
    from .rasterize import _W_CLIP_EPS, _band_centers

    H, W = resolution
    tile_h, tile_w = tile
    y0, Hf = (0, H) if viewport is None else (viewport[0], int(viewport[1]))
    instance_mode = pos.ndim > 2
    B = ranges.shape[0]
    nty = binning._cdiv(H, tile_h)
    ntx = binning._cdiv(W, tile_w)

    rec_cm, clip, valid, slop = binning.build_records(pos, tri)

    def layout(rec_i, clip_i, valid_i, slop_i):
        aabb = binning.aabb_cols(clip_i, valid_i, slop_i, H, W, y0, Hf)
        return binning.csr_layout(rec_i, aabb, nty, ntx, tile_h, tile_w)

    if instance_mode:
        rec, gaabb, gstart, gcnt = jax.vmap(layout)(rec_cm, clip, valid,
                                                    slop)
    else:
        rec, gaabb, gstart, gcnt = (
            a[None] for a in layout(rec_cm, clip, valid, slop))

    fx, fy = _band_centers(resolution, viewport)
    fx = jnp.pad(fx, (0, ntx * tile_w - W))
    fy = jnp.pad(fy, (0, nty * tile_h - H))
    inputs = [gstart, gcnt, gaabb, rec, jnp.asarray(ranges, jnp.int32),
              fx, fy]
    in_specs = [pl.BlockSpec()] * len(inputs)
    block = pl.BlockSpec((None, tile_h, tile_w),
                         lambda b, ty, tx: (b, ty, tx))
    Hp, Wp = nty * tile_h, ntx * tile_w
    if peel_depth is not None:
        inputs.append(jnp.pad(peel_depth, ((0, 0), (0, Hp - H), (0, Wp - W)),
                              constant_values=jnp.inf))
        in_specs.append(block)

    kernel = _make_kernel(tile_h, tile_w, ntx, nty, _W_CLIP_EPS,
                          peel_depth is not None, instance_mode)
    idbuf, zbuf = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((B, Hp, Wp), jnp.int32),
                   jax.ShapeDtypeStruct((B, Hp, Wp), jnp.float32)),
        grid=(B, nty, ntx),
        in_specs=in_specs,
        out_specs=(block, block),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        backend="triton",
        name="nvdr_coverage",
    )(*inputs)
    return idbuf[:, :H, :W], zbuf[:, :H, :W]
