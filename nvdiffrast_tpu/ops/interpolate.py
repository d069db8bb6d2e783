"""Differentiable attribute interpolation.

Forward math is an exact re-derivation of
csrc/common/interpolate.cu:15-126 (out = b0*a0 + b1*a1 + (1-b0-b1)*a2,
zeroed where no triangle; optional image-space attribute derivatives
via the chain rule through rast_db).

Data flow (same design as the rasterize backward):

* per-pixel state is flat [N] / [K, N] SoA;
* the three vertex attribute rows per pixel come from ONE row-gather
  of a per-triangle table [3A, T(+1)] (dummy zero column for empty
  pixels), built with a cheap [T]-sized gather from the attribute
  tensor — never a per-pixel vertex-index gather;
* the backward (re-derivation of interpolate.cu:131-274) is a
  hand-written custom_vjp: attribute gradients reduce pixels ->
  triangle rows (ops/scatter.py) then triangle -> vertex with a tiny
  scatter; bary gradients land in rast channels 0-1 with channels 2-3
  zero, matching the reference.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import coord
from .gather import table_take
from .scatter import scatter_add_by_id

# Maximum number of differentiable attributes (reference:
# csrc/common/interpolate.h:18). No hard limit is imposed here; the
# constant is kept for API-compatible validation.
MAX_DIFF_ATTRS = 32


def _int_zero_ct(x):
    return np.zeros(x.shape, dtype=jax.dtypes.float0)


def _pixel_ids(attr, rast, tri, instance_mode, attr_bc):
    """Shared plumbing: attr table + flat ids + masked barys.

    Returns (rid [N], tbl [3A, R+1], b0, b1, b2 [N], valid [N], meta).
    meta = (B, H, W, A, R, T).
    """
    B, H, W, _ = rast.shape
    T = tri.shape[0]
    A = attr.shape[-1]
    N = B * H * W

    # Per-triangle attribute table [3A, (B*)T] + dummy zero column.
    if instance_mode and not attr_bc:
        att = attr[:, tri]  # [B, T, 3, A]
    else:
        a2d = attr[0] if instance_mode else attr
        att = a2d[tri]  # [T, 3, A]
    tbl = att.reshape(-1, 3 * A).T  # [3A, (B*)T]
    R = tbl.shape[1]
    tbl = jnp.concatenate([tbl, jnp.zeros((3 * A, 1), jnp.float32)], axis=1)

    idbuf = coord.float_to_triidx(rast[..., 3]).reshape(N) - 1
    valid = (idbuf >= 0) & (idbuf < T)
    tid = jnp.where(valid, idbuf, 0)
    if instance_mode and not attr_bc:
        boff = (jnp.arange(N, dtype=jnp.int32) // (H * W)) * T
        rid = jnp.where(valid, tid + boff, R)
    else:
        rid = jnp.where(valid, tid, R)

    r2 = rast.reshape(N, 4)
    b0 = jnp.where(valid, r2[:, 0], 0.0)
    b1 = jnp.where(valid, r2[:, 1], 0.0)
    b2 = jnp.where(valid, 1.0 - r2[:, 0] - r2[:, 1], 0.0)
    return rid, tbl, b0, b1, b2, valid, (B, H, W, A, R, T)


def _pixel_tables(attr, rast, tri, instance_mode, attr_bc):
    """Plumbing + gathered attr table rows (XLA path).

    Returns (rid [N], g3 [3A, N] channel-major, b0, b1, b2 [N],
    valid [N], meta)."""
    rid, tbl, b0, b1, b2, valid, meta = _pixel_ids(
        attr, rast, tri, instance_mode, attr_bc)
    g3 = table_take(tbl, rid)  # [3A, N]
    return rid, g3, b0, b1, b2, valid, meta


def _db_cols(rast_db, valid, N):
    db = rast_db.reshape(N, 4)
    return tuple(jnp.where(valid, db[:, i], 0.0) for i in range(4))


def _interp_fwd_core(attr, rast, rast_db, tri, diff_list, instance_mode,
                     attr_bc, tables=None):
    if tables is None:
        tables = _pixel_tables(attr, rast, tri, instance_mode, attr_bc)
    rid, g3, b0, b1, b2, valid, meta = tables
    B, H, W, A, R, T = meta
    N = B * H * W

    # Per-channel 1D math.
    out = jnp.stack(
        [b0 * g3[a] + b1 * g3[A + a] + b2 * g3[2 * A + a] for a in range(A)],
        axis=-1)

    D = len(diff_list)
    if D == 0:
        return (out.reshape(B, H, W, A),
                jnp.zeros((B, H, W, 0), jnp.float32))

    dudx, dudy, dvdx, dvdy = _db_cols(rast_db, valid, N)
    da_cols = []
    for j in diff_list:
        dsdu = g3[j] - g3[2 * A + j]
        dsdv = g3[A + j] - g3[2 * A + j]
        da_cols.append(dudx * dsdu + dvdx * dsdv)
        da_cols.append(dudy * dsdu + dvdy * dsdv)
    out_da = jnp.stack(da_cols, axis=-1).reshape(B, H, W, 2 * D)
    return out.reshape(B, H, W, A), out_da


def _interp_bwd_core(attr, rast, rast_db, tri, diff_list, instance_mode,
                     attr_bc, gy, gda, saved=None):
    """Re-derivation of InterpolateGradKernel[Da] (interpolate.cu:131-274)."""
    if saved is not None:
        # Fwd residuals: skip re-gathering the attribute table (the
        # [3A, N] buffer costs far less to store than to re-fetch).
        rid, g3, b0, b1, b2, valid, meta = saved
    else:
        rid, g3, b0, b1, b2, valid, meta = _pixel_tables(
            attr, rast, tri, instance_mode, attr_bc)
    B, H, W, A, R, T = meta
    N = B * H * W
    D = len(diff_list)

    gy2 = gy.reshape(N, A)
    gyc = [gy2[:, a] for a in range(A)]

    # Bary gradients -> rast channels 0-1 (channels 2-3 stay zero).
    gb0 = sum(gyc[a] * (g3[a] - g3[2 * A + a]) for a in range(A))
    gb1 = sum(gyc[a] * (g3[A + a] - g3[2 * A + a]) for a in range(A))
    zeros = jnp.zeros_like(gb0)
    g_rast = jnp.stack([gb0, gb1, zeros, zeros],
                       axis=-1).reshape(B, H, W, 4)

    # Attribute gradients, level 1: pixels -> triangle rows.
    ga0 = [b0 * gyc[a] for a in range(A)]
    ga1 = [b1 * gyc[a] for a in range(A)]
    ga2 = [b2 * gyc[a] for a in range(A)]

    g_rast_db = None
    if D > 0:
        dudx, dudy, dvdx, dvdy = _db_cols(rast_db, valid, N)
        gda2 = gda.reshape(N, 2 * D)
        gdb = [zeros, zeros, zeros, zeros]
        for jj, j in enumerate(diff_list):
            gdax = gda2[:, 2 * jj]
            gday = gda2[:, 2 * jj + 1]
            # d(out_da)/d(attr): s0 du terms, s1 dv terms, s2 minus both.
            c0 = dudx * gdax + dudy * gday
            c1 = dvdx * gdax + dvdy * gday
            ga0[j] = ga0[j] + c0
            ga1[j] = ga1[j] + c1
            ga2[j] = ga2[j] - c0 - c1
            # d(out_da)/d(rast_db).
            dsdu = g3[j] - g3[2 * A + j]
            dsdv = g3[A + j] - g3[2 * A + j]
            gdb[0] = gdb[0] + gdax * dsdu
            gdb[1] = gdb[1] + gday * dsdu
            gdb[2] = gdb[2] + gdax * dsdv
            gdb[3] = gdb[3] + gday * dsdv
        g_rast_db = jnp.stack(
            [jnp.where(valid, c, 0.0) for c in gdb],
            axis=-1).reshape(B, H, W, 4)

    gcols = [jnp.where(valid, c, 0.0) for c in (ga0 + ga1 + ga2)]
    gval = jnp.stack(gcols, axis=0)  # [3A, N] channel-major
    gt = scatter_add_by_id(rid, gval, R)  # [(B*)T, 3A]

    # Level 2: triangle rows -> vertex attribute gradients.
    gt = gt.reshape(-1, T, 3, A)
    if instance_mode and not attr_bc:
        g_attr = jnp.zeros(attr.shape, jnp.float32)
        g_attr = g_attr.at[:, tri].add(gt, mode="drop")
    else:
        Va = attr.shape[-2]
        g2 = jnp.zeros((Va, A), jnp.float32).at[tri].add(gt[0], mode="drop")
        g_attr = g2[None] if instance_mode else g2

    return g_attr, g_rast, g_rast_db


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6))
def _interpolate_prim(attr, rast, rast_db, tri, diff_list, instance_mode,
                      attr_bc):
    return _interpolate_prim_fwd(attr, rast, rast_db, tri, diff_list,
                                 instance_mode, attr_bc)[0]


def _interpolate_prim_fwd(attr, rast, rast_db, tri, diff_list, instance_mode,
                          attr_bc):
    saved = _pixel_tables(attr, rast, tri, instance_mode, attr_bc)
    outs = _interp_fwd_core(attr, rast, rast_db, tri, diff_list,
                            instance_mode, attr_bc, tables=saved)
    return outs, (attr, rast, rast_db, tri, saved)


def _interpolate_prim_bwd(diff_list, instance_mode, attr_bc, res, cts):
    attr, rast, rast_db, tri, saved = res
    gy, gda = cts
    g_attr, g_rast, g_rast_db = _interp_bwd_core(
        attr, rast, rast_db, tri, diff_list, instance_mode, attr_bc,
        gy, gda, saved=saved)
    if g_rast_db is None:
        g_rast_db = jnp.zeros_like(rast_db)
    return (g_attr, g_rast, g_rast_db, _int_zero_ct(tri))


_interpolate_prim.defvjp(_interpolate_prim_fwd, _interpolate_prim_bwd)


def interpolate(attr, rast, tri, rast_db=None, diff_attrs=None):
    """Interpolate vertex attributes.

    API parity with the reference op (nvdiffrast/torch/ops.py:241-291).

    Args:
        attr: Attribute tensor, float32. [num_vertices, num_attributes]
            in range mode, or [minibatch_size, num_vertices,
            num_attributes] in instanced mode. Broadcasting is supported
            along the minibatch axis (size-1 leading dim).
        rast: Main output tensor from `rasterize()`.
        tri: Triangle tensor, [num_triangles, 3], int32.
        rast_db: (Optional) second output of `rasterize()` — image-space
            barycentric derivatives. Enables attribute derivatives.
        diff_attrs: (Optional) list of attribute indices for which
            image-space derivatives are computed; 'all' selects every
            attribute. Negative indices are Python-style.

    Returns:
        (out, out_da): out is [minibatch_size, height, width,
        num_attributes]; out_da is [minibatch_size, height, width,
        2 * len(diff_attrs)] with (dA/dX, dA/dY) pairs, or a
        zero-width tensor when `diff_attrs` is not given.
    """
    # Sanitize the list of pixel differential attributes
    # (mirrors nvdiffrast/torch/ops.py:271-280).
    if diff_attrs is None:
        diff_attrs = []
    elif diff_attrs != "all":
        diff_attrs = np.asarray(diff_attrs, np.int32)
        assert len(diff_attrs.shape) == 1
        diff_attrs = diff_attrs.tolist()

    attr = jnp.asarray(attr, jnp.float32)
    rast = jnp.asarray(rast, jnp.float32)
    tri = jnp.asarray(tri, jnp.int32)

    instance_mode = attr.ndim == 3
    A = attr.shape[-1]
    B = rast.shape[0]
    attr_bc = instance_mode and attr.shape[0] == 1

    if diff_attrs == "all":
        diff_list = tuple(range(A))
    else:
        # Python-style negative indices (reference: interpolate.cu:101-103).
        diff_list = tuple(int(j) + (A if int(j) < 0 else 0)
                          for j in diff_attrs)
        for j in diff_list:
            if not 0 <= j < A:
                raise ValueError(f"diff_attrs index out of range: {j}")
    if len(diff_list) > 0 and rast_db is None:
        raise ValueError("diff_attrs requires rast_db")

    if rast_db is None:
        rast_db = jnp.zeros((B, rast.shape[1], rast.shape[2], 4), jnp.float32)
    else:
        rast_db = jnp.asarray(rast_db, jnp.float32)

    with jax.named_scope("nvdiffrast.interpolate"):
        return _interpolate_prim(attr, rast, rast_db, tri, diff_list,
                                 bool(instance_mode), bool(attr_bc))
