"""Spatial (rowband) parallelism: one large image across devices.

The reference's analog is viewport tiling into <= 2048^2 passes on one
GPU (csrc/torch/torch_rasterize.cpp:98-124); here the tiles are *row
bands on different devices* under `jax.shard_map`:

* Every device holds the full (replicated) geometry and runs the FULL
  single-device pipeline — including the coverage kernel — on its own
  H-band, using the ops' `viewport=(y0, full_height)` extension. Band
  pixels are bit-identical to the same rows of a single-device render.
* rasterize / interpolate / texture are pixel-local, so they shard for
  free. antialias couples vertically adjacent pixels: pairs *inside* a
  band are handled locally (band edges fold like image borders), and
  the one row of pairs that straddles each band boundary is evaluated
  by `_aa_boundary` — a shard-local custom_vjp fed by a 1-row halo
  `ppermute`. The blend contribution that belongs to the neighbor's
  row travels back with a second `ppermute`; JAX AD transposes both
  ppermutes automatically, so backward halo traffic needs no manual
  code.
* Backward: vertex/texture gradients are shard-partial sums; psum them
  over the sp axis (shard_map AD inserts this for replicated inputs).

Collectives: 2 x 1-row ppermute forward, 2 reversed in backward — a
few KB per step, against megabytes of band pixels kept local.
"""

import functools

import jax
import jax.numpy as jnp

from ..ops.antialias import (TopologyHashWrapper, _build_tables, antialias,
                             decode_aux, pair_alpha, pair_ids, pair_pos_grad)
from ..ops.gather import table_take
from ..ops.scatter import scatter_add_by_id
from ..ops.topology import build_opposite_table


def _int_zero_ct(x):
    import numpy as np

    return np.zeros(x.shape, dtype=jax.dtypes.float0)


# ---------------------------------------------------------------------------
# Boundary pass: the single row of vertical pixel pairs straddling a
# band boundary. Exact same math as the in-band pass (antialias.cu
# analysis/grad kernels, d=1), on explicit top/bottom rows.
# ---------------------------------------------------------------------------

def _boundary_fwd_math(ctop, cbot, rtop, rbot, ftable, T, y0row, active,
                       full_height, instance_mode):
    B, W, C = ctop.shape
    N = B * W
    idf0 = rtop.reshape(N, 4)[:, 3]
    idf1 = rbot.reshape(N, 4)[:, 3]
    z0 = rtop.reshape(N, 4)[:, 2]
    z1 = rbot.reshape(N, 4)[:, 2]

    tid, is_t1, act = pair_ids(idf0, idf1, z0, z1, T)
    act = act & active
    pix = jnp.arange(N, dtype=jnp.int32)
    rofs = (pix // W) * T if instance_mode else jnp.zeros((N,), jnp.int32)
    rid = tid + rofs

    fx = (pix % W).astype(jnp.float32) + (0.5 - 0.5 * W)
    fy = (jnp.zeros((N,), jnp.int32) + y0row).astype(jnp.float32) \
        + (0.5 - 0.5 * full_height)

    t7 = table_take(ftable, rid)
    alpha, di = pair_alpha([t7[k] for k in range(7)], fx, fy, is_t1, act, 1)
    return alpha, di, is_t1, rid, fx, fy


def aa_boundary(ctop, cbot, rtop, rbot, pos, tri, op_table, y0row, active,
                full_height, boost=1.0):
    """Blend deltas for one row of cross-band vertical pairs.

    ctop/cbot: [B, W, C] color rows (band's last row, neighbor's first
    row); rtop/rbot: [B, W, 4] rast rows; y0row: global row index of
    the top row (traced); active: scalar bool (False on the last
    band). Returns (dtop, dbot) [B, W, C] deltas.
    """
    return _aa_boundary_prim(ctop, cbot, rtop, rbot, pos, tri, op_table,
                             y0row, active, int(full_height), float(boost))


@functools.partial(jax.custom_vjp, nondiff_argnums=(9, 10))
def _aa_boundary_prim(ctop, cbot, rtop, rbot, pos, tri, op_table, y0row,
                      active, full_height, boost):
    out, _ = _aa_boundary_fwd_impl(ctop, cbot, rtop, rbot, pos, tri,
                                   op_table, y0row, active, full_height)
    return out


def _aa_boundary_fwd_impl(ctop, cbot, rtop, rbot, pos, tri, op_table, y0row,
                          active, full_height):
    B, W, C = ctop.shape
    N = B * W
    instance_mode = pos.ndim > 2
    ftable, _, R, T = _build_tables(pos, tri, op_table, instance_mode,
                                    full_height, W)
    alpha, di, is_t1, rid, fx, fy = _boundary_fwd_math(
        ctop, cbot, rtop, rbot, ftable, T, y0row, active, full_height,
        instance_mode)

    ct = ctop.reshape(N, C)
    cb = cbot.reshape(N, C)
    apos = alpha > 0
    contrib = alpha[:, None] * (cb - ct)
    dtop = jnp.where(apos[:, None], contrib, 0.0).reshape(B, W, C)
    dbot = jnp.where(apos[:, None], 0.0, contrib).reshape(B, W, C)
    aux = di.astype(jnp.float32) + 4.0 * is_t1.astype(jnp.float32)
    return (dtop, dbot), (alpha, aux)


def _aa_boundary_prim_fwd(ctop, cbot, rtop, rbot, pos, tri, op_table, y0row,
                          active, full_height, boost):
    out, res = _aa_boundary_fwd_impl(ctop, cbot, rtop, rbot, pos, tri,
                                     op_table, y0row, active, full_height)
    return out, (ctop, cbot, rtop, rbot, pos, tri, op_table, y0row, active,
                 res)


def _aa_boundary_prim_bwd(full_height, boost, saved, cts):
    (ctop, cbot, rtop, rbot, pos, tri, op_table, y0row, active,
     (alpha, aux)) = saved
    gtop_d, gbot_d = cts
    B, W, C = ctop.shape
    N = B * W
    instance_mode = pos.ndim > 2
    V = pos.shape[1] if instance_mode else pos.shape[0]
    _, btable, R, T = _build_tables(pos, tri, op_table, instance_mode,
                                    full_height, W)

    idf0 = rtop.reshape(N, 4)[:, 3]
    idf1 = rbot.reshape(N, 4)[:, 3]
    di, is_t1 = decode_aux(aux)
    act = alpha != 0.0
    idf = jnp.where(is_t1, idf1, idf0)
    tsel = idf.astype(jnp.int32) - 1
    ok = act & (tsel >= 0) & (tsel < T)
    tid = jnp.where(ok, tsel, 0)
    pix = jnp.arange(N, dtype=jnp.int32)
    rofs = (pix // W) * T if instance_mode else jnp.zeros((N,), jnp.int32)
    rid = tid + rofs

    fx = (pix % W).astype(jnp.float32) + (0.5 - 0.5 * W)
    fy = (jnp.zeros((N,), jnp.int32) + y0row).astype(jnp.float32) \
        + (0.5 - 0.5 * full_height)

    gt = gtop_d.reshape(N, C)
    gb = gbot_d.reshape(N, C)
    ct = ctop.reshape(N, C)
    cb = cbot.reshape(N, C)
    apos = alpha > 0
    # v = al * pdy; g_ctop -= v, g_cbot += v (antialias.cu:449-462).
    pdy = jnp.where(apos[:, None], gt, gb)
    v = alpha[:, None] * pdy
    g_ctop = (-v).reshape(B, W, C)
    g_cbot = v.reshape(B, W, C)

    dd = jnp.sum(pdy * (cb - ct), axis=1)
    dd = jnp.where(act, dd, 0.0)
    keep = ok & (dd != 0.0) & (jnp.abs(alpha) < 0.5)
    t9 = table_take(btable, rid)
    cols = pair_pos_grad([t9[k] for k in range(9)], dd, keep, di, is_t1,
                         fx, fy, 1, W, full_height)
    gvals = jnp.stack(cols, axis=0)  # [9, N]
    gtab = scatter_add_by_id(rid, gvals, R)
    gtab = gtab.reshape(-1, T, 3, 3)
    gv = jnp.zeros(gtab.shape[:-1] + (4,), jnp.float32)
    gv = gv.at[..., 0].set(gtab[..., 0])
    gv = gv.at[..., 1].set(gtab[..., 1])
    gv = gv.at[..., 3].set(gtab[..., 2])
    if instance_mode:
        g_pos = jnp.zeros((pos.shape[0], V, 4), jnp.float32).at[:, tri].add(
            gv, mode="drop")
    else:
        g_pos = jnp.zeros((V, 4), jnp.float32).at[tri].add(gv[0], mode="drop")
    if boost != 1.0:
        g_pos = g_pos * boost

    return (g_ctop, g_cbot, jnp.zeros_like(rtop), jnp.zeros_like(rbot),
            g_pos, _int_zero_ct(tri), _int_zero_ct(op_table),
            _int_zero_ct(y0row), _int_zero_ct(active))


_aa_boundary_prim.defvjp(_aa_boundary_prim_fwd, _aa_boundary_prim_bwd)


# ---------------------------------------------------------------------------
# antialias over a row band inside shard_map.
# ---------------------------------------------------------------------------

def antialias_sp(color, rast, pos, tri, axis_name, full_height,
                 topology_hash=None, pos_gradient_boost=1.0):
    """Antialias a row band inside `shard_map` (sharded over axis_name).

    color/rast: [B, Hband, W, *] local band; pos/tri replicated. The
    in-band pairs run through the standard op with a viewport; the one
    row of cross-band pairs is evaluated via a 1-row halo ppermute and
    `_aa_boundary`, whose neighbor-side contribution ppermutes back.
    Produces exactly the single-device antialias of the full image.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    Hband = color.shape[1]
    y0 = idx * Hband

    if topology_hash is not None:
        assert isinstance(topology_hash, TopologyHashWrapper)
        op_table = topology_hash.op_table
    else:
        op_table = build_opposite_table(jnp.asarray(tri, jnp.int32))
        topology_hash = TopologyHashWrapper(op_table)

    out = antialias(color, rast, pos, tri, topology_hash=topology_hash,
                    pos_gradient_boost=pos_gradient_boost,
                    viewport=(y0, full_height))
    if n == 1:
        return out

    # Device i receives row 0 of device i+1 (cyclic; masked at the end).
    perm_up = [((i + 1) % n, i) for i in range(n)]
    cbot = jax.lax.ppermute(color[:, 0], axis_name, perm_up)
    rbot = jax.lax.ppermute(rast[:, 0], axis_name, perm_up)
    active = idx < n - 1

    dtop, dbot = aa_boundary(
        color[:, -1], cbot, rast[:, -1], rbot, pos, tri, op_table,
        y0 + Hband - 1, active, full_height, boost=pos_gradient_boost)
    out = out.at[:, -1].add(dtop)

    # The neighbor-row contribution travels back down one device.
    perm_down = [(i, (i + 1) % n) for i in range(n)]
    dbot_recv = jax.lax.ppermute(dbot, axis_name, perm_down)
    out = out.at[:, 0].add(dbot_recv)
    return out


def make_sp_render(mesh, tri, col_idx, resolution, sp_axis="sp"):
    """Rowband-sharded color renderer: full rasterize+interpolate+AA
    pipeline, one image split into H-bands across the sp axis.

    Returns render(pos [B, V, 4], col [V, C]) -> [B, H, W, C] jitted
    shard_map program; geometry replicated, output H-sharded.
    """
    from jax.sharding import PartitionSpec as P

    from ..ops.rasterize import rasterize
    from ..ops.interpolate import interpolate

    H, W = resolution
    n_sp = mesh.shape[sp_axis]
    assert H % n_sp == 0, f"H={H} not divisible by sp={n_sp}"
    Hband = H // n_sp
    tri = jnp.asarray(tri, jnp.int32)
    cidx = jnp.asarray(col_idx, jnp.int32)
    op_table = build_opposite_table(tri)
    topo = TopologyHashWrapper(op_table)

    def band(pos, col):
        y0 = jax.lax.axis_index(sp_axis) * Hband
        rast, _ = rasterize(None, pos, tri, (Hband, W), grad_db=False,
                            viewport=(y0, H))
        img, _ = interpolate(jnp.broadcast_to(col[None],
                                              (pos.shape[0],) + col.shape),
                             rast, cidx)
        return antialias_sp(img, rast, pos, tri, sp_axis, H,
                            topology_hash=topo)

    mapped = jax.shard_map(
        band, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(None, sp_axis),
        check_vma=False,
    )
    return jax.jit(mapped)
