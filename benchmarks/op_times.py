"""Per-op wall times on one GPU at bench.py's sizes.

Times each jitted call with ``block_until_ready`` (median and p90 of
``--reps`` calls after one compile+first call), so launch overhead is
included. Three parts:

1. coverage: the binned kernel (``impl="auto"`` on a GPU) against the
   XLA scan ``_coverage_xla`` on the bench mesh (3,968 triangles at
   2048^2) and on a 99,904-triangle sphere at 1024^2, with the count of
   pixels whose triangle id differs;
2. the kernel's pixel tile and warp count swept at the bench cell;
3. rasterize, interpolate, texture and antialias, forward and
   forward+backward, at the bench cell (512^2 trilinear texture).

Prints the card's name and power limit first. Exits non-zero when JAX
finds no GPU.

Usage: python benchmarks/op_times.py [--reps 20]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench import gpu_info, require_gpu, sphere_scene  # noqa: E402

RES = 2048
BIG_MESH, BIG_RES = (224, 224), 1024
TILES = ((16, 16, 4), (16, 32, 4), (16, 64, 4), (32, 32, 2), (32, 32, 4),
         (32, 64, 4), (64, 64, 8))


def timed(jax, f, args, reps):
    """(compile+first seconds, median ms, p90 ms, last output)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return first, float(np.median(ts)), float(np.percentile(ts, 90)), out


def line(name, first, med, p90):
    print(f"{name}: median {med:.3f} ms p90 {p90:.3f} ms (compile+first "
          f"{first:.1f} s)", flush=True)


def coverage(jax, reps):
    import jax.numpy as jnp

    from nvdiffrast_tpu.models import primitives
    from nvdiffrast_tpu.ops import coverage_kernel as CK
    from nvdiffrast_tpu.ops import rasterize as R
    from nvdiffrast_tpu.utils import camera

    s = sphere_scene(RES)
    pos_idx, vtxp, _, _ = primitives.uv_sphere(*BIG_MESH)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    mvp = camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
    cells = {
        f"bench {s['tri'].shape[0]} tris @{RES}^2": (
            s["pos"], s["tri"], RES),
        f"{pos_idx.shape[0]} tris @{BIG_RES}^2": (
            (posw @ mvp.T)[None].astype(np.float32), pos_idx, BIG_RES)}
    for name, (pos, tri, res) in cells.items():
        pos, tri = jnp.asarray(pos), jnp.asarray(tri)
        ranges = jnp.array([[0, tri.shape[0]]], jnp.int32)
        outs = {}
        for impl, n in (("xla", 3), ("auto", reps)):
            f = jax.jit(lambda p, impl=impl: R._coverage(
                p, tri, (res, res), ranges, None, 64, impl))
            first, med, p90, outs[impl] = timed(jax, f, (pos,), n)
            line(f"coverage {name} {impl}", first, med, p90)
        diff = int((np.asarray(outs["auto"][0])
                    != np.asarray(outs["xla"][0])).sum())
        print(f"coverage {name}: kernel vs xla id mismatches {diff}",
              flush=True)

    pos, tri = jnp.asarray(s["pos"]), jnp.asarray(s["tri"])
    ranges = jnp.array([[0, tri.shape[0]]], jnp.int32)
    warps = CK.NUM_WARPS
    try:
        for th, tw, nw in TILES:
            CK.NUM_WARPS = nw
            f = jax.jit(lambda p, t=(th, tw): CK.coverage_binned(
                p, tri, (RES, RES), ranges, tile=t))
            line(f"coverage kernel tile {th}x{tw} warps {nw} @{RES}^2",
                 *timed(jax, f, (pos,), reps)[:3])
    finally:
        CK.NUM_WARPS = warps


def ops(jax, reps):
    import jax.numpy as jnp

    import nvdiffrast_tpu as dr

    s = sphere_scene(RES)
    pos, tri = jnp.asarray(s["pos"]), jnp.asarray(s["tri"])
    cidx = jnp.asarray(s["cidx"])
    col, uv, tex = (jnp.asarray(s[k]) for k in ("col", "uv", "tex"))
    topo = dr.antialias_construct_topology_hash(tri)
    res = s["res"]
    rast, rast_db = jax.jit(lambda p: dr.rasterize(None, p, tri, res))(pos)
    img, _ = jax.jit(lambda c, r: dr.interpolate(c, r, cidx))(col, rast)
    uvi, uv_da = jax.jit(lambda u, r, db: dr.interpolate(
        u, r, cidx, db, diff_attrs="all"))(uv, rast, rast_db)

    def sq(*outs):
        return sum(jnp.sum(o ** 2) for o in outs)

    cases = {
        "rasterize (grad_db)": (
            lambda p: dr.rasterize(None, p, tri, res), (pos,)),
        "interpolate color": (
            lambda c, r: dr.interpolate(c, r, cidx)[0], (col, rast)),
        "interpolate uv + derivatives": (
            lambda u, r, db: dr.interpolate(u, r, cidx, db,
                                            diff_attrs="all"),
            (uv, rast, rast_db)),
        "texture trilinear 512^2": (
            lambda t, u, d: dr.texture(t, u, uv_da=d,
                                       filter_mode="linear-mipmap-linear"),
            (tex, uvi, uv_da)),
        "antialias": (
            lambda c, p: dr.antialias(c, rast, p, tri, topology_hash=topo),
            (img, pos)),
    }
    for name, (fn, args) in cases.items():
        line(f"{name} fwd", *timed(jax, jax.jit(fn), args, reps)[:3])
        grad = jax.jit(jax.grad(
            lambda *a, fn=fn: sq(*jax.tree_util.tree_leaves(fn(*a))),
            argnums=tuple(range(len(args)))))
        line(f"{name} fwd+bwd", *timed(jax, grad, args, reps)[:3])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    jax = require_gpu()
    name, limit = gpu_info()
    print(f"gpu: {name}, power limit {limit}", flush=True)
    coverage(jax, a.reps)
    ops(jax, a.reps)


if __name__ == "__main__":
    main()
