"""Multi-process worker for tests/test_multihost_2proc.py.

Runs as ONE process of a jax.distributed cluster (CPU backend, 4 local
virtual devices), exercising the real multi-host code paths:

  * multihost.initialize() with an explicit coordinator — BEFORE any
    backend-initializing JAX call (the regression the old
    jax.process_count() guard caused).
  * pod_mesh(): global (processes=2, local=4) -> dp=2 across
    processes, sp=4 within each.
  * local_batch_slice(): this process's shard of the global batch.
  * shard_map_train_step(): 2 SGD steps of the full
    rasterize+interpolate+antialias pipeline, grads pmean'd over dp.
  * make_sp_render(): rowband spatial parallelism incl. the AA halo
    ppermutes, on the sp (within-process) axis of the global mesh.

Results are written as JSON for the parent test to cross-check against
a single-process run of the identical global computation.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
flag = "--xla_force_host_platform_device_count=4"
if flag not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + flag).strip()

import numpy as np


def build_scene():
    """Deterministic tiny scene shared with the parent (pure numpy)."""
    from nvdiffrast_tpu.models import primitives
    from nvdiffrast_tpu.utils import camera

    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(8, 12)
    vtxc = (vtxp * 0.5 + 0.5).astype(np.float32)
    mvp = camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    base = (posw @ mvp.T).astype(np.float32)
    # Global batch of 4 slightly different views.
    batch = np.stack([base * (1.0 + 1e-3 * i) for i in range(4)])
    return pos_idx, col_idx, vtxc, batch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    from nvdiffrast_tpu.parallel import multihost

    # Must run before jax.devices()/process_count()/any computation.
    multihost.initialize(coordinator_address=f"127.0.0.1:{args.port}",
                         num_processes=args.nproc, process_id=args.pid)

    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert jax.process_count() == args.nproc, (
        f"distributed init failed: process_count={jax.process_count()}")

    from nvdiffrast_tpu.ops.antialias import antialias
    from nvdiffrast_tpu.ops.interpolate import interpolate
    from nvdiffrast_tpu.ops.rasterize import rasterize
    from nvdiffrast_tpu.parallel import shard, spatial

    mesh = multihost.pod_mesh()
    assert mesh.shape["dp"] == args.nproc
    sp = mesh.shape["sp"]

    pos_idx, col_idx, vtxc, batch = build_scene()
    tri = jnp.asarray(pos_idx)
    cidx = jnp.asarray(col_idx)
    RES = 64

    # --- dp training: 2 steps of shard_map_train_step -----------------
    def loss_fn(params, pos_clip):
        rast, _ = rasterize(None, pos_clip, tri, (RES, RES), grad_db=False)
        img, _ = interpolate(
            jnp.broadcast_to(params["col"][None],
                             (pos_clip.shape[0],) + params["col"].shape),
            rast, cidx)
        img = antialias(img, rast, pos_clip, tri)
        return jnp.mean((img - 0.25) ** 2)

    opt = optax.sgd(1e-2)
    step = shard.shard_map_train_step(loss_fn, opt, mesh)

    repl = NamedSharding(mesh, P())

    def repl_put(x):
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(repl, x, x.shape)

    params = jax.tree.map(repl_put, {"col": vtxc})
    opt_state = opt.init(params)

    start, size = multihost.local_batch_slice(batch.shape[0], mesh)
    local = batch[start:start + size]
    batch_sh = NamedSharding(mesh, P("dp"))
    gbatch = jax.make_array_from_process_local_data(batch_sh, local,
                                                    batch.shape)

    losses = []
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state, gbatch)
        losses.append(float(np.asarray(loss.addressable_data(0))))
    col_final = np.asarray(params["col"].addressable_data(0))

    # --- sp rowband render on the global mesh (AA halo ppermutes) -----
    render = spatial.make_sp_render(mesh, pos_idx, col_idx, (RES, RES))
    pos1 = repl_put(batch[:1])
    col0 = repl_put(vtxc)
    img = render(pos1, col0)
    # Output is sp-sharded locally, dp-replicated: assemble from the
    # addressable shards.
    full = np.zeros(img.shape, np.float32)
    for s in img.addressable_shards:
        full[s.index] = np.asarray(s.data)

    json.dump({
        "process_count": jax.process_count(),
        "batch_slice": [int(start), int(size)],
        "losses": losses,
        "col_sum": float(col_final.sum()),
        "col_head": [float(x) for x in col_final.ravel()[:8]],
        "sp_image_sum": float(full.sum()),
        "sp_image_sha": __import__("hashlib").sha256(
            full.tobytes()).hexdigest(),
    }, open(args.out, "w"))


if __name__ == "__main__":
    main()
