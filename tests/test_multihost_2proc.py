"""Real 2-process multi-host test (jax.distributed over localhost).

Spawns two coordinated CPU processes (tests/_mh_worker.py), each with 4
virtual devices, forming a global (dp=2, sp=4) mesh — the smallest
configuration that crosses a process boundary. Asserts:

  * jax.distributed actually initialized (process_count == 2 in both
    workers — the old jax.process_count() pre-touch bug made this
    silently fall back to two independent single-process jobs);
  * local_batch_slice hands each process its own disjoint shard;
  * two shard_map_train_step SGD steps produce identical replicated
    params/losses on both processes AND match a single-process run of
    the identical global computation;
  * the sp rowband render (AA halo ppermutes on the intra-host axis)
    is byte-identical across processes and matches the single-device
    full-image pipeline.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory, repo_root_mod):
    tmp = tmp_path_factory.mktemp("mh2proc")
    port = _free_port()
    procs = []
    outs = []
    for pid in range(2):
        out = tmp / f"worker{pid}.json"
        outs.append(out)
        env = dict(os.environ)
        # The workers set their own XLA_FLAGS (device count).
        env.pop("XLA_FLAGS", None)
        env["JAX_PLATFORMS"] = "cpu"
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp / "cache")
        procs.append(subprocess.Popen(
            [sys.executable, str(repo_root_mod / "tests" / "_mh_worker.py"),
             "--pid", str(pid), "--nproc", "2", "--port", str(port),
             "--out", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(log)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    return [json.load(open(o)) for o in outs]


@pytest.fixture(scope="module")
def repo_root_mod():
    import pathlib

    return pathlib.Path(__file__).resolve().parent.parent


def test_two_processes_initialized(worker_results):
    r0, r1 = worker_results
    assert r0["process_count"] == 2
    assert r1["process_count"] == 2


def test_local_batch_slices_disjoint(worker_results):
    r0, r1 = worker_results
    assert r0["batch_slice"] == [0, 2]
    assert r1["batch_slice"] == [2, 2]


def test_replicated_results_identical_across_processes(worker_results):
    r0, r1 = worker_results
    assert r0["losses"] == pytest.approx(r1["losses"], rel=1e-6)
    assert r0["col_head"] == pytest.approx(r1["col_head"], rel=1e-6)
    assert r0["sp_image_sha"] == r1["sp_image_sha"]


def test_matches_single_process_global_run(worker_results):
    # The identical global computation, one process, no mesh.
    import optax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _mh_worker

    from nvdiffrast_tpu.ops.antialias import antialias
    from nvdiffrast_tpu.ops.interpolate import interpolate
    from nvdiffrast_tpu.ops.rasterize import rasterize

    pos_idx, col_idx, vtxc, batch = _mh_worker.build_scene()
    tri = jnp.asarray(pos_idx)
    cidx = jnp.asarray(col_idx)
    RES = 64

    def loss_fn(params, pos_clip):
        rast, _ = rasterize(None, pos_clip, tri, (RES, RES), grad_db=False)
        img, _ = interpolate(
            jnp.broadcast_to(params["col"][None],
                             (pos_clip.shape[0],) + params["col"].shape),
            rast, cidx)
        img = antialias(img, rast, pos_clip, tri)
        return jnp.mean((img - 0.25) ** 2)

    def global_loss(params, batch):
        # pmean-of-shard-means == mean of the two half-batch means.
        l0 = loss_fn(params, batch[:2])
        l1 = loss_fn(params, batch[2:])
        return 0.5 * (l0 + l1)

    opt = optax.sgd(1e-2)
    params = {"col": jnp.asarray(vtxc)}
    opt_state = opt.init(params)
    step = jax.jit(
        lambda p, s, b: _apply(opt, p, s, b, global_loss))

    losses = []
    gb = jnp.asarray(batch)
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state, gb)
        losses.append(float(loss))

    r0 = worker_results[0]
    assert r0["losses"] == pytest.approx(losses, rel=2e-5)
    col = np.asarray(params["col"])
    assert r0["col_sum"] == pytest.approx(float(col.sum()), rel=2e-5)
    assert r0["col_head"] == pytest.approx(
        [float(x) for x in col.ravel()[:8]], rel=2e-5, abs=1e-6)

    # sp rowband render == plain single-device full-image pipeline.
    def render_ref(pos, col):
        rast, _ = rasterize(None, pos, tri, (RES, RES), grad_db=False)
        img, _ = interpolate(
            jnp.broadcast_to(col[None], (pos.shape[0],) + col.shape),
            rast, cidx)
        return antialias(img, rast, pos, tri)

    img = np.asarray(jax.jit(render_ref)(gb[:1], jnp.asarray(vtxc)))
    assert r0["sp_image_sum"] == pytest.approx(float(img.sum()), rel=1e-5)
    import hashlib

    assert r0["sp_image_sha"] == hashlib.sha256(
        img.astype(np.float32).tobytes()).hexdigest()


def _apply(opt, params, opt_state, batch, global_loss):
    import optax

    loss, grads = jax.value_and_grad(global_loss)(params, batch)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return params, opt_state, loss
