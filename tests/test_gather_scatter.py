"""Unit tests for the data-movement primitives (gather/scatter) and
kernel-vs-XLA parity of the binned coverage kernel (interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np

import nvdiffrast_tpu as dr
from nvdiffrast_tpu.ops.gather import table_take
from nvdiffrast_tpu.ops.scatter import scatter_add_by_id


def _scatter_ref(ids, vals, R):
    """float64 np.add.at reference; out-of-range ids dropped."""
    ids = np.asarray(ids)
    vals = np.asarray(vals, np.float64)
    out = np.zeros((R, vals.shape[0]))
    ok = (ids >= 0) & (ids < R)
    np.add.at(out, ids[ok], vals[:, ok].T)
    return out


def _assert_scatter(got, want):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4 * scale)


def test_table_take_matches_xla():
    rng = np.random.RandomState(0)
    K, T, N = 7, 300, 5000
    tbl = rng.randn(K, T).astype(np.float32)
    rid = rng.randint(0, T, N).astype(np.int32)
    out = table_take(jnp.asarray(tbl), jnp.asarray(rid))
    np.testing.assert_array_equal(np.asarray(out), tbl[:, rid])


def test_table_take_padded_tail():
    # Odd sizes; ids hitting the appended zero column.
    rng = np.random.RandomState(1)
    K, T, N = 3, 130, 70001
    tbl = np.concatenate([rng.randn(K, T), np.zeros((K, 1))], 1)
    tbl = tbl.astype(np.float32)
    rid = rng.randint(0, T + 1, N).astype(np.int32)
    out = table_take(jnp.asarray(tbl), jnp.asarray(rid))
    np.testing.assert_array_equal(np.asarray(out), tbl[:, rid])


def test_scatter_methods_agree():
    rng = np.random.RandomState(2)
    K, R, N = 5, 40, 1 << 17
    ids = rng.randint(0, R + 3, N).astype(np.int32)  # some OOB
    vals = rng.randn(K, N).astype(np.float32)
    want = _scatter_ref(ids, vals, R)
    for method in ("scatter", "onehot", "auto"):
        _assert_scatter(scatter_add_by_id(jnp.asarray(ids),
                                          jnp.asarray(vals), R,
                                          method=method), want)


def test_scatter_large_table_windowed():
    """Tables past the one-hot cap: 'auto' takes the scatter lowering;
    coherent ids plus out-of-range strays."""
    rng = np.random.RandomState(7)
    K, R, N = 9, 100000, 1 << 17
    ids = np.sort(rng.randint(0, R, N)).astype(np.int32)
    ids[:: 1000] = -1
    ids[500::1000] = R + 17
    vals = rng.randn(K, N).astype(np.float32)
    _assert_scatter(scatter_add_by_id(jnp.asarray(ids), jnp.asarray(vals),
                                      R), _scatter_ref(ids, vals, R))


def test_scatter_row_blocked():
    """One-hot at its row cap with several pixel chunks and a dead
    (all-zero) stretch."""
    rng = np.random.RandomState(11)
    K, R, N = 5, 16384, 3 * (1 << 15) + 123
    ids = np.sort(rng.randint(0, R, N)).astype(np.int32)
    ids[::777] = -3
    ids[300::777] = R + 5
    vals = rng.randn(K, N).astype(np.float32)
    vals[:, 1000:9000] = 0.0
    got = scatter_add_by_id(jnp.asarray(ids), jnp.asarray(vals), R,
                            method="onehot")
    _assert_scatter(got, _scatter_ref(ids, vals, R))


def test_scatter_incoherent_ids_windowed():
    rng = np.random.RandomState(8)
    K, R, N = 3, 50000, 1 << 17
    ids = rng.randint(0, R, N).astype(np.int32)  # fully random
    vals = rng.randn(K, N).astype(np.float32)
    _assert_scatter(scatter_add_by_id(jnp.asarray(ids), jnp.asarray(vals),
                                      R), _scatter_ref(ids, vals, R))


def test_fused_rasterizer_parity_interpret():
    """The binned kernel (interpret) matches the XLA path on a mesh
    exercising clipping, batching, and derivative outputs."""
    rng = np.random.RandomState(3)
    V, T = 40, 30
    pos = rng.uniform(-1, 1, (2, V, 4)).astype(np.float32)
    pos[..., 3] = rng.uniform(0.5, 2.0, (2, V))
    pos[0, :5, 3] = -0.3  # vertices behind the near plane -> clip path
    tri = rng.randint(0, V, (T, 3)).astype(np.int32)

    r_x, db_x = dr.rasterize(None, jnp.asarray(pos), jnp.asarray(tri),
                             (48, 80), impl="xla")
    r_p, db_p = dr.rasterize(None, jnp.asarray(pos), jnp.asarray(tri),
                             (48, 80), impl="triton_interpret")
    np.testing.assert_allclose(np.asarray(r_x), np.asarray(r_p), atol=1e-5)
    np.testing.assert_allclose(np.asarray(db_x), np.asarray(db_p), atol=1e-5)


def test_fused_rasterizer_range_mode_and_peel_interpret():
    pos = jnp.asarray(
        [[-0.5, -0.5, 0.5, 1.0], [0.5, -0.5, 0.5, 1.0], [0.0, 0.5, 0.5, 1.0],
         [-0.5, -0.5, -0.5, 1.0], [0.5, -0.5, -0.5, 1.0],
         [0.0, 0.5, -0.5, 1.0]], jnp.float32)
    tri = jnp.asarray([[0, 1, 2], [3, 4, 5]], jnp.int32)
    ranges = jnp.asarray([[0, 2], [1, 1]], jnp.int32)
    r_x, _ = dr.rasterize(None, pos, tri, (32, 32), ranges=ranges, impl="xla")
    r_p, _ = dr.rasterize(None, pos, tri, (32, 32), ranges=ranges,
                          impl="triton_interpret")
    np.testing.assert_allclose(np.asarray(r_x), np.asarray(r_p), atol=1e-5)

    posb = pos[None]
    outs = {}
    for impl in ("xla", "triton_interpret"):
        with dr.DepthPeeler(dr.RasterizeCudaContext(), posb, tri, (32, 32),
                            impl=impl) as peeler:
            r1, _ = peeler.rasterize_next_layer()
            r2, _ = peeler.rasterize_next_layer()
        outs[impl] = (np.asarray(r1), np.asarray(r2))
    for i in range(2):
        np.testing.assert_allclose(outs["xla"][i], outs["triton_interpret"][i],
                                   atol=1e-5)
