"""The binned coverage kernel (interpret mode) and its binning prepass.

Edge cases of the per-tile walk — empty tiles, a tile whose segment
spans several record groups, range mode, depth peeling, viewport bands,
other tile sizes — against the XLA scan, plus the CSR layout against a
brute-force AABB/tile overlap and the coverage-route choice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nvdiffrast_tpu as dr
from nvdiffrast_tpu.ops import binning
from nvdiffrast_tpu.ops import rasterize as R
from nvdiffrast_tpu.ops.coverage_kernel import coverage_binned


def _flat_tris(centers, size, z):
    """Small screen-space triangles (w = 1) at the given clip centers."""
    c = np.asarray(centers, np.float32)
    T = len(c)
    pos = np.zeros((1, 3 * T, 4), np.float32)
    pos[0, 0::3, :2] = c + [-size, -size]
    pos[0, 1::3, :2] = c + [size, -size]
    pos[0, 2::3, :2] = c + [0.0, size]
    pos[0, :, 2] = np.repeat(np.asarray(z, np.float32), 3)
    pos[0, :, 3] = 1.0
    return jnp.asarray(pos), jnp.asarray(np.arange(3 * T, dtype=np.int32)
                                         .reshape(T, 3))


def _both(pos, tri, res, **kw):
    out = [np.asarray(dr.rasterize(None, pos, tri, res, impl=impl, **kw)[0])
           for impl in ("xla", "triton_interpret")]
    return out


def test_kernel_empty_tiles():
    """One triangle in a corner: every other tile has empty segments
    and must write -1 / +inf."""
    pos, tri = _flat_tris([[-0.8, -0.8]], 0.1, [0.0])
    res = (64, 96)
    ranges = jnp.array([[0, 1]], jnp.int32)
    idbuf, zbuf = coverage_binned(pos, tri, res, ranges, interpret=True)
    idx, zx = R._coverage(pos, tri, res, ranges, None, 64, "xla")
    np.testing.assert_array_equal(np.asarray(idbuf), np.asarray(idx))
    covered = np.asarray(idbuf) >= 0
    assert 0 < covered.sum() < 200
    assert np.isinf(np.asarray(zbuf)[~covered]).all()
    np.testing.assert_array_equal(np.asarray(zbuf), np.asarray(zx))


def test_kernel_segment_spans_groups():
    """40 overlapping triangles inside one 32x32 tile: its own segment
    holds several GROUP-record groups, walked in order with the depth
    test deciding."""
    rng = np.random.RandomState(0)
    centers = rng.uniform(-0.9, -0.6, (40, 2))
    pos, tri = _flat_tris(centers, 0.05, rng.uniform(-0.9, 0.9, 40))
    res = (64, 64)
    rec_cm, clip, valid, slop = binning.build_records(pos, tri)
    aabb = binning.aabb_cols(jax.tree.map(lambda a: a[0], clip), valid[0],
                             slop[0], 64, 64, 0, 64)
    _, _, gstart, gcnt = binning.csr_layout(rec_cm[0], aabb, 2, 2, 32, 32)
    assert int(gcnt[0]) >= 3  # tile (0, 0): several groups
    r_x, r_k = _both(pos, tri, res)
    np.testing.assert_array_equal(r_x[..., 3], r_k[..., 3])


def test_kernel_range_mode():
    rng = np.random.RandomState(1)
    pos, tri = _flat_tris(rng.uniform(-0.7, 0.7, (30, 2)), 0.3,
                          rng.uniform(-0.9, 0.9, 30))
    ranges = jnp.asarray([[0, 12], [5, 20], [29, 1]], jnp.int32)
    r_x, r_k = _both(pos[0], tri, (48, 80), ranges=ranges)
    np.testing.assert_array_equal(r_x[..., 3], r_k[..., 3])
    assert (r_x[2, ..., 3] == 0).mean() > 0.5  # only triangle 29 in image 2


def test_kernel_peel_layers():
    rng = np.random.RandomState(2)
    pos, tri = _flat_tris(rng.uniform(-0.5, 0.5, (12, 2)), 0.5,
                          np.linspace(-0.8, 0.8, 12))
    layers = {}
    for impl in ("xla", "triton_interpret"):
        with dr.DepthPeeler(dr.RasterizeCudaContext(), pos, tri, (40, 56),
                            impl=impl) as peeler:
            layers[impl] = [np.asarray(peeler.rasterize_next_layer()[0])
                            for _ in range(4)]
    for a, b in zip(layers["xla"], layers["triton_interpret"]):
        np.testing.assert_array_equal(a[..., 3], b[..., 3])
    assert (layers["xla"][3][..., 3] > 0).any()


def test_kernel_viewport_bands():
    """Bands of a traced y0 (as under shard_map) equal the same rows of
    the full kernel render and of the XLA band render."""
    rng = np.random.RandomState(3)
    pos, tri = _flat_tris(rng.uniform(-0.8, 0.8, (20, 2)), 0.25,
                          rng.uniform(-0.9, 0.9, 20))
    H, W, hb = 96, 64, 24
    full = np.asarray(dr.rasterize(None, pos, tri, (H, W),
                                   impl="triton_interpret")[0])
    band = jax.jit(lambda y0: dr.rasterize(
        None, pos, tri, (hb, W), viewport=(y0, H),
        impl="triton_interpret")[0])
    for b in range(H // hb):
        got = np.asarray(band(jnp.int32(b * hb)))
        rows = full[:, b * hb:(b + 1) * hb]
        np.testing.assert_array_equal(got[..., 3], rows[..., 3])
        # Shading under jit vs eager: equal to an ulp.
        np.testing.assert_allclose(got, rows, atol=1e-6)
        ref, _ = dr.rasterize(None, pos, tri, (hb, W), viewport=(b * hb, H),
                              impl="xla")
        np.testing.assert_array_equal(got[..., 3], np.asarray(ref)[..., 3])


@pytest.mark.parametrize("tile", [(16, 16), (16, 64)])
def test_kernel_tile_sizes_agree(tile):
    rng = np.random.RandomState(4)
    pos, tri = _flat_tris(rng.uniform(-0.9, 0.9, (60, 2)), 0.2,
                          rng.uniform(-0.9, 0.9, 60))
    res = (50, 70)
    ranges = jnp.array([[0, 60]], jnp.int32)
    a = coverage_binned(pos, tri, res, ranges, interpret=True)
    b = coverage_binned(pos, tri, res, ranges, interpret=True, tile=tile)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_csr_layout_covers_every_overlap():
    """Every record whose AABB overlaps a tile is reachable from that
    tile's segments (own, band, global), and every slot's record lies
    in exactly one segment."""
    rng = np.random.RandomState(5)
    S, nty, ntx, th, tw = 300, 3, 4, 16, 16
    x0 = rng.uniform(-5, 70, S)
    y0 = rng.uniform(-5, 50, S)
    ext = rng.exponential(6, (S, 2))
    ok = rng.rand(S) > 0.1
    aabb = (jnp.asarray(x0, jnp.float32), jnp.asarray(y0, jnp.float32),
            jnp.asarray(x0 + ext[:, 0], jnp.float32),
            jnp.asarray(y0 + ext[:, 1], jnp.float32), jnp.asarray(ok))
    rec_cm = jnp.zeros((16, S), jnp.float32).at[15].set(
        jnp.arange(S, dtype=jnp.float32) + 1)
    rec, gaabb, gstart, gcnt = binning.csr_layout(rec_cm, aabb, nty, ntx,
                                                  th, tw)
    ids = np.asarray(rec)[:, 15]
    gstart, gcnt = np.asarray(gstart), np.asarray(gcnt)

    def segment_ids(k):
        lo = gstart[k] * binning.GROUP
        seg = ids[lo:lo + gcnt[k] * binning.GROUP]
        return set(seg[seg < binning.ID_VALID_THRESH].astype(np.int64))

    seen = [segment_ids(k) for k in range(len(gstart))]
    assert sum(len(s) for s in seen) == ok.sum()  # each record once
    for ty in range(nty):
        for tx in range(ntx):
            reach = (seen[ty * ntx + tx] | seen[nty * ntx + ty]
                     | seen[nty * ntx + nty])
            # The kernel's own test: a pixel center of the tile lies
            # inside the box.
            hit = (ok & (x0 <= (tx + 1) * tw - 1) & (x0 + ext[:, 0] >= tx * tw)
                   & (y0 <= (ty + 1) * th - 1) & (y0 + ext[:, 1] >= ty * th))
            assert set(np.nonzero(hit)[0] + 1) <= reach, (ty, tx)
    # Group AABBs bound their records.
    g = np.asarray(gaabb)
    rx0 = np.asarray(aabb[0])
    for slot, rid in enumerate(ids):
        if rid < binning.ID_VALID_THRESH:
            assert g[slot // binning.GROUP, 0] <= rx0[int(rid) - 1]


def test_coverage_route_choice():
    with pytest.raises(ValueError, match="impl"):
        R._use_kernel("pallas")
    assert R._use_kernel("triton_interpret")
    assert not R._use_kernel("xla")
    assert R._use_kernel("auto") == (jax.default_backend() == "gpu")
    with jax.default_device(jax.devices("cpu")[0]):
        assert not R._use_kernel("auto")
