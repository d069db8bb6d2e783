"""Watertight rasterization: shared mesh edges cover pixels exactly once.

The rasterizer normalizes winding by the sign of the homogeneous area
form and applies an exclusive tie rule for pixels exactly on an edge
(binning.build_records, rasterize._tie_bits). A mesh edge shared by two triangles
evaluates to bitwise-opposite edge functions on the two sides, so every
pixel is claimed by exactly one triangle — the reference achieves the
same with fixed-point snap + integer edge functions
(cudaraster/impl/Util.inl:214-309, TriangleSetup.inl:11-38).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nvdiffrast_tpu.ops.rasterize import rasterize


def _coverage_per_tri(pos, tri, res, impl="auto"):
    """Rasterize each triangle as its own mesh -> [T, H, W] masks."""
    masks = []
    for t in range(tri.shape[0]):
        rast, _ = rasterize(None, pos, tri[t:t + 1], res, impl=impl)
        masks.append(np.asarray(rast[0, ..., 3]) > 0)
    return np.stack(masks)


def _fan(n, rng, center=(0.0, 0.0)):
    """Open triangle fan (wedge <= pi): union is a convex polygon, and
    adjacent triangles share the spoke edges (center, ring_k)."""
    base = rng.uniform(0, 2 * np.pi)
    angles = base + np.sort(rng.uniform(0, np.pi, n + 1))
    radius = rng.uniform(0.4, 0.9)
    cx, cy = center
    ring = np.stack([cx + radius * np.cos(angles),
                     cy + radius * np.sin(angles)], axis=1)
    verts = np.concatenate([[[cx, cy]], ring], axis=0)
    tri = np.stack([np.zeros(n, np.int32),
                    np.arange(1, n + 1, dtype=np.int32),
                    np.arange(2, n + 2, dtype=np.int32)], axis=1)
    poly = np.concatenate([[[cx, cy]], ring], axis=0)  # ccw closed ring
    return verts.astype(np.float32), tri, poly, (cx, cy, radius)


def _strictly_inside(px, py, poly, margin):
    """Point strictly inside the convex polygon (ccw ring) by margin."""
    inside = np.ones(px.shape, bool)
    n = len(poly)
    for i in range(n):
        ax, ay = poly[i]
        bx, by = poly[(i + 1) % n]
        e = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        nrm = np.hypot(bx - ax, by - ay)
        inside &= e > margin * nrm
    return inside


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("res", [(64, 64), (67, 93)])
def test_fan_watertight(seed, res):
    rng = np.random.RandomState(seed)
    verts2, tri, ring, _ = _fan(7, rng)
    H, W = res
    pos = jnp.asarray(np.concatenate(
        [verts2, np.zeros((len(verts2), 1), np.float32),
         np.ones((len(verts2), 1), np.float32)], axis=1)[None])
    tri = jnp.asarray(tri)

    masks = _coverage_per_tri(pos, tri, res)
    total = masks.sum(axis=0)

    # No pixel is claimed by two triangles (shared-edge exclusivity) --
    # fan triangles only overlap along shared edges.
    assert total.max() <= 1, "double-covered pixels on shared edges"

    # Every pixel strictly inside the fan polygon is covered.
    xs = (np.arange(W) + 0.5) / W * 2 - 1
    ys = (np.arange(H) + 0.5) / H * 2 - 1
    px, py = np.meshgrid(xs, ys)
    inside = _strictly_inside(px, py, ring, margin=4.0 / min(H, W))
    assert (total[inside] == 1).all(), "dropped pixels inside the fan"

    # The full-mesh render covers exactly the union.
    rast, _ = rasterize(None, pos, tri, res)
    union = np.asarray(rast[0, ..., 3]) > 0
    np.testing.assert_array_equal(union, total.astype(bool))


def test_pixel_center_edges_exact():
    """Shared edges passing exactly through pixel centers: the tie rule
    must hand each on-edge pixel to exactly one triangle."""
    H = W = 32
    # Clip coords of the exact center column/row of the pixel grid
    # (pixel k center at (k + 0.5)/W * 2 - 1; pick k = W/2 -> x = 1/W).
    x0 = 1.0 / W
    y0 = 1.0 / H
    # Quad split along the vertical line x = x0 (through pixel centers)
    # and again along the horizontal line y = y0.
    quad = np.array([
        [-0.9, -0.9], [x0, -0.9], [0.9, -0.9],
        [-0.9, y0], [x0, y0], [0.9, y0],
        [-0.9, 0.9], [x0, 0.9], [0.9, 0.9]], np.float32)
    tris = []
    for r in range(2):
        for c in range(2):
            a = 3 * r + c
            tris += [[a, a + 1, a + 4], [a, a + 4, a + 3]]
    tri = jnp.asarray(np.asarray(tris, np.int32))
    pos = jnp.asarray(np.concatenate(
        [quad, np.zeros((9, 1), np.float32), np.ones((9, 1), np.float32)],
        axis=1)[None])

    masks = _coverage_per_tri(pos, tri, (H, W))
    total = masks.sum(axis=0)
    assert total.max() <= 1
    # Everything strictly inside the outer quad is covered exactly once,
    # including the pixel-center rows/columns on the interior edges.
    xs = (np.arange(W) + 0.5) / W * 2 - 1
    ys = (np.arange(H) + 0.5) / H * 2 - 1
    px, py = np.meshgrid(xs, ys)
    inside = ((px > -0.9 + 0.1 / W) & (px < 0.9 - 0.1 / W)
              & (py > -0.9 + 0.1 / H) & (py < 0.9 - 0.1 / H))
    assert (total[inside] == 1).all()


def test_winding_invariance():
    """CW and CCW windings render identically (reference renders both:
    torch_rasterize.cpp:94, TriangleSetup.inl:130-137)."""
    rng = np.random.RandomState(3)
    verts2, tri_np, _, _ = _fan(6, rng)
    pos = jnp.asarray(np.concatenate(
        [verts2, np.zeros((len(verts2), 1), np.float32),
         np.ones((len(verts2), 1), np.float32)], axis=1)[None])
    tri_ccw = jnp.asarray(tri_np)
    tri_cw = jnp.asarray(tri_np[:, ::-1].copy())
    r1, db1 = rasterize(None, pos, tri_ccw, (48, 48))
    r2, db2 = rasterize(None, pos, tri_cw, (48, 48))
    np.testing.assert_array_equal(np.asarray(r1[..., 3]),
                                  np.asarray(r2[..., 3]))
    # Barycentrics differ by vertex permutation: u' = v, v' = u is NOT
    # the permutation here (reversal swaps v1<->v2 keeping v0... no:
    # (0,1,2)->(2,1,0)). Check u+v+w partition is preserved instead.
    b1 = np.asarray(r1[..., :2])
    b2 = np.asarray(r2[..., :2])
    # reversed tri (2,1,0): new b0 (for old v2) = old 1-u-v, new b1 = old v.
    np.testing.assert_allclose(b2[..., 1], b1[..., 1], atol=1e-5)
    cov = np.asarray(r1[..., 3]) > 0
    np.testing.assert_allclose((1 - b1[..., 0] - b1[..., 1])[cov],
                               b2[..., 0][cov], atol=1e-5)
    np.testing.assert_allclose(np.asarray(r1[..., 2]), np.asarray(r2[..., 2]),
                               atol=1e-6)


def test_watertight_pallas_xla_identical():
    """Binned kernel and XLA path produce bit-identical ID buffers on
    adjacency meshes."""
    rng = np.random.RandomState(5)
    verts2, tri_np, _, _ = _fan(9, rng)
    pos = jnp.asarray(np.concatenate(
        [verts2, np.zeros((len(verts2), 1), np.float32),
         np.ones((len(verts2), 1), np.float32)], axis=1)[None])
    tri = jnp.asarray(tri_np)
    for res in [(48, 64), (67, 130)]:
        rx, _ = rasterize(None, pos, tri, res, impl="xla")
        rp, _ = rasterize(None, pos, tri, res, impl="triton_interpret")
        np.testing.assert_array_equal(np.asarray(rx[..., 3]),
                                      np.asarray(rp[..., 3]))


def _nearclip_scene(rot90=False):
    """Two triangles sharing edge A-B where B lies behind the w = eps
    near plane. The visible part of the shared edge is the ray from
    projected A toward the clip intersection's direction — interior to
    the union, so it must be crack-free and single-covered."""
    A = [0.0, -0.6, 0.0, 1.0]
    B = [0.05, 0.9, -0.2, -0.4]   # w < eps: clipped
    C1 = [-0.9, 0.2, 0.0, 1.3]
    C2 = [0.8, 0.3, -0.1, 0.8]
    verts = np.array([A, B, C1, C2], np.float32)
    if rot90:
        verts = verts[:, [1, 0, 2, 3]] * np.float32([1, -1, 1, 1])
    # Manifold winding: edge A->B in tri 0, B->A in tri 1.
    tri = np.array([[0, 1, 2], [1, 0, 3]], np.int32)
    return jnp.asarray(verts[None]), jnp.asarray(tri)


def _assert_watertight(masks):
    """Single cover + no cracks on the shared boundary of two masks."""
    total = masks.sum(axis=0)
    # Both wedges are visible and meet inside the viewport.
    assert masks[0].sum() > 50 and masks[1].sum() > 50
    assert total.max() <= 1, "double cover along the clipped shared edge"

    # Crack detection: an uncovered pixel whose two neighbors (along
    # either axis) belong to DIFFERENT triangles is a hole on the
    # shared boundary.
    m0, m1 = masks[0], masks[1]
    hole = ~(m0 | m1)
    for ax in (0, 1):
        def sh(m, d):
            return np.roll(m, d, axis=ax)
        crack = hole & ((sh(m0, 1) & sh(m1, -1)) | (sh(m1, 1) & sh(m0, -1)))
        # Exclude image borders where roll wraps.
        if ax == 0:
            crack[0, :] = crack[-1, :] = False
        else:
            crack[:, 0] = crack[:, -1] = False
        assert not crack.any(), f"crack along axis {ax} on the shared edge"
    return total


@pytest.mark.parametrize("rot90", [False, True])
@pytest.mark.parametrize("res", [(96, 96), (63, 101)])
def test_nearclip_shared_edge_watertight(rot90, res):
    """Watertightness across the near-clip boundary: adjacent triangles
    whose shared edge crosses w = eps claim every pixel along the
    clipped shared boundary exactly once, in BOTH implementations.
    Holds because the clipper's canonical rotation always evaluates
    isect(inside_vertex, outside_vertex) in that argument order, so both
    triangles compute a bitwise-identical intersection point
    (binning.near_clip_cols), and shared-edge coefficients are
    exact IEEE negations.

    Cross-impl id buffers may differ by ulp-level coverage flips on the
    *clip-cut silhouette* (the w = eps cut edge belongs to one triangle
    only, so a 1-ulp edge-function difference between the two compiled
    programs legally flips a boundary pixel in/out); such pixels must be
    rare and lie on the coverage boundary.
    """
    pos, tri = _nearclip_scene(rot90)

    for impl in ("xla", "triton_interpret"):
        masks = _coverage_per_tri(pos, tri, res, impl=impl)
        total = _assert_watertight(masks)
        # Full-mesh render covers exactly the union.
        r, _ = rasterize(None, pos, tri, res, impl=impl)
        union = np.asarray(r[0, ..., 3]) > 0
        np.testing.assert_array_equal(union, total.astype(bool))
        if impl == "xla":
            ix = np.asarray(r[0, ..., 3])
        else:
            ip = np.asarray(r[0, ..., 3])

    # Cross-impl: identical up to <= 2 silhouette-boundary pixels.
    diff = ix != ip
    assert diff.sum() <= 2, f"{diff.sum()} differing pixels"
    if diff.any():
        cov = ix > 0
        edge = np.zeros_like(cov)
        edge[1:] |= cov[1:] != cov[:-1]
        edge[:-1] |= cov[:-1] != cov[1:]
        edge[:, 1:] |= cov[:, 1:] != cov[:, :-1]
        edge[:, :-1] |= cov[:, :-1] != cov[:, 1:]
        assert (diff <= edge).all(), "interior pixels differ between impls"


@pytest.mark.parametrize("impl", ["xla", "triton_interpret"])
def test_degenerate_triangle_covers_nothing(impl):
    """Exactly-degenerate triangles (duplicate vertex / collinear) must
    shade no pixels, even though f32 noise can leave their area form pD
    within +-1 ulp of zero instead of exactly 0. Their opposed edge
    rows are exact IEEE negations, so the exclusive tie rule empties
    the coverage set — PROVIDED the winding sign po is one consistent
    value across all record rows (the optimization_barrier in
    binning.build_records, which both routes read; without it XLA's per-site
    FMA contraction of pD can flip po between rows on these triangles,
    turning the record into garbage half-planes). Reference culls
    zero-area triangles after fixed-point snap
    (cudaraster/impl/TriangleSetup.inl:130-137)."""
    rng = np.random.RandomState(7)
    # Vertices at awkward (non-representable) coordinates; w varies so
    # the products in pD genuinely round.
    v = rng.randn(8, 2).astype(np.float32) * 0.7
    w = (1.0 + np.abs(rng.randn(8)) * 0.5).astype(np.float32)
    pos = np.concatenate(
        [v * w[:, None], np.zeros((8, 1), np.float32), w[:, None]],
        axis=1)
    # Duplicate-vertex degenerates plus a collinear one (v6 is the
    # midpoint of v4, v5 in clip space => zero area).
    pos[6] = 0.5 * (pos[4] + pos[5])
    tri = np.array([[0, 0, 1], [2, 3, 3], [4, 6, 5], [1, 1, 1]], np.int32)
    rast, _ = rasterize(None, jnp.asarray(pos[None]), jnp.asarray(tri),
                        (64, 64), impl=impl)
    cov = np.asarray(rast[0, ..., 3])
    assert (cov == 0).all(), f"{(cov != 0).sum()} pixels shaded by degenerates"


def test_shared_edge_exact_negation():
    """The foundation of the fill rule: the two sides of a shared mesh
    edge get bitwise-negated edge coefficients. The naive j,k-order
    expression loses this under backend fma contraction of
    fl(a*b) - fl(c*d) (~30% of opposed pairs off by 1 ulp on XLA:CPU);
    _edge_coeffs computes each coefficient in canonical value order
    with the sign applied last, which is contraction-proof."""
    import jax

    from nvdiffrast_tpu.ops import binning
    from nvdiffrast_tpu.ops.rasterize import _edge_coeffs

    rng = np.random.RandomState(3)
    T, V = 2000, 700
    pos = rng.randn(V, 4).astype(np.float32)
    tri_a = rng.randint(0, V, (T, 3)).astype(np.int32)
    # B shares A's edge (v1, v2), traversed in the opposite direction.
    tri_b = np.stack([rng.randint(0, V, (T,)).astype(np.int32),
                      tri_a[:, 2], tri_a[:, 1]], axis=1)
    tv_a = jnp.asarray(pos)[jnp.asarray(tri_a)]
    tv_b = jnp.asarray(pos)[jnp.asarray(tri_b)]
    ea, eb = jax.jit(lambda a, b: (_edge_coeffs(a), _edge_coeffs(b)))(
        tv_a, tv_b)
    # A's edge 0 is (v1, v2); B's edge 0 is (v2, v1).
    np.testing.assert_array_equal(np.asarray(ea)[:, 0, :],
                                  -np.asarray(eb)[:, 0, :])

    # Channel-major builder: bitwise identical to the tensor form.
    x = tuple(tv_a[:, j, 0] for j in range(3))
    y = tuple(tv_a[:, j, 1] for j in range(3))
    w = tuple(tv_a[:, j, 3] for j in range(3))
    ec = jax.jit(binning.edge_coeffs_cols)(x, y, w)
    et = np.asarray(ea)
    for k in range(3):
        for c in range(3):
            np.testing.assert_array_equal(np.asarray(ec[k][c]), et[:, k, c])
