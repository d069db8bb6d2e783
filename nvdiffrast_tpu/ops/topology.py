"""Mesh topology: opposite-vertex table construction.

Replacement for the reference's GPU edge-vertex hash
(csrc/common/antialias.cu:45-160). Instead of a Jenkins-mix hash built
with atomicCAS, we sort all 3T directed edges lexicographically by
their canonical (vmin, vmax) key and extract, per edge group, the
first two *distinct* opposing vertices — the same information the
reference hash stores (up to 2 opposing vertices per edge, used for
silhouette classification), but fully deterministic and jit-friendly.

For each triangle t and local edge e (e=0: {v1,v2} opp v0; e=1:
{v2,v0} opp v1; e=2: {v0,v1} opp v2 — matching the find calls at
antialias.cu:275-277), the table entry op[t, e] is the opposing vertex
of the *other* triangle sharing that edge, or -1 when the edge is a
boundary/silhouette candidate.
"""

import jax
import jax.numpy as jnp


def build_opposite_table(tri, num_vertices=None):
    """Compute op[T, 3] opposing-vertex indices (-1 = none).

    Args:
      tri: [T, 3] int32 triangle vertex indices.
      num_vertices: optional count for corrupt-index rejection.

    Returns:
      [T, 3] int32.
    """
    tri = jnp.asarray(tri, jnp.int32)
    T = tri.shape[0]
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]

    # Mirror the mesh kernel's rejection rules (antialias.cu:145-155).
    ok = (v0 != v1) & (v1 != v2) & (v2 != v0)
    ok &= (v0 >= 0) & (v1 >= 0) & (v2 >= 0)
    if num_vertices is not None:
        nv = jnp.int32(num_vertices)
        ok &= (v0 < nv) & (v1 < nv) & (v2 < nv)

    # Directed edge slots: slot = 3*t + e.
    ea = jnp.stack([v1, v2, v0], axis=1).reshape(-1)  # edge endpoint a
    eb = jnp.stack([v2, v0, v1], axis=1).reshape(-1)  # edge endpoint b
    vn = jnp.stack([v0, v1, v2], axis=1).reshape(-1)  # own opposing vertex
    okf = jnp.repeat(ok, 3)

    kmin = jnp.minimum(ea, eb)
    kmax = jnp.maximum(ea, eb)
    # Invalid slots get a sentinel key that groups them at the end.
    big = jnp.int32(2147483647)
    kmin = jnp.where(okf, kmin, big)
    kmax = jnp.where(okf, kmax, big)

    n = 3 * T
    slot = jnp.arange(n, dtype=jnp.int32)
    kmin_s, kmax_s, vn_s, ok_s, slot_s = jax.lax.sort(
        (kmin, kmax, vn, okf.astype(jnp.int32), slot), num_keys=3)

    idx = jnp.arange(n, dtype=jnp.int32)
    new_group = jnp.concatenate([
        jnp.ones((1,), bool),
        (kmin_s[1:] != kmin_s[:-1]) | (kmax_s[1:] != kmax_s[:-1])])
    gid = jnp.cumsum(new_group.astype(jnp.int32)) - 1  # [n]

    # Group start index via running max of flagged positions.
    start = jax.lax.associative_scan(jnp.maximum, jnp.where(new_group, idx, 0))
    p0 = vn_s[start]  # smallest opposing vertex in the group

    # First index within the group whose vn differs from p0: since the
    # group is sorted by vn, it sits at start + count(vn == p0).
    eq0 = (vn_s == p0).astype(jnp.int32)
    n_eq0 = jax.ops.segment_sum(eq0, gid, num_segments=n)
    gsize = jax.ops.segment_sum(jnp.ones_like(eq0), gid, num_segments=n)
    p1_pos = start + n_eq0[gid]
    has_p1 = p1_pos < start + gsize[gid]
    p1 = jnp.where(has_p1, vn_s[jnp.minimum(p1_pos, n - 1)], -1)

    # The stored pair is (p0, p1); resolve each slot's query:
    # return the partner that is not our own opposing vertex.
    op = jnp.where(p0 == vn_s, p1, jnp.where(p1 == vn_s, p0, -1))
    op = jnp.where(ok_s.astype(bool), op, -1)

    table = jnp.zeros((n,), jnp.int32).at[slot_s].set(op)
    return table.reshape(T, 3)
