"""Pixel -> table gradient reductions.

The reference accumulates per-pixel gradients into per-vertex/texel
buffers with coalesced float atomics (csrc/common/common.h:198-260).
Two XLA formulations are kept here:

* ``onehot``: a chunked one-hot matrix product, float32 accumulation
  with exact 0/1 weights in a fixed order — deterministic. Its work
  grows with N x rows, so it serves small tables only.
* ``scatter``: ``.at[].add``. On a GPU XLA lowers it to float atomics,
  whose summation order (and so the last bits) can change from run to
  run.

Layout rule: per-pixel values travel channel-major ([K, N], pixel axis
minormost), the layout every producer in ``ops/`` emits.
"""

import jax
import jax.numpy as jnp

# 'auto' rule: the one-hot product is O(N * R), so it is kept to small
# tables fed by many values. Neither these thresholds nor the row fold
# below (up to 128 product columns) has been measured on a GPU; they
# are carried over from an earlier matrix-unit design, and choosing the
# GPU reduction is ROADMAP A4/B2.
_ONEHOT_MAX_ROWS = 16384
_CHUNK = 1 << 15


def scatter_add_by_id(ids, vals_t, num_rows, method="auto"):
    """out[r, k] = sum over i with ids[i] == r of vals_t[k, i].

    Args:
      ids: [N] int32 row ids; out-of-range ids are dropped.
      vals_t: [K, N] float32, channel-major.
      num_rows: R, static.
      method: 'auto' | 'onehot' | 'scatter'. 'auto' takes 'onehot' for
        tables of at most 16384 rows fed by at least 131072 values.

    Returns:
      [R, K] float32.
    """
    K, N = vals_t.shape
    if method == "auto":
        method = ("onehot" if num_rows <= _ONEHOT_MAX_ROWS
                  and N >= 4 * _CHUNK else "scatter")
    if method not in ("onehot", "scatter"):
        raise ValueError(f"scatter_add_by_id: unknown method {method!r}")

    if method == "scatter":
        safe = jnp.where((ids >= 0) & (ids < num_rows), ids, num_rows)
        return jnp.zeros((num_rows, K), jnp.float32).at[safe].add(
            vals_t.T, mode="drop")

    # Chunked one-hot product (f32 accumulate, deterministic). Row
    # folding: F consecutive table rows share one one-hot column
    # (out[q, f*K+k] for row q*F+f), F times fewer one-hot columns at
    # the cost of F-expanded value rows (F unmeasured on a GPU, above).
    F = 1
    while (F * 2 * K <= 128) and (F < 8):
        F *= 2
    Rf = -(-num_rows // F) * F
    QR = Rf // F

    n_chunks = -(-N // _CHUNK)
    Np = n_chunks * _CHUNK
    if Np != N:
        ids = jnp.pad(ids, (0, Np - N), constant_values=-1)
        vals_t = jnp.pad(vals_t, ((0, 0), (0, Np - N)))
    # Out-of-range ids -> an id whose q is out of range (dropped).
    ids = jnp.where((ids >= 0) & (ids < num_rows), ids, Rf)
    # Materialize the values: fused into the loop's dynamic slice, their
    # producer would be compiled F-fold into the loop body.
    vals_t = jax.lax.optimization_barrier(vals_t)
    row_ids = jnp.arange(QR, dtype=ids.dtype)

    def body(i, acc):
        idc = jax.lax.dynamic_slice(ids, (i * _CHUNK,), (_CHUNK,))
        vc = jax.lax.dynamic_slice(vals_t, (0, i * _CHUNK), (K, _CHUNK))
        q = idc // F
        s = idc % F
        oh = (q[:, None] == row_ids[None, :]).astype(jnp.float32)
        if F > 1:
            vc = jnp.concatenate(
                [jnp.where(s[None, :] == f, vc, 0.0) for f in range(F)],
                axis=0)  # [F*K, CHUNK]
        # out[qr, fk] = sum_p oh[p, qr] * vc[fk, p]; HIGHEST keeps the
        # float32 values out of TF32 on a GPU.
        return acc + jax.lax.dot_general(
            oh, vc, dimension_numbers=(((0,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)

    acc0 = jnp.zeros((QR, F * K), jnp.float32)
    out = jax.lax.fori_loop(0, n_chunks, body, acc0)
    return out.reshape(Rf, K)[:num_rows]
