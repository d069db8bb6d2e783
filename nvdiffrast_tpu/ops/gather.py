"""Per-pixel table lookups (the pipeline's universal primitive).

Every op's per-pixel stage starts by fetching a per-triangle record by
the pixel's triangle id (the reference does this as raw per-thread
loads, e.g. csrc/common/interpolate.cu:30-36). Here the lookup is one
``jnp.take`` on a channel-major table: on a GPU, XLA emits it as a
plain gather that reads the table through L2 and fuses into its
consumers.
"""

import jax.numpy as jnp


def table_take(tbl_t, rid):
    """out[k, i] = tbl_t[k, rid[i]] — channel-major table lookup.

    Args:
      tbl_t: [K, T] float32 table (channel-major). Out-of-range ids
        must point at zero entries the caller appended.
      rid: [N] int32 ids in [0, T).

    Returns:
      [K, N] float32.
    """
    return jnp.take(tbl_t, rid, axis=1)
