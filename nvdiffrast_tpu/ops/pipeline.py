"""Rasterize -> interpolate -> antialias in one call.

``render_pipeline`` renders the standard 3-op chain of the reference
samples (e.g. samples/torch/cube.py:27-32) by composing the public
ops::

    rast, _ = rasterize(None, pos, tri, resolution, grad_db=False)
    color, _ = interpolate(attr, rast, attr_idx or tri)
    out = antialias(color, rast, pos, tri, topology_hash,
                    pos_gradient_boost)

Gradients flow to ``pos`` (rasterize + antialias, with
``pos_gradient_boost`` on the antialias part) and ``attr``. Under
``jit`` XLA fuses across the op boundaries; whether a hand-fused
kernel would pay on top of that is an open measurement.
"""

import jax
import jax.numpy as jnp

from .antialias import TopologyHashWrapper, antialias
from .interpolate import interpolate
from .rasterize import rasterize
from .topology import build_opposite_table


def render_pipeline(pos, tri, attr, resolution, attr_idx=None,
                    topology_hash=None, pos_gradient_boost=1.0,
                    impl="auto"):
    """Render rasterize + interpolate + antialias.

    Args:
        pos: [minibatch, num_vertices, 4] clip-space positions.
        tri: [num_triangles, 3] int32.
        attr: [minibatch or 1, num_vertices_attr, A] or
            [num_vertices_attr, A] vertex attributes.
        resolution: (height, width).
        attr_idx: triangle tensor for the attribute topology (defaults
            to `tri`; must have the same number of triangles).
        topology_hash: optional TopologyHashWrapper for `tri`.
        pos_gradient_boost: multiplier for the antialias position
            gradients (reference: nvdiffrast/torch/ops.py:484-485).
        impl: coverage route of `rasterize`.

    Returns:
        Antialiased color image [minibatch, height, width, A].
    """
    tri = jnp.asarray(tri, jnp.int32)
    atri = tri if attr_idx is None else jnp.asarray(attr_idx, jnp.int32)
    if atri.shape[0] != tri.shape[0]:
        raise ValueError(
            f"render_pipeline: attr_idx triangle count {atri.shape[0]} "
            f"must match tri {tri.shape[0]}")
    if topology_hash is None:
        topology_hash = TopologyHashWrapper(build_opposite_table(tri))

    with jax.named_scope("nvdiffrast.render_pipeline"):
        rast, _ = rasterize(None, pos, tri, resolution, grad_db=False,
                            impl=impl)
        color, _ = interpolate(attr, rast, atri)
        return antialias(color, rast, pos, tri, topology_hash=topology_hash,
                         pos_gradient_boost=pos_gradient_boost)
