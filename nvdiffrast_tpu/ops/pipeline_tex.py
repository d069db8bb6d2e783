"""Rasterize -> interpolate -> texture -> antialias in one call.

``render_pipeline_textured`` renders the reference's textured workload
(earth.py / envphong.py shape, e.g. samples/torch/earth.py:44-61) by
composing the public ops::

    rast, rast_db = rasterize(ctx, pos, tri, res, grad_db=use_mip)
    uv, uv_da = interpolate(uv_attr, rast, uv_tri, rast_db,
                            diff_attrs='all' if use_mip else None)
    color = texture(tex, uv, uv_da=uv_da, filter_mode=..., ...)
    out = antialias(color, rast, pos, tri)

with gradients to ``pos``, ``uv_attr`` and ``tex``.
"""

import jax
import jax.numpy as jnp

from .antialias import antialias
from .interpolate import interpolate
from .rasterize import rasterize
from .texture import texture


def render_pipeline_textured(pos, tri, uv_attr, tex, resolution,
                             uv_tri=None, filter_mode="linear-mipmap-linear",
                             boundary_mode="wrap", max_mip_level=-1,
                             pos_gradient_boost=1.0, topology_hash=None,
                             impl="auto"):
    """Render rasterize + uv-interpolate + texture + antialias.

    Args:
      pos: [B, V, 4] clip-space positions.
      tri: [T, 3] int32.
      uv_attr: [Vu, 2] (or [1, Vu, 2]) texture coordinates — or
        [Vu, 3] direction vectors for boundary_mode='cube'.
      tex: [D, th, tw, C] texture, or [D, 6, fw, fw, C] cube map
        (D == 1 or B).
      resolution: (H, W).
      uv_tri: [T, 3] int32 uv indices (defaults to `tri`).
      filter_mode / boundary_mode / max_mip_level: as in `texture`
        (max_mip_level=-1 builds the full pyramid).
      pos_gradient_boost: antialias position-gradient multiplier.
      topology_hash: optional `TopologyHashWrapper` (from
        `antialias_construct_topology_hash`) so a static mesh's
        opposite-vertex table is not rebuilt every step.
      impl: coverage route of `rasterize`.

    Returns:
      [B, H, W, C] antialiased textured image.
    """
    uv_tri = tri if uv_tri is None else uv_tri
    use_mip = "mipmap" in filter_mode
    with jax.named_scope("nvdiffrast.render_pipeline_textured"):
        rast, rast_db = rasterize(None, pos, tri, resolution,
                                  grad_db=use_mip, impl=impl)
        uv, uv_da = interpolate(uv_attr, rast, uv_tri, rast_db,
                                diff_attrs="all" if use_mip else None)
        img = texture(jnp.asarray(tex, jnp.float32), uv,
                      uv_da=uv_da if use_mip else None,
                      filter_mode=filter_mode, boundary_mode=boundary_mode,
                      max_mip_level=None if max_mip_level < 0
                      else max_mip_level)
        return antialias(img, rast, pos, tri, topology_hash=topology_hash,
                         pos_gradient_boost=pos_gradient_boost)
