"""nvdiffrast_tpu — differentiable rasterization primitives in JAX.

A from-scratch JAX implementation of the four modular differentiable
rendering primitives popularized by nvdiffrast (rasterize,
interpolate, texture, antialias):

* no atomics in coverage — one owner per pixel, deterministic
  lexicographic depth/id merges; a binned Pallas kernel on GPUs,
* static shapes everywhere (jit friendly),
* multi-device scaling via ``jax.sharding`` meshes (see
  :mod:`nvdiffrast_tpu.parallel`).

Public API mirrors the reference's ``nvdiffrast.torch`` surface
(reference: nvdiffrast/torch/__init__.py:9-10).
"""

__version__ = "0.1.0"

from .ops.rasterize import rasterize, DepthPeeler, RasterizeCudaContext, RasterizeGLContext
from .ops.interpolate import interpolate
from .ops.texture import texture, texture_construct_mip, TextureMipWrapper
from .ops.antialias import antialias, antialias_construct_topology_hash, TopologyHashWrapper
from .ops.pipeline import render_pipeline
from .ops.pipeline_tex import render_pipeline_textured
from .ops.coord import triidx_to_float, float_to_triidx
from .utils.log import get_log_level, set_log_level

__all__ = [
    "__version__",
    "RasterizeCudaContext",
    "RasterizeGLContext",
    "rasterize",
    "DepthPeeler",
    "interpolate",
    "texture",
    "texture_construct_mip",
    "TextureMipWrapper",
    "antialias",
    "antialias_construct_topology_hash",
    "TopologyHashWrapper",
    "render_pipeline",
    "render_pipeline_textured",
    "triidx_to_float",
    "float_to_triidx",
    "get_log_level",
    "set_log_level",
]
