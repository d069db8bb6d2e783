"""Multi-chip scaling: device meshes and sharded rendering.

The reference is single-GPU-per-op (SURVEY.md section 2.6); this module
adds ``jax.sharding.Mesh`` scaling over several devices: minibatch
sharded over the data-parallel axis and image rows over the spatial
axis, vertex/texture gradients all-reduced by XLA-inserted collectives.
"""

from .mesh import make_mesh, default_mesh
from .shard import (
    render_shardings,
    shard_pipeline,
    sharded_train_step,
    shard_map_train_step,
)
from .spatial import antialias_sp, make_sp_render
from . import multihost

__all__ = [
    "make_mesh",
    "default_mesh",
    "render_shardings",
    "shard_pipeline",
    "sharded_train_step",
    "shard_map_train_step",
    "antialias_sp",
    "make_sp_render",
    "multihost",
]
