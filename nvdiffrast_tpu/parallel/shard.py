"""Sharded rendering and training steps.

Scaling strategy (SURVEY.md section 7): images are sharded
over the mesh — minibatch on the "dp" axis, image rows (H) on the "sp"
axis — while vertex/triangle data is replicated. Under ``jit`` with
these shardings XLA partitions the per-pixel phases spatially and
inserts collectives (psum) for the vertex/texture gradient
reductions in the backward pass; nothing in the op implementations
needs to change (they are pure, shape-static XLA programs).
"""

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def render_shardings(mesh, dp_axis="dp", sp_axis="sp"):
    """Standard sharding set for the render pipeline.

    Returns dict with NamedShardings:
      image: [B, H, W, C] sharded (dp, sp) on (B, H),
      pos_instanced: [B, V, 4] sharded dp on B,
      replicated: fully replicated.
    """
    return {
        "image": NamedSharding(mesh, P(dp_axis, sp_axis)),
        "pos_instanced": NamedSharding(mesh, P(dp_axis)),
        "replicated": NamedSharding(mesh, P()),
    }


def shard_pipeline(render_fn, mesh, dp_axis="dp", sp_axis="sp",
                   donate_argnums=()):
    """jit a render function with image outputs sharded over the mesh.

    `render_fn(pos, tri, *args) -> image [B, H, W, C]`; pos is
    [B, V, 4] instanced. Inputs are constrained so that the minibatch
    rides the dp axis and image rows ride sp.
    """
    sh = render_shardings(mesh, dp_axis, sp_axis)

    def wrapped(pos, tri, *args):
        pos = jax.lax.with_sharding_constraint(pos, sh["pos_instanced"])
        out = render_fn(pos, tri, *args)
        return jax.lax.with_sharding_constraint(out, sh["image"])

    return jax.jit(wrapped, donate_argnums=donate_argnums)


def sharded_train_step(loss_fn, optimizer, mesh, dp_axis="dp", sp_axis="sp"):
    """Build a jit-compiled sharded training step.

    Args:
      loss_fn: (params, batch) -> scalar loss. `batch` is a pytree
        whose leading axis is the minibatch (sharded over dp).
      optimizer: an optax GradientTransformation.
      mesh: jax.sharding.Mesh.

    Returns:
      step(params, opt_state, batch) -> (params, opt_state, loss),
      jitted with params/opt_state replicated and batch dp-sharded.
    """
    repl = NamedSharding(mesh, P())
    batch_sh = NamedSharding(mesh, P(dp_axis))

    def step(params, opt_state, batch):
        batch = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, batch_sh), batch)
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        # Gradients of replicated params are automatically psum-reduced
        # by XLA; constrain to keep them replicated.
        grads = jax.tree.map(
            lambda g: jax.lax.with_sharding_constraint(g, repl), grads)
        import optax

        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(step)


def shard_map_train_step(loss_fn, optimizer, mesh, dp_axis="dp"):
    """Data-parallel training step via ``jax.shard_map``.

    Each device runs the FULL single-device pipeline (including the
    coverage kernel) on its minibatch shard; parameter gradients are
    ``pmean``-reduced over the dp axis. This is the main multi-device path:
    unlike constraint-based GSPMD partitioning, none of the pipeline's
    flat-pixel reshapes or chunked reductions ever cross a shard
    boundary, so no resharding collectives appear inside the step.

    Args:
      loss_fn: (params, batch) -> scalar mean loss over the shard.
        `batch` is a pytree whose leading axis is the minibatch.
      optimizer: an optax GradientTransformation.
      mesh: jax.sharding.Mesh containing `dp_axis`.

    Returns:
      step(params, opt_state, batch) -> (params, opt_state, loss),
      jitted; params/opt_state replicated, batch dp-sharded.
    """
    import optax

    def per_shard(params, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        # pmean (not psum): each shard computes the mean loss over its
        # local minibatch slice, so the global-mean-loss gradient is the
        # mean of the shard gradients. A bare psum would scale the
        # applied gradient by n_dp relative to the reported loss.
        grads = jax.lax.pmean(grads, dp_axis)
        loss = jax.lax.pmean(loss, dp_axis)
        return loss, grads

    batch_spec = P(dp_axis)
    repl_spec = P()
    mapped = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(repl_spec, batch_spec),
        out_specs=(repl_spec, repl_spec),
        check_vma=False,
    )

    def step(params, opt_state, batch):
        loss, grads = mapped(params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(step)
