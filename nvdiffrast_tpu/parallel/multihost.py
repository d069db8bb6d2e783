"""Multi-process entry points.

The reference is strictly single-process/single-GPU (SURVEY.md §2.6).
Here one process can drive every card of a host; several processes
(one per host, or one per card) join through JAX's distributed runtime
and share one global Mesh. Programs are written with shard_map/GSPMD,
and XLA routes the collectives (NCCL on GPUs).

Usage (one call per process, before any other JAX work):

    import nvdiffrast_tpu.parallel.multihost as mh
    mh.initialize("localhost:12345", num_processes=2, process_id=0)
    mesh = mh.pod_mesh()
    step = shard_map_train_step(loss, opt, mesh)   # unchanged code

Every op in this package is pure and shape-static, so the single-card
pipeline runs unmodified inside shard_map on each card; only the
gradient psums (dp) and the 1-row AA halo ppermutes (sp) touch the
interconnect. Cards of one host are joined all to all (NVLink), so the
mesh follows the algorithm alone.
"""

import numpy as np

import jax


def _distributed_client_active():
    """True iff jax.distributed.initialize already ran in this process."""
    try:
        return jax.distributed.is_initialized()
    except AttributeError:  # older jax
        from jax._src import distributed

        return distributed.global_state.client is not None


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               **kwargs):
    """Initialize the JAX distributed runtime (idempotent).

    Arguments are passed explicitly, or through JAX's own variables
    (JAX_COORDINATOR_ADDRESS, with num_processes / process_id given
    here). With neither, this is a no-op: a single-process run has
    nothing to coordinate.

    MUST be called before any other JAX API that initializes the XLA
    backends (jax.devices, jax.process_count, any computation). When a
    coordinator IS configured but the backend was already touched, this
    raises — a silent single-process fallback would mean N independent
    jobs, not one.
    """
    if _distributed_client_active():
        return  # idempotent: distributed runtime already up
    import os

    if (coordinator_address is None and num_processes is None
            and not os.environ.get("JAX_COORDINATOR_ADDRESS")):
        return  # single-process environment
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def pod_mesh(axis_names=("dp", "sp"), dp_over_hosts=True, devices=None):
    """Global mesh over all processes: processes x local devices.

    dp_over_hosts=True puts the data-parallel axis across processes and
    the spatial axis over each process's local cards, so the per-step
    sp halo exchanges stay inside a host (NVLink) and only the dp
    gradient reduction crosses hosts. False swaps the two axes.

    Returns a jax.sharding.Mesh with shape
    (num_processes, local_device_count) — or (1, n) single-process.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n_hosts = jax.process_count()
    grid = devices.reshape(n_hosts, devices.size // n_hosts)
    if not dp_over_hosts:
        axis_names = tuple(reversed(axis_names))
        grid = grid.T
    from jax.sharding import Mesh

    return Mesh(grid, axis_names)


def local_batch_slice(global_batch, mesh, dp_axis="dp"):
    """Host-local slice bounds of a dp-sharded global batch.

    Multi-host data loading: each process feeds only its own shard.
    Returns (start, size) for this process along the batch axis,
    derived from the mesh's actual device layout (which dp coordinates
    this process's local devices cover) — correct for dp-over-hosts,
    dp-within-host, and mixed layouts alike.
    """
    n_dp = mesh.shape[dp_axis]
    per = global_batch // n_dp
    axis = mesh.axis_names.index(dp_axis)
    dev = np.asarray(mesh.devices)
    pid = jax.process_index()
    proc = np.vectorize(lambda d: d.process_index)(dev)
    coords = np.argwhere(proc == pid)
    if coords.size == 0:
        return 0, 0  # process owns no device of this mesh
    dp_lo = int(coords[:, axis].min())
    dp_hi = int(coords[:, axis].max())
    return dp_lo * per, (dp_hi - dp_lo + 1) * per
