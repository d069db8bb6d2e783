"""Headline benchmark: forward+backward throughput at 2048^2 on one GPU.

Two cells, both a 3,968-triangle UV sphere at 2048x2048, minibatch 1:

* ``render_pipeline`` — rasterize + interpolate + antialias, L2 loss,
  gradients to vertex positions and colors;
* ``render_pipeline_textured`` — the same plus a 512^2 trilinear
  texture (earth.py shape), gradients to positions and texture.

Each step is timed with ``block_until_ready`` over 30 steps (inputs
cycle through 8 perturbed views); compile time is reported apart.
Prints one JSON line per metric, each naming the device it ran on.
Exits non-zero when JAX finds no GPU.

Usage: python bench.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

RES = 2048
STEPS = 30


def gpu_info():
    """(name, power limit) as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "unknown", "unknown"
    name, _, limit = out.strip().splitlines()[0].partition(",")
    return name.strip(), limit.strip()


def require_gpu():
    """Import JAX with its compile cache set up; exit unless a GPU is the
    default device. Returns the jax module."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".jax_cache"))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform} devices", file=sys.stderr)
        sys.exit(2)
    return jax


def device_fields(jax):
    name, limit = gpu_info()
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "gpu_name": name,
            "power_limit": limit}


def sphere_scene(res=RES):
    """The bench mesh, camera and texture (numpy)."""
    from nvdiffrast_tpu.models import primitives
    from nvdiffrast_tpu.utils import camera

    pos_idx, vtxp, col_idx, _ = primitives.uv_sphere(32, 64)
    mvp = camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    pos = (posw.astype(np.float64) @ mvp.T.astype(np.float64))[None]
    uv = np.stack([np.arctan2(vtxp[:, 0], vtxp[:, 2]) / (2 * np.pi) + 0.5,
                   np.arccos(np.clip(vtxp[:, 1], -1, 1)) / np.pi], axis=1)
    tex = np.random.RandomState(0).rand(1, 512, 512, 3)
    return {"pos": pos.astype(np.float32), "tri": pos_idx,
            "cidx": col_idx, "col": (vtxp * 0.5 + 0.5).astype(np.float32),
            "uv": uv.astype(np.float32), "tex": tex.astype(np.float32),
            "res": (res, res)}


def make_steps(scene):
    """{cell: (grad step, args)} for the two bench cells."""
    import jax
    import jax.numpy as jnp

    import nvdiffrast_tpu as dr

    tri = jnp.asarray(scene["tri"])
    cidx = jnp.asarray(scene["cidx"])
    topo = dr.antialias_construct_topology_hash(tri)
    res = scene["res"]

    def color_loss(pos, col):
        img = dr.render_pipeline(pos, tri, col, res, attr_idx=cidx,
                                 topology_hash=topo)
        return jnp.mean(img ** 2)

    def tex_loss(pos, tex):
        img = dr.render_pipeline_textured(pos, tri, scene["uv"], tex, res,
                                          uv_tri=cidx, topology_hash=topo)
        return jnp.mean(img ** 2)

    return {
        "raster_interp_aa": (jax.grad(color_loss, argnums=(0, 1)),
                             (scene["pos"], scene["col"])),
        "raster_interp_tex_aa": (jax.grad(tex_loss, argnums=(0, 1)),
                                 (scene["pos"], scene["tex"])),
    }


def time_step(step, args, steps=STEPS):
    """(compile+first-call seconds, per-step seconds list). Inputs cycle
    through 8 perturbed position sets."""
    import jax
    import jax.numpy as jnp

    pos0, other = args
    posv = [jnp.asarray(pos0) * jnp.float32(1.0 + i * 1e-6) for i in range(8)]
    other = jnp.asarray(other)
    t0 = time.perf_counter()
    jax.block_until_ready(step(posv[0], other))
    compile_s = time.perf_counter() - t0
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        jax.block_until_ready(step(posv[i % 8], other))
        times.append(time.perf_counter() - t0)
    return compile_s, times


def main():
    jax = require_gpu()
    fields = device_fields(jax)
    scene = sphere_scene()
    for cell, (grad, args) in make_steps(scene).items():
        compile_s, times = time_step(jax.jit(grad), args)
        med = float(np.median(times))
        print(json.dumps({
            "metric": f"mpix_per_s_fwd_bwd_2048_{cell}",
            "value": RES * RES / 1e6 / med,
            "unit": "Mpix/s",
            "vs_baseline": None,
            "median_ms": med * 1e3,
            "p90_ms": float(np.percentile(times, 90)) * 1e3,
            "compile_s": compile_s,
            "steps": len(times),
            **fields,
        }))


if __name__ == "__main__":
    main()
