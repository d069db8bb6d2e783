"""Smoke test of the render path on one NVIDIA GPU (or four).

Runs the library's main path through its public entry points at full
size and checks every result against the plain XLA reference:

1. device: nvidia-smi name and power limit, JAX devices;
2. coverage kernel vs the XLA scan (``_coverage_xla``) at 2048^2 on the
   bench mesh and at 10^5 triangles at 1024^2, plus range mode, depth
   peeling and viewport bands;
3. edge coefficients on the GPU bitwise equal to the CPU's, the
   one-hot reduction at full f32 precision, and the test suite's
   card-only checks (``pytest -m gpu``);
4. bench.py's two fwd+bwd steps at 2048^2 and ``__graft_entry__.entry``:
   compile and median step time, forward image and gradients against
   the same step on the CPU at 512^2 (the textured step also with a
   smooth texture, and with a TF32 control), and whether two GPU runs
   give bitwise-equal gradients (reported, not gated);
5. a few steps of the earth texture fit at the reference's earth
   settings: the loss is finite and falls.

``--chips 4`` runs only the four-card phase instead: data parallelism
(4 views of the textured step) and rowband spatial parallelism (one
2048^2 image in 4 bands), each against the single-card result.

The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; any failed
check exits non-zero without it. Exits non-zero at once when JAX finds
no GPU.

Usage: python chip_smoke.py [--chips 4]
"""

import argparse
import json
import sys
import time

import numpy as np

from bench import gpu_info, make_steps, require_gpu, sphere_scene, time_step

# Tolerances. Coverage: the XLA scan merges each 64-triangle chunk as a
# pairwise tree, the kernel sequentially, so at genuine depth ties
# (|dz| <= 1e-4) f32 rounding may pick the other triangle; such pixels
# may be at most 2e-4 of the image (tests/test_parity_sweep.py).
ZFIGHT_DZ = 1e-4
ZFIGHT_FRAC = 2e-4
# Shading of equal ids runs the same XLA code on both routes.
SHADE_ATOL = 1e-5
# GPU vs CPU step: images are per-pixel f32 math (a few ulp apart);
# gradients are sums over ~10^5 pixels reduced in another order (float
# atomics on the GPU), compared relative to the largest entry.
IMG_ATOL = 1e-4
GRAD_RTOL = 1e-3
# The bench texture is uniform noise, so the textured step's position
# gradient (through the texture's uv gradient, which jumps at every
# texel center) is ill-conditioned: moving the positions by one ulp
# moves it by 4e-3 to 1.5e-2 of its largest entry on the CPU alone,
# against 5e-5 to 9e-5 with a smooth texture. That one argument is held
# to the CPU's own one-ulp spread (median of three draws), and the same
# step with a smooth texture (same shapes) to GRAD_RTOL. Positions
# rounded to TF32 move the position gradient by ~0.2 (CPU readings); a
# GPU reading of that control is printed.
# The one-hot reduction at HIGHEST vs float64; inputs are chosen so
# that TF32 rounding would err by 3.7e-4 of every value.
ONEHOT_RTOL = 1e-5

# Sizes: the bench cell, the CPU comparison, the 10^5-triangle mesh
# (uv_sphere(224, 224) has 99,904 triangles) and the earth fit settings
# (SURVEY.md §2.5: 2048x1536 atlas, max_mip_level=9).
RES = 2048
RES_CPU = 512
BIG_MESH = (224, 224)
BIG_RES = 1024
EARTH = dict(res=512, ref_res=2048, tex_res=(1536, 2048), max_mip_level=9)


class Checks:
    def __init__(self):
        self.failed = []

    def check(self, name, ok, detail=""):
        print(f"[{'PASS' if ok else 'FAIL'}] {name} {detail}", flush=True)
        if not ok:
            self.failed.append(name)


def bench_mesh(jnp, res):
    s = sphere_scene(res)
    return jnp.asarray(s["pos"]), jnp.asarray(s["tri"])


def coverage_pair(jax, R, pos, tri, res, **kw):
    """(kernel, xla) coverage on one input, jitted."""
    B = pos.shape[0] if pos.ndim == 3 else kw["ranges"].shape[0]
    ranges = kw.pop("ranges", None)
    if ranges is None:
        ranges = jax.numpy.broadcast_to(
            jax.numpy.array([[0, tri.shape[0]]], jax.numpy.int32), (B, 2))
    outs = []
    for impl in ("auto", "xla"):
        f = jax.jit(lambda p, impl=impl: R._coverage(
            p, tri, res, ranges, None, 64, impl, kw.get("viewport")))
        outs.append(jax.block_until_ready(f(pos)))
    return outs


def compare_ids(ck, name, kern, ref):
    ik, zk = (np.asarray(a) for a in kern)
    ix, zx = (np.asarray(a) for a in ref)
    differ = ik != ix
    dz = np.abs(zk[differ] - zx[differ]) if differ.any() else np.zeros(0)
    ok = bool((dz <= ZFIGHT_DZ).all()) and differ.mean() <= ZFIGHT_FRAC
    same = ~differ & (ix >= 0)
    zerr = float(np.abs(zk[same] - zx[same]).max()) if same.any() else 0.0
    ok &= zerr <= SHADE_ATOL
    ck.check(name, ok, f"id mismatches {int(differ.sum())} "
             f"(allowed: z-fights |dz|<={ZFIGHT_DZ}, <= {ZFIGHT_FRAC} of "
             f"pixels); covered {float((ix >= 0).mean()):.4f}; "
             f"max |dz| on equal ids {zerr:.3g} (<= {SHADE_ATOL})")


def phase_coverage(ck, jax):
    import jax.numpy as jnp

    from nvdiffrast_tpu.models import primitives
    from nvdiffrast_tpu.ops import rasterize as R
    from nvdiffrast_tpu.utils import camera

    pos, tri = bench_mesh(jnp, RES)
    kern, ref = coverage_pair(jax, R, pos, tri, (RES, RES))
    compare_ids(ck, f"coverage {tri.shape[0]} tris @{RES}^2", kern, ref)

    import nvdiffrast_tpu as dr
    rk, dbk = dr.rasterize(None, pos, tri, (RES, RES))
    rx, dbx = dr.rasterize(None, pos, tri, (RES, RES), impl="xla")
    err = max(float(jnp.abs(rk - rx).max()), float(jnp.abs(dbk - dbx).max()))
    ck.check(f"rasterize (u, v, z/w, id) + db kernel vs xla @{RES}^2",
             err <= SHADE_ATOL, f"max abs diff {err:.3g} (<= {SHADE_ATOL})")

    pos_idx, vtxp, _, _ = primitives.uv_sphere(*BIG_MESH)
    mvp = camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    pos5 = jnp.asarray((posw @ mvp.T)[None].astype(np.float32))
    kern, ref = coverage_pair(jax, R, pos5, jnp.asarray(pos_idx),
                              (BIG_RES, BIG_RES))
    compare_ids(ck, f"coverage {pos_idx.shape[0]} tris @{BIG_RES}^2",
                kern, ref)

    # Range mode: two images, overlapping triangle windows.
    T = tri.shape[0]
    ranges = jnp.asarray([[0, T // 2], [T // 4, T - T // 4]], jnp.int32)
    r = RES_CPU
    kern, ref = coverage_pair(jax, R, pos[0], tri, (r, r), ranges=ranges)
    compare_ids(ck, f"coverage range mode @{r}^2", kern, ref)

    # Depth peeling: each route peels its own first layer.
    def second_layer(p, impl):
        with dr.DepthPeeler(dr.RasterizeCudaContext(), p, tri, (r, r),
                            impl=impl) as peeler:
            peeler.rasterize_next_layer()
            return peeler.rasterize_next_layer()[0]

    layers = []
    for impl in ("auto", "xla"):
        rast = np.asarray(jax.jit(second_layer, static_argnums=1)(pos, impl))
        layers.append((dr.float_to_triidx(rast[..., 3]) - 1, rast[..., 2]))
    compare_ids(ck, f"coverage peel layer 2 @{r}^2", *layers)

    # Viewport band: rows [r/2, 3r/4) of an r-tall image.
    kern, ref = coverage_pair(jax, R, pos, tri, (r // 4, r),
                              viewport=(jnp.int32(r // 2), r))
    compare_ids(ck, f"coverage viewport band @{r}^2", kern, ref)


def phase_edges(ck, jax):
    import jax.numpy as jnp

    from nvdiffrast_tpu.ops import rasterize as R

    pos, tri = bench_mesh(jnp, RES)
    rng = np.random.RandomState(0)
    adv = rng.uniform(-1, 1, (4000, 3, 4)).astype(np.float32)
    adv[..., 3] = rng.uniform(-0.5, 2.5, (4000, 3))
    cpu = jax.devices("cpu")[0]
    for name, tv in (("bench mesh", np.asarray(pos[0][tri])),
                     ("4000 random clip-space triangles", adv)):
        eg = np.asarray(jax.jit(R._edge_coeffs)(jnp.asarray(tv)))
        ec = np.asarray(jax.jit(R._edge_coeffs)(jax.device_put(tv, cpu)))
        same = (eg.view(np.uint32) == ec.view(np.uint32))
        ck.check(f"edge coefficients GPU == CPU bitwise ({name})",
                 bool(same.all()), f"{int((~same).sum())} differing words")

    # The backward's one-hot reduction at bench size (4.2M values into
    # the bench mesh's vertex table) against float64. Every value is
    # 2^k * (1 + 3 * 2^-13), exact in f32, which TF32 would round down
    # to 2^k.
    from nvdiffrast_tpu.ops.scatter import scatter_add_by_id

    n, rows = RES * RES, int(pos.shape[1])
    ids = rng.randint(-1, rows, n).astype(np.int32)
    vals = (np.float32(1 + 3 * 2 ** -13)
            * 2.0 ** rng.randint(-3, 4, (3, n))).astype(np.float32)
    ref = np.stack([np.bincount(ids + 1, weights=v, minlength=rows + 1)[1:]
                    for v in vals.astype(np.float64)], -1)
    got = jax.jit(lambda i, v: scatter_add_by_id(i, v, rows, "onehot"))(
        ids, vals)
    # Control: the same values through a default-precision matrix
    # product (a GEMM, which XLA may run in TF32 on a GPU).
    ctl = jnp.dot(jnp.asarray(vals), jnp.ones((n, 16), jnp.float32))
    tot = vals.astype(np.float64).sum(1, keepdims=True)
    ctl_rel = float(np.abs(np.asarray(ctl, np.float64) - tot).max()
                    / np.abs(tot).max())
    rel = max_rel(got, ref)
    ck.check(f"one-hot reduction GPU vs float64 ({n} values, {rows} rows)",
             rel <= ONEHOT_RTOL,
             f"max |diff| / max |sum| {rel:.3g} (<= {ONEHOT_RTOL}); "
             f"control, a default-precision product of the same values: "
             f"{ctl_rel:.3g}")


def phase_gpu_tests(ck, jax):
    """The test suite's card-only checks (marker ``gpu``), in this
    process: a second process could not get the card's memory."""
    import os

    import pytest

    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(root, "tests", "test_gpu.py")])
    ck.check("pytest -m gpu tests/test_gpu.py", rc == 0, f"exit code {rc}")


def max_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def on_cpu(jax, build):
    """Build (fn, args) on the CPU; returns (call, args), where call runs
    jit(fn) there."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        fn, args = build()
        f = jax.jit(fn)

    def call(*a):
        with jax.default_device(cpu):
            return jax.block_until_ready(f(*jax.device_put(a, cpu)))

    return call, args


def one_ulp(x, seed=0):
    """x moved by one ulp, up or down at random per entry."""
    up = np.random.RandomState(seed).rand(*x.shape) < 0.5
    return np.nextafter(x, np.where(up, np.inf, -np.inf).astype(x.dtype))


def smooth_texture(shape):
    """Low-frequency texture of the bench texture's shape."""
    _, h, w, c = shape
    y, x = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    return np.stack([0.5 + 0.4 * np.sin(2 * np.pi * k * x)
                     * np.cos(2 * np.pi * k * y) for k in (3, 5, 7)[:c]],
                    -1)[None].astype(np.float32)


def phase_main_path(ck, jax):
    import jax.numpy as jnp

    from __graft_entry__ import entry

    for cell, (grad, args) in make_steps(sphere_scene(RES)).items():
        step = jax.jit(grad)
        compile_s, times = time_step(step, args, steps=10)
        g1 = step(*map(jnp.asarray, args))
        g2 = step(*map(jnp.asarray, args))
        bitwise = all(bool((np.asarray(a) == np.asarray(b)).all())
                      for a, b in zip(g1, g2))
        finite = all(bool(np.isfinite(np.asarray(g)).all()) for g in g1)
        ck.check(f"{cell} fwd+bwd @{RES}^2", finite,
                 f"compile {compile_s:.2f} s, median step "
                 f"{np.median(times) * 1e3:.3f} ms over {len(times)}; "
                 f"two runs bitwise-equal gradients: {bitwise}")

    # GPU vs CPU: gradients of the same step, (positions, colors or
    # texture).
    scene = sphere_scene(RES_CPU)
    steps = make_steps(scene)
    for cell, (grad, args) in steps.items():
        gpu = jax.jit(grad)
        cpu, _ = on_cpu(jax, lambda cell=cell: make_steps(scene)[cell])
        rels = [max_rel(a, b) for a, b in zip(gpu(*args), cpu(*args))]
        if "tex" not in cell:
            ck.check(f"{cell} gradients GPU vs CPU @{RES_CPU}^2",
                     max(rels) <= GRAD_RTOL,
                     f"max |diff| / max |g| per argument {rels} "
                     f"(<= {GRAD_RTOL})")
            continue
        pos, tex = args
        g_c = cpu(pos, tex)[0]
        spreads = [max_rel(cpu(one_ulp(pos, seed), tex)[0], g_c)
                   for seed in range(3)]
        spread = float(np.median(spreads))
        ck.check(f"{cell} gradients GPU vs CPU @{RES_CPU}^2, bench "
                 f"texture", rels[0] <= spread and rels[1] <= GRAD_RTOL,
                 f"max |diff| / max |g| per argument {rels} (positions <= "
                 f"the CPU's own spread under a one-ulp position change, "
                 f"median of {[f'{v:.3g}' for v in spreads]}; texture <= "
                 f"{GRAD_RTOL})")
        tex_s = smooth_texture(tex.shape)
        ref = cpu(pos, tex_s)
        rels = [max_rel(a, b) for a, b in zip(gpu(pos, tex_s), ref)]
        # Control: positions through a default-precision product on the
        # GPU (TF32 where XLA takes it).
        pos_tf = jnp.dot(jnp.asarray(pos), jnp.eye(4, dtype=jnp.float32))
        moved = float(np.abs(np.asarray(pos_tf) - pos).max())
        ctl = max_rel(gpu(pos_tf, tex_s)[0], ref[0])
        ck.check(f"{cell} gradients GPU vs CPU @{RES_CPU}^2, smooth "
                 f"texture", max(rels) <= GRAD_RTOL,
                 f"max |diff| / max |g| per argument {rels} (<= "
                 f"{GRAD_RTOL}); control, positions through a default-"
                 f"precision product (moved by up to {moved:.3g}): "
                 f"position gradient {ctl:.3g}")

    def build_image():
        import nvdiffrast_tpu as dr

        tri = jnp.asarray(scene["tri"])
        cidx = jnp.asarray(scene["cidx"])

        def image(pos, col):
            return dr.render_pipeline(pos, tri, col, scene["res"],
                                      attr_idx=cidx)

        return image, (scene["pos"], scene["col"])

    image, args = build_image()
    img_g = jax.jit(image)(*args)
    img_cpu, _ = on_cpu(jax, build_image)
    err = float(np.abs(np.asarray(img_g) - np.asarray(img_cpu(*args))).max())
    ck.check(f"render_pipeline image GPU vs CPU @{RES_CPU}^2",
             err <= IMG_ATOL, f"max abs diff {err:.3g} (<= {IMG_ATOL})")

    fn, args = entry()
    t0 = time.perf_counter()
    out_g = jax.block_until_ready(jax.jit(fn)(*args))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        jax.block_until_ready(jax.jit(fn)(*args))
        ts.append(time.perf_counter() - t0)
    entry_cpu, args_c = on_cpu(jax, entry)
    out_c = entry_cpu(*args_c)
    err = float(np.abs(np.asarray(out_g) - np.asarray(out_c)).max())
    ck.check("entry() forward GPU vs CPU", err <= IMG_ATOL and bool(
        np.isfinite(np.asarray(out_g)).all()),
        f"shape {tuple(out_g.shape)}, compile {compile_s:.2f} s, median "
        f"{np.median(ts) * 1e3:.3f} ms, max abs diff {err:.3g} "
        f"(<= {IMG_ATOL})")


def phase_earth(ck, jax):
    from nvdiffrast_tpu.models.fit_earth import EarthFitModel

    model = EarthFitModel(**EARTH)
    psnr0 = model.texture_psnr()
    t0 = time.perf_counter()
    losses = [model.step()]
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses += [model.step() for _ in range(11)]
    step_ms = (time.perf_counter() - t0) / 11 * 1e3
    psnr1 = model.texture_psnr()
    third = len(losses) // 3
    falls = np.mean(losses[-third:]) < np.mean(losses[:third])
    ck.check(f"earth fit {EARTH}",
             bool(np.isfinite(losses).all()) and bool(falls)
             and psnr1 > psnr0,
             f"losses {[f'{v:.5f}' for v in losses]}; texture PSNR "
             f"{psnr0:.2f} -> {psnr1:.2f} dB; compile+first "
             f"{compile_s:.2f} s, {step_ms:.1f} ms/step")


def phase_four_cards(ck, jax):
    """dp and sp on 4 cards, each against the single-card result."""
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import nvdiffrast_tpu as dr
    from nvdiffrast_tpu.models import primitives
    from nvdiffrast_tpu.parallel import make_mesh, shard_map_train_step
    from nvdiffrast_tpu.parallel.spatial import antialias_sp
    from nvdiffrast_tpu.utils import camera

    n = len(jax.devices())
    scene = sphere_scene(RES)
    tri = jnp.asarray(scene["tri"])
    cidx = jnp.asarray(scene["cidx"])
    topo = dr.antialias_construct_topology_hash(tri)
    res = scene["res"]
    # n views: the bench sphere under n random model rotations.
    _, vtxp, _, _ = primitives.uv_sphere(32, 64)
    posw = np.concatenate([vtxp, np.ones_like(vtxp[:, :1])], axis=1)
    proj = camera.projection(x=0.4) @ camera.translate(0, 0, -3.5)
    rng = np.random.RandomState(1)
    views = np.stack([
        posw @ (proj @ camera.random_rotation_translation(0.3, rng)).T
        for _ in range(n)]).astype(np.float32)  # [n, V, 4]

    # The single-card references are bench.py's steps (compiled once
    # per shape, so a warm compile cache serves them).
    steps = {k: jax.jit(g) for k, (g, _) in make_steps(scene).items()}
    d0 = jax.devices()[0]

    # dp: one view per card, textured step, pmean of texture gradients.
    def loss(params, pos):
        img = dr.render_pipeline_textured(pos, tri, scene["uv"],
                                          params["tex"], res, uv_tri=cidx,
                                          topology_hash=topo)
        return jnp.mean(img ** 2)

    opt = optax.sgd(1.0)
    params = {"tex": jnp.asarray(scene["tex"])}
    mesh = make_mesh((n,), ("dp",))
    step = shard_map_train_step(loss, opt, mesh)
    pos_sh = jax.device_put(views, NamedSharding(mesh, P("dp")))
    shards = [(s.device.id, s.data.shape) for s in pos_sh.addressable_shards]
    t0 = time.perf_counter()
    new, _, l_dp = jax.block_until_ready(
        step(params, opt.init(params), pos_sh))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(5):
        new, _, l_dp = jax.block_until_ready(
            step(params, opt.init(params), pos_sh))
    dp_ms = (time.perf_counter() - t0) / 5 * 1e3
    g_dp = params["tex"] - new["tex"]  # sgd(1): the applied gradient
    tex1 = jax.device_put(params["tex"], d0)
    g1 = np.mean([np.asarray(steps["raster_interp_tex_aa"](
        jax.device_put(views[i:i + 1], d0), tex1)[1]) for i in range(n)], 0)
    rel = max_rel(g_dp, g1)
    ck.check(f"dp x{n}: textured step vs one card on the same {n} views",
             rel <= GRAD_RTOL and bool(np.isfinite(float(l_dp))),
             f"pos shards (device, shape) {shards}; loss {float(l_dp):.6g}; "
             f"tex grad max rel diff {rel:.3g}; compile {compile_s:.1f} s, "
             f"{dp_ms:.2f} ms/step")

    # sp: one image in n row bands with the AA halo ppermute.
    H, W = res
    hb = H // n
    sp_mesh = make_mesh((n,), ("sp",))
    pos1 = jnp.asarray(scene["pos"])
    col = jnp.asarray(scene["col"])

    def band(pos, col):
        y0 = jax.lax.axis_index("sp") * hb
        rast, _ = dr.rasterize(None, pos, tri, (hb, W), grad_db=False,
                               viewport=(y0, H))
        img, _ = dr.interpolate(col, rast, cidx)
        return antialias_sp(img, rast, pos, tri, "sp", H,
                            topology_hash=topo)

    def sp_loss(pos, col):
        out = jax.shard_map(band, mesh=sp_mesh, in_specs=(P(), P()),
                            out_specs=P(None, "sp"), check_vma=False)(
                                pos, col)
        return jnp.mean(out ** 2), out

    t0 = time.perf_counter()
    (_, out_sp), gs = jax.block_until_ready(jax.jit(jax.value_and_grad(
        sp_loss, argnums=(0, 1), has_aux=True))(pos1, col))
    compile_s = time.perf_counter() - t0
    p0, c0 = jax.device_put((pos1, col), d0)
    go = steps["raster_interp_aa"](p0, c0)
    out_1 = jax.jit(lambda p, c: dr.render_pipeline(
        p, tri, c, res, attr_idx=cidx, topology_hash=topo))(p0, c0)
    bands = [(s.device.id, s.index[1].start, s.data.shape,
              float(jnp.abs(s.data).sum()))
             for s in out_sp.addressable_shards]
    err = float(np.abs(np.asarray(out_sp) - np.asarray(out_1)).max())
    rels = [max_rel(a, b) for a, b in zip(gs, go)]
    ck.check(f"sp x{n}: {RES}^2 image in {n} bands vs one card",
             err <= IMG_ATOL and max(rels) <= GRAD_RTOL
             and len({b[0] for b in bands}) == n
             and all(b[3] > 0 for b in bands),
             f"bands (device, row0, shape, |sum|) {bands}; image max abs "
             f"diff {err:.3g}; grad max rel diff (pos, col) {rels}; "
             f"compile+first {compile_s:.1f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    a = ap.parse_args()

    jax = require_gpu()
    name, limit = gpu_info()
    print(f"gpu: {name}, power limit {limit}", flush=True)
    print(f"jax {jax.__version__}: {jax.devices()} kind "
          f"{jax.devices()[0].device_kind}", flush=True)
    if len(jax.devices()) < a.chips:
        print(f"--chips {a.chips} needs {a.chips} GPUs", file=sys.stderr)
        sys.exit(2)

    ck = Checks()
    phases = ([phase_four_cards] if a.chips == 4 else
              [phase_coverage, phase_edges, phase_gpu_tests,
               phase_main_path, phase_earth])
    for phase in phases:
        t0 = time.perf_counter()
        phase(ck, jax)
        print(f"-- {phase.__name__} {time.perf_counter() - t0:.1f} s",
              flush=True)
    if ck.failed:
        print(f"failed: {ck.failed}", file=sys.stderr)
        sys.exit(1)
    dev = jax.devices()[0]
    print(f"gpu: {name}, power limit {limit}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
