"""Cube-map environment + Phong BRDF fitting (envphong.py workload).

Re-creation of samples/torch/envphong.py:113-162: per-pixel reflection
vectors interpolated with image-space derivatives (diff_attrs='all'),
trilinear cube-map sampling, and a learned Phong term. Exercises the
cube-map sampler incl. the seamless-filtering gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..ops.rasterize import rasterize
from ..ops.interpolate import interpolate
from ..ops.texture import texture
from ..utils import camera
from . import primitives


def _vertex_normals(tri, vtx):
    """Area-weighted vertex normals (for a sphere these are radial)."""
    v = vtx[tri]  # [T, 3, 3]
    n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    out = np.zeros_like(vtx)
    for k in range(3):
        np.add.at(out, tri[:, k], n)
    out /= np.linalg.norm(out, axis=1, keepdims=True) + 1e-12
    return out.astype(np.float32)


def render_refl(mvp, campos, pos, pos_idx, normals, res):
    """Rasterize and return interpolated, normalized reflection vectors."""
    viewvec = pos[:, :3] - campos[None, :]
    reflvec = viewvec - 2.0 * normals * jnp.sum(normals * viewvec, -1,
                                                keepdims=True)
    reflvec = reflvec / jnp.sum(reflvec ** 2, -1, keepdims=True) ** 0.5
    posw = jnp.concatenate([pos[:, :3], jnp.ones_like(pos[:, :1])], axis=1)
    pos_clip = jnp.matmul(posw, mvp.T, precision=camera.HIGHEST)[None]
    rast_out, rast_out_db = rasterize(None, pos_clip, pos_idx, (res, res))
    refl, refld = interpolate(reflvec[None], rast_out, pos_idx,
                              rast_db=rast_out_db, diff_attrs="all")
    refl = refl / (jnp.sum(refl ** 2, -1, keepdims=True) + 1e-8) ** 0.5
    mask = rast_out[..., -1:] == 0
    return refl, refld, mask


def shade(env, phong_rgb, phong_exp, refl, refld, ldir, mask):
    color = texture(env[None], refl, uv_da=refld,
                    filter_mode="linear-mipmap-linear", boundary_mode="cube")
    ldotr = jnp.sum(-ldir * refl, -1, keepdims=True)
    color = color + phong_rgb * jnp.maximum(0.0, ldotr) ** phong_exp
    return jnp.where(mask, 1.0, color)


class EnvPhongFitModel:
    """Learn env cube map + Phong params; metrics match envphong.py."""

    def __init__(self, res=128, env_res=32, subdiv=2, lr=1e-2, seed=0):
        tri, vtx = primitives.icosphere(subdiv)
        self.pos_idx = jnp.asarray(tri)
        self.pos = jnp.asarray(vtx)
        self.normals = jnp.asarray(_vertex_normals(np.asarray(tri),
                                                   np.asarray(vtx)))
        self.env_ref = jnp.asarray(primitives.procedural_cubemap(env_res))
        self.phong_rgb_ref = jnp.asarray([1.0, 0.8, 0.6], jnp.float32)
        self.phong_exp_ref = jnp.float32(25.0)
        self.res = int(res)
        self.rng = np.random.RandomState(seed)

        self.params = {
            "env": jnp.full(self.env_ref.shape, 0.5, jnp.float32),
            # phong_var: rgb + exponent (envphong.py phong_var[:3], [3]).
            "phong": jnp.asarray([1.0, 1.0, 1.0, 10.0], jnp.float32),
        }
        self.tx = optax.adam(lr)
        self.opt_state = self.tx.init(self.params)

        @jax.jit
        def _step(params, opt_state, mvp, campos, ldir):
            refl, refld, mask = render_refl(
                mvp, campos, self.pos, self.pos_idx, self.normals, self.res)
            ref_img = shade(self.env_ref, self.phong_rgb_ref,
                            self.phong_exp_ref, refl, refld, ldir, mask)

            def loss_fn(p):
                img = shade(p["env"], p["phong"][:3], p["phong"][3],
                            refl, refld, ldir, mask)
                return jnp.mean((img - ref_img) ** 2)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            params["env"] = jnp.clip(params["env"], 0.0, 1.0)
            return params, opt_state, loss

        self._step = _step

    def random_view(self):
        rot = camera.random_rotation_translation(0.25, self.rng)
        mv = camera.translate(0, 0, -3.5) @ rot
        mvp = (camera.projection(x=0.4) @ mv).astype(np.float32)
        campos = np.linalg.inv(mv)[:3, 3].astype(np.float32)
        ldir = self.rng.normal(size=[3])
        ldir /= np.linalg.norm(ldir) + 1e-8
        return mvp, campos, ldir.astype(np.float32)

    def metrics(self):
        """(env RMSE, phong rgb RMSE, exponent relative error)."""
        env_rmse = float(jnp.sqrt(jnp.mean(
            (self.params["env"] - self.env_ref) ** 2)))
        rgb_rmse = float(jnp.sqrt(jnp.mean(
            (self.params["phong"][:3] - self.phong_rgb_ref) ** 2)))
        exp_rel = float(jnp.abs(self.params["phong"][3] - self.phong_exp_ref)
                        / self.phong_exp_ref)
        return env_rmse, rgb_rmse, exp_rel

    def step(self):
        mvp, campos, ldir = self.random_view()
        self.params, self.opt_state, loss = self._step(
            self.params, self.opt_state, jnp.asarray(mvp),
            jnp.asarray(campos), jnp.asarray(ldir))
        return float(loss)

    def fit(self, max_iter=1000, log_interval=0):
        for it in range(max_iter):
            loss = self.step()
            if log_interval and it % log_interval == 0:
                e, r, x = self.metrics()
                print(f"iter={it} loss={loss:.6f} env_rmse={e:.4f} "
                      f"rgb_rmse={r:.4f} exp_rel={x:.4f}")
        return self.metrics()
