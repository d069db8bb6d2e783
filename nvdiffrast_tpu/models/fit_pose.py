"""Pose fitting from rendered color (pose.py workload).

Re-creation of samples/torch/pose.py:108-249: recover a cube's
orientation quaternion with a two-phase schedule — random search, then
gradient descent relying on antialias position gradients. The
convergence metric is the angular error in degrees.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.rasterize import rasterize
from ..ops.interpolate import interpolate
from ..ops.antialias import antialias
from ..utils import camera
from . import primitives


def render(mvp, q, pos, pos_idx, col, col_idx, resolution):
    mtx = jnp.matmul(mvp, camera.q_to_mtx(q), precision=camera.HIGHEST)
    pos_clip = camera.transform_pos(mtx, pos)
    rast_out, _ = rasterize(None, pos_clip, pos_idx, (resolution, resolution))
    color, _ = interpolate(col[None], rast_out, col_idx)
    color = antialias(color, rast_out, pos_clip, pos_idx)
    return color


class PoseFitModel:
    """Two-phase pose fitting; metric = quaternion angle error (deg)."""

    def __init__(self, resolution=64, lr_base=0.01, nr_base=1.0,
                 nr_falloff=1e-4, grad_phase_start=0.5, seed=0):
        pos_idx, vtxp, col_idx, vtxc = primitives.cube_continuous()
        self.pos_idx = jnp.asarray(pos_idx)
        self.col_idx = jnp.asarray(col_idx)
        self.vtx_pos = jnp.asarray(vtxp)
        self.vtx_col = jnp.asarray(vtxc)
        self.resolution = int(resolution)
        self.lr_base = lr_base
        self.nr_base = nr_base
        self.nr_falloff = nr_falloff
        self.grad_phase_start = grad_phase_start
        self.rng = np.random.RandomState(seed)

        proj = camera.projection(x=0.4)
        mv = camera.translate(0, 0, -3.5)
        self.mvp = jnp.asarray((proj @ mv).astype(np.float32))

        self.pose_target = camera.q_rnd(self.rng)
        self.pose_init = camera.q_rnd(self.rng)
        self.pose_opt = jnp.asarray(self.pose_init / np.linalg.norm(self.pose_init))

        @jax.jit
        def _loss(q, target_img):
            img = render(self.mvp, q, self.vtx_pos, self.pos_idx,
                         self.vtx_col, self.col_idx, self.resolution)
            return jnp.mean((target_img - img) ** 2)

        self._loss = _loss
        self._loss_grad = jax.jit(jax.grad(_loss))
        self.target_img = render(
            self.mvp, jnp.asarray(self.pose_target), self.vtx_pos,
            self.pos_idx, self.vtx_col, self.col_idx, self.resolution)

    def angle_error(self):
        return camera.q_angle_deg(np.asarray(self.pose_opt), self.pose_target)

    def fit(self, max_iter=300, log_interval=0):
        pose_best = np.asarray(self.pose_opt)
        loss_best = float(self._loss(jnp.asarray(pose_best), self.target_img))

        for it in range(max_iter):
            noise_t = it / max_iter
            noise = self.nr_base * self.nr_falloff ** noise_t
            lr = self.lr_base  # simple constant lr for the gradient phase

            if it < self.grad_phase_start * max_iter:
                # Random search phase: jitter the best pose.
                q = camera.q_scale_small(camera.q_rnd(self.rng), noise)
                cand = camera.q_mul(jnp.asarray(q), jnp.asarray(pose_best))
                cand = cand / jnp.linalg.norm(cand)
                loss = float(self._loss(cand, self.target_img))
                if loss < loss_best:
                    pose_best = np.asarray(cand)
                    loss_best = loss
                self.pose_opt = jnp.asarray(pose_best)
            else:
                # Gradient phase.
                g = self._loss_grad(self.pose_opt, self.target_img)
                self.pose_opt = self.pose_opt - lr * g
                self.pose_opt = self.pose_opt / jnp.linalg.norm(self.pose_opt)
                loss = float(self._loss(self.pose_opt, self.target_img))
                if loss < loss_best:
                    pose_best = np.asarray(self.pose_opt)
                    loss_best = loss

            if log_interval and it % log_interval == 0:
                print(f"iter={it} loss={loss_best:.6f} "
                      f"angle={self.angle_error():.3f} deg")

        self.pose_opt = jnp.asarray(pose_best)
        return self.angle_error()
