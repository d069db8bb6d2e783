"""Projection / transformation helpers (JAX).

Conventions match the reference samples (samples/torch/util.py:16-50):
GL-style perspective projection, row-vector-on-the-right 4x4 matrices,
clip-space positions produced as ``(M @ p)`` with p a column [x,y,z,1].
"""

import jax
import jax.numpy as jnp
import numpy as np

# Float32 products name their precision: on a GPU the default may run
# them in TF32 (about 10 mantissa bits), ~1 px of clip-space error at
# 2048^2.
HIGHEST = jax.lax.Precision.HIGHEST


def projection(x=0.1, n=1.0, f=50.0):
    """GL-convention perspective projection matrix."""
    return np.array([
        [n / x, 0, 0, 0],
        [0, n / x, 0, 0],
        [0, 0, -(f + n) / (f - n), -(2 * f * n) / (f - n)],
        [0, 0, -1, 0]], dtype=np.float32)


def translate(x, y, z):
    return np.array([
        [1, 0, 0, x],
        [0, 1, 0, y],
        [0, 0, 1, z],
        [0, 0, 0, 1]], dtype=np.float32)


def rotate_x(a):
    s, c = np.sin(a), np.cos(a)
    return np.array([
        [1, 0, 0, 0],
        [0, c, -s, 0],
        [0, s, c, 0],
        [0, 0, 0, 1]], dtype=np.float32)


def rotate_y(a):
    s, c = np.sin(a), np.cos(a)
    return np.array([
        [c, 0, s, 0],
        [0, 1, 0, 0],
        [-s, 0, c, 0],
        [0, 0, 0, 1]], dtype=np.float32)


def _quat_to_rot3(q):
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix (numpy)."""
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


def random_rotation_translation(t, rng=None):
    """Uniform random rotation + uniform translation in [-t, t]^3.

    Returns a 4x4 rigid transform. The rotation is Haar-uniform on
    SO(3): a uniform unit quaternion (normalized 4-D Gaussian) mapped
    through the standard quaternion-to-matrix formula.
    """
    rng = rng or np.random
    m = np.eye(4)
    m[:3, :3] = _quat_to_rot3(q_rnd(rng))
    m[:3, 3] = rng.uniform(-t, t, size=[3])
    return m.astype(np.float32)


def transform_pos(mtx, pos):
    """Apply a 4x4 matrix to [V, 3] positions -> clip-space [1, V, 4]."""
    pos = jnp.asarray(pos, jnp.float32)
    posw = jnp.concatenate([pos, jnp.ones_like(pos[:, :1])], axis=1)
    mtx = jnp.asarray(mtx, jnp.float32)
    return jnp.matmul(posw, mtx.T, precision=HIGHEST)[None]


# Quaternion helpers used by pose fitting (re-derivation of
# samples/torch/pose.py:31-76 semantics).

def q_unit():
    return np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)


def q_rnd(rng=None):
    """Uniform random unit quaternion (Haar measure on SO(3)).

    A 4-D isotropic Gaussian normalized to the unit sphere is exactly
    uniform on S^3; resample in the (measure-zero) degenerate case.
    """
    rng = rng or np.random
    while True:
        q = rng.normal(size=[4])
        n = np.linalg.norm(q)
        if n > 1e-6:
            return (q / n).astype(np.float32)


def q_scale_small(q, scale, rng=None):
    """Shrink rotation `q` toward the identity by factor `scale`.

    Implemented as a spherical interpolation slerp(identity, q, scale),
    taking the short arc, so the rotation angle scales (approximately)
    linearly with `scale`.
    """
    del rng
    q = np.asarray(q, np.float64)
    if q[0] < 0.0:  # short arc: identity is (1,0,0,0)
        q = -q
    cos_o = np.clip(q[0], -1.0, 1.0)
    omega = np.arccos(cos_o)
    if omega < 1e-6:
        out = q_unit() + scale * (q - q_unit())
    else:
        s = np.sin(omega)
        out = (np.sin((1.0 - scale) * omega) / s) * q_unit() \
            + (np.sin(scale * omega) / s) * q
    return (out / np.linalg.norm(out)).astype(np.float32)


def q_mul(p, q):
    s1, v1 = p[0], p[1:]
    s2, v2 = q[0], q[1:]
    s = s1 * s2 - jnp.dot(v1, v2, precision=HIGHEST)
    v = s1 * v2 + s2 * v1 + jnp.cross(v1, v2)
    return jnp.concatenate([s[None], v])


def q_to_mtx(q):
    """Quaternion (w, x, y, z) -> 4x4 rotation matrix (differentiable)."""
    q = q / jnp.linalg.norm(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    r = jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, :3].set(r)


def q_angle_deg(q1, q2):
    """Angular difference of two unit quaternions in degrees."""
    d = abs(float(np.dot(np.asarray(q1), np.asarray(q2))))
    d = min(d, 1.0)
    return np.degrees(2.0 * np.arccos(d))
