"""Image helpers: bilinear 2x downsample, PSNR, save."""

import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np


def bilinear_downsample(x, steps=1):
    """2x bilinear downsample with the reference's 4x4 [1,3,3,1] kernel
    (samples/torch/util.py:56-60), NHWC, expressed as an XLA conv."""
    x = jnp.asarray(x, jnp.float32)
    w1 = jnp.asarray([1.0, 3.0, 3.0, 1.0]) / 8.0
    w = jnp.outer(w1, w1)  # [4, 4], sums to 1
    C = x.shape[-1]
    kernel = jnp.zeros((4, 4, 1, C), jnp.float32) + w[:, :, None, None]
    for _ in range(steps):
        x = jax.lax.conv_general_dilated(
            x, kernel,
            window_strides=(2, 2),
            padding=[(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=C,
            precision=jax.lax.Precision.HIGHEST,
        )
    return x


def psnr(a, b, peak=1.0):
    mse = float(jnp.mean((jnp.asarray(a) - jnp.asarray(b)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def save_image(fn, x):
    """Write an [H, W] or [H, W, 1|3|4] float image in [0, 1] as an
    8-bit PNG, with the standard library only (zlib + struct)."""
    x = np.asarray(x)
    x = np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)
    if x.ndim == 2:
        x = x[..., None]
    h, w, c = x.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    # Each scanline starts with filter type 0 (none).
    raw = np.concatenate([np.zeros((h, 1), np.uint8), x.reshape(h, w * c)],
                         axis=1).tobytes()

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                        0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw))
           + chunk(b"IEND", b""))
    with open(fn, "wb") as f:
        f.write(png)
