"""utils.image: the stdlib PNG writer round-trips 8-bit pixels."""

import struct
import zlib

import numpy as np
import pytest

from nvdiffrast_tpu.utils.image import save_image


def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, i = {}, 8
    while i < len(data):
        n, tag = struct.unpack(">I4s", data[i:i + 8])
        body = data[i + 8:i + 8 + n]
        crc = struct.unpack(">I", data[i + 8 + n:i + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        i += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    c = {0: 1, 2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + w * c)
    assert depth == 8 and (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("shape", [(5, 7), (6, 4, 1), (5, 7, 3), (3, 2, 4)])
def test_save_image_png_roundtrip(tmp_path, shape):
    x = np.random.RandomState(0).rand(*shape)
    path = tmp_path / "img.png"
    save_image(str(path), x)
    want = np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(_read_png(path),
                                  want.reshape(want.shape[:2] + (-1,)))
