"""PNG output without Pillow: the stdlib encoder in engine/film.py."""

import struct
import sys
import zlib

import numpy as np
import pytest

from raytracing_gpu.engine import film


def _decode(data: bytes) -> np.ndarray:
    """Minimal PNG reader for 8-bit RGB, filter 0 (what encode_png writes)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body), tag
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert (depth, color) == (8, 2)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert np.all(raw[:, 0] == 0)
    return raw[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (48, 64)])
def test_png_round_trip(shape):
    rgb = np.random.default_rng(0).integers(0, 256, shape + (3,), np.uint8)
    np.testing.assert_array_equal(_decode(film.encode_png(rgb)), rgb)


def test_write_png_without_pillow(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "PIL", None)   # import PIL fails
    img = np.random.default_rng(1).random((6, 9, 3))
    path = tmp_path / "out.png"
    film.write_png(str(path), img)
    np.testing.assert_array_equal(_decode(path.read_bytes()),
                                  film.to_uint8(img))


def test_image_decode_names_pillow_when_absent(monkeypatch):
    from raytracing_gpu.io import images

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        images.load_image("texture.jpg")
