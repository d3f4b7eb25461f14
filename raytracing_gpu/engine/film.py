"""Film: sample accumulation, tone mapping, image output.

Replaces the reference's 8-bit PPM frame-buffer ensemble (`color.h:19-49`,
`color.h:57-170`): partial sums are kept in float32 (no gamma round-trip
precision loss — the reference de-gammas 8-bit PPMs to average them,
`color.h:125`), and the final image applies the same gamma-2 (sqrt) + clamp
transfer as `write_frame_buffer` before PNG encoding.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def finalize(sample_sum: np.ndarray, samples_per_pixel: int) -> np.ndarray:
    """Mean + gamma-2 + clamp (reference `color.h:32-43`).

    sample_sum: (H, W, 3) float sum of linear radiance samples.
    Returns (H, W, 3) float in [0, 1).
    """
    mean = np.asarray(sample_sum, np.float64) / max(samples_per_pixel, 1)
    # gamma 2: sqrt, guarded against negative fireflies
    g = np.sqrt(np.maximum(mean, 0.0))
    return np.clip(g, 0.0, 0.999)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1) float -> [0, 255] uint8 (reference `color.h:44-47` scale 256)."""
    return (256.0 * np.clip(img, 0.0, 0.999)).astype(np.uint8)


def encode_png(rgb8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes: 8-bit RGB, no filtering, one IDAT."""
    h, w, _ = rgb8.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8),
         np.ascontiguousarray(rgb8, np.uint8).reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """PNG encode (reference writes via png++, `color.h:139-168`)."""
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8(img)))


def write_ppm(path: str, img: np.ndarray) -> None:
    """P3 PPM writer for parity with `write_frame_buffer` (`color.h:19-49`)."""
    h, w, _ = img.shape
    data = to_uint8(img)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        for row in data:
            for px in row:
                f.write(f"{px[0]} {px[1]} {px[2]}\n")


def read_ppm(path: str) -> np.ndarray:
    """Read a P3 PPM back to float [0,1] (reference `average_images` re-reads
    its frame buffers, `color.h:57-137`)."""
    with open(path) as f:
        tokens = f.read().split()
    assert tokens[0] == "P3"
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array(tokens[4:4 + w * h * 3], dtype=np.float64)
    return (vals / maxv).reshape(h, w, 3)


def average_images(images: list[np.ndarray]) -> np.ndarray:
    """Ensemble average in linear space (reference `color.h:57-137` de-gammas,
    averages, re-gammas; inputs here are gamma-encoded [0,1] images)."""
    acc = np.zeros_like(images[0], dtype=np.float64)
    for img in images:
        acc += np.asarray(img, np.float64) ** 2  # de-gamma (color.h:125)
    return np.sqrt(acc / len(images))
