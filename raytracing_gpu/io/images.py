"""Image decode for textures (replaces vendored stb_image, reference
`external/stb_image.h` + `imread`/`make_image`, `texture.h:166-203`)."""

from __future__ import annotations

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Decode an image file -> (H, W, 3) float32 in [0, 1].

    Decoding JPEG/PNG files needs Pillow, which only scenes that load image
    files from disk use; every built-in scene renders without it.
    """
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {path!r} needs Pillow (pip install pillow); scenes "
            "without image files do not") from e

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.float32)
    return arr / 255.0
