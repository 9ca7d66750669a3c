"""Image and text fetchers (counterpart of
``phi_3_vision_mlx_tpu/utils/media.py``).

``PIL`` and ``requests`` are imported inside the functions: a machine
without Pillow still serves images that arrive decoded, as any object with
``.convert`` (and ``.size``) passes through :func:`fetch_image` untouched,
such as :class:`ArrayImage`.
"""

from __future__ import annotations

from io import BytesIO
from pathlib import Path
from urllib.parse import urlparse


class ArrayImage:
    """A decoded image held as a uint8 (H, W, 3) array, without Pillow:
    ``.size`` is (width, height) and ``.convert("RGB")`` returns an object
    numpy reads as the array, the duck type :func:`fetch_image` and the
    image processor take."""

    def __init__(self, pixels, name: str = "image"):
        import numpy as np

        self.pixels, self.name = np.asarray(pixels, np.uint8), name
        self.size = (self.pixels.shape[1], self.pixels.shape[0])

    def convert(self, mode):
        if mode != "RGB":
            raise ValueError(f"ArrayImage holds RGB pixels, not {mode}")
        return self

    def __array__(self, dtype=None, copy=None):
        return self.pixels if dtype is None else self.pixels.astype(dtype)

    def __str__(self):
        return f"{self.name} ({self.size[0]} x {self.size[1]})"


def is_url(s) -> bool:
    return isinstance(s, str) and urlparse(s).scheme in ("http", "https")


def _http_get(url: str, **kw):
    import requests

    return requests.get(url, **kw)


def fetch_image(source):
    """PIL image (or any object with ``.convert``) | BytesIO | URL | file
    path -> a decoded image."""
    if hasattr(source, "convert"):
        return source
    from PIL import Image

    try:
        if isinstance(source, BytesIO):
            return Image.open(source)
        if is_url(source):
            response = _http_get(source, stream=True)
            response.raise_for_status()
            return Image.open(response.raw)
        if isinstance(source, (str, Path)) and Path(source).is_file():
            return Image.open(source)
    except Exception as e:
        raise ValueError(f"Failed to load image from {source!r}: {e}") from e
    raise ValueError(f"The image {source} must be a valid URL or existing file.")


def fetch_text(source: str) -> str:
    """URL -> response body; file path -> contents; anything else -> itself.
    Double quotes fold to single quotes, as in the JAX package."""
    source = source.strip()
    if is_url(source):
        response = _http_get(source)
        if response.status_code != 200:
            raise RuntimeError(f"Failed to retrieve URL: {source}, Status code: {response.status_code}")
        text = response.text
    else:
        path = Path(source)
        text = path.read_text() if path.is_file() else source
    return text.replace('"', "'")
