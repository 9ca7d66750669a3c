"""Phi-3.5-vision image preprocessing, numpy only (counterpart of
``phi_3_vision_mlx_tpu/models/image_processor.py``).

The hd_transform multi-crop tiling: portrait images are transposed to
landscape, scaled so the area is about ``num_crops`` 336 x 336 tiles (PIL
bilinear), the height white-padded to a multiple of 336, CLIP mean/std
normalized; the global 336 x 336 view uses the reference's 2-tap bicubic
(:func:`interpolate_336`), written as two dense matrices ``G_h @ img @
G_w^T``.  :func:`_pil_bilinear_matrix` is PIL's bilinear resampling along
one axis as a matrix, which the raw-image path applies on the device
(``models/vision.py:device_image_features_raw``).

``Phi3VImageProcessor.__call__`` has three modes, chosen by the same
environment variables as in the JAX package: ``raw=True`` ships the
original uint8 pixels and a resize plan (the default; ``PHI3V_TPU_HOST_
RESIZE=1`` resizes on the host with PIL and ships the hd image instead),
``raw=False`` normalized crops as ``pixel_values``.  Only
``hd_transform_uint8`` needs PIL, imported where it runs; the raw mode
reads ``.size`` and ``.convert("RGB")`` of each image alone.
"""

from __future__ import annotations

import os

import numpy as np

CROP = 336
MAX_CROPS = 17  # 16 sub-crops and the global view
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax**2
    ax3 = ax**3
    return (1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2
    ) * ((ax > 1) & (ax <= 2))


def _resize_matrix(scale: float, out_size: int, in_size: int) -> np.ndarray:
    """Dense (out_size, in_size) matrix of the reference's 2-tap normalized
    cubic interpolation along one axis."""
    out_coords = np.linspace(0, in_size - 1, out_size)
    in_coords = out_coords / scale
    left = np.floor(in_coords - 0.5).astype(np.int32)
    right = left + 1
    left = np.clip(left, 0, in_size - 1)
    right = np.clip(right, 0, in_size - 1)
    w_left = _cubic(in_coords - left)
    w_right = _cubic(right - in_coords)
    wsum = w_left + w_right
    nz = wsum != 0
    w_left[nz] /= wsum[nz]
    w_right[nz] /= wsum[nz]
    g = np.zeros((out_size, in_size), np.float64)
    np.add.at(g, (np.arange(out_size), left), w_left)
    np.add.at(g, (np.arange(out_size), right), w_right)
    return g


def _pil_bilinear_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Dense (out_size, in_size) matrix of PIL's BILINEAR resampling along
    one axis: a triangle filter whose support scales for antialiased
    downscaling, each row's weights normalized.  PIL rounds through uint8
    after resizing; the device path stays in float."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    g = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        xs = np.arange(lo, hi)
        w = 1.0 - np.abs((xs + 0.5 - center) / filterscale)
        w = np.clip(w, 0.0, None)
        s = w.sum()
        if s > 0:
            g[i, lo:hi] = w / s
    return g


def interpolate_336(x: np.ndarray) -> np.ndarray:
    """(N, C, H, W) -> (N, C, 336, 336) by the separable 2-tap cubic, as two
    dense matmuls."""
    n, c, h, w = x.shape
    gh = _resize_matrix(CROP / h, CROP, h).astype(np.float32)
    gw = _resize_matrix(CROP / w, CROP, w).astype(np.float32)
    xf = np.ascontiguousarray(x, np.float32).reshape(n * c, h, w)
    out = gh @ xf @ gw.T
    return out.reshape(n, c, CROP, CROP).astype(x.dtype)


def count_tokens(h: int, w: int) -> int:
    """Image tokens of an (h, w) hd image: each 336-pixel crop and the global
    view give 144, plus a separator after each row of 12 and the global
    separator."""
    return int((h // CROP * w // CROP + 1) * 144 + 1 + (h // CROP + 1) * 12)


class Phi3VImageProcessor:
    count_tokens = staticmethod(count_tokens)

    def __init__(self, num_crops: int = 16):
        self.num_crops = num_crops
        self.image_mean = np.array(IMAGE_MEAN)
        self.image_std = np.array(IMAGE_STD)

    def hd_transform_uint8(self, img) -> np.ndarray:
        """PIL image -> (H, W, 3) uint8 hd image: landscape-oriented,
        bilinear-resized to about ``num_crops`` tiles, the height padded with
        white to a multiple of 336, transposed back."""
        from PIL import Image, ImageOps

        img = img.convert("RGB")
        w, h = img.size
        trans = False
        if w < h:
            img = img.transpose(Image.TRANSPOSE)
            trans = True
            w, h = img.size
        scale = int(np.sqrt(self.num_crops * w / h))
        img = img.resize([int(scale * CROP), int(scale * CROP * h / w)], Image.BILINEAR)
        _, bh = img.size
        diff = int(np.ceil(bh / CROP) * CROP) - bh
        top = diff // 2
        img = ImageOps.expand(img, border=(0, top, 0, diff - top), fill=(255, 255, 255))
        if trans:
            img = img.transpose(Image.TRANSPOSE)
        return np.asarray(img, np.uint8)

    def resize_plan(self, img) -> dict:
        """The hd_transform's geometry for one image (the arithmetic of
        :meth:`hd_transform_uint8`, no pixel work)."""
        w, h = img.size
        trans = w < h
        if trans:
            w, h = h, w
        scale = int(np.sqrt(self.num_crops * w / h))
        rw, rh = int(scale * CROP), int(scale * CROP * h / w)
        diff = int(np.ceil(rh / CROP) * CROP) - rh
        top = diff // 2
        out_h, out_w = rh + diff, rw
        if trans:
            out_h, out_w = out_w, out_h
        return {"trans": trans, "src_h": h, "src_w": w, "rh": rh, "rw": rw,
                "pad_top": top, "pad_bot": diff - top, "out_h": out_h, "out_w": out_w}

    def normalize(self, arr_u8: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 -> CLIP-normalized (3, H, W) float32."""
        mean = self.image_mean.astype(np.float32)
        std_inv = (1.0 / self.image_std).astype(np.float32)
        arr = (arr_u8.astype(np.float32) * np.float32(1 / 255.0) - mean) * std_inv
        return arr.transpose(2, 0, 1)

    count_tokens = staticmethod(count_tokens)

    def __call__(self, images, raw: bool = False) -> dict:
        if raw and os.environ.get("PHI3V_TPU_HOST_RESIZE", "0") != "1":
            plans = [self.resize_plan(img) for img in images]
            shapes = [[p["out_h"], p["out_w"]] for p in plans]
            return {
                "raw_images": [np.asarray(img.convert("RGB"), np.uint8) for img in images],
                "resize_plans": plans,
                "image_sizes": shapes,
                "num_img_tokens": [count_tokens(h, w) for h, w in shapes],
            }
        hd_u8 = [self.hd_transform_uint8(img) for img in images]
        shapes = [[im.shape[0], im.shape[1]] for im in hd_u8]
        num_img_tokens = [count_tokens(h, w) for h, w in shapes]
        if raw:
            return {"hd_images": hd_u8, "image_sizes": shapes, "num_img_tokens": num_img_tokens}
        pixel_values = np.zeros((len(hd_u8), MAX_CROPS, 3, CROP, CROP), np.float32)
        for i, (im, (h, w)) in enumerate(zip(hd_u8, shapes)):
            im = self.normalize(im)
            pixel_values[i, 0] = interpolate_336(im[None])[0]
            crops = (im.reshape(3, h // CROP, CROP, w // CROP, CROP)
                     .transpose(1, 3, 0, 2, 4).reshape(-1, 3, CROP, CROP))
            pixel_values[i, 1 : 1 + crops.shape[0]] = crops
        return {"pixel_values": pixel_values, "image_sizes": shapes, "num_img_tokens": num_img_tokens}
