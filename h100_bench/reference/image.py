"""Phi-3.5-vision's image preprocessing from the raw pixels, in float32
PyTorch: the multi-crop transform, normalization, the crops and the global
view.

Published description (the model card's processor, as the MLX framework
the system follows implements it): a portrait image is transposed to
landscape; it is scaled to ``s * 336`` wide, ``s = floor(sqrt(num_crops *
w / h))``, by PIL's bilinear filter (a triangle whose support widens by the
downscale factor); the height is padded with white to a multiple of 336,
half above; the image is transposed back, scaled to [0, 1] and normalized
by CLIP's mean and deviation, and cut into 336 x 336 crops, row by row.
The global view is the whole image resized to 336 x 336.

Departures, each shared with the system under test: the resize stays in
float (PIL rounds it to uint8); the global view uses the MLX framework's
two-tap cubic (Keys' kernel with a = -0.5 on the two nearest samples of
evenly spaced source points, weights normalized), where Hugging Face's
processor calls ``torch.nn.functional.interpolate(mode="bicubic")``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CROP = 336
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def grid(h: int, w: int, num_crops: int) -> tuple:
    """(rows, cols) of crops, and the plan of the transform."""
    trans = w < h
    sh, sw = (w, h) if trans else (h, w)
    s = int(math.sqrt(num_crops * sw / sh))
    rw, rh = s * CROP, int(s * CROP * sh / sw)
    ph = -(-rh // CROP) * CROP
    plan = {"trans": trans, "src": (sh, sw), "resized": (rh, rw), "top": (ph - rh) // 2,
            "bottom": ph - rh - (ph - rh) // 2}
    rows, cols = ph // CROP, rw // CROP
    return ((cols, rows) if trans else (rows, cols)), plan


def tokens(rows: int, cols: int) -> int:
    """Image tokens: 144 a crop and for the global view, 12 separators a
    row of crops plus the global view's, one between the two."""
    return (rows * cols + 1) * 144 + 1 + (rows + 1) * 12


def _bilinear(out_n: int, in_n: int) -> torch.Tensor:
    """PIL's bilinear resampling along one axis as an (out_n, in_n) matrix."""
    scale = in_n / out_n
    support = max(scale, 1.0)
    m = torch.zeros((out_n, in_n), dtype=torch.float64)
    for i in range(out_n):
        centre = (i + 0.5) * scale
        lo, hi = max(int(centre - support + 0.5), 0), min(int(centre + support + 0.5), in_n)
        x = torch.arange(lo, hi, dtype=torch.float64)
        wt = (1.0 - ((x + 0.5 - centre) / support).abs()).clamp(min=0.0)
        if wt.sum() > 0:
            m[i, lo:hi] = wt / wt.sum()
    return m.float()


def _keys(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax <= 1, 1.5 * ax**3 - 2.5 * ax**2 + 1,
                       torch.where(ax <= 2, -0.5 * ax**3 + 2.5 * ax**2 - 4 * ax + 2, torch.zeros_like(ax)))


def _two_tap_cubic(in_n: int) -> torch.Tensor:
    """The global view's (336, in_n) resize: the output samples sit at
    ``linspace(0, in_n - 1, 336) * in_n / 336`` in source pixels; each takes
    its two nearest source pixels (``floor(x - 0.5)`` and the next), each
    clamped to the image before its weight is taken, under Keys' kernel,
    normalized."""
    x = torch.from_numpy(np.linspace(0, in_n - 1, CROP)) * (in_n / CROP)
    left = torch.floor(x - 0.5).clamp(0, in_n - 1)
    right = (torch.floor(x - 0.5) + 1).clamp(0, in_n - 1)
    wl, wr = _keys(x - left), _keys(right - x)
    total = wl + wr
    wl, wr = torch.where(total != 0, wl / total, wl), torch.where(total != 0, wr / total, wr)
    m = torch.zeros((CROP, in_n), dtype=torch.float64)
    rows = torch.arange(CROP)
    m.index_put_((rows, left.long()), wl, accumulate=True)
    m.index_put_((rows, right.long()), wr, accumulate=True)
    return m.float()


def crops(pixels: np.ndarray, num_crops: int, device) -> tuple:
    """(h, w, 3) uint8 -> ((1 + rows * cols, 3, 336, 336) float32 on
    ``device``, global view first, then the crops row by row; (rows,
    cols))."""
    (rows, cols), plan = grid(pixels.shape[0], pixels.shape[1], num_crops)
    x = torch.from_numpy(np.ascontiguousarray(pixels)).to(device).float()  # (H, W, 3)
    if plan["trans"]:
        x = x.transpose(0, 1)
    (rh, rw), (sh, sw) = plan["resized"], plan["src"]
    x = torch.einsum("oh,hwc->owc", _bilinear(rh, sh).to(device), x)
    x = torch.einsum("pw,owc->opc", _bilinear(rw, sw).to(device), x).clamp(0.0, 255.0)
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, plan["top"], plan["bottom"]), value=255.0)
    if plan["trans"]:
        x = x.transpose(0, 1)
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    x = ((x / 255.0 - mean) / std).permute(2, 0, 1)  # (3, H, W)
    hh, ww = x.shape[1], x.shape[2]
    glb = _two_tap_cubic(hh).to(device) @ x @ _two_tap_cubic(ww).to(device).T
    tiles = x.reshape(3, rows, CROP, cols, CROP).permute(1, 3, 0, 2, 4).reshape(-1, 3, CROP, CROP)
    return torch.cat([glb[None], tiles]), (rows, cols)
