"""CPU-side video transforms and sample filters (numpy uint8).

Port of t2v_turbo_tpu/data/transforms.py: the reference's VideoResizer and
crop transforms (data/dataloader/transform.py:12-152) and metadata filters
(data/dataloader/filters.py). The JAX package resizes through PIL; this one
has no PIL: `resize_video` is a numpy twin of Pillow's `BILINEAR` resample
(Pillow's `ImagingResample`), equal to it bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Pillow's fixed-point precision for 8-bit images (Resample.c PRECISION_BITS)
_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int):
    """(first input index (O,), integer weights (O, K)) of one axis, as
    Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc` compute them: a
    triangle filter of support max(in/out, 1) centred at (x + 0.5) * scale,
    the window [int(center - support + 0.5), int(center + support + 0.5))
    clipped to the image, the weights normalised by their sum (added in
    window order) and rounded to 22-bit fixed point as C's (int) cast does."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    j = np.arange(ksize)
    w = 1.0 - np.abs((j[None, :] + xmin[:, None] - center[:, None] + 0.5) / filterscale)
    w = np.where((j[None, :] < xmax[:, None]) & (w > 0.0), w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):  # window order, as the C loop adds them
        ww += w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = w * float(1 << _PRECISION_BITS)
    kk = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int32)
    return xmin, kk


def _resample_rows(x: np.ndarray, coeffs, out: np.ndarray) -> None:
    """One of Pillow's passes along axis 0 of an (S, R, C) uint8 array, into
    `out` (O, R, C): each output is 2^21 plus the integer-weighted sum of
    its window, shifted right by 22 and clipped to [0, 255]. Each tap
    gathers whole rows, so a horizontal pass runs on the transposed frame."""
    xmin, kk = coeffs
    acc = np.full(out.shape, 1 << (_PRECISION_BITS - 1), np.int32)
    term = np.empty_like(acc)
    for k in range(kk.shape[1]):
        idx = np.minimum(xmin + k, x.shape[0] - 1)  # weight 0 past the window
        np.multiply(x[idx], kk[:, k].reshape(-1, 1, 1), out=term)
        acc += term
    np.right_shift(acc, _PRECISION_BITS, out=acc)
    np.clip(acc, 0, 255, out=out, casting="unsafe")


def resize_image_bilinear(video: np.ndarray, out_hw) -> np.ndarray:
    """(T, H, W, C) uint8 -> (T, oh, ow, C) uint8, equal to
    `PIL.Image.resize((ow, oh), BILINEAR)` on each frame: the horizontal
    pass, stored as uint8, then the vertical one; a pass whose size is
    unchanged is skipped. The integer weights are computed once per axis,
    then applied frame by frame (one frame's arrays stay in cache: 3.5x
    faster than all frames at once at 16 x 360 x 640)."""
    t, h, w, c = video.shape
    oh, ow = out_hw
    cols = _bilinear_coeffs(w, ow) if ow != w else None
    rows = _bilinear_coeffs(h, oh) if oh != h else None
    out = np.empty((t, oh, ow, c), np.uint8)
    for i in range(t):
        frame = video[i]
        if cols is not None:
            wide = np.empty((ow, h, c), np.uint8)
            _resample_rows(np.ascontiguousarray(frame.transpose(1, 0, 2)), cols, wide)
            frame = np.ascontiguousarray(wide.transpose(1, 0, 2))
        if rows is not None:
            _resample_rows(frame, rows, out[i])
        else:
            out[i] = frame
    return out


def resize_video(video: np.ndarray, short_size: int) -> np.ndarray:
    """Aspect-preserving resize so min(H, W) == short_size.
    video: (T, H, W, 3) uint8."""
    t, h, w, _ = video.shape
    if min(h, w) == short_size:
        return video
    if h < w:
        nh, nw = short_size, max(1, round(w * short_size / h))
    else:
        nh, nw = max(1, round(h * short_size / w)), short_size
    return resize_image_bilinear(np.asarray(video, np.uint8), (nh, nw))


def crop_video(
    video: np.ndarray,
    crop_h: int,
    crop_w: int,
    random: bool = False,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    t, h, w, _ = video.shape
    if h < crop_h or w < crop_w:
        raise ValueError(f"crop ({crop_h}, {crop_w}) larger than the video {video.shape}")
    if random:
        rng = rng or np.random
        y = rng.randint(0, h - crop_h + 1)
        x = rng.randint(0, w - crop_w + 1)
    else:
        y = (h - crop_h) // 2
        x = (w - crop_w) // 2
    return video[:, y : y + crop_h, x : x + crop_w]


def resize_crop(video, size_hw, random_crop=False, rng=None):
    """resize-short-side then crop to (H, W) — the standard WebVid recipe
    (reference data/dataset.py:126-138)."""
    ch, cw = size_hw
    scale = max(ch / video.shape[1], cw / video.shape[2])
    short = int(np.ceil(min(video.shape[1], video.shape[2]) * scale))
    video = resize_video(video, short)
    return crop_video(video, ch, cw, random=random_crop, rng=rng)


def normalize_video(video: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1] (reference train loop:946-948)."""
    return video.astype(np.float32) / 127.5 - 1.0


# ---------------------------------------------------------------------------
# metadata filters (reference data/dataloader/filters.py)
# ---------------------------------------------------------------------------


class KeyFilter:
    def __init__(self, required=("mp4", "txt")):
        self.required = tuple(required)

    def __call__(self, sample: dict) -> bool:
        return all(k in sample for k in self.required)


class LanguageFilter:
    def __init__(self, languages=("en",), key="json"):
        self.languages = set(languages)
        self.key = key

    def __call__(self, sample: dict) -> bool:
        meta = sample.get(self.key) or {}
        lang = meta.get("language") or meta.get("lang")
        return lang is None or lang in self.languages


class AestheticsFilter:
    def __init__(self, min_score: float = 0.0, key="json"):
        self.min_score = min_score
        self.key = key

    def __call__(self, sample: dict) -> bool:
        meta = sample.get(self.key) or {}
        score = meta.get("aesthetic", meta.get("AESTHETIC_SCORE"))
        return score is None or score >= self.min_score


class UnsafeFilter:
    def __init__(self, max_p: float = 0.99, key="json"):
        self.max_p = max_p
        self.key = key

    def __call__(self, sample: dict) -> bool:
        meta = sample.get(self.key) or {}
        p = meta.get("p_unsafe", meta.get("punsafe"))
        return p is None or p <= self.max_p
