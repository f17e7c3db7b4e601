"""Inference resize and normalize on the host; YUV 4:2:0 packing on the host,
decode + normalize on the device.

Counterpart of the inference and transport functions of
``odam_tpu/data/transforms.py``: shorter side to 800 with a 1333 cap, PIL
bilinear resize, ImageNet normalization.
"""
from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def target_size(h: int, w: int, short_side: int = 800, max_size: int = 1333,
                pad_multiple: int = 1) -> tuple[int, int]:
    """Resized (h, w): shorter side to ``short_side``, longer side capped at
    ``max_size``, optionally rounded up to a multiple."""
    scale = short_side / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if pad_multiple > 1:
        nh = -(-nh // pad_multiple) * pad_multiple
        nw = -(-nw // pad_multiple) * pad_multiple
    return nh, nw


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize (align_corners=False, PIL/torch convention) to float32
    in [0, 1]."""
    try:
        from PIL import Image

        pil = Image.fromarray(
            (np.clip(img, 0, 1) * 255).astype(np.uint8) if img.dtype != np.uint8 else img
        )
        out = pil.resize((out_w, out_h), Image.BILINEAR)
        return np.asarray(out).astype(np.float32) / 255.0
    except ImportError:  # pure-NumPy fallback
        h, w = img.shape[:2]
        ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
        xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = np.clip(ys - y0, 0, 1)[:, None, None]
        wx = np.clip(xs - x0, 0, 1)[None, :, None]
        im = img.astype(np.float32)
        if im.max() > 2.0:
            im = im / 255.0
        top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
        bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
        return top * (1 - wy) + bot * wy


def preprocess_image(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8/float [H, W, 3] -> normalized float32 [out_h, out_w, 3]."""
    resized = resize_bilinear(img, out_h, out_w)
    return ((resized - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)

# BT.601 chroma -> RGB contribution of (U, V) per channel, columns = R, G, B.
_YUV_K = ((0.0, -0.344136, 1.772),
          (1.402, -0.714136, 0.0))


def rgb_to_yuv420(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 RGB [H, W, 3] -> (Y [H, W] uint8, UV [H/2, W/2, 2] uint8).

    BT.601 full range; chroma is 2x2 box-averaged over the even-cropped image.
    """
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    f = rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    H, W = y.shape
    H2, W2 = H // 2 * 2, W // 2 * 2
    uv = np.stack([u[:H2, :W2], v[:H2, :W2]], axis=-1)
    uv = uv.reshape(H2 // 2, 2, W2 // 2, 2, 2).mean(axis=(1, 3))
    return np.clip(y, 0, 255).astype(np.uint8), np.clip(uv, 0, 255).astype(np.uint8)


def yuv420_to_normalized_device(y: torch.Tensor, uv: torch.Tensor, mean: torch.Tensor,
                                std: torch.Tensor) -> torch.Tensor:
    """YUV 4:2:0 (uint8 tensors on the device) -> ImageNet-normalized float32
    [H, W, 3]: nearest chroma upsampling (edge-extended for odd sizes), BT.601
    to RGB clipped to [0, 255], then ``rgb / (255 std) - mean / std``.
    ``mean`` and ``std`` are [3] float32 tensors on the frame's device."""
    yf = y.float()
    uvf = uv.float() - 128.0
    H, W = yf.shape
    uv_up = uvf.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    pad_h, pad_w = H - uv_up.shape[0], W - uv_up.shape[1]
    if pad_h > 0 or pad_w > 0:
        uv_up = torch.nn.functional.pad(
            uv_up.permute(2, 0, 1)[None], (0, max(pad_w, 0), 0, max(pad_h, 0)),
            mode="replicate")[0].permute(1, 2, 0)
    uv_up = uv_up[:H, :W]
    u, v = uv_up[..., 0], uv_up[..., 1]
    (ku_r, ku_g, ku_b), (kv_r, kv_g, kv_b) = _YUV_K
    rgb = torch.stack([yf + (u * ku_r + v * kv_r), yf + (u * ku_g + v * kv_g),
                       yf + (u * ku_b + v * kv_b)], dim=-1)
    rgb = torch.clamp(rgb, 0.0, 255.0)
    s = 1.0 / (255.0 * std)
    t = mean / std
    return rgb * s - t


def resize_bilinear_device(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[..., H, W, C] float -> [..., out_h, out_w, C], the counterpart of
    ``jax.image.resize(img, shape, "bilinear")``: half-pixel centres, and a
    triangle kernel widened by the scale when downsampling (antialiased), with
    the weights that fall outside the image renormalised away."""
    lead, (H, W, C) = img.shape[:-3], img.shape[-3:]
    x = img.reshape((-1, H, W, C)).permute(0, 3, 1, 2)
    y = torch.nn.functional.interpolate(x, size=(out_h, out_w), mode="bilinear",
                                        align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(lead + (out_h, out_w, C))
