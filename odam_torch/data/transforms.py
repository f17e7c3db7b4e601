"""Frame transport: YUV 4:2:0 packing on the host, decode + normalize on the device.

Counterpart of the two transport functions of ``odam_tpu/data/transforms.py``.
"""
from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

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
