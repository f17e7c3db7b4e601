"""DETR-style 3D-aware per-frame detector, with its fixed-shape postprocess.

Counterpart of ``odam_tpu/models/detr.py``: frozen-BN ResNet-50 (its
stem literal, ``s2d`` or ``im2col``; its last stage dilated with
``dilation``) or TinyBackbone, sine positional encoding, a post-norm or
pre-norm (``pre_norm``) transformer, six heads (class, 2D box, 2D center offset, azimuth bins, 3D size, depth) with
``aux_outputs``, and ``postprocess``: softmax threshold, unprojection of the
3D center, angle decode, the fixpoint 3D NMS and a MAX_DETECTIONS-slot
``Detections`` contract.

Public layouts follow the JAX package: images [B, H, W, 3] NHWC.
``DETRConfig.dtype`` is the compute dtype, with Flax's semantics
(:mod:`.layers`): float32 parameters cast at use, bf16 activations and
heads; ``postprocess`` casts every head to float32 first.
``DETRConfig.dropout`` acts in ``.train()`` mode only, with masks drawn from
the forward's ``generator``; ``use_kernels`` (JAX's ``use_pallas``) sends
the transformer's attention to the CUDA kernels, and training turns it off.
``DETR.forward(..., lanes=P)`` runs P scenes' frames stacked on the batch
axis (the scene-parallel step): the attention routes on each lane's batch,
and ``postprocess`` takes one intrinsic matrix per image.
``DETR.forward(..., shards=W)`` runs one rank's block of a batch sharded
over W ranks, and the attention routes on the global batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..utils import boxes as box_ops
from . import convert, position, resnet
from .layers import Conv, Dense
from .transformer import Transformer

MAX_DETECTIONS = 30


@dataclass(frozen=True)
class DETRConfig:
    num_classes: int = 18
    num_queries: int = 100
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1           # in .train() mode only
    aux_loss: bool = True
    num_angle_bins: int = 30
    backbone: str = "resnet50"     # "resnet50" | "tiny"
    backbone_stage: int = 4        # feature stage fed to the transformer
    pre_norm: bool = False         # the transformer's normalize_before
    dilation: bool = False         # ResNet-50's last stage dilated, not strided
    # Kept and not read, as in the JAX package, whose DETR always takes the
    # sine encoding (odam_tpu/models/detr.py:50,138): "learned" gives the
    # same model.  position.LearnedPositionEncoding is the learned module.
    position_embedding: str = "sine"
    stem: str = "conv"             # ResNet-50's stem: "conv" | "s2d" | "im2col"
    dtype: torch.dtype = torch.float32   # compute dtype: float32 or bfloat16
    use_kernels: bool = True       # the attention kernels (JAX: use_pallas)

    @classmethod
    def from_cfg(cls, cfg: dict, dtype: torch.dtype = torch.float32,
                 use_kernels: bool = True) -> "DETRConfig":
        """Build from the reference YAML schema (configs/detr_scan_net.yaml).

        A YAML whose ``transformer`` names another detector raises: an
        entry point that builds DETR alone must not run it in that
        detector's place (:func:`detector_from_cfg` builds either)."""
        kind = cfg.get("transformer", "detr")
        if kind != "detr":
            raise ValueError(f"the YAML names transformer {kind!r}, and this builds DETR only: "
                             "build the detector with models.detr.detector_from_cfg")
        return cls(
            num_classes=int(cfg.get(
                "num_classes", 18 if cfg.get("dataset_file", "scan_net") == "scan_net" else 20)),
            num_queries=int(cfg.get("num_queries", 100)),
            hidden_dim=int(cfg.get("hidden_dim", 256)),
            nheads=int(cfg.get("nheads", 8)),
            enc_layers=int(cfg.get("enc_layers", 6)),
            dec_layers=int(cfg.get("dec_layers", 6)),
            dim_feedforward=int(cfg.get("dim_feedforward", 2048)),
            dropout=float(cfg.get("dropout", 0.1)),
            aux_loss=bool(cfg.get("aux_loss", True)),
            backbone=cfg.get("backbone", "resnet50"),
            backbone_stage=int(cfg.get("backbone_stage", 4)),
            pre_norm=bool(cfg.get("pre_norm", False)),
            dilation=bool(cfg.get("dilation", False)),
            position_embedding=cfg.get("position_embedding", "sine"),
            stem=cfg.get("stem", "conv"),
            dtype=dtype,
            use_kernels=use_kernels,
        )


class HeadMLP(nn.Module):
    """3-layer ReLU MLP prediction head."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, num_layers: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", Dense(dims[i], dims[i + 1], dtype=dtype))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class DETR(nn.Module):
    def __init__(self, config: DETRConfig = DETRConfig()):
        super().__init__()
        c = self.config = config
        dt = c.dtype
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dt} is not float32 or bfloat16")
        if c.backbone == "tiny":
            self.backbone = resnet.TinyBackbone(return_stages=(c.backbone_stage,), dtype=dt)
        elif c.backbone == "resnet50":
            self.backbone = resnet.resnet50(dt, c.dilation, (c.backbone_stage,), c.stem)
        else:
            raise ValueError(f"unknown backbone {c.backbone!r}")
        D = c.hidden_dim
        self.input_proj = Conv(self.backbone.channels(c.backbone_stage), D, 1, dtype=dt)
        self.query_embed = nn.Parameter(torch.zeros(c.num_queries, D))
        self.transformer = Transformer(D, c.nheads, c.enc_layers, c.dec_layers,
                                       c.dim_feedforward, c.dropout, dt, c.use_kernels,
                                       c.pre_norm)
        self.class_embed = Dense(D, c.num_classes + 1, dtype=dt)
        self.bbox_embed = HeadMLP(D, D, 4, dtype=dt)
        self.offset_embed = HeadMLP(D, D, 2, dtype=dt)
        self.angle_embed = HeadMLP(D, D, c.num_angle_bins, dtype=dt)
        self.size_embed = HeadMLP(D, D, 3, dtype=dt)
        self.depth_embed = HeadMLP(D, D, 1, dtype=dt)

    def forward(self, images: torch.Tensor, pixel_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None, lanes: int = 1,
                shards: int = 1) -> dict:
        """
        Args:
            images: [B, H, W, 3] normalized images (cast to the compute dtype).
            pixel_mask: [B, H, W] bool, True = padded pixel.
            generator: draws the dropout masks in ``.train()`` mode.
            lanes: scenes stacked on the batch axis, which the attention
                routes on (B / lanes images each).
            shards: ranks whose blocks of B images form the global batch,
                which the attention routes on.

        Returns:
            dict with pred_logits [B, Q, C+1], pred_boxes [B, Q, 4] (cxcywh,
            sigmoid), pred_angle [B, Q, bins], pred_offset [B, Q, 2],
            pred_size [B, Q, 3], pred_depth [B, Q, 1], pred_obj_features
            [B, Q, D], and aux_outputs (one dict per earlier decoder layer),
            all in the compute dtype.
        """
        c = self.config
        B, H, W, _ = images.shape
        if pixel_mask is None:
            pixel_mask = torch.zeros((B, H, W), dtype=torch.bool, device=images.device)
        feats = self.backbone(images.permute(0, 3, 1, 2))[c.backbone_stage]
        fh, fw = feats.shape[-2:]
        # "nearest-exact" samples at half-pixel centres, as jax.image.resize does
        feat_mask = F.interpolate(pixel_mask[:, None].float(), size=(fh, fw),
                                  mode="nearest-exact")[:, 0].bool()
        pos = position.sine_position_encoding(feat_mask, num_pos_feats=c.hidden_dim // 2,
                                              dtype=c.dtype)
        src = self.input_proj(feats).permute(0, 2, 3, 1)
        hs, _ = self.transformer(src, feat_mask, self.query_embed, pos, generator, lanes,
                                 shards)

        logits = self.class_embed(hs)
        boxes = torch.sigmoid(self.bbox_embed(hs))
        angle = self.angle_embed(hs)
        offset = self.offset_embed(hs)
        size = self.size_embed(hs)
        depth = self.depth_embed(hs)
        out = {
            "pred_logits": logits[-1],
            "pred_boxes": boxes[-1],
            "pred_angle": angle[-1],
            "pred_offset": offset[-1],
            "pred_size": size[-1],
            "pred_depth": depth[-1],
            "pred_obj_features": hs[-1],
        }
        if c.aux_loss:
            out["aux_outputs"] = [
                {"pred_logits": logits[i], "pred_boxes": boxes[i], "pred_angle": angle[i],
                 "pred_offset": offset[i], "pred_size": size[i], "pred_depth": depth[i]}
                for i in range(hs.shape[0] - 1)
            ]
        return out


def build_detr(config: DETRConfig = DETRConfig(), *, flax_params=None, seed: int = 0,
               device: str | torch.device | None = None) -> DETR:
    """A DETR in eval mode on ``device`` (default: the card).

    Weights come from ``flax_params`` (a Flax tree of numpy arrays, see
    :mod:`odam_torch.models.convert`) or, without one, from the seeded init.
    """
    return init_detector(DETR(config), flax_params=flax_params, seed=seed, device=device)


def init_detector(model: nn.Module, *, flax_params=None, seed: int = 0,
                  device: str | torch.device | None = None) -> nn.Module:
    """``model`` (a DETR or a Deformable DETR) in eval mode on ``device``,
    with the weights of ``flax_params`` or the seeded init, as
    :func:`build_detr`."""
    dev = resolve_device(device)
    if flax_params is not None:
        convert.load_flax_params(model, flax_params)
    else:
        convert.init_flax_like_(model, seed)
    return model.to(dev).eval()


def detector_from_cfg(cfg: dict, dtype: torch.dtype = torch.float32,
                      use_kernels: bool = True) -> nn.Module:
    """The detector a YAML names with ``transformer``: ``detr`` (the default)
    builds :class:`DETR` from :meth:`DETRConfig.from_cfg`, ``deformable`` a
    :class:`~odam_torch.models.deformable_detr.DeformableDETR`.  Its weights
    are the constructor's (see :func:`init_detector`)."""
    kind = cfg.get("transformer", "detr")
    if kind == "detr":
        return DETR(DETRConfig.from_cfg(cfg, dtype=dtype, use_kernels=use_kernels))
    if kind == "deformable":
        from .deformable_detr import DeformableDETR, DeformableDETRConfig

        return DeformableDETR(DeformableDETRConfig.from_cfg(cfg, dtype=dtype,
                                                            use_kernels=use_kernels))
    raise ValueError(f"unknown transformer {kind!r}: 'detr' or 'deformable'")


class Detections(NamedTuple):
    """Fixed-shape postprocess output ([N] = MAX_DETECTIONS slots per image)."""

    valid: torch.Tensor       # [B, N] bool
    classes: torch.Tensor     # [B, N] int32
    scores: torch.Tensor      # [B, N]
    boxes: torch.Tensor       # [B, N, 4] xyxy pixels
    dims: torch.Tensor        # [B, N, 3]
    t_co: torch.Tensor        # [B, N, 3] camera-frame center
    angle_deg: torch.Tensor   # [B, N] azimuth in degrees
    features: torch.Tensor    # [B, N, D] query features


def _suppression_pairs(classes, t_co, dims, boxes_2d, iou3d_threshold: float,
                       iou2d_threshold: float, use_2d: bool) -> torch.Tensor:
    """[..., Q, Q] bool: i and j conflict under the reference NMS rules."""
    Q = classes.shape[-1]
    half = dims / 2.0
    aabb = torch.stack([t_co - half, t_co + half], dim=-2)          # [..., Q, 2, 3]
    iou3 = box_ops.iou_aabb(aabb[..., :, None, :, :], aabb[..., None, :, :, :])
    sup_pair = (classes[..., :, None] == classes[..., None, :]) & (iou3 > iou3d_threshold)
    if use_2d:
        iou2, _ = box_ops.pairwise_box_iou(boxes_2d, boxes_2d)
        sup_pair = sup_pair | (iou2 > iou2d_threshold)
    return sup_pair & ~torch.eye(Q, dtype=torch.bool, device=classes.device)


def nms_3d_mask(classes, scores, t_co, dims, boxes_2d, valid, iou3d_threshold: float = 0.25,
                iou2d_threshold: float = 0.5, use_2d: bool = True) -> torch.Tensor:
    """Greedy 3D NMS over each image's candidates: [..., Q] inputs -> keep
    mask [..., Q], one image or a batch of them at once.

    Greedy NMS is the unique fixed point of ``keep_i = valid_i and no kept,
    higher-ranked j conflicts with i`` (rank: higher score, then lower
    index).  The JAX package iterates the map in a while_loop until it stops
    changing, at most Q + 1 rounds.  Here it runs exactly Q + 1 rounds with no
    host sync: the map is idempotent at its fixed point, so the extra rounds
    leave the result exact.  A batch runs the same Q + 1 rounds, each over
    every image at once.
    """
    Q = classes.shape[-1]
    sup_pair = _suppression_pairs(classes, t_co, dims, boxes_2d,
                                  iou3d_threshold, iou2d_threshold, use_2d)
    idx = torch.arange(Q, device=classes.device)
    outranks = (scores[..., None, :] > scores[..., :, None]) | (
        (scores[..., None, :] == scores[..., :, None]) & (idx[None, :] < idx[:, None]))
    S = sup_pair & outranks & valid[..., None, :]
    keep = valid
    for _ in range(Q + 1):
        keep = valid & ~(S & keep[..., None, :]).any(dim=-1)
    return keep


def _nms_3d_mask_sequential(classes, scores, t_co, dims, boxes_2d, valid,
                            iou3d_threshold: float = 0.25, iou2d_threshold: float = 0.5,
                            use_2d: bool = True) -> torch.Tensor:
    """The literal Q-step greedy sweep over one image (equivalence oracle for
    tests)."""
    Q = classes.shape[0]
    sup_pair = _suppression_pairs(classes, t_co, dims, boxes_2d,
                                  iou3d_threshold, iou2d_threshold, use_2d)
    order = torch.argsort(torch.where(valid, -scores, torch.inf), stable=True)
    keep = torch.zeros(Q, dtype=torch.bool, device=classes.device)
    suppressed = torch.zeros_like(keep)
    for i in order.tolist():
        active = bool(valid[i] & ~suppressed[i])
        keep[i] = active
        if active:
            suppressed |= sup_pair[i]
    return keep


def postprocess(outputs: dict, img_w: float, img_h: float, threshold: float,
                K: torch.Tensor, max_dets: int = MAX_DETECTIONS,
                use_nms_2d: bool = True) -> Detections:
    """Decode raw DETR outputs into fixed-shape detections.

    Softmax-threshold keep, cxcywh -> xyxy pixels, 3D center = unproject(box
    center + offset) * depth, angle-bin argmax * (180 / bins) degrees, the
    fixpoint NMS, then the top ``max_dets`` by score (stable order), padded
    with invalid slots when there are fewer queries than slots.  ``K`` is
    one [3, 3] intrinsic matrix for every image, or [B, 3, 3], one each.
    """
    logits = outputs["pred_logits"].float()
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)[..., :-1]
    scores = probs.amax(dim=-1)
    classes = probs.argmax(dim=-1).int()
    keep = scores > threshold

    scale = box_ops.xyxy_scale(img_w, img_h, dev)
    boxes = box_ops.cxcywh_to_xyxy(outputs["pred_boxes"].float()) * scale
    offset = outputs["pred_offset"].float() * scale[:2]
    box_center = (boxes[..., :2] + boxes[..., 2:]) / 2.0
    shape_center = offset + box_center
    Kb = K.reshape(-1, 3, 3)
    f = torch.stack([Kb[:, 0, 0], Kb[:, 1, 1]], dim=-1)[:, None]     # [B or 1, 1, 2]
    cxy = torch.stack([Kb[:, 0, 2], Kb[:, 1, 2]], dim=-1)[:, None]
    depth = outputs["pred_depth"].float()
    center_xy = (shape_center - cxy) / f * depth
    t_co = torch.cat([center_xy, depth], dim=-1)

    n_bins = outputs["pred_angle"].shape[-1]
    angle_deg = outputs["pred_angle"].float().argmax(dim=-1).float() * (180.0 / n_bins)
    dims = outputs["pred_size"].float()

    keep = nms_3d_mask(classes, scores, t_co, dims, boxes, keep, use_2d=use_nms_2d)

    sort_key = torch.where(keep, -scores, torch.inf)
    order = torch.argsort(sort_key, dim=-1, stable=True)[:, :max_dets]
    valid = torch.gather(keep, 1, order)
    if order.shape[1] < max_dets:
        pad = max_dets - order.shape[1]
        order = F.pad(order, (0, pad))
        valid = F.pad(valid, (0, pad))

    def take(x):
        idx = order.reshape(order.shape + (1,) * (x.ndim - 2)).expand(
            order.shape + x.shape[2:])
        return torch.gather(x, 1, idx)

    return Detections(
        valid=valid,
        classes=torch.gather(classes, 1, order),
        scores=torch.gather(scores, 1, order),
        boxes=take(boxes),
        dims=take(dims),
        t_co=take(t_co),
        angle_deg=torch.gather(angle_deg, 1, order),
        features=take(outputs["pred_obj_features"].float()),
    )
