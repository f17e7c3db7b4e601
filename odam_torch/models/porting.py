"""Reference (PyTorch) checkpoints -> Flax-layout parameter trees -> the port.

A copy of the numpy converters of ``odam_tpu/models/porting.py``, so that
the port reads the reference's ``detector.pth`` / ``associator.pth`` without
importing the JAX package: a ``.pth`` becomes the Flax-layout tree of numpy
arrays that the JAX package would build, and :mod:`.convert` loads that tree
into the port's modules, as it loads any Flax tree.

Handles the three layout differences between the torch reference and this
framework (SURVEY.md §7 "weight porting fidelity"):

1. conv kernels: torch OIHW -> flax HWIO; 1x1-conv1d "MLPs" -> Dense.
2. torch nn.MultiheadAttention packs q/k/v into in_proj_weight [3D, D];
   we split into separate q/k/v projections.
3. the associator's custom attention reshapes channels as [head_dim, heads]
   (head-minor, associator.py:84), while the canonical layout (and torch
   MultiheadAttention) use [heads, head_dim]; its q/k/v/merge kernels are
   permuted accordingly.

All functions take a flat ``state_dict``-like mapping of numpy arrays and
return nested Flax param dicts, the layout of both packages' models.
"""
from __future__ import annotations

import numpy as np

Tensor = np.ndarray


def _t(w: Tensor) -> Tensor:
    """torch Linear weight [out, in] -> flax Dense kernel [in, out]."""
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w: Tensor) -> Tensor:
    """torch conv2d weight OIHW -> flax HWIO."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


def _conv1d_dense(w: Tensor) -> Tensor:
    """torch conv1d k=1 weight [out, in, 1] -> flax Dense kernel [in, out]."""
    return _t(np.asarray(w)[:, :, 0])


def _bn(sd: dict, prefix: str) -> dict:
    return {
        "weight": np.asarray(sd[f"{prefix}.weight"]),
        "bias": np.asarray(sd[f"{prefix}.bias"]),
        "running_mean": np.asarray(sd[f"{prefix}.running_mean"]),
        "running_var": np.asarray(sd[f"{prefix}.running_var"]),
    }


def _dense(sd: dict, prefix: str, transpose=_t) -> dict:
    return {"kernel": transpose(sd[f"{prefix}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _layernorm(sd: dict, prefix: str) -> dict:
    return {"scale": np.asarray(sd[f"{prefix}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _packed_mha(sd: dict, prefix: str) -> dict:
    """torch nn.MultiheadAttention -> {q,k,v,out}_proj Dense params."""
    w = np.asarray(sd[f"{prefix}.in_proj_weight"])
    b = np.asarray(sd[f"{prefix}.in_proj_bias"])
    D = w.shape[0] // 3
    out = {}
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[name] = {"kernel": _t(w[i * D:(i + 1) * D]), "bias": b[i * D:(i + 1) * D]}
    out["out_proj"] = _dense(sd, f"{prefix}.out_proj")
    return out


# --------------------------------------------------------------------- resnet

def convert_resnet50(sd: dict, prefix: str = "backbone.0.body.") -> dict:
    """torchvision resnet50 state dict -> the ResNet's Flax-layout params."""
    p = {
        "conv1": {"kernel": _conv(sd[prefix + "conv1.weight"])},
        "bn1": _bn(sd, prefix + "bn1"),
    }
    stage_sizes = (3, 4, 6, 3)
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for blk in range(n_blocks):
            tp = f"{prefix}layer{stage}.{blk}."
            block = {}
            for c in (1, 2, 3):
                block[f"conv{c}"] = {"kernel": _conv(sd[tp + f"conv{c}.weight"])}
                block[f"bn{c}"] = _bn(sd, tp + f"bn{c}")
            if tp + "downsample.0.weight" in sd:
                block["downsample_conv"] = {"kernel": _conv(sd[tp + "downsample.0.weight"])}
                block["downsample_bn"] = _bn(sd, tp + "downsample.1")
            p[f"layer{stage}_{blk}"] = block
    return p


# ---------------------------------------------------------------- transformer

def convert_transformer(sd: dict, prefix: str = "transformer.",
                        enc_layers: int = 6, dec_layers: int = 6) -> dict:
    p = {}
    for i in range(enc_layers):
        lp = f"{prefix}encoder.layers.{i}."
        p[f"encoder_layer{i}"] = {
            "self_attn": _packed_mha(sd, lp + "self_attn"),
            "linear1": _dense(sd, lp + "linear1"),
            "linear2": _dense(sd, lp + "linear2"),
            "norm1": _layernorm(sd, lp + "norm1"),
            "norm2": _layernorm(sd, lp + "norm2"),
        }
    for i in range(dec_layers):
        lp = f"{prefix}decoder.layers.{i}."
        p[f"decoder_layer{i}"] = {
            "self_attn": _packed_mha(sd, lp + "self_attn"),
            "multihead_attn": _packed_mha(sd, lp + "multihead_attn"),
            "linear1": _dense(sd, lp + "linear1"),
            "linear2": _dense(sd, lp + "linear2"),
            "norm1": _layernorm(sd, lp + "norm1"),
            "norm2": _layernorm(sd, lp + "norm2"),
            "norm3": _layernorm(sd, lp + "norm3"),
        }
    p["decoder_norm"] = _layernorm(sd, f"{prefix}decoder.norm")
    if f"{prefix}encoder.norm.weight" in sd:
        p["encoder_norm"] = _layernorm(sd, f"{prefix}encoder.norm")
    return p


def convert_detr(sd: dict, enc_layers: int = 6, dec_layers: int = 6) -> dict:
    """Full reference detector.pth ``model`` state dict -> DETR flax params."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    p = {
        "backbone": convert_resnet50(sd),
        "transformer": convert_transformer(sd, enc_layers=enc_layers,
                                           dec_layers=dec_layers),
        "input_proj": {
            "kernel": _conv(sd["input_proj.weight"]),
            "bias": sd["input_proj.bias"],
        },
        "query_embed": sd["query_embed.weight"],
        "class_embed": _dense(sd, "class_embed"),
    }
    for head in ("bbox", "offset", "angle", "size", "depth"):
        layers = {}
        i = 0
        while f"{head}_embed.layers.{i}.weight" in sd:
            layers[f"layer{i}"] = _dense(sd, f"{head}_embed.layers.{i}")
            i += 1
        p[f"{head}_embed"] = layers
    return {"params": p}


# ----------------------------------------------------------------- associator

def _head_minor_perm(d_model: int, num_heads: int) -> np.ndarray:
    """perm such that canonical channel (h*dh + d) = torch channel (d*H + h)."""
    dh = d_model // num_heads
    h, d = np.meshgrid(np.arange(num_heads), np.arange(dh), indexing="ij")
    return (d * num_heads + h).reshape(-1)


def _assoc_attn(sd: dict, prefix: str, d_model: int, num_heads: int) -> dict:
    """Custom associator attention (associator.py:72-88) -> canonical layout."""
    perm = _head_minor_perm(d_model, num_heads)
    out = {}
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        k = _conv1d_dense(sd[f"{prefix}.proj.{i}.weight"])   # [in, out]
        b = np.asarray(sd[f"{prefix}.proj.{i}.bias"])
        out[name] = {"kernel": k[:, perm], "bias": b[perm]}
    mk = _conv1d_dense(sd[f"{prefix}.merge.weight"])          # [in, out]
    out["merge"] = {"kernel": mk[perm, :], "bias": np.asarray(sd[f"{prefix}.merge.bias"])}
    return out


def _assoc_prop(sd: dict, prefix: str, d_model: int, num_heads: int) -> dict:
    p = _assoc_attn(sd, f"{prefix}.attn", d_model, num_heads)
    p["mlp"] = {
        "layer0": {"kernel": _conv1d_dense(sd[f"{prefix}.mlp.0.weight"]),
                   "bias": np.asarray(sd[f"{prefix}.mlp.0.bias"])},
        "layer1": {"kernel": _conv1d_dense(sd[f"{prefix}.mlp.2.weight"]),
                   "bias": np.asarray(sd[f"{prefix}.mlp.2.bias"])},
    }
    return p


def convert_associator(sd: dict, d_model: int = 256, num_heads: int = 4,
                       n_gnn: int = 8, n_fuser: int = 2) -> dict:
    """Reference associator.pth ``model`` state dict -> Associator flax params."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    p: dict = {
        "encoder": {
            "layer0": {"kernel": _conv1d_dense(sd["encoder.0.weight"]),
                       "bias": sd["encoder.0.bias"]},
            "layer1": {"kernel": _conv1d_dense(sd["encoder.2.weight"]),
                       "bias": sd["encoder.2.bias"]},
        },
        "final_proj": {"kernel": _conv1d_dense(sd["final_proj.weight"]),
                       "bias": sd["final_proj.bias"]},
        "bin_score": sd["bin_score"],
    }
    for i in range(n_fuser):
        p[f"fuser_layer{i}"] = _assoc_prop(sd, f"fuser.layers.{i}", d_model, num_heads)
    for i in range(n_gnn):
        p[f"gnn_layer{i}"] = _assoc_prop(sd, f"gnn.layers.{i}", d_model, num_heads)
    return {"params": p}


def load_torch_checkpoint(path: str, key: str = "model") -> dict:
    """A reference ``.pth`` -> a flat numpy state dict.

    The reference's checkpoints pickle their training arguments beside the
    weights, so this unpickles the file (``weights_only=False``): load only
    checkpoints from a source you trust.
    """
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt[key] if isinstance(ckpt, dict) and key in ckpt else ckpt
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}
