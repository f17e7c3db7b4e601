"""Reference ``.pth`` checkpoints through the port's CLI loader against the
JAX package's converters on the CPU.

A reference-layout state dict is built from a Flax init with the inverse
transposes of ``tests/test_porting_roundtrip.py`` (torchvision ResNet-50
names, packed ``in_proj`` attention, head-minor associator conv1d layers)
and saved as a ``.pth`` with a pickled argument namespace beside the
weights, as the reference's checkpoints have it.  The port's
``run_processor.build_models`` reads it; JAX's ``porting.convert_*`` +
apply is the reference.
"""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from odam_torch.models import convert
from odam_torch.models import porting as t_porting
from odam_torch.scripts import run_processor as t_run
from odam_tpu.models import associator as j_assoc
from odam_tpu.models import detr as j_detr
from odam_tpu.models import porting as j_porting
from test_porting_roundtrip import _bn_out, _dense_out, _inv_conv, _inv_t, _ln_out, _mha_out
from torch_threads import one_torch_thread  # noqa: F401

CFG = {"enc_layers": 1, "dec_layers": 1, "GNN_layers": ["self", "cross"],
       "self_GNN_layers": ["self"], "sinkhorn_iterations": 10}


def _detr_state_dict(p, enc_layers, dec_layers):
    sd = {}
    bb = p["backbone"]
    sd["backbone.0.body.conv1.weight"] = _inv_conv(bb["conv1"]["kernel"])
    _bn_out(sd, "backbone.0.body.bn1", bb["bn1"])
    for stage, n_blocks in enumerate((3, 4, 6, 3), start=1):
        for blk in range(n_blocks):
            fb, tp = bb[f"layer{stage}_{blk}"], f"backbone.0.body.layer{stage}.{blk}"
            for c in (1, 2, 3):
                sd[f"{tp}.conv{c}.weight"] = _inv_conv(fb[f"conv{c}"]["kernel"])
                _bn_out(sd, f"{tp}.bn{c}", fb[f"bn{c}"])
            if "downsample_conv" in fb:
                sd[f"{tp}.downsample.0.weight"] = _inv_conv(fb["downsample_conv"]["kernel"])
                _bn_out(sd, f"{tp}.downsample.1", fb["downsample_bn"])
    tr = p["transformer"]
    for i in range(enc_layers):
        fl, tp = tr[f"encoder_layer{i}"], f"transformer.encoder.layers.{i}"
        _mha_out(sd, f"{tp}.self_attn", fl["self_attn"])
        for n in ("linear1", "linear2"):
            _dense_out(sd, f"{tp}.{n}", fl[n])
        for n in ("norm1", "norm2"):
            _ln_out(sd, f"{tp}.{n}", fl[n])
    for i in range(dec_layers):
        fl, tp = tr[f"decoder_layer{i}"], f"transformer.decoder.layers.{i}"
        _mha_out(sd, f"{tp}.self_attn", fl["self_attn"])
        _mha_out(sd, f"{tp}.multihead_attn", fl["multihead_attn"])
        for n in ("linear1", "linear2"):
            _dense_out(sd, f"{tp}.{n}", fl[n])
        for n in ("norm1", "norm2", "norm3"):
            _ln_out(sd, f"{tp}.{n}", fl[n])
    _ln_out(sd, "transformer.decoder.norm", tr["decoder_norm"])
    sd["input_proj.weight"] = _inv_conv(p["input_proj"]["kernel"])
    sd["input_proj.bias"] = np.asarray(p["input_proj"]["bias"])
    sd["query_embed.weight"] = np.asarray(p["query_embed"])
    _dense_out(sd, "class_embed", p["class_embed"])
    for head in ("bbox", "offset", "angle", "size", "depth"):
        for i in range(3):
            _dense_out(sd, f"{head}_embed.layers.{i}", p[f"{head}_embed"][f"layer{i}"])
    return sd


def _assoc_state_dict(p, d_model, num_heads):
    inv_perm = np.argsort(j_porting._head_minor_perm(d_model, num_heads))

    def conv1d_out(sd, name, fp):
        sd[f"{name}.weight"] = _inv_t(fp["kernel"])[:, :, None]
        sd[f"{name}.bias"] = np.asarray(fp["bias"])

    def prop_out(sd, name, fp):
        for i, n in enumerate(("q_proj", "k_proj", "v_proj")):
            sd[f"{name}.attn.proj.{i}.weight"] = _inv_t(
                np.asarray(fp[n]["kernel"])[:, inv_perm])[:, :, None]
            sd[f"{name}.attn.proj.{i}.bias"] = np.asarray(fp[n]["bias"])[inv_perm]
        sd[f"{name}.attn.merge.weight"] = _inv_t(
            np.asarray(fp["merge"]["kernel"])[inv_perm, :])[:, :, None]
        sd[f"{name}.attn.merge.bias"] = np.asarray(fp["merge"]["bias"])
        conv1d_out(sd, f"{name}.mlp.0", fp["mlp"]["layer0"])
        conv1d_out(sd, f"{name}.mlp.2", fp["mlp"]["layer1"])

    sd = {"bin_score": np.asarray(p["bin_score"])}
    conv1d_out(sd, "encoder.0", p["encoder"]["layer0"])
    conv1d_out(sd, "encoder.2", p["encoder"]["layer1"])
    conv1d_out(sd, "final_proj", p["final_proj"])
    prop_out(sd, "fuser.layers.0", p["fuser_layer0"])
    for i in range(2):
        prop_out(sd, f"gnn.layers.{i}", p[f"gnn_layer{i}"])
    return sd


def _save_pth(path, sd):
    """A reference-style checkpoint: weights under "model", pickled args
    beside them (so it loads only with weights_only=False)."""
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                "args": argparse.Namespace(lr=1e-4, backbone="resnet50")}, path)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def test_reference_pth_loads_through_the_cli(tmp_path):
    """Both .pth files through ``run_processor.build_models``: the port's
    converters give JAX's Flax trees leaf for leaf (exact), and the loaded
    modules give JAX's outputs from ``porting.convert_*`` + apply.  DETR at
    full width (ResNet-50, 100 queries, 1+1 layers) on a 64x64 image:
    within atol 2e-4 + rtol 2e-4, tests/test_torch_detr.py's bar for the
    same model (53 convolutions summed in another order, activations of
    O(100)); the associator (256-d, 1 fuser + 2 GNN layers): log assignment
    within atol 1e-5, matches exact."""
    dcfg = j_detr.DETRConfig(enc_layers=1, dec_layers=1)
    jdetr = j_detr.DETR(dcfg)
    img = np.random.default_rng(0).normal(size=(1, 64, 64, 3)).astype(np.float32)
    dparams = jax.jit(jdetr.init)(jax.random.key(0), jnp.asarray(img))
    acfg = j_assoc.AssociatorConfig(gnn_layers=("self", "cross"), self_gnn_layers=("self",),
                                    sinkhorn_iterations=10)
    jassoc = j_assoc.Associator(acfg)
    rng = np.random.default_rng(1)
    tracks = (rng.normal(size=(1, 6, 4, 79)) * 0.5).astype(np.float32)
    tracks[..., 0] = np.arange(4)
    dets = (rng.normal(size=(1, 5, 79)) * 0.5).astype(np.float32)
    dets[..., 0] = 4
    aargs = (tracks, np.arange(6)[None] < 4, dets, np.arange(5)[None] < 3)
    aparams = jax.jit(jassoc.init)(jax.random.key(1), *map(jnp.asarray, aargs))

    det_path, assoc_path = str(tmp_path / "detector.pth"), str(tmp_path / "associator.pth")
    _save_pth(det_path, _detr_state_dict(dparams["params"], 1, 1))
    _save_pth(assoc_path, _assoc_state_dict(aparams["params"], 256, acfg.num_heads))

    jd_tree = j_porting.convert_detr(j_porting.load_torch_checkpoint(det_path), 1, 1)
    ja_tree = j_porting.convert_associator(j_porting.load_torch_checkpoint(assoc_path),
                                           n_gnn=2, n_fuser=1)
    td_tree = t_porting.convert_detr(t_porting.load_torch_checkpoint(det_path), 1, 1)
    ta_tree = t_porting.convert_associator(t_porting.load_torch_checkpoint(assoc_path),
                                           n_gnn=2, n_fuser=1)
    for t_tree, j_tree in ((td_tree, jd_tree), (ta_tree, ja_tree)):
        a, b = _flatten(t_tree), _flatten(j_tree)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    tdetr, tassoc = t_run.build_models(CFG, det_path, assoc_path, "exact", torch.device("cpu"),
                                       torch.float32)
    assert len(convert.flax_to_state_dict(td_tree)) == len(tdetr.state_dict())
    jo = jax.jit(jdetr.apply)(jax.tree.map(jnp.asarray, jd_tree), jnp.asarray(img))
    with torch.no_grad():
        to = tdetr(torch.from_numpy(img))
    for name in ("pred_logits", "pred_boxes", "pred_angle", "pred_offset", "pred_size",
                 "pred_depth", "pred_obj_features"):
        np.testing.assert_allclose(to[name].numpy(), np.asarray(jo[name]), atol=2e-4, rtol=2e-4,
                                   err_msg=name)
    ja = jax.jit(jassoc.apply)(jax.tree.map(jnp.asarray, ja_tree), *map(jnp.asarray, aargs), 0.05)
    with torch.no_grad():
        ta = tassoc(*map(torch.from_numpy, aargs), 0.05)
    live = np.asarray(ja.log_assignment) > -1e8
    np.testing.assert_allclose(ta.log_assignment.numpy()[live],
                               np.asarray(ja.log_assignment)[live], atol=1e-5)
    np.testing.assert_array_equal(ta.matches.numpy(), np.asarray(ja.matches))
    assert os.path.getsize(det_path) > 0
