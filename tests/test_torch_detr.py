"""odam_torch's DETR, postprocess and NMS against odam_tpu on the CPU.

Weights come from a seeded Flax init, converted by odam_torch.models.convert;
inputs are made with numpy and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odam_torch.models import convert
from odam_torch.models import detr as t_detr
from odam_torch.models import position as t_pos
from odam_tpu.models import detr as j_detr
from odam_tpu.models import position as j_pos

HEADS = ("pred_logits", "pred_boxes", "pred_angle", "pred_offset", "pred_size",
         "pred_depth")


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _compare_outputs(jo, to, atol, rtol):
    for name in HEADS + ("pred_obj_features",):
        np.testing.assert_allclose(to[name].numpy(), np.asarray(jo[name]),
                                   atol=atol, rtol=rtol, err_msg=name)
    assert len(to["aux_outputs"]) == len(jo["aux_outputs"])
    for ja, ta in zip(jo["aux_outputs"], to["aux_outputs"]):
        for name in HEADS:
            np.testing.assert_allclose(ta[name].numpy(), np.asarray(ja[name]),
                                       atol=atol, rtol=rtol, err_msg=name)


def test_full_width_detr_forward_matches():
    """ResNet-50, hidden 256, 8 heads, FFN 2048, 100 queries, 18 classes with
    1+1 transformer layers at a 64x64 image; every leaf of the full-width
    Flax tree is converted.  Tolerance atol 2e-4 + rtol 2e-4: both run f32 on
    the CPU, but through 53 convolutions whose sums run in another order, and
    the random ResNet's activations grow to O(100) before the projection."""
    cfg_kw = dict(enc_layers=1, dec_layers=1)
    jmodel = j_detr.DETR(j_detr.DETRConfig(**cfg_kw))
    img = np.random.default_rng(0).normal(size=(1, 64, 64, 3)).astype(np.float32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(img))
    jo = jmodel.apply(params, jnp.asarray(img))

    tree = _numpy_tree(params)
    sd = convert.flax_to_state_dict(tree)
    n_leaves = len(jax.tree.leaves(params))
    tmodel = t_detr.build_detr(t_detr.DETRConfig(**cfg_kw), flax_params=tree, device="cpu")
    assert len(sd) == n_leaves == len(tmodel.state_dict())
    with torch.no_grad():
        to = tmodel(torch.from_numpy(img))
    _compare_outputs(jo, to, atol=2e-4, rtol=2e-4)


def test_tiny_detr_with_pixel_mask_matches():
    """TinyBackbone (GroupNorm eps 1e-6) with a non-empty pixel mask, so the
    nearest mask resize and the masked sine encoding both matter; f32 sums in
    another order, atol 5e-5."""
    cfg_kw = dict(num_classes=8, num_queries=12, hidden_dim=32, nheads=4, enc_layers=2,
                  dec_layers=2, dim_feedforward=64, backbone="tiny", backbone_stage=3)
    jmodel = j_detr.DETR(j_detr.DETRConfig(**cfg_kw))
    rng = np.random.default_rng(1)
    img = rng.normal(size=(2, 96, 80, 3)).astype(np.float32)
    mask = np.zeros((2, 96, 80), bool)
    mask[0, 70:] = True
    mask[1, :, 50:] = True
    params = jmodel.init(jax.random.key(1), jnp.asarray(img), jnp.asarray(mask))
    jo = jmodel.apply(params, jnp.asarray(img), jnp.asarray(mask))
    tmodel = t_detr.build_detr(t_detr.DETRConfig(**cfg_kw), flax_params=_numpy_tree(params),
                               device="cpu")
    with torch.no_grad():
        to = tmodel(torch.from_numpy(img), torch.from_numpy(mask))
    _compare_outputs(jo, to, atol=5e-5, rtol=0)


@pytest.mark.parametrize("shape,out", [((64, 64), (2, 2)), ((800, 1071), (25, 34)),
                                       ((192, 192), (12, 12))])
def test_mask_resize_and_sine_encoding_match(shape, out):
    rng = np.random.default_rng(shape[0])
    mask = rng.random((2,) + shape) < 0.3
    mask[1, : shape[0] // 3] = True
    j_small = jax.image.resize(jnp.asarray(mask, jnp.float32), (2,) + out,
                               method="nearest").astype(bool)
    t_small = torch.nn.functional.interpolate(
        torch.from_numpy(mask)[:, None].float(), size=out, mode="nearest-exact")[:, 0].bool()
    np.testing.assert_array_equal(t_small.numpy(), np.asarray(j_small))
    np.testing.assert_allclose(
        t_pos.sine_position_encoding(t_small, 16).numpy(),
        np.asarray(j_pos.sine_position_encoding(j_small, 16)), atol=2e-6)


def test_timestep_encoding_matches():
    pos = np.arange(-1, 99, dtype=np.float32).reshape(4, 25)
    np.testing.assert_allclose(
        t_pos.timestep_encoding(torch.from_numpy(pos), 64).numpy(),
        np.asarray(j_pos.timestep_encoding(jnp.asarray(pos), 64)), atol=2e-5)


def _raw_outputs(seed, B=1, Q=40, C=8, bins=30, D=16):
    rng = np.random.default_rng(seed)
    out = {
        "pred_logits": rng.normal(size=(B, Q, C + 1)) * 3,
        "pred_boxes": rng.uniform(0.05, 0.95, size=(B, Q, 4)) * [1, 1, 0.3, 0.3],
        "pred_angle": rng.normal(size=(B, Q, bins)),
        "pred_offset": rng.normal(size=(B, Q, 2)) * 0.02,
        "pred_size": rng.uniform(0.3, 1.5, size=(B, Q, 3)),
        "pred_depth": rng.uniform(1.0, 4.0, size=(B, Q, 1)),
        "pred_obj_features": rng.normal(size=(B, Q, D)),
    }
    # exact score ties between distinct queries: the lower index ranks first
    out["pred_logits"][:, 5] = out["pred_logits"][:, 3]
    out["pred_boxes"][:, 5] = out["pred_boxes"][:, 3] + 0.01
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.mark.parametrize("seed,Q,threshold", [(0, 40, 0.2), (1, 100, 0.0), (2, 12, 0.3)])
def test_postprocess_matches(seed, Q, threshold):
    """valid, classes and slot order exact; float rows within atol 1e-4
    (pixels of a 640x480 frame, metres)."""
    raw = _raw_outputs(seed, Q=Q)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    jd = j_detr.postprocess({k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(640.0),
                            jnp.asarray(480.0), jnp.asarray(threshold), jnp.asarray(K))
    td = t_detr.postprocess({k: torch.from_numpy(v) for k, v in raw.items()}, 640.0, 480.0,
                            threshold, torch.from_numpy(K))
    assert td.valid.shape == (1, t_detr.MAX_DETECTIONS)
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    v = td.valid.numpy()
    np.testing.assert_array_equal(td.classes.numpy()[v], np.asarray(jd.classes)[v])
    for name in ("scores", "boxes", "dims", "t_co", "angle_deg", "features"):
        np.testing.assert_allclose(getattr(td, name).numpy()[v], np.asarray(getattr(jd, name))[v],
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("seed", range(6))
def test_fixpoint_nms_equals_sequential_sweep(seed):
    """The fixed-round fixpoint NMS equals the greedy sweep and JAX's
    while_loop fixpoint, on crowded candidates with exact score ties."""
    rng = np.random.default_rng(seed)
    Q = 60
    classes = rng.integers(0, 3, Q).astype(np.int32)
    scores = rng.choice(np.linspace(0.3, 0.9, 12), Q).astype(np.float32)   # many ties
    t_co = (rng.normal(size=(Q, 3)) * 0.4 + [0, 0, 3]).astype(np.float32)
    dims = rng.uniform(0.3, 1.0, size=(Q, 3)).astype(np.float32)
    xy = rng.uniform(0, 500, size=(Q, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(40, 160, size=(Q, 2))], 1).astype(np.float32)
    valid = rng.random(Q) < 0.8
    args = (classes, scores, t_co, dims, boxes, valid)
    t_args = [torch.from_numpy(a) for a in args]
    keep = t_detr.nms_3d_mask(*t_args).numpy()
    np.testing.assert_array_equal(keep, t_detr._nms_3d_mask_sequential(*t_args).numpy())
    np.testing.assert_array_equal(
        keep, np.asarray(j_detr.nms_3d_mask(*[jnp.asarray(a) for a in args])))
    assert 0 < keep.sum() < valid.sum()
