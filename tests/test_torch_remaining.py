"""The last definitions of odam_tpu ported to odam_torch, against JAX's on
the CPU: the DETR options (pre-norm, the dilated last stage, the learned
position encoding, the s2d and im2col stems, ``resnet50``), the device 3D
box family, the host boxes, ``projected_bbox``, ``sq_inside_outside``, both
transforms, the quadric fitting functions and ``quadric_algebra``, and the
native sampler.  Inputs are made with numpy from a seed; models run with
weights converted from a seeded Flax init, JAX's applies jitted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odam_torch import native as t_native
from odam_torch.data import transforms as t_tf
from odam_torch.mapping import quadric as t_quad
from odam_torch.mapping import quadric_algebra as t_qa
from odam_torch.mapping import superquadric as t_sq
from odam_torch.models import convert
from odam_torch.models import detr as t_detr
from odam_torch.models import position as t_pos
from odam_torch.models import resnet as t_resnet
from odam_torch.ops import kernels
from odam_torch.ops import surface as t_surf
from odam_torch.utils import boxes as t_boxes
from odam_torch.utils import host_boxes as t_hb
from odam_tpu import native as j_native
from odam_tpu.data import transforms as j_tf
from odam_tpu.mapping import quadric as j_quad
from odam_tpu.mapping import quadric_algebra as j_qa
from odam_tpu.mapping import superquadric as j_sq
from odam_tpu.models import detr as j_detr
from odam_tpu.models import position as j_pos
from odam_tpu.models import resnet as j_resnet
from odam_tpu.ops import surface as j_surf
from odam_tpu.utils import boxes as j_boxes
from odam_tpu.utils import geometry as j_geo
from odam_tpu.utils import host_boxes as j_hb
from torch_threads import one_torch_thread  # noqa: F401

HEADS = ("pred_logits", "pred_boxes", "pred_angle", "pred_offset", "pred_size", "pred_depth",
         "pred_obj_features")


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _seeded(tm, seed):
    """The port's module with its seeded Flax-like init, and the same weights
    as a Flax variable dict for JAX's apply (no JAX init to compile)."""
    convert.init_flax_like_(tm, seed)
    return tm.eval(), {"params": convert.state_dict_to_flax(tm)}


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("stem,dilate", [("im2col", True)])
def test_resnet_stem_and_dilation_match(stem, dilate):
    """A one-block-a-stage ResNet at 64x64 with the im2col stem and the
    dilated last stage (the s2d stem runs in the full-width test below)
    against JAX's on the same weights.  f32, sums in another order over 13
    convolutions: atol 1e-4 + rtol 1e-4.  The port's stem gives the literal
    conv's output within 1e-5."""
    img = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = j_resnet.ResNet(stage_sizes=(1, 1, 1, 1), return_stages=(3, 4), dilate_last=dilate,
                         stem=stem)
    tm, params = _seeded(t_resnet.ResNet((1, 1, 1, 1), (3, 4), torch.float32, dilate, stem), 5)
    want = jax.jit(jm.apply)(params, jnp.asarray(img))
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tm(x)
        tm.stem = "conv"
        literal = tm(x)
    for s in (3, 4):
        np.testing.assert_allclose(got[s].permute(0, 2, 3, 1).numpy(), np.asarray(want[s]),
                                   atol=1e-4, rtol=1e-4, err_msg=f"stage {s}")
        np.testing.assert_allclose(got[s].numpy(), literal[s].numpy(), atol=1e-5, rtol=1e-5)
    assert got[4].shape[-1] == (4 if dilate else 2)       # the dilated stage keeps stride 16


@pytest.mark.parametrize("opts", [{"pre_norm": True, "position_embedding": "learned"}])
def test_tiny_detr_options_match(opts):
    """TinyBackbone DETR (2+2 layers) with pre-norm (encoder_norm, normed
    block inputs) and the learned-encoding option, which JAX's DETR stores
    and does not read: f32, atol 5e-5 as the tiny DETR's parity test."""
    kw = dict(num_classes=8, num_queries=12, hidden_dim=32, nheads=4, enc_layers=2, dec_layers=2,
              dim_feedforward=64, backbone="tiny", backbone_stage=3, **opts)
    img = np.random.default_rng(2).normal(size=(1, 64, 64, 3)).astype(np.float32)
    jm = j_detr.DETR(j_detr.DETRConfig(**kw))
    tm, params = _seeded(t_detr.DETR(t_detr.DETRConfig(**kw)), 2)
    jo = jax.jit(jm.apply)(params, jnp.asarray(img))
    assert "transformer.encoder_norm.weight" in tm.state_dict()
    with torch.no_grad():
        to = tm(torch.from_numpy(img))
    for name in HEADS:
        np.testing.assert_allclose(to[name].numpy(), np.asarray(jo[name]), atol=5e-5,
                                   err_msg=name)


def test_full_width_detr_all_four_options_match():
    """ResNet-50 (``resnet50`` with the s2d stem and the dilated last stage),
    hidden 256, 8 heads, 100 queries, pre-norm 1+1 layers and the learned
    option, at 64x64, every leaf converted: atol 2e-4 + rtol 2e-4, the
    full-width DETR parity test's bar (53 convolutions summed in another
    order)."""
    opts = dict(pre_norm=True, dilation=True, position_embedding="learned", stem="s2d",
                enc_layers=1, dec_layers=1)
    cfg = t_detr.DETRConfig.from_cfg({**opts, "num_classes": 18})
    assert (cfg.pre_norm, cfg.dilation, cfg.position_embedding, cfg.stem) == (
        True, True, "learned", "s2d")
    img = np.random.default_rng(3).normal(size=(1, 64, 64, 3)).astype(np.float32)
    jm = j_detr.DETR(j_detr.DETRConfig.from_cfg({**opts, "num_classes": 18}))
    tm, params = _seeded(t_detr.DETR(cfg), 3)
    jo = jax.jit(jm.apply)(params, jnp.asarray(img))
    shapes = jax.eval_shape(jm.init, jax.random.key(3), jnp.asarray(img))["params"]
    assert jax.tree.map(lambda x: x.shape, shapes) == jax.tree.map(np.shape, params["params"])
    with torch.no_grad():
        to = tm(torch.from_numpy(img))
    for name in HEADS:
        np.testing.assert_allclose(to[name].numpy(), np.asarray(jo[name]), atol=2e-4, rtol=2e-4,
                                   err_msg=name)
    ref = t_resnet.resnet50(dilate_last=True, stem="s2d")
    assert [n for n, _ in ref.named_parameters()] == [
        n[len("backbone."):] for n, _ in tm.named_parameters() if n.startswith("backbone.")]


def test_learned_position_encoding_matches():
    jm = j_pos.LearnedPositionEncoding(num_pos_feats=16, max_size=20)
    params = jm.init(jax.random.key(4), (2, 7, 9))
    want = np.asarray(jm.apply(params, (2, 7, 9)))
    tm = t_pos.LearnedPositionEncoding(16, 20)
    convert.load_flax_params(tm, _tree(params))
    np.testing.assert_array_equal(tm((2, 7, 9)).detach().numpy(), want)
    assert convert.flax_path(tm, "row_embed.weight") == ("row_embed", "embedding")
    convert.init_flax_like_(tm, 0)
    assert 0.1 < float(tm.row_embed.weight.detach().std()) < 0.4    # 16^-1/2, truncated


# --------------------------------------------------------------- 3D boxes

def _corners(rng, n):
    dims = rng.uniform(0.5, 2.0, (n, 3))
    angle = rng.uniform(-np.pi, np.pi, n)
    center = rng.normal(0.0, 0.6, (n, 3))
    return np.array(jax.vmap(j_geo.box3d_corners)(jnp.asarray(dims), jnp.asarray(angle),
                                                  jnp.asarray(center)), np.float32)


def test_box3d_family_matches_jax_and_host():
    """pairwise_box3d_iou (box3d_iou, the clipped quadrilaterals' areas,
    box3d_vol) against JAX's (jitted) within 1e-5; box3d_iou's 3D and BEV
    IoU against the host's exact box3d_iou (float64) within 1e-4, with
    convex_quad_intersection_area held through the BEV IoU; one pair is a
    box with itself (IoU 1), many pairs do not touch (0)."""
    rng = np.random.default_rng(6)
    a, b = _corners(rng, 12), _corners(rng, 9)
    b[0] = a[0]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    pair = np.asarray(jax.jit(j_boxes.pairwise_box3d_iou)(jnp.asarray(a), jnp.asarray(b)))
    got = t_boxes.pairwise_box3d_iou(ta, tb).numpy()
    np.testing.assert_allclose(got, pair, atol=1e-5)
    assert abs(got[0, 0] - 1.0) < 1e-5 and (got == 0).sum() > 10
    iou, bev = t_boxes.box3d_iou(ta[:9], tb)
    host = np.array([t_hb.box3d_iou(x, y) for x, y in zip(a[:9], b)])
    np.testing.assert_allclose(iou.numpy(), host[:, 0], atol=1e-4)
    np.testing.assert_allclose(bev.numpy(), host[:, 1], atol=1e-4)
    np.testing.assert_allclose(t_boxes.box3d_vol(ta).numpy(),
                               np.asarray(j_boxes.box3d_vol(jnp.asarray(a))), rtol=1e-6)
    # the BEV IoU is the clipped area over the union: the area, held directly
    q1, q2 = torch.from_numpy(a[:9, [3, 2, 1, 0], :2]), torch.from_numpy(b[:, [3, 2, 1, 0], :2])
    inter = t_boxes.convex_quad_intersection_area(q1, q2).numpy()
    union = t_boxes._quad_area(q1).numpy() + t_boxes._quad_area(q2).numpy() - inter
    np.testing.assert_allclose(inter / union, host[:, 1], atol=1e-4)


def test_aabb_functions_match():
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(5, 40, 3)).astype(np.float32)
    box = t_boxes.aabb_from_points(torch.from_numpy(pts))
    np.testing.assert_array_equal(box.numpy(), np.asarray(j_boxes.aabb_from_points(pts)))
    other = box.flip(0) + 0.3
    np.testing.assert_allclose(t_boxes.giou_aabb(box, other).numpy(),
                               np.asarray(j_boxes.giou_aabb(box.numpy(), other.numpy())),
                               rtol=1e-6)


def test_host_boxes_match_exactly():
    """The host min-area rectangle, oriented box and orientation: the same
    NumPy code, equal bit for bit."""
    rng = np.random.default_rng(8)
    for n in (3, 20, 200):
        pts = rng.normal(size=(n, 3)) * [2.0, 0.5, 1.0]
        c, ang = t_hb.min_area_rect(pts[:, :2])
        jc, jang = j_hb.min_area_rect(pts[:, :2])
        np.testing.assert_array_equal(c, jc)
        assert ang == jang
        np.testing.assert_array_equal(t_hb.oriented_bbox_3d(pts), j_hb.oriented_bbox_3d(pts))
        corners, theta = t_hb.bbox_and_orientation(pts)
        jcorners, jtheta = j_hb.bbox_and_orientation(pts)
        np.testing.assert_array_equal(corners, jcorners)
        assert theta == jtheta


# ------------------------------------------------------------- mapping ops

def _sq_params(rng, n):
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.uniform(-1, 1, n).astype(np.float32),
            rng.uniform(0.3, 1.0, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 2)).astype(np.float32))


def test_projected_bbox_and_inside_outside_match():
    """projected_bbox through the deterministic sampler (64 points) within
    1e-3 px + rtol 1e-5 of JAX's (float32 projections summed in another
    order; pixels up to a few hundred); sq_inside_outside within rtol 1e-5."""
    rng = np.random.default_rng(9)
    leaves = _sq_params(rng, 4)
    P = np.concatenate([np.eye(3) * 500.0, rng.normal(size=(3, 1)) + [[0], [0], [6]]], 1)
    P[:2, 2] = 320.0, 240.0
    P = np.broadcast_to(P.astype(np.float32), (4, 3, 4))
    want = jax.jit(j_sq.projected_bbox, static_argnames="n_samples")(
        j_sq.SQParams(*map(jnp.asarray, leaves)), jnp.asarray(P), n_samples=64)
    got = t_sq.projected_bbox(t_sq.SQParams(*map(torch.from_numpy, leaves)), torch.from_numpy(P),
                              n_samples=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-5)
    pts = rng.normal(size=(4, 30, 3)).astype(np.float32)
    scales = rng.uniform(0.3, 1.5, (4, 3)).astype(np.float32)
    eps = rng.uniform(0.2, 1.6, (4, 2)).astype(np.float32)
    np.testing.assert_allclose(
        t_surf.sq_inside_outside(*map(torch.from_numpy, (pts, scales, eps))).numpy(),
        np.asarray(j_surf.sq_inside_outside(pts, scales, eps)), rtol=1e-5)


def test_transforms_match():
    """inference_transform (host NumPy) bit-equal; yuv420_to_rgb_device on
    an odd-sized frame within 1e-4 of JAX's."""
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (45, 61, 3), dtype=np.uint8)
    np.testing.assert_array_equal(t_tf.inference_transform(img, 64, 100),
                                  j_tf.inference_transform(img, 64, 100))
    y, uv = j_tf.rgb_to_yuv420(img)
    np.testing.assert_allclose(
        t_tf.yuv420_to_rgb_device(torch.from_numpy(y), torch.from_numpy(uv)).numpy(),
        np.asarray(jax.jit(j_tf.yuv420_to_rgb_device)(y, uv)), atol=1e-4)


def test_quadric_functions_match():
    """plane_distance_residual, decompose_quadric, ellipsoid_points and five
    fit_quadric iterations against JAX's (f32, atol 1e-4: the fit is Adam on
    the same float32 steps), and quadric_algebra, a NumPy copy, equal."""
    rng = np.random.default_rng(11)
    O, V = 3, 5
    translate = (rng.normal(size=(O, 3)) + [0, 0, 5]).astype(np.float32)
    angle = rng.uniform(-1, 1, O).astype(np.float32)
    half = rng.uniform(0.3, 1.0, (O, 3)).astype(np.float32)
    Q = np.asarray(j_quad.quadric_matrix(translate, angle, half ** 2))
    planes = rng.normal(size=(O, 4, 4)).astype(np.float32)
    planes[..., :3] /= np.linalg.norm(planes[..., :3], axis=-1, keepdims=True)
    pmask = np.ones((O, 4), np.float32)
    pmask[0, 2:] = 0
    np.testing.assert_allclose(
        t_quad.plane_distance_residual(*map(torch.from_numpy, (Q, planes, pmask))).numpy(),
        np.asarray(j_quad.plane_distance_residual(Q, planes, pmask)), rtol=1e-5, atol=1e-6)
    for got, want in zip(t_quad.decompose_quadric(Q[1]), j_quad.decompose_quadric(Q[1])):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(t_quad.ellipsoid_points(Q[2], 12), j_quad.ellipsoid_points(Q[2], 12)):
        np.testing.assert_array_equal(got, want)

    Ms = np.concatenate([np.broadcast_to(np.eye(3) * [400, 400, 1], (O, V, 3, 3)),
                         rng.normal(0, 0.2, (O, V, 3, 1))], -1).astype(np.float32)
    Ms[..., :2, 2] = 200.0
    lines = np.asarray(j_quad.conic_bbox_lines(np.einsum("ovij,ojk,ovlk->ovil", Ms, Q, Ms)))
    lines = (lines + rng.normal(0, 2.0, lines.shape)).astype(np.float32)
    lmask = (rng.random((O, V, 4)) < 0.8).astype(np.float32)
    args = (translate + 0.1, angle + 0.05, half * 1.2, lines, lmask, Ms, planes, pmask)
    want = j_quad.fit_quadric(*map(jnp.asarray, args), n_iters=5, plane_weight=0.5)
    got = t_quad.fit_quadric(*map(torch.from_numpy, args), n_iters=5, plane_weight=0.5)
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-4, rtol=1e-5, err_msg=name)
    assert float(got.loss_log[-1]) < float(got.loss_log[0])

    corners = np.asarray(j_geo.box3d_corners(half[0] * 2, 0.0, translate[0]))
    faces = t_qa.aabb_face_planes(corners)
    for x, y in zip(faces, j_qa.aabb_face_planes(corners)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(t_qa.quadric_from_planes_svd(faces),
                                  j_qa.quadric_from_planes_svd(faces))
    np.testing.assert_array_equal(t_qa.vector_to_quadric(t_qa.quadric_to_vector(Q[0])),
                                  j_qa.vector_to_quadric(j_qa.quadric_to_vector(Q[0])))
    box = np.array([30.0, 40.0, 200.0, 150.0])
    for x, y in zip(t_qa.bbox_edge_lines(box, 240, 320), j_qa.bbox_edge_lines(box, 240, 320)):
        np.testing.assert_array_equal(x, y)
    T_wc = np.eye(4)
    T_wc[:3, 3] = [0.2, -0.1, 0.5]
    for x, y in zip(t_qa.depth_bound_planes(corners, T_wc), j_qa.depth_bound_planes(corners, T_wc)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        t_qa.backproject_line_to_plane(np.array([1.0, 0.5, -30.0]), Ms[0, 0].astype(np.float64)),
        j_qa.backproject_line_to_plane(np.array([1.0, 0.5, -30.0]), Ms[0, 0].astype(np.float64)))


# ------------------------------------------------------------------ native

@pytest.mark.parametrize("deterministic,seed", [(True, 0), (False, 0), (False, 7)])
def test_native_sampler_bit_equal(deterministic, seed):
    """The port's copy of sq_sampler.cpp, built into odam_torch/_build/,
    against odam_tpu.native: the same angles, bit for bit."""
    rng = np.random.default_rng(12)
    scales = rng.uniform(0.2, 1.5, (2, 3, 3)).astype(np.float32)
    eps = rng.uniform(0.2, 1.6, (2, 3, 2)).astype(np.float32)
    got = t_native.sample_sq_batch(scales, eps, 300, seed=seed, deterministic=deterministic)
    want = j_native.sample_sq_batch(scales, eps, 300, seed=seed, deterministic=deterministic)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    path = kernels.NATIVE.info["path"]
    assert "odam_torch" in path and "_build" in path
    with pytest.raises(ValueError):
        t_native.sample_sq_batch(scales[0], eps[0])


def test_detr_config_keeps_the_new_fields():
    """DETRConfig carries JAX's fields under JAX's names (use_pallas is
    use_kernels)."""
    t_fields = {f.name for f in dataclasses.fields(t_detr.DETRConfig)}
    j_fields = {f.name for f in dataclasses.fields(j_detr.DETRConfig)}
    assert j_fields - {"use_pallas"} == t_fields - {"use_kernels"}
