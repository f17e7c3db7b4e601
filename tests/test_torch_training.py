"""odam_torch's training path against odam_tpu's on the CPU: the matcher,
the set criterion, dropout, the detector and associator train steps (loss,
gradients, parameters after 3 steps, group labels, frozen leaves), and the
attention wrappers' refusal to cut a gradient.

Weights are the port's seeded init, handed to JAX as a Flax tree through
``convert.state_dict_to_flax``; inputs are made with numpy.  Each JAX train
step is compiled once, in a module-scoped fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from odam_torch.models import associator as t_assoc
from odam_torch.models import convert
from odam_torch.models import criterion as t_crit
from odam_torch.models import detr as t_detr
from odam_torch.models import matcher as t_match
from odam_torch.models import training as t_train
from odam_torch.ops import attention as t_attn
from odam_torch.ops import cuda_attention as ca
from odam_torch.ops import lap as t_lap
from odam_torch.utils import boxes as t_boxes
from odam_tpu.models import associator as j_assoc
from odam_tpu.models import criterion as j_crit
from odam_tpu.models import detr as j_detr
from odam_tpu.models import matcher as j_match
from odam_tpu.models import training as j_train
from odam_tpu.utils import boxes as j_boxes

C = 5          # classes of the criterion tests


def _flax(model):
    """The port's weights as the JAX package's variables."""
    return {"params": jax.tree.map(jnp.asarray, convert.state_dict_to_flax(model))}


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _targets_np(rng, B, M, n_valid):
    mask = np.zeros((B, M), bool)
    for b, n in enumerate(n_valid):
        mask[b, :n] = True
    return dict(
        classes=rng.integers(0, C, (B, M)).astype(np.int32),
        boxes=rng.uniform(0.2, 0.6, (B, M, 4)).astype(np.float32),
        sizes=rng.uniform(0.5, 2.0, (B, M, 3)).astype(np.float32),
        offsets=rng.normal(0, 0.1, (B, M, 2)).astype(np.float32),
        depths=rng.uniform(1.0, 4.0, (B, M)).astype(np.float32),
        angle_bins=rng.integers(0, 30, (B, M)).astype(np.int32),
        mask=mask,
    )


def _both_targets(t):
    fields = [t[k] for k in t_crit.Targets._fields]
    return (j_crit.Targets(*map(jnp.asarray, fields)),
            t_crit.Targets(*map(torch.from_numpy, fields)))


def _predictions(rng, B, Q, n_sets):
    """Final-layer and aux prediction sets with well separated costs."""
    sets = []
    for _ in range(n_sets):
        sets.append({
            "pred_logits": rng.normal(0, 2.0, (B, Q, C + 1)).astype(np.float32),
            "pred_boxes": rng.uniform(0.15, 0.65, (B, Q, 4)).astype(np.float32),
            "pred_angle": rng.normal(size=(B, Q, 30)).astype(np.float32),
            "pred_offset": rng.normal(0, 0.1, (B, Q, 2)).astype(np.float32),
            "pred_size": rng.uniform(0.5, 2.0, (B, Q, 3)).astype(np.float32),
            "pred_depth": rng.uniform(1.0, 4.0, (B, Q, 1)).astype(np.float32),
        })
    out = dict(sets[0], aux_outputs=sets[1:])
    return out


def _to(out, fn):
    res = {k: fn(v) for k, v in out.items() if k != "aux_outputs"}
    if "aux_outputs" in out:
        res["aux_outputs"] = [{k: fn(v) for k, v in a.items()} for a in out["aux_outputs"]]
    return res


def test_giou_and_match_cost_match():
    rng = np.random.default_rng(0)
    b1 = rng.uniform(0.1, 0.7, (12, 4)).astype(np.float32)
    b2 = rng.uniform(0.1, 0.7, (5, 4)).astype(np.float32)
    x1, x2 = j_boxes.cxcywh_to_xyxy(jnp.asarray(b1)), j_boxes.cxcywh_to_xyxy(jnp.asarray(b2))
    want = j_boxes.pairwise_generalized_box_iou(x1, x2)
    got = t_boxes.pairwise_generalized_box_iou(t_boxes.cxcywh_to_xyxy(torch.from_numpy(b1)),
                                               t_boxes.cxcywh_to_xyxy(torch.from_numpy(b2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(t_boxes.xyxy_to_cxcywh(t_boxes.cxcywh_to_xyxy(
        torch.from_numpy(b1))).numpy(), np.asarray(j_boxes.xyxy_to_cxcywh(x1)), atol=1e-6)
    logits = rng.normal(size=(12, C + 1)).astype(np.float32)
    classes = rng.integers(0, C, 5).astype(np.int32)
    want = j_match.match_cost(jnp.asarray(logits), jnp.asarray(b1), jnp.asarray(classes),
                              jnp.asarray(b2))
    got = t_match.match_cost(torch.from_numpy(logits), torch.from_numpy(b1),
                             torch.from_numpy(classes), torch.from_numpy(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def criterion_case():
    """Predictions of 3 sets (final + 2 aux), B 3, Q 10, M 4 with 4, 2 and 0
    valid targets, and JAX's match of every set."""
    rng = np.random.default_rng(1)
    B, Q, M = 3, 10, 4
    out = _predictions(rng, B, Q, 3)
    tnp = _targets_np(rng, B, M, (4, 2, 0))
    jt, tt = _both_targets(tnp)
    jmatch = jax.jit(j_match.hungarian_match)
    sets = [out] + out["aux_outputs"]
    jm = [np.asarray(jmatch(jnp.asarray(s["pred_logits"]), jnp.asarray(s["pred_boxes"]),
                            jt.classes, jt.boxes, jt.mask)) for s in sets]
    return out, tnp, jt, tt, jm


def test_hungarian_match_exact(criterion_case):
    """Every set's match equals JAX's; one batched solve for all sets
    through HungarianMatcher, the same as one set at a time."""
    out, _, _, tt, jm = criterion_case
    sets = [out] + out["aux_outputs"]
    matcher = t_match.HungarianMatcher()
    before = t_lap.PLAIN_CALLS["lap_solve"]
    got = matcher([_to(s, torch.from_numpy) for s in sets], tt.classes, tt.boxes, tt.mask)
    assert t_lap.PLAIN_CALLS["lap_solve"] - before == 1
    for s, g, want in zip(sets, got, jm):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), want)
        one = t_match.hungarian_match(torch.from_numpy(s["pred_logits"]),
                                      torch.from_numpy(s["pred_boxes"]), tt.classes,
                                      tt.boxes, tt.mask)
        np.testing.assert_array_equal(one.numpy(), want)
    assert (jm[0][2] == -1).all()               # no valid target: nothing matched
    assert sorted(jm[0][1][jm[0][1] >= 0]) == [0, 1]


def test_set_criterion_matches_jax(criterion_case):
    """Every term of every layer within 1e-5 relative of JAX's, under JAX's
    match; the port's own match gives the same numbers."""
    out, _, jt, tt, jm = criterion_case
    cfg_j = j_crit.CriterionConfig(num_classes=C)
    cfg_t = t_crit.CriterionConfig(num_classes=C)
    _, want = jax.jit(lambda o, t: j_crit.set_criterion(o, t, cfg_j))(_to(out, jnp.asarray), jt)
    _, got = t_crit.set_criterion(_to(out, torch.from_numpy), tt, cfg_t,
                                  matches=[torch.from_numpy(m) for m in jm])
    _, own = t_crit.set_criterion(_to(out, torch.from_numpy), tt, cfg_t)
    assert set(got) == set(want)
    assert len([k for k in got if k.endswith("_1")]) == 7    # both aux layers' terms
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        assert float(own[k]) == float(got[k]), k


@pytest.mark.parametrize("hw", [(3, 5), (12, 10)], ids=["upsample", "downsample"])
def test_mask_losses_match_jax(hw):
    """Focal and dice losses within 1e-5 relative, predicted masks resized up
    (plain bilinear) or down (antialiased, as jax.image.resize)."""
    rng = np.random.default_rng(2)
    B, Q, M, H, W = 2, 5, 3, 8, 7
    pred = rng.normal(size=(B, Q) + hw).astype(np.float32)
    tgt = (rng.random((B, M, H, W)) > 0.5).astype(np.float32)
    t4q = np.full((B, Q), -1, np.int32)
    t4q[0, [1, 4]] = [0, 2]
    t4q[1, 0] = 1
    want = j_crit.loss_masks(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(t4q),
                             jnp.asarray(3.0))
    got = t_crit.loss_masks(torch.from_numpy(pred), torch.from_numpy(tgt),
                            torch.from_numpy(t4q), torch.tensor(3.0))
    for k in ("loss_mask", "loss_dice"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_association_nll_matches():
    rng = np.random.default_rng(3)
    Z = rng.normal(size=(2, 6, 5)).astype(np.float32)
    pairs = np.stack([rng.integers(0, 6, (2, 7)), rng.integers(0, 5, (2, 7))], -1).astype(np.int32)
    valid = rng.random((2, 7)) > 0.3
    want = j_assoc.association_nll(jnp.asarray(Z), jnp.asarray(pairs), jnp.asarray(valid))
    got = t_assoc.association_nll(torch.from_numpy(Z), torch.from_numpy(pairs),
                                  torch.from_numpy(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


TINY = dict(num_classes=4, num_queries=6, hidden_dim=32, nheads=4, enc_layers=1,
            dec_layers=2, dim_feedforward=32, backbone="tiny", backbone_stage=2)


@pytest.mark.parametrize("rate", [1.0, 0.0])
def test_dropout_sites_match_flax(rate):
    """At rate 1 Flax's nn.Dropout and the port's both give zeros without a
    draw, so JAX's DETR with deterministic=False and the port's in
    .train() mode agree only if every site is in the same place; at rate 0
    the train forward is the eval forward."""
    model = t_detr.build_detr(t_detr.DETRConfig(**TINY, dropout=rate), seed=3, device="cpu")
    img = np.random.default_rng(4).normal(size=(1, 32, 32, 3)).astype(np.float32)
    jm = j_detr.DETR(j_detr.DETRConfig(**TINY, dropout=rate))
    want = jax.jit(lambda p, x: jm.apply(p, x, deterministic=False,
                                         rngs={"dropout": jax.random.key(0)}))(
        _flax(model), jnp.asarray(img))
    with torch.no_grad():
        evald = model(torch.from_numpy(img))
        model.train()
        got = model(torch.from_numpy(img), generator=torch.Generator().manual_seed(0))
    for k in ("pred_logits", "pred_boxes", "pred_angle", "pred_depth", "pred_obj_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-5, rtol=2e-5,
                                   err_msg=k)
        assert torch.equal(got[k], evald[k]) == (rate == 0.0), k


def test_dropout_mask_is_seeded():
    """Between 0 and 1 the masks come from the generator: the same seed
    gives the same output, another seed another one."""
    model = t_detr.build_detr(t_detr.DETRConfig(**TINY, dropout=0.5), seed=3, device="cpu")
    model.train()
    img = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        a, b, c = (model(img, generator=torch.Generator().manual_seed(s))["pred_logits"]
                   for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_wrappers_refuse_to_cut_the_gradient():
    """Both wrappers raise before any call under grad mode when an input
    requires grad; without grad mode they run; mha_core without the kernels
    carries the gradient; a model built with the kernels cannot be trained."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 16, generator=g, requires_grad=True)
    k = torch.randn(1, 8, 2, 16, generator=g)
    ca.reset_counts()
    for fn in (ca.fused_attention, ca.flash_attention):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(q, k, k)
    assert ca.PLAIN_CALLS == {"fused_attention": 0, "flash_attention": 0}
    with torch.no_grad():
        ca.fused_attention(q, k, k)
    assert ca.PLAIN_CALLS["fused_attention"] == 1
    with pytest.raises(RuntimeError, match="no backward"):
        t_attn.mha_core(q.reshape(1, 8, 32), k.reshape(1, 8, 32), k.reshape(1, 8, 32), 2)
    out = t_attn.mha_core(q.reshape(1, 8, 32), k.reshape(1, 8, 32), k.reshape(1, 8, 32), 2,
                          use_kernels=False)
    out.sum().backward()
    assert q.grad is not None and float(q.grad.abs().sum()) > 0
    model = t_detr.build_detr(t_detr.DETRConfig(**TINY), device="cpu")
    tcfg = t_train.DetrTrainConfig()
    with pytest.raises(ValueError, match="use_kernels=False"):
        t_train.init_train_state(model, t_train.make_detr_optimizer(model, tcfg))


# --- the detector train step ------------------------------------------------

DETR_KW = dict(num_classes=4, num_queries=6, hidden_dim=32, nheads=4, enc_layers=1,
               dec_layers=1, dim_feedforward=32, aux_loss=False, dropout=0.0)
STEPS = 3


def _jax_step(model, tx, tcfg):
    """make_detr_train_step's body, also returning the gradients and the
    final layer's match (the one set_criterion computes inside)."""

    def loss_fn(params, images, targets, rng):
        outputs = model.apply(params, images, deterministic=False, rngs={"dropout": rng})
        match = j_match.hungarian_match(outputs["pred_logits"], outputs["pred_boxes"],
                                        targets.classes, targets.boxes, targets.mask)
        total, metrics = j_crit.set_criterion(outputs, targets, tcfg.criterion)
        return total, (metrics, match)

    def step(state, images, targets, rng):
        (_, (metrics, match)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, images, targets, rng)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return j_train.TrainState(params, opt_state, state.step + 1), metrics, grads, match

    return jax.jit(step)


@pytest.fixture(scope="module")
def detr_run():
    """3 steps of a ResNet-50 DETR (hidden 32, 1+1 layers, 64x64, batch 2)
    in both packages from the same weights and batch, the port under JAX's
    match of each step."""
    model = t_detr.build_detr(t_detr.DETRConfig(**DETR_KW, use_kernels=False), seed=0,
                              device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    params = _flax(model)
    rng = np.random.default_rng(5)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    tnp = _targets_np(rng, 2, 3, (3, 2))
    tnp["classes"] %= DETR_KW["num_classes"]
    jt, tt = _both_targets(tnp)

    jm = j_detr.DETR(j_detr.DETRConfig(**DETR_KW))
    jcfg = j_train.DetrTrainConfig(lr=1e-3, criterion=j_crit.CriterionConfig(num_classes=4))
    tx = j_train.make_detr_optimizer(params, jcfg)
    jstate = j_train.init_train_state(params, tx)
    jstep = _jax_step(jm, tx, jcfg)

    tcfg = t_train.DetrTrainConfig(lr=1e-3, criterion=t_crit.CriterionConfig(num_classes=4))
    opt = t_train.make_detr_optimizer(model, tcfg)
    state = t_train.init_train_state(model, opt)
    tstep = t_train.make_detr_train_step(tcfg)
    j_log, t_log = [], []
    for i in range(STEPS):
        jstate, jmet, jgrads, jmatch = jstep(jstate, jnp.asarray(images), jt, jax.random.key(i))
        met = tstep(state, torch.from_numpy(images), tt,
                    matches=[torch.from_numpy(np.asarray(jmatch))])
        grads = dict(_paths(convert.tensors_to_flax(model, {
            key: p.grad for key, p in model.named_parameters() if p.grad is not None})))
        j_log.append((jax.tree.map(np.asarray, jmet), jax.tree.map(np.asarray, jgrads)))
        t_log.append((met, grads))
    return dict(model=model, init=init, state=state, jparams=jax.tree.map(np.asarray,
                jstate.params), j_log=j_log, t_log=t_log, params0=params, opt=opt)


def test_detr_step_losses_match(detr_run):
    for i, ((jmet, _), (met, _)) in enumerate(zip(detr_run["j_log"], detr_run["t_log"])):
        for k in jmet:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")


def _leaf_error(a, b):
    return float(np.linalg.norm(a - b)), float(np.linalg.norm(b))


def _noise_leaves(jgrads) -> set:
    """Leaves whose gradient is zero but for rounding: below 1e-6 of the
    gradient's global norm in JAX.  Softmax ignores a shift common to all
    keys, so no key-projection bias gets a gradient; and the first decoder
    layer's self-attention sees equal values for all its keys (the decoder
    starts from zeros), so neither do its query and key projections."""
    jflat = dict(_paths(jgrads["params"]))
    scale = np.sqrt(sum(float(np.sum(np.square(g))) for g in jflat.values()))
    return {p for p, g in jflat.items() if np.linalg.norm(g) <= 1e-6 * scale}, scale


def _check_grads(grads, jgrads, where):
    """Each leaf's gradient within 1e-4 of JAX's in relative norm; where
    JAX's is rounding noise (_noise_leaves), the port's must be too."""
    noise, scale = _noise_leaves(jgrads)
    jflat = dict(_paths(jgrads["params"]))
    for path, g in grads.items():
        if path in noise:
            assert np.linalg.norm(g) <= 1e-6 * scale, (where, path)
            continue
        err, ref = _leaf_error(g, jflat[path])
        assert err <= 1e-4 * ref, (where, path, err, ref)


def test_detr_step_gradients_match(detr_run):
    """Every trained leaf's gradient of the first step (see _check_grads);
    no gradient reaches a frozen leaf.  (Later steps start from parameters
    that differ by Adam's rounding noise, which the ReLU backbone turns into
    gradient differences up to 7e-4 by the third step; their losses and the
    parameters after them are held instead.)"""
    model = detr_run["model"]
    (_, jgrads), (_, grads) = detr_run["j_log"][0], detr_run["t_log"][0]
    assert len(grads) > 50
    _check_grads(grads, jgrads, "step 0")
    assert not any(p.requires_grad for key, p in model.named_parameters()
                   if t_train.detr_label(convert.flax_path(model, key)) == "frozen")


def _check_params(model, jparams, jgrads, lr):
    """Every leaf after the steps within 1e-4 of JAX's in relative norm.
    Where the gradient is rounding noise (_noise_leaves), Adam's normalised
    step is noise too, so there each package moves at most STEPS x lr an
    element.  (The update's arithmetic alone is held to optax's within
    rounding by test_optimizer_matches_optax.)"""
    noise, _ = _noise_leaves(jgrads)
    jp = dict(_paths(jparams["params"]))
    for path, got in _paths(convert.state_dict_to_flax(model)):
        if path in noise:
            assert np.abs(got - jp[path]).max() <= 2 * STEPS * lr, path
            continue
        err, ref = _leaf_error(got, jp[path])
        assert err <= 1e-4 * ref, (path, err, ref)


def test_detr_params_after_three_steps(detr_run):
    _check_params(detr_run["model"], detr_run["jparams"], detr_run["j_log"][0][1], 1e-3)


def test_detr_group_labels_match_jax(detr_run):
    """The port's labels equal JAX's leaf by leaf, on the ResNet-50 tree and
    on a TinyBackbone tree (all of whose backbone JAX labels frozen: its
    backbone has no layer2-4)."""
    for model in (detr_run["model"],
                  t_detr.build_detr(t_detr.DETRConfig(**TINY), device="cpu")):
        tree = convert.state_dict_to_flax(model)

        def label(path, _):
            if j_train._is_frozen_path(path):
                return "frozen"
            return "backbone" if j_train._is_backbone_path(path) else "main"

        want = jax.tree_util.tree_map_with_path(label, tree)
        got = t_train.detr_labels(model)
        assert got == dict(_paths(want))
        backbone = {v for p, v in got.items() if p[0] == "backbone"}
        assert backbone == ({"frozen"} if model.config.backbone == "tiny"
                            else {"frozen", "backbone"})


def test_detr_flax_tree_matches_jax_init(detr_run):
    """The inverse converter gives JAX's tree: the same paths and shapes as
    the JAX package's own init."""
    jm = j_detr.DETR(j_detr.DETRConfig(**DETR_KW))
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    want = {p: tuple(v.shape) for p, v in _paths(shapes["params"])}
    got = {p: v.shape for p, v in _paths(detr_run["params0"]["params"])}
    assert got == want


def test_frozen_leaves_bit_equal(detr_run):
    """After 3 steps every frozen parameter and buffer is bit-equal to its
    start (and so to JAX's, which started there); every trained leaf that
    starts nonzero moved (weight decay alone moves it).  A TinyBackbone
    DETR's whole backbone stays too."""
    def check(model, init):
        for key, t in model.state_dict().items():
            if t_train.detr_label(convert.flax_path(model, key)) == "frozen":
                assert torch.equal(t, init[key]), key
            elif init[key].any():
                assert not torch.equal(t, init[key]), key

    check(detr_run["model"], detr_run["init"])
    tiny = t_detr.build_detr(t_detr.DETRConfig(**TINY, use_kernels=False), seed=1,
                             device="cpu")
    before = {k: v.clone() for k, v in tiny.state_dict().items()}
    tcfg = t_train.DetrTrainConfig(lr=1e-2, criterion=t_crit.CriterionConfig(num_classes=4))
    state = t_train.init_train_state(tiny, t_train.make_detr_optimizer(tiny, tcfg))
    rng = np.random.default_rng(6)
    tnp = _targets_np(rng, 1, 2, (2,))
    tnp["classes"] %= 4
    t_train.make_detr_train_step(tcfg)(
        state, torch.from_numpy(rng.normal(size=(1, 32, 32, 3)).astype(np.float32)),
        _both_targets(tnp)[1])
    check(tiny, before)
    assert {t_train.detr_label(convert.flax_path(tiny, k)) for k in before
            if k.startswith("backbone.")} == {"frozen"}


# --- the associator train step ----------------------------------------------

ASSOC_KW = dict(descriptor_dim=32, keypoint_encoder=(78, 32, 32), gnn_layers=("self", "cross"),
                self_gnn_layers=("self",), sinkhorn_iterations=10)


def _assoc_batch(rng, B=2, T=5, W=6, N=4):
    tracks = np.full((B, T, W, 79), -1.0, np.float32)
    tracks[:, :3] = rng.normal(size=(B, 3, W, 79)).astype(np.float32)
    tm = np.zeros((B, T), bool)
    tm[:, :3] = True
    dets = np.full((B, N, 79), -1.0, np.float32)
    dets[:, :3] = rng.normal(size=(B, 3, 79)).astype(np.float32)
    dm = np.zeros((B, N), bool)
    dm[:, :3] = True
    pairs = np.zeros((B, 6, 2), np.int32)
    pairs[:, :4] = [[0, 1], [1, 0], [T, 2], [2, N]]
    valid = np.zeros((B, 6), bool)
    valid[:, :4] = True
    return tracks, tm, dets, dm, pairs, valid


@pytest.fixture(scope="module")
def assoc_run():
    model = t_assoc.build_associator(t_assoc.AssociatorConfig(**ASSOC_KW, use_kernels=False),
                                     seed=2, device="cpu")
    params = _flax(model)
    batch = _assoc_batch(np.random.default_rng(7))
    jm = j_assoc.Associator(j_assoc.AssociatorConfig(**ASSOC_KW))
    jcfg = j_train.AssocTrainConfig(lr=1e-3)
    tx = optax.chain(optax.clip_by_global_norm(jcfg.clip_norm), optax.adam(jcfg.lr))

    def loss_fn(p, tracks, tm, dets, dm, pairs, valid):
        out = jm.apply(p, tracks, tm, dets, dm)
        n = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)
        return j_assoc.association_nll(out.log_assignment, pairs, valid) / n

    @jax.jit
    def jstep(state, *b):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, *b)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        return j_train.TrainState(optax.apply_updates(state.params, updates), opt_state,
                                  state.step + 1), loss, grads

    jstate = j_train.init_train_state(params, tx)
    opt = t_train.make_assoc_optimizer(model, t_train.AssocTrainConfig(lr=1e-3))
    state = t_train.init_train_state(model, opt)
    tstep = t_train.make_assoc_train_step()
    log = []
    lap_calls = t_lap.PLAIN_CALLS["lap_solve"]
    for _ in range(STEPS):
        jstate, jloss, jgrads = jstep(jstate, *map(jnp.asarray, batch))
        loss = tstep(state, *map(torch.from_numpy, batch))
        grads = dict(_paths(convert.tensors_to_flax(model, {
            k: p.grad for k, p in model.named_parameters()})))
        log.append((float(jloss), jax.tree.map(np.asarray, jgrads), float(loss), grads))
    return dict(model=model, params0=params, jparams=jax.tree.map(np.asarray, jstate.params),
                log=log, lap_calls=t_lap.PLAIN_CALLS["lap_solve"] - lap_calls)


def test_assoc_step_matches_jax(assoc_run):
    """association_nll within 1e-5 and each leaf's gradient (see
    _check_grads) at every step, and no decode (no LAP solve) in the step."""
    for i, (jloss, jgrads, loss, grads) in enumerate(assoc_run["log"]):
        np.testing.assert_allclose(loss, jloss, rtol=1e-5, err_msg=f"step {i}")
        assert set(grads) == set(dict(_paths(jgrads["params"])))
        _check_grads(grads, jgrads, f"step {i}")
    assert assoc_run["lap_calls"] == 0
    assert assoc_run["log"][-1][2] < assoc_run["log"][0][2]


def test_assoc_params_after_three_steps(assoc_run):
    _check_params(assoc_run["model"], assoc_run["jparams"], assoc_run["log"][0][1], 1e-3)


def test_optimizer_matches_optax():
    """OptaxAdam against optax on the same gradients, 3 steps: the
    detector's multi_transform (main and backbone groups, each clipped by its
    own global norm, one above and one below the clip; a frozen leaf) with
    adamw, and the associator's clip -> adam.  The arithmetic is optax's, so
    the parameters agree to a few roundings."""
    rng = np.random.default_rng(8)
    params = {"main": {"a": rng.normal(size=(4, 3)), "b": rng.normal(size=3)},
              "backbone": {"layer2": {"k": rng.normal(size=(2, 2))}},
              "frozen_leaf": rng.normal(size=2)}
    params = jax.tree.map(lambda v: v.astype(np.float32), params)
    labels = {"main": {"a": "main", "b": "main"}, "backbone": {"layer2": {"k": "backbone"}},
              "frozen_leaf": "frozen"}

    def group(lr, wd):
        return optax.chain(optax.clip_by_global_norm(0.5),
                           optax.adamw(lr, weight_decay=wd) if wd else optax.adam(lr))

    for wd in (1e-4, None):
        tx = optax.multi_transform({"main": group(1e-2, wd), "backbone": group(1e-3, wd),
                                    "frozen": optax.set_to_zero()}, labels)
        jp = jax.tree.map(jnp.asarray, params)
        jstate = tx.init(jp)
        tp = {p: torch.nn.Parameter(torch.from_numpy(v.copy())) for p, v in _paths(params)}
        opt = t_train.OptaxAdam({name: (lr, [(p, tp[p]) for p in tp if p[0] == name])
                                 for name, lr in (("main", 1e-2), ("backbone", 1e-3))}, 0.5, wd)
        for _ in range(STEPS):
            grads = jax.tree.map(lambda v: rng.normal(0, 0.1, v.shape).astype(np.float32),
                                 params)
            grads["main"]["a"] *= 10.0                     # main above the clip
            upd, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
            jp = optax.apply_updates(jp, upd)
            for p, g in _paths(grads):
                tp[p].grad = torch.from_numpy(g)
            opt.step()
        for p, v in _paths(jax.tree.map(np.asarray, jp)):
            np.testing.assert_allclose(tp[p].detach().numpy(), v, rtol=1e-6, atol=1e-7,
                                       err_msg=str(p))
        assert np.array_equal(tp[("frozen_leaf",)].detach().numpy(), params["frozen_leaf"])
