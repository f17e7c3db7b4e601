"""Training steps for the detector and the associator.

Counterpart of ``odam_tpu/models/training.py``.  JAX trains on the plain
attention path (its train scripts build the models without ``use_pallas``),
and the kernels have no backward, so the models trained here are built with
``use_kernels=False``.

Data parallel over a ``dp`` mesh (:mod:`odam_torch.parallel.mesh`): each
rank holds its rows of the global batch, and the parameters are broadcast
from rank 0 once, in :func:`init_train_state`.  JAX computes the loss over
the global batch; here each rank's loss is its share, its numerator over
the global normalizers (:mod:`.criterion`; the associator's pair count),
so after ``backward`` one flattened all-reduce (SUM) of the trained leaves'
gradients, with the metrics in the same buffer, gives every rank the global
gradient and the global metrics.  Each group's clip then runs on the global
gradient, as JAX clips.  (A DDP wrap would average per-rank losses: wrong
whenever the ranks hold different numbers of boxes.)  Dropout masks are
drawn from a generator seeded with ``step * world + rank``, so the ranks'
masks differ; at world size 1 that is JAX's seed, the step.

The optimizer is optax's, written out in optax's arithmetic order:

- the detector: ``multi_transform`` of three groups, ``main`` (lr),
  ``backbone`` (lr_backbone) and ``frozen`` (``set_to_zero``), each trained
  group its own ``clip_by_global_norm -> adamw`` chain, so the clip norm is
  taken per group;
- the associator: ``clip_by_global_norm -> adam`` over every parameter.

``clip_by_global_norm`` keeps g when ||g|| < max and else takes
``(g / ||g||) * max`` (not ``clip_grad_norm_``'s ``max / (||g|| + 1e-6)``);
``scale_by_adam`` bias-corrects both moments with ``1 - b ** count`` in
float32 and puts eps outside the square root; adamw then adds ``wd * p``;
the update is scaled by ``-lr`` and added.  The group labels come from each
leaf's Flax path (:func:`odam_torch.models.convert.flax_path`) through a
copy of JAX's rules, so the same leaves get the same labels.  Frozen
parameters get ``requires_grad=False`` and are never written; the frozen-BN
statistics are buffers.  The updates use ``torch._foreach_*``, a few
launches a group for each operation rather than one a leaf.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..parallel.distributed import all_reduce_sum
from . import associator as assoc_mod
from . import criterion as crit_mod
from . import matcher as matcher_mod
from .convert import flax_path

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class DetrTrainConfig:
    lr: float = 1e-4
    lr_backbone: float = 1e-5
    weight_decay: float = 1e-4
    clip_norm: float = 0.1
    criterion: crit_mod.CriterionConfig = field(default_factory=crit_mod.CriterionConfig)


@dataclass(frozen=True)
class AssocTrainConfig:
    lr: float = 1e-4
    clip_norm: float = 1.0


def _is_frozen_path(keys: tuple[str, ...]) -> bool:
    """JAX's rule (odam_tpu/models/training.py:46-58): frozen-BN leaves under
    the backbone, and every backbone leaf outside layer2-4.  A TinyBackbone
    is named ``backbone`` too and has no layer2-4, so all of it is frozen,
    as in JAX."""
    if "backbone" not in keys:
        return False
    if any(k.startswith("bn") or k.endswith("_bn") or k == "downsample_bn" for k in keys):
        return True
    return not any(k.startswith(("layer2", "layer3", "layer4")) for k in keys)


def detr_label(path: tuple[str, ...]) -> str:
    """``frozen``, ``backbone`` or ``main`` for a Flax path of the DETR tree."""
    if _is_frozen_path(path):
        return "frozen"
    return "backbone" if "backbone" in path else "main"


def detr_labels(model: nn.Module) -> dict[tuple[str, ...], str]:
    """The label of every leaf of the model's Flax tree (buffers included),
    keyed by its Flax path."""
    paths = [flax_path(model, key) for key in model.state_dict()]
    return {path: detr_label(path) for path in paths}


class OptaxAdam:
    """optax's ``clip_by_global_norm -> adam`` (``weight_decay=None``) or
    ``-> adamw`` for each group of parameters, in optax's arithmetic.

    ``groups`` maps a group's name to its learning rate and its
    ``(Flax path, parameter)`` pairs.  The moments are keyed by Flax path in
    :meth:`state_arrays`, and ``count`` is optax's step count, kept on the
    device so that a step makes no host sync."""

    def __init__(self, groups: dict[str, tuple[float, list[tuple[tuple[str, ...], nn.Parameter]]]],
                 clip_norm: float, weight_decay: float | None = None):
        self.groups = {name: (lr, [p for _, p in leaves]) for name, (lr, leaves) in groups.items()
                       if leaves}
        self.paths = {name: [path for path, _ in groups[name][1]] for name in self.groups}
        self.clip_norm = clip_norm
        self.weight_decay = weight_decay
        self.mu = {name: [torch.zeros_like(p) for p in ps] for name, (_, ps) in self.groups.items()}
        self.nu = {name: [torch.zeros_like(p) for p in ps] for name, (_, ps) in self.groups.items()}
        dev = next(iter(self.groups.values()))[1][0].device
        self.count = torch.zeros((), dtype=torch.float32, device=dev)
        self._b1 = torch.full((), ADAM_B1, device=dev)
        self._b2 = torch.full((), ADAM_B2, device=dev)

    def parameters(self) -> list[nn.Parameter]:
        return [p for _, ps in self.groups.values() for p in ps]

    @torch.no_grad()
    def step(self) -> None:
        """Apply one update from the parameters' ``.grad`` (None counts as 0)."""
        self.count += 1
        c1 = 1 - torch.pow(self._b1, self.count)
        c2 = 1 - torch.pow(self._b2, self.count)
        for name, (lr, params) in self.groups.items():
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
            keep = norm < self.clip_norm
            # (g / norm) * max when clipping, g / 1 * 1 (exactly g) when not
            g = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(g, torch.where(keep, 1.0, self.clip_norm))
            mu, nu = self.mu[name], self.nu[name]
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1 - ADAM_B1))
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1 - ADAM_B2)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_add_(nu, g2)
            den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
            torch._foreach_add_(den, ADAM_EPS)
            upd = torch._foreach_div(torch._foreach_div(mu, c1), den)
            if self.weight_decay is not None:
                torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(params, upd)

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The optimizer state as numpy arrays: ``count``, and ``mu/<path>``
        and ``nu/<path>`` for every trained leaf."""
        out = {"count": np.asarray(self.count.item(), np.float32)}
        for name in self.groups:
            for path, m, v in zip(self.paths[name], self.mu[name], self.nu[name]):
                out["mu/" + "/".join(path)] = m.detach().cpu().numpy()
                out["nu/" + "/".join(path)] = v.detach().cpu().numpy()
        return out

    def load_state_arrays(self, arrays) -> None:
        """Restore what :meth:`state_arrays` gave; every leaf must be there."""
        with torch.no_grad():
            self.count.fill_(float(arrays["count"]))
            for name in self.groups:
                for path, m, v in zip(self.paths[name], self.mu[name], self.nu[name]):
                    key = "/".join(path)
                    m.copy_(torch.from_numpy(np.asarray(arrays["mu/" + key])))
                    v.copy_(torch.from_numpy(np.asarray(arrays["nu/" + key])))


def make_detr_optimizer(model: nn.Module, cfg: DetrTrainConfig) -> OptaxAdam:
    """AdamW over the ``main`` (lr) and ``backbone`` (lr_backbone) groups;
    the ``frozen`` leaves get ``requires_grad=False``.  Raises if a buffer
    would be trained."""
    labels = detr_labels(model)
    buffers = {flax_path(model, key) for key, _ in model.named_buffers()}
    trained = [path for path in buffers if labels[path] != "frozen"]
    if trained:
        raise ValueError(f"buffers labelled for training: {trained[:4]}")
    leaves: dict[str, list] = {"main": [], "backbone": []}
    for key, p in model.named_parameters():
        label = labels[flax_path(model, key)]
        p.requires_grad_(label != "frozen")
        if label != "frozen":
            leaves[label].append((flax_path(model, key), p))
    return OptaxAdam({"main": (cfg.lr, leaves["main"]),
                      "backbone": (cfg.lr_backbone, leaves["backbone"])},
                     cfg.clip_norm, cfg.weight_decay)


def make_assoc_optimizer(model: nn.Module, cfg: AssocTrainConfig) -> OptaxAdam:
    """``clip_by_global_norm(clip_norm) -> adam(lr)`` over every parameter."""
    leaves = [(flax_path(model, key), p) for key, p in model.named_parameters()]
    return OptaxAdam({"main": (cfg.lr, leaves)}, cfg.clip_norm)


class TrainState:
    """The trained module, its optimizer and the step counter."""

    def __init__(self, model: nn.Module, opt: OptaxAdam, step: int = 0):
        self.model = model
        self.opt = opt
        self.step = step


def _group(mesh):
    return None if mesh is None else mesh.group


def init_train_state(model: nn.Module, opt: OptaxAdam, mesh=None) -> TrainState:
    """Puts the model in ``.train()`` mode (dropout on) at step 0.  Raises for
    a model built with ``use_kernels``: the kernels have no backward.  With a
    ``mesh``, rank 0's parameters and buffers are broadcast to every rank."""
    if model.config.use_kernels:
        raise ValueError("build the model with use_kernels=False to train it: the attention "
                         "kernels have no backward")
    if _group(mesh) is not None:
        tensors = list(model.state_dict().values())
        for dtype in {t.dtype for t in tensors}:
            same = [t for t in tensors if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.broadcast(flat, src=0, group=mesh.group)
            with torch.no_grad():
                torch._foreach_copy_(same, [x.view_as(t) for x, t in
                                            zip(flat.split([t.numel() for t in same]), same)])
    model.train()
    return TrainState(model, opt)


def _seed(state: TrainState, mesh) -> int:
    """The dropout seed: the step at world size 1, distinct over the ranks."""
    if mesh is None:
        return state.step
    return state.step * mesh.size + mesh.rank


def _backward_and_update(state: TrainState, loss: torch.Tensor, mesh=None,
                         metrics: list[torch.Tensor] = ()) -> list[torch.Tensor]:
    """backward, then (with a mesh) one all-reduce of the gradients and the
    ``metrics``, then the update; returns the metrics, summed over the
    ranks with a mesh."""
    params = state.opt.parameters()
    for p in params:
        p.grad = None
    loss.backward()
    if _group(mesh) is not None:
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        sizes = [g.numel() for g in grads] + [1] * len(metrics)
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [m.detach().reshape(1).to(grads[0].dtype) for m in metrics])
        dist.all_reduce(flat, group=mesh.group)
        parts = flat.split(sizes)
        # back into each leaf's own gradient: the update then reads the same
        # layout as without a mesh (views into ``flat`` round differently)
        torch._foreach_copy_(grads, [g.view_as(p) for g, p in zip(parts, grads)])
        metrics = [m.reshape(()).to(x.dtype) for m, x in zip(parts[len(params):], metrics)]
    state.opt.step()
    state.step += 1
    return [m.detach() for m in metrics]


def make_detr_train_step(cfg: DetrTrainConfig,
                         matcher: matcher_mod.HungarianMatcher | None = None, mesh=None):
    """One detector step: ``step(state, images, targets, pixel_mask=None,
    matches=None) -> metrics`` (tensors on the device).  Dropout masks are
    drawn from a generator seeded with the step count, as JAX seeds with
    ``jax.random.key(step)`` (with a ``mesh``: ``step * world + rank``); the
    matches come from ``matcher`` (one LAP launch a step, no host read)
    unless given.  With a ``mesh``, ``images`` and
    ``targets`` are this rank's rows of the global batch (``matches`` too),
    and the metrics are the global batch's."""
    matcher = matcher or matcher_mod.HungarianMatcher(cfg.criterion.matcher)
    generators: dict = {}

    def step(state: TrainState, images: torch.Tensor, targets: crit_mod.Targets,
             pixel_mask: torch.Tensor | None = None,
             matches: list[torch.Tensor] | None = None) -> dict:
        dev = images.device
        gen = generators.setdefault(dev, torch.Generator(device=dev))
        gen.manual_seed(_seed(state, mesh))
        with torch.enable_grad():
            outputs = state.model(images, pixel_mask, generator=gen)
            total, metrics = crit_mod.set_criterion(outputs, targets, cfg.criterion,
                                                    matches=matches, matcher=matcher,
                                                    group=_group(mesh))
            values = _backward_and_update(state, total, mesh, list(metrics.values()))
        return dict(zip(metrics, values))

    step.matcher = matcher
    return step


def make_assoc_train_step(mesh=None):
    """One associator step: ``step(state, tracks, track_mask, detections,
    det_mask, gt_pairs, pair_valid) -> loss`` (the NLL over the valid pairs,
    divided by their count, as JAX's).  The forward stops at the log
    assignment: no decode, no host copy.  With a ``mesh`` the inputs are
    this rank's rows, the pair count is the global batch's, and the loss
    returned is the global batch's."""
    group = _group(mesh)

    def step(state: TrainState, tracks, track_mask, detections, det_mask, gt_pairs,
             pair_valid) -> torch.Tensor:
        with torch.enable_grad():
            Z, _ = state.model.assignment(tracks, track_mask, detections, det_mask)
            n = pair_valid.float().sum()
            if group is not None:
                n = all_reduce_sum(n, group)
            loss = assoc_mod.association_nll(Z, gt_pairs, pair_valid) / torch.clamp(n, min=1.0)
            (loss,) = _backward_and_update(state, loss, mesh, [loss])
        return loss

    return step
