"""The committed rehearsal checkpoints in the form the port reads.

The card's machine has no JAX and no orbax, so the two committed orbax
checkpoints (``artifacts/rehearsal_hard_{detr,assoc}_ckpt``) are also kept
as Flax trees of numpy leaves, one ``.npz`` each with ``/``-joined paths as
keys, under ``artifacts/torch/``.  This file holds them to a fresh restore,
leaf for leaf and bit for bit, and rewrites them when run as a script:

    python tests/test_torch_checkpoints.py
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from odam_torch import config as t_config
from odam_torch.models import associator as t_assoc
from odam_torch.models import convert
from odam_torch.models import detr as t_detr
from odam_tpu.models import associator as j_assoc
from odam_tpu.models import detr as j_detr

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CONFIG = os.path.join(ROOT, "examples", "cli_rehearsal", "data_hard", "rehearsal.yaml")
CKPTS = {
    "detr": ("rehearsal_hard_detr_ckpt", "rehearsal_hard_detr.npz"),
    "assoc": ("rehearsal_hard_assoc_ckpt", "rehearsal_hard_assoc.npz"),
}


def restore(kind: str) -> dict:
    """The orbax checkpoint restored with the JAX package's reader, into the
    tree the JAX CLI builds from the rehearsal config."""
    from odam_tpu import config as j_config
    from odam_tpu.utils import checkpoint

    cfg = j_config.merge_cfg([CONFIG])
    if kind == "detr":
        model = j_detr.DETR(j_detr.DETRConfig.from_cfg(cfg))
        like = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3))),
                              jax.random.key(0))
    else:
        model = j_assoc.Associator(j_assoc.AssociatorConfig.from_cfg(cfg))
        like = jax.eval_shape(
            lambda k: model.init(k, jnp.full((1, 4, 4, 79), -1.0), jnp.zeros((1, 4), bool),
                                 jnp.full((1, 4, 79), -1.0), jnp.zeros((1, 4), bool)),
            jax.random.key(1))
    tree = checkpoint.restore(os.path.join(ROOT, "artifacts", CKPTS[kind][0]), like)
    return jax.tree.map(np.asarray, tree)


def flat(tree: dict) -> dict:
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def npz_path(kind: str) -> str:
    return os.path.join(ROOT, "artifacts", "torch", CKPTS[kind][1])


@pytest.mark.parametrize("kind", sorted(CKPTS))
def test_committed_npz_equals_a_fresh_restore(kind):
    """Same keys, dtypes and shapes, and every leaf bit for bit."""
    fresh = flat(restore(kind))
    with np.load(npz_path(kind), allow_pickle=False) as npz:
        assert sorted(npz.files) == sorted(fresh)
        for key, leaf in fresh.items():
            assert npz[key].dtype == leaf.dtype and npz[key].shape == leaf.shape, key
            assert npz[key].tobytes() == np.ascontiguousarray(leaf).tobytes(), key


@pytest.mark.parametrize("kind", sorted(CKPTS))
def test_load_flax_npz_builds_the_rehearsal_models(kind):
    """``load_flax_npz`` gives back the nested tree, and every leaf of it maps
    to exactly one tensor of the model the port's CLI builds."""
    cfg = t_config.merge_cfg([CONFIG])
    tree = convert.load_flax_npz(npz_path(kind))
    ref = flat(restore(kind))
    assert {k: v.tobytes() for k, v in flat(tree).items()} == \
        {k: v.tobytes() for k, v in ref.items()}
    if kind == "detr":
        model = t_detr.build_detr(t_detr.DETRConfig.from_cfg(cfg), flax_params=tree,
                                  device="cpu")
    else:
        model = t_assoc.build_associator(t_assoc.AssociatorConfig.from_cfg(cfg),
                                         flax_params=tree, device="cpu")
    assert len(model.state_dict()) == len(ref)


def export() -> None:
    os.makedirs(os.path.join(ROOT, "artifacts", "torch"), exist_ok=True)
    for kind in sorted(CKPTS):
        leaves = flat(restore(kind))
        np.savez(npz_path(kind), **leaves)
        print(f"wrote {os.path.relpath(npz_path(kind), ROOT)}: {len(leaves)} leaves")


if __name__ == "__main__":
    export()
