"""Crash-safe checkpoints of a training run.

Counterpart of ``odam_tpu/utils/checkpoint.py`` without orbax.  A
checkpoint is a directory holding

- ``params.npz``: the model's Flax tree (``convert.save_flax_npz``), which
  ``run_processor --detector_ckpt`` / ``--associator_ckpt`` read (the
  directory or the file) and JAX's ``model.apply`` takes as
  ``{"params": tree}``;
- ``opt_state.npz``: the optimizer's moments and count
  (``OptaxAdam.state_arrays``), so that a resumed run continues the update;
- ``odam_meta.json``: the meta dict (``{"step": ...}`` and whatever the
  caller adds), written last: its presence marks the checkpoint complete.

:func:`save` writes ``<path>.tmp`` and swaps it in with renames; the
previous checkpoint survives as ``<path>.bak`` until the swap is done, and
:func:`latest_path` finds the newest complete one after a crash anywhere in
between.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

from ..models import convert

PARAMS = "params.npz"
OPT_STATE = "opt_state.npz"
METAFILE = "odam_meta.json"


def save(path: str, params: dict, opt_state: dict | None = None,
         meta: dict | None = None) -> None:
    """Write ``params`` (a Flax tree of numpy arrays), ``opt_state`` (flat
    name -> array) and ``meta`` as the checkpoint ``path``."""
    path = os.path.abspath(path)
    tmp, bak = path + ".tmp", path + ".bak"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    convert.save_flax_npz(os.path.join(tmp, PARAMS), params)
    if opt_state is not None:
        with open(os.path.join(tmp, OPT_STATE), "wb") as f:
            np.savez(f, **opt_state)
    with open(os.path.join(tmp, METAFILE), "w") as f:
        json.dump(meta or {}, f)
    if os.path.exists(bak):
        shutil.rmtree(bak)
    if os.path.exists(path):
        os.rename(path, bak)
    os.rename(tmp, path)
    if os.path.exists(bak):
        shutil.rmtree(bak)


def _committed(p: str) -> bool:
    return os.path.isdir(p) and os.path.exists(os.path.join(p, METAFILE))


def latest_path(path: str) -> str | None:
    """The newest complete checkpoint for ``path``: a complete ``.tmp`` (the
    crash came after the write, during the swap), then ``path``, then
    ``.bak`` (the state before the save); None if there is none."""
    path = os.path.abspath(path)
    for p in (path + ".tmp", path, path + ".bak"):
        if _committed(p):
            return p
    return None


def load_meta(path: str) -> dict | None:
    """The meta dict of the newest complete checkpoint for ``path``, or None."""
    p = latest_path(path)
    if p is None:
        return None
    with open(os.path.join(p, METAFILE)) as f:
        return json.load(f)


def restore(path: str) -> tuple[dict, dict | None, dict]:
    """(params tree, optimizer state or None, meta) of the newest complete
    checkpoint for ``path``."""
    p = latest_path(path)
    if p is None:
        raise FileNotFoundError(f"no complete checkpoint at {path} (nor .tmp / .bak)")
    params = convert.load_flax_npz(os.path.join(p, PARAMS))
    opt_state = None
    if os.path.exists(os.path.join(p, OPT_STATE)):
        with np.load(os.path.join(p, OPT_STATE), allow_pickle=False) as npz:
            opt_state = {k: npz[k] for k in npz.files}
    with open(os.path.join(p, METAFILE)) as f:
        return params, opt_state, json.load(f)
