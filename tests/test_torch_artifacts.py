"""``odam_torch.artifacts`` against the JAX package's ``artifacts/`` on the CPU.

- ``validate.eval_associator`` on the committed ``.npz`` equals JAX's
  ``artifacts/validate.py`` on the orbax checkpoint (its test in
  ``tests/test_artifacts.py`` reads 0.145) within NLL_ATOL, and
  ``eval_detector`` gives JAX's counts, recall, class accuracy and
  ``global_step`` (JAX's ``probe_detector.stats`` run from its source);
- ``validate.main``'s asserts and prints: the NLL bar, the recall pin for
  a complete model, a partial or meta-less model reported, an absent one
  named; it runs on the card unless ``--device cpu``;
- ``retrain.sh`` with a stub ``python`` on ``PATH`` that logs its argv and
  runs the real interpreter for the meta heredoc: no checkpoint trains the
  associator then segments 0..11, a ``global_step`` of 3000 starts at
  segment 2, a checkpoint without that meta exits non-zero with JAX's
  message, and an output root under ``artifacts/`` is refused.
"""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_examples import ROOT, jax_def, jax_module
from odam_torch.artifacts import validate as t_validate
from odam_torch.examples.cli_rehearsal import common as t_common
from odam_torch.examples.cli_rehearsal import probe_detector as t_probe
from odam_torch.models import convert
from odam_torch.utils import checkpoint as t_ckpt
from torch_threads import one_torch_thread  # noqa: F401

j_common = jax_module("cli_rehearsal/common.py")
j_hard = jax_module("cli_rehearsal/hard.py")

NLL_ATOL = 1e-4       # a mean of f32 NLLs over 11 batches of 8 (measured below 1e-6)
RETRAIN = os.path.join(ROOT, "odam_torch", "artifacts", "retrain.sh")
NO_META = ("rehearsal_hard_detr_ckpt exists but has no global_step meta; pass the next "
           "segment explicitly (see artifacts/TRAINLOG.md)")


def _jax_validate(name: str, **namespace):
    """A function of JAX's ``artifacts/validate.py``, run from its source."""
    from odam_tpu.utils import checkpoint

    base = dict(np=np, jax=jax, jnp=jnp, checkpoint=checkpoint,
                ASSOC=os.path.join(ROOT, "artifacts", "rehearsal_hard_assoc_ckpt"),
                DETR=os.path.join(ROOT, "artifacts", "rehearsal_hard_detr_ckpt"))
    return jax_def(os.path.join("..", "artifacts", "validate.py"), name, **base, **namespace)


@pytest.fixture(scope="module")
def jax_results():
    """JAX's associator NLL and detector probe on the committed weights; its
    ``probe_detector`` module stands in as the one definition the probe needs
    (the script enables a compile cache when imported)."""
    stats = jax_def("cli_rehearsal/probe_detector.py", "stats", np=np, jax=jax, jnp=jnp,
                    hard_scene_views=j_hard.hard_scene_views, norm=j_common.norm)
    probe = types.ModuleType("probe_detector")
    probe.stats = stats
    saved = sys.modules.get("probe_detector")
    sys.modules["probe_detector"] = probe
    try:
        return {"nll": _jax_validate("eval_associator")(),
                "detector": _jax_validate("eval_detector", FULL_STEPS=18000,
                                          RECALL_PIN=0.84)()}
    finally:
        if saved is None:
            del sys.modules["probe_detector"]
        else:
            sys.modules["probe_detector"] = saved


@pytest.fixture(scope="module")
def port_results():
    return t_validate.main(["--device", "cpu"])


def test_eval_associator_equals_jax(jax_results, port_results):
    got, want = port_results["associator_nll"], jax_results["nll"]
    assert abs(got - want) <= NLL_ATOL, (got, want)
    assert 0.05 < got < 0.5


def test_eval_detector_equals_jax(jax_results, port_results):
    got, want = port_results["detector"], jax_results["detector"]
    assert got == want, (got, want)
    assert got["global_step"] == 18000 and got["recall"] >= t_validate.RECALL_PIN


def _stubbed(monkeypatch, nll=0.1, counts=(10, 0, 10, 0)):
    monkeypatch.setattr(t_validate, "eval_associator", lambda weights, device: nll)
    monkeypatch.setattr(t_probe, "stats", lambda *a, **k: counts)


def test_main_prints_the_jax_lines(monkeypatch, capsys):
    _stubbed(monkeypatch, nll=0.145, counts=(196, 3, 31, 275))
    t_validate.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "associator eval-stream NLL: 0.145 (expect ~0.10-0.15; fail > 0.5)"
    assert out[1].startswith("detector probe on eval views: {'recall': 0.865, 'class_acc': "
                             "0.985, 'tp': 196, 'cls_err': 3, 'fn': 31, 'fp': 275, "
                             "'global_step': 18000}")
    assert out[-1] == "ARTIFACT VALIDATION OK"


@pytest.mark.parametrize("case", ["complete_below_pin", "partial", "npz_without_meta",
                                  "absent", "untrained_associator"])
def test_main_pins_and_reports(case, monkeypatch, tmp_path, capsys):
    """Recall 0.5 fails the pin only on a complete model; an NLL above 0.5
    fails; a partial or meta-less model is reported; no weights, named."""
    params = convert.load_flax_npz(t_common.DETR_WEIGHTS)
    _stubbed(monkeypatch, nll=0.7 if case == "untrained_associator" else 0.1)
    argv = ["--device", "cpu"]
    if case == "partial":
        t_ckpt.save(str(tmp_path / "ckpt"), params, meta={"global_step": 3000})
        argv += ["--detr", str(tmp_path / "ckpt")]
    elif case == "npz_without_meta":
        convert.save_flax_npz(str(tmp_path / "detr.npz"), params)
        argv += ["--detr", str(tmp_path / "detr.npz")]
    elif case == "absent":
        argv += ["--detr", str(tmp_path / "none")]
    if case in ("complete_below_pin", "untrained_associator"):
        with pytest.raises(AssertionError, match="does not match its docs|visible-recall 0.5"):
            t_validate.main(argv)
        return
    out = t_validate.main(argv)
    text = capsys.readouterr().out
    assert "ARTIFACT VALIDATION OK" in text
    if case == "absent":
        assert out["detector"] is None and "detector checkpoint absent" in text
    else:
        step = 3000 if case == "partial" else None
        assert out["detector"]["global_step"] == step
        assert f"(partial checkpoint at {step}/18000 steps: recall reported, not pinned)" in text


def test_validate_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: t_validate.main([]), lambda: t_validate.eval_associator(),
                 lambda: t_validate.eval_detector()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ------------------------------------------------------------------- retrain.sh

def _retrain(tmp_path, *args):
    """retrain.sh with a stub ``python`` that logs every call and runs the
    real interpreter only for the heredoc (``python -``): (rc, calls, output)."""
    stub = tmp_path / "bin"
    stub.mkdir(exist_ok=True)
    log = tmp_path / "calls.log"
    (stub / "python").write_text(
        "#!/bin/sh\n"
        f'echo "$*" >> "{log}"\n'
        f'if [ "$1" = "-" ]; then exec "{sys.executable}" "$@"; fi\n'
        "exit 0\n")
    (stub / "python").chmod(0o755)
    env = dict(os.environ, PATH=f"{stub}:{os.environ['PATH']}")
    r = subprocess.run(["bash", RETRAIN, *args], env=env, capture_output=True, text=True,
                       timeout=120)
    calls = log.read_text().splitlines() if log.exists() else []
    return r.returncode, calls, r.stdout + r.stderr


def _train(mode, seg, steps, ckpt, device="cuda"):
    return (f"-m odam_torch.examples.cli_rehearsal.train {mode} {seg} {steps} {ckpt} "
            f"--device {device}")


def test_retrain_from_nothing_trains_associator_then_every_segment(tmp_path):
    out = tmp_path / "out"
    rc, calls, text = _retrain(tmp_path, "--out", str(out))
    assert rc == 0, text
    assert calls == [_train("associator", 0, 800, f"{out}/rehearsal_hard_assoc_ckpt")] + [
        _train("detector", s, 1500, f"{out}/rehearsal_hard_detr_ckpt") for s in range(12)]
    assert "ODAM_DECAY_STEPS=18000" in text and "ODAM_BANK=150" in text


@pytest.mark.parametrize("first,want", [(None, 2), ("7", 7)])
def test_retrain_resumes_at_the_segment_of_the_meta(tmp_path, first, want):
    out = tmp_path / "out"
    tiny = {"x": np.zeros(1, np.float32)}
    t_ckpt.save(str(out / "rehearsal_hard_assoc_ckpt"), tiny, meta={"global_step": 800})
    t_ckpt.save(str(out / "rehearsal_hard_detr_ckpt"), tiny,
                meta={"global_step": 3000, "seg": 1, "seg_steps": 1500})
    rc, calls, text = _retrain(tmp_path, "--device", "cpu", "--out", str(out),
                               *([first] if first else []))
    assert rc == 0, text
    trains = [c for c in calls if c != f"- {out}/rehearsal_hard_detr_ckpt"]
    assert trains == [_train("detector", s, 1500, f"{out}/rehearsal_hard_detr_ckpt", "cpu")
                      for s in range(want, 12)]
    assert (len(calls) - len(trains)) == (first is None)


@pytest.mark.parametrize("meta_file", [True, False])
def test_retrain_refuses_a_checkpoint_without_meta(tmp_path, meta_file):
    out = tmp_path / "out"
    detr = out / "rehearsal_hard_detr_ckpt"
    if meta_file:            # the port's checkpoint with an empty meta
        t_ckpt.save(str(detr), {"x": np.zeros(1, np.float32)})
    else:                    # a directory the port never completed
        detr.mkdir(parents=True)
    (out / "rehearsal_hard_assoc_ckpt").mkdir(parents=True)
    rc, calls, text = _retrain(tmp_path, "--out", str(out))
    assert rc != 0 and NO_META in text
    assert not any("detector" in c for c in calls)


def test_retrain_refuses_to_write_into_artifacts(tmp_path):
    before = sorted(os.listdir(os.path.join(ROOT, "artifacts")))
    rc, calls, text = _retrain(tmp_path, "--out", "artifacts/retrained")
    assert rc != 0 and "refusing to write under artifacts/" in text and calls == []
    assert sorted(os.listdir(os.path.join(ROOT, "artifacts"))) == before
