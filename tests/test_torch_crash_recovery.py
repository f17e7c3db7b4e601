"""``odam_torch.scripts.crash_recovery_demo`` on the CPU: a rehearsal
training run killed in the middle of a save resumes and ends near where an
uninterrupted run ends.

The trainer processes (``odam_torch.examples.cli_rehearsal.train``) get a
``sitecustomize`` on their path (``chip_smoke.slow_save_site``) that makes
every checkpoint write wait a second after its ``.tmp`` directory exists,
so the demo's kill lands inside the second bank (step 4) in every run,
before its files are written: the resume must then start from the bank of
step 2.  The demo itself has no such option.  In ``detector`` mode the
trainer resumes segment 0 at that bank with a fresh optimizer and data
stream, so the final losses agree within JAX's 0.15.
"""
import json
import os
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from odam_torch.scripts import crash_recovery_demo  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401


def test_kill_mid_save_resumes_to_the_uninterrupted_loss(tmp_path, monkeypatch, capsys):
    site = chip_smoke.slow_save_site(str(tmp_path / "site"), seconds=1.0)
    monkeypatch.setenv("PYTHONPATH", site + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # the hard split's TinyBackbone DETR at batch 2, one thread a trainer
    monkeypatch.setenv("ODAM_HARD", "1")
    monkeypatch.setenv("ODAM_TRAIN_BATCH", "2")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    work = tmp_path / "work"
    result = crash_recovery_demo.main([
        "--mode", "detector", "--device", "cpu", "--steps", "6", "--bank", "2",
        "--workdir", str(work)])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert result["mode"] == "detector"
    assert result["killed_mid_save"], result
    assert result["interruption"] == "SIGKILL mid-save (crash_ckpt.tmp present)"
    # the kill came before the second bank was complete: the resume took step 2's
    assert result["banked_steps_at_kill"] == 2
    assert result["recovery_segment"] == [0, 6]        # segment 0 again, from its bank
    assert result["within_tolerance"] and result["relative_diff"] <= 0.15
    with open(work / "crash_seg1.log") as f:
        assert "resumed from" in f.read()
