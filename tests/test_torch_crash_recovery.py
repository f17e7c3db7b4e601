"""``odam_torch.scripts.crash_recovery_demo`` on the CPU: a training run
killed in the middle of a save resumes and ends where an uninterrupted run
ends.

The trainer processes get a ``sitecustomize`` on their path
(``chip_smoke.slow_save_site``) that makes every checkpoint write wait a
second after its ``.tmp`` directory exists, so the demo's kill lands inside
the save of step 4 in every run, before its files are written: the resume
must then start from ``ckpt_2``.  The demo itself has no such option.
"""
import json
import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from odam_torch.scripts import crash_recovery_demo  # noqa: E402


def test_kill_mid_save_resumes_to_the_uninterrupted_loss(tmp_path, monkeypatch, capsys):
    site = chip_smoke.slow_save_site(str(tmp_path / "site"), seconds=1.0)
    monkeypatch.setenv("PYTHONPATH", site + os.pathsep + os.environ.get("PYTHONPATH", ""))
    work = tmp_path / "work"
    result = crash_recovery_demo.main([
        "--device", "cpu", "--steps", "6", "--bank", "2", "--img_h", "64", "--img_w", "64",
        "--batch_size", "2", "--tol", "1e-6", "--workdir", str(work)])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert result["killed_mid_save"], result
    assert result["interruption"] == "SIGKILL mid-save (ckpt_4.tmp present)"
    # the kill came before ckpt_4.tmp was complete: the resume took ckpt_2
    assert result["banked_steps_at_kill"] == 2
    assert result["within_tolerance"] and result["relative_diff"] <= 1e-6
    assert result["baseline_final_loss"] == pytest.approx(result["recovered_final_loss"],
                                                          rel=1e-6)
