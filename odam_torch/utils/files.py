"""Path/date helpers and run-snapshot utilities (counterpart of
``odam_tpu/utils/files.py``: the reference's src/utils/file_utils.py and its
run snapshotting, git-sha capture and config dump, misc.py:268-285, 478-486).
"""
from __future__ import annotations

import datetime
import os
import subprocess


def get_file_name(path: str) -> str:
    """Basename without extension (file_utils.py:1-10)."""
    return os.path.splitext(os.path.basename(path))[0]


def get_date_time() -> str:
    """Timestamp string for run directories (file_utils.py:13-25)."""
    return datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")


def get_git_sha(repo_dir: str | None = None) -> str:
    """Current commit sha + dirty flag (misc.py:268-285)."""
    try:
        cwd = repo_dir or os.getcwd()
        sha = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=cwd, stderr=subprocess.DEVNULL
        ).decode().strip()
        dirty = subprocess.call(
            ["git", "diff-index", "--quiet", "HEAD"], cwd=cwd,
            stderr=subprocess.DEVNULL,
        )
        return sha + ("-dirty" if dirty else "")
    except Exception:
        return "unknown"


def snapshot_run(out_dir: str, cfg: dict | None = None, args=None) -> None:
    """Write run metadata (git sha, config, CLI args) into out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "run_info.txt"), "w") as f:
        f.write(f"time: {get_date_time()}\n")
        f.write(f"git: {get_git_sha()}\n")
        if args is not None:
            f.write(f"args: {vars(args) if hasattr(args, '__dict__') else args}\n")
    if cfg is not None:
        from .. import config as config_mod

        config_mod.save_cfg(dict(cfg), os.path.join(out_dir, "config_snapshot.yaml"))
