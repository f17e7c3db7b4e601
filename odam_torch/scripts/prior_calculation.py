"""Recompute the per-class scale prior from Scan2CAD annotations.

Counterpart of ``scripts/prior_calculation.py`` (the reference's
src/super_quadric/prior_calculation.py).  The port ships the tables as
literals (:mod:`odam_torch.mapping.prior`); this regenerates them from a
full_annotations.json on the host.

    python -m odam_torch.scripts.prior_calculation --scan2cad full_annotations.json
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np

from ..mapping import prior


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m odam_torch.scripts.prior_calculation",
                                 description="Per-class scale prior from Scan2CAD annotations.")
    ap.add_argument("--scan2cad", required=True,
                    help="path to Scan2CAD full_annotations.json")
    ap.add_argument("--out", default=None, help="optional pickle output path")
    return ap


def main(argv: list[str] | None = None) -> dict[str, np.ndarray]:
    """Returns the tables, as printed and written to ``--out``."""
    args = build_parser().parse_args(argv)
    tables = prior.compute_scale_prior(args.scan2cad)
    for cat, invcov in tables.items():
        print(prior.CLASS_NAMES[cat])
        print(invcov)
        print("---------")
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(tables, f)
    return tables


if __name__ == "__main__":
    main()
