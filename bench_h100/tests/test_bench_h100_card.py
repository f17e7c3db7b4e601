"""On the card, at each cell's own size: a short run is correct, and the
control (the reference at the precision one below the configuration's in
the program's place) is not, on three seeds.  Skips without a card.

    python3 -m pytest bench_h100 -m h100
"""
from __future__ import annotations

import pytest

from bench_h100 import calibrate, manifest, run

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SECONDS = {"lanes": 3.0, "scene_end": 20.0}


def _seconds(cell):
    return SECONDS[manifest.traffic(manifest.cell(manifest.load(), cell)["traffic"])["mix"]]


@pytest.mark.h100
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = run.run_cell(cell, 2 ** 31 + 17, _seconds(cell), False, card)
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu" and run.forbidden_modules() == []


@pytest.mark.h100
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(card, cell):
    limits = manifest.limits(cell)
    for reading in calibrate.readings(cell, [], [101, 102, 103], _seconds(cell), card):
        correct, compared = run.evaluate(reading["numbers"], limits)
        assert not correct, (reading["seed"], compared)
