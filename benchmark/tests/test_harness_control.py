"""The comparison that decides ``correct`` fails what it must, at a CPU size.

A sound run of each cell kind is correct; the control (the reference in
the nearest lower precision in the program's place) fails a number; and a
run with the timed path broken underneath comes out not correct, once for
each fault the cell can have."""

from __future__ import annotations

import pytest

from benchmark.drivers import round_eval, round_train
from benchmark.tests import tiny


@pytest.mark.parametrize("net", ["sphnet20", "iresnet18"])
def test_sound_training_run_is_correct(net):
    result = round_train.run(tiny.ctx(net))
    assert result.attempted > 0
    assert tiny.correct(result.checked), result.checked


def test_sound_eval_run_is_correct():
    result = round_eval.run(tiny.ctx(kind="eval"))
    assert result.attempted > 0
    assert tiny.correct(result.checked), result.checked


@pytest.mark.parametrize("fault", round_train.FAULTS)
def test_training_fault_is_not_correct(fault):
    result = round_train.run(tiny.ctx(fault=fault, seconds=0.0))
    assert not tiny.correct(result.checked), (fault, result.checked)


@pytest.mark.parametrize("fault,number", [("stats_unchanged", "stats_gap"),
                                          ("heads_unchanged", "update_gap_head")])
def test_fault_the_median_leaf_cannot_see_fails_its_own_number(fault, number):
    """iresnet100 compares the median leaf: a fault confined to the running
    statistics or to the heads is caught by a number of its own."""
    result = round_train.run(tiny.ctx("iresnet18", fault=fault, seconds=0.0))
    assert result.checked[number]["value"] > result.checked[number]["limit"], result.checked
    assert not tiny.correct(result.checked), (fault, result.checked)


@pytest.mark.parametrize("fault", round_eval.FAULTS)
def test_eval_fault_is_not_correct(fault):
    result = round_eval.run(tiny.ctx(kind="eval", fault=fault, seconds=0.5))
    assert not tiny.correct(result.checked), (fault, result.checked)


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_control_is_not_correct(kind):
    c = tiny.ctx(kind=kind, seconds=0.0 if kind == "train" else 0.5)
    c.controls = True
    driver = round_train if kind == "train" else round_eval
    readings = driver.run(c).record["controls"]["control"]
    assert any(readings[k] > limit for k, limit in tiny.LIMITS[kind].items()), readings
