"""A traced run splits its window: the host-clock readers read the untraced
lead, and the device-trace readers the traced rest alone."""

from __future__ import annotations

import pytest

from benchmark.drivers import round_eval, round_train
from benchmark.harness import window as window_mod
from benchmark.metrics import reader
from benchmark.tests import tiny


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_traced_run_reads_host_clock_metrics_from_its_untraced_lead(kind):
    c = tiny.ctx(kind=kind, seconds=2.0)
    c.trace = True
    driver = round_train if kind == "train" else round_eval
    record = driver.run(c).record
    lead, traced = record["lead"], record["traced_s"]
    assert lead and lead["images"] > 0 and traced > 0
    share = 1.0 - window_mod.TRACED_SHARE
    assert share * c.seconds <= lead["seconds"] < record["window_s"]
    assert lead["seconds"] + traced <= record["window_s"] + 1e-6
    assert record["images"] > lead["images"]
    assert reader(f"mfu.{kind}")(record) > 0
    if kind == "train":
        spans = lead["spans"]
        assert spans and all(b <= spans[0][1] + lead["seconds"] for _, _, b in spans)
        assert 0 <= reader("client_overhead_share.train")(record) <= 100


def test_untraced_run_has_no_lead():
    record = round_train.run(tiny.ctx(seconds=0.5)).record
    assert record["lead"] is None and record["traced_s"] is None
    assert reader("mfu.train")(record) is None


def test_host_load_reads_steal_and_busy_shares():
    a = [100, 0, 50, 800, 0, 0, 0, 50]
    b = [300, 0, 100, 1300, 0, 0, 0, 300]  # +200 user, +50 system, +500 idle, +250 steal
    load = window_mod.host_load(a, b, own_s=1.5, wall_s=1.0)
    assert load == {"steal_share": 0.25, "busy_share": 0.25, "own_cores": 1.5}
    assert window_mod.host_load(None, b, 1.0, 2.0) == {"own_cores": 0.5}
    assert window_mod.host_load(a, a, 1.0, 2.0) == {"own_cores": 0.5}
