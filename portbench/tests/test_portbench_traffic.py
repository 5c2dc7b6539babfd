"""The traffic generator's seeded plans."""

import json
import os

import numpy as np
import pytest

from harness import traffic
from conftest import BENCH


def mix(name):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def test_open_loop_same_arrivals_in_another_order():
    periodic = mix("periodic")
    a = traffic.plan(periodic, 2 ** 31 + 11, 30.0)
    b = traffic.plan(periodic, 2 ** 31 + 11, 30.0)
    c = traffic.plan(periodic, 7, 30.0)
    assert a == b
    count = int(round(periodic["rate_per_s"] * 30.0))
    assert len(a["due"]) == len(c["due"]) == len(a["order"]) == count
    # the same arrival times for every seed; the seed draws the bodies
    assert a["due"] == c["due"]
    assert a["order"] != c["order"]
    assert sorted(a["order"]) == sorted(c["order"])
    assert a["due"][0] == 0.0 and max(a["due"]) < 30.0
    assert all(x < y for x, y in zip(a["due"], a["due"][1:]))


def test_open_loop_gaps_at_the_rate():
    periodic = mix("periodic")
    assert periodic["arrivals"] == "poisson"
    gaps = np.diff(traffic.plan(dict(periodic, rate_per_s=50.0), 3, 200.0)["due"])
    assert abs(gaps.mean() - 1 / 50.0) < 1e-3
    # an exponential's standard deviation equals its mean
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.1
    # no two runs of a cell offer another rate
    with pytest.raises(ValueError):
        traffic.plan(dict(periodic, arrivals="staggered"), 3, 30.0)


def test_machines_drawn_uniformly_every_body_as_often():
    for name in ("periodic", "backfill"):
        tr = mix(name)
        plan = traffic.plan(tr, 5, 30.0)
        assert plan["bodies"] == [m for m in range(tr["fleet"])
                                  for _ in range(tr["bodies_per_machine"])]
        counts = np.bincount(plan["order"], minlength=len(plan["bodies"]))
        assert counts.max() - counts.min() <= 1


def test_closed_loop_order_and_window_counts():
    backfill = mix("backfill")
    plan = traffic.plan(backfill, 9, 30.0)
    assert plan["due"] is None and len(plan["order"]) == traffic.CLOSED_ORDER
    assert plan["order"] != traffic.plan(backfill, 10, 30.0)["order"]
    assert traffic.rows_per_request(backfill, 1440) == 1679
    assert traffic.rows_per_request(mix("periodic"), 1440) == 1499
