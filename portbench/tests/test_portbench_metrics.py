"""The end-to-end arithmetic, the /metrics deltas and which metric a cell
reports."""

import pytest

from conftest import ROOT
from harness import manifest
from harness.readings import Run, parse_prometheus, percentile


def run_of(records, t0=10.0, t1=20.0, **kw):
    kw.setdefault("config", {})
    return Run(cell={}, traffic={}, t0=t0, t1=t1, setup_s=5.0, collected=25.0,
               records=records, **kw)


def rec(sent, done, status=200, due=None, windows=10):
    return {"body": 0, "due": due, "sent": sent, "done": done, "status": status,
            "windows": windows}


def test_rate_counts_each_request_by_its_share_of_the_window():
    run = run_of([rec(9.0, 11.0), rec(11.0, 12.0), rec(19.0, 23.0), rec(12.0, 13.0, status=503)])
    # half of the first, all of the second, a quarter of the third; the
    # failed one scores nothing
    expected = (5.0 + 10.0 + 2.5) / 10.0
    assert manifest.reader("windows_per_s")(run) == pytest.approx(expected)


def test_p95_over_all_requests_due_with_failures_missing():
    records = [rec(10 + i * 0.1, 10 + i * 0.1 + 0.05, due=10 + i * 0.1) for i in range(20)]
    run = run_of(records)
    assert manifest.reader("latency_p95_ms")(run) == pytest.approx(50.0)
    records[3]["status"] = 0
    records[4]["status"] = 503
    worst = manifest.reader("latency_p95_ms")(run_of(records))
    # 2 of 20 failed: the 19th of 20 values is a failure, longer than any answer
    assert worst > 1000.0 * (25.0 - 10.4)
    # a request due outside the window is not owed by it
    late = rec(21.0, 21.5, due=20.5)
    assert len(run_of(records + [late]).due_in_window()) == 20


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))
    assert percentile(values, 95) == 95
    assert percentile([3.0], 95) == 3.0
    assert percentile(list(range(1, 21)), 95) == 19


def test_prometheus_deltas():
    before = parse_prometheus('# HELP x\ngordo_stage_seconds_sum{stage="encode"} 1.5\n'
                              'gordo_stage_seconds_count{stage="encode"} 10\n'
                              'gordo_engine_requests_total{path="cold"} 4\n'
                              'gordo_engine_dispatch_seconds_count{path="cold"} 2\n')
    after = parse_prometheus('gordo_stage_seconds_sum{stage="encode"} 2.5\n'
                             'gordo_stage_seconds_count{stage="encode"} 30\n'
                             'gordo_stage_seconds_count{stage="queue_wait"} 7\n'
                             'gordo_engine_requests_total{path="cold"} 10\n'
                             'gordo_engine_requests_total{path="mega"} 6\n'
                             'gordo_engine_dispatch_seconds_count{path="cold"} 4\n'
                             'gordo_engine_dispatch_seconds_count{path="mega"} 2\n')
    run = run_of([], prom={"before": before, "after": after})
    assert manifest.reader("encode_ms.periodic")(run) == pytest.approx(50.0)
    assert manifest.reader("requests_per_dispatch.periodic")(run) == pytest.approx(3.0)
    assert manifest.reader("queue_wait_ms.periodic")(run) == 0.0
    assert manifest.reader("encode_ms.periodic")(run_of([])) is None


def test_trace_readers_find_nothing_without_a_trace():
    run = run_of([rec(11.0, 12.0)], config={"model": {}, "n_tags": 1, "peak": "tf32"})
    for name in ("attn_roofline.backfill", "idle_share.backfill", "idle_share.periodic"):
        assert manifest.reader(name)(run) is None
    traced = run_of([rec(11.0, 12.0)], trace={"busy_s": 7.5, "window_s": 10.0, "kernel_s": {}})
    assert manifest.reader("idle_share.periodic")(traced) == pytest.approx(25.0)


def test_each_cell_reports_what_its_per_layer_metrics_move():
    man = manifest.load(ROOT)
    for cell in man["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(man, cell["name"], False)}
        layer = manifest.metrics_of(man, cell["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
