"""The port's scrape-of-scrapes (``observability/aggregate.py``) against the
reference's, on the CPU.

First the reference's own cases (``tests/test_slo.py``): counters summed,
histogram buckets merged, gauges labelled by worker; exemplars newest-wins
and stripped when not asked for; a TYPE conflict or a bucket-layout
mismatch skips its family, not the scrape; malformed input raises; an
untyped family passes through worker-labelled. Then parity: for the same
worker texts, rendered by each package's own registry, the port's merged
exposition equals the reference's text for text.
"""

import time

import pytest

from gordo_components_tpu.observability import aggregate as ref_aggregate
from gordo_components_tpu.observability import exposition as ref_exposition
from gordo_components_tpu.observability import tracing as ref_tracing
from gordo_components_tpu.observability.registry import Registry as RefRegistry

from gordo_components_tpu_torch.observability import aggregate, exposition, tracing
from gordo_components_tpu_torch.observability.registry import Registry

PACKAGES = {
    "port": (aggregate, exposition, tracing, Registry),
    "reference": (ref_aggregate, ref_exposition, ref_tracing, RefRegistry),
}


def _scoring_registry(latency_s: float, n: int = 50, registry_cls=Registry):
    registry = registry_cls()
    hist = registry.histogram(
        "gordo_server_request_duration_seconds", "lat",
        labels=("endpoint",),
    )
    counter = registry.counter(
        "gordo_server_requests_total", "reqs",
        labels=("endpoint", "status"),
    )
    for _ in range(n):
        hist.labels("anomaly").observe(latency_s)
        counter.labels("anomaly", "200").inc()
    return registry


def _exposed(registry, trace_id=None, exemplars=False, packages=PACKAGES["port"]):
    _, exposition_mod, tracing_mod, _ = packages
    if trace_id:
        token = tracing_mod.set_trace_id(trace_id)
        try:
            registry.histogram(
                "gordo_server_request_duration_seconds", "lat",
                labels=("endpoint",),
            ).labels("anomaly").observe(0.01)
        finally:
            tracing_mod.reset_trace_id(token)
    return exposition_mod.render_prometheus(registry, exemplars=exemplars)


def test_aggregate_counters_sum_histograms_merge_gauges_label():
    r1 = _scoring_registry(0.010, n=3)
    r2 = _scoring_registry(0.020, n=7)
    g1 = r1.gauge("gordo_router_workers_alive", "alive")
    g1.set(1)
    g2 = r2.gauge("gordo_router_workers_alive", "alive")
    g2.set(2)
    merged = aggregate.merge_expositions({
        "worker-0": exposition.render_prometheus(r1),
        "worker-1": exposition.render_prometheus(r2),
    })
    samples = exposition.parse_prometheus_text(merged)
    # counters summed into ONE fleet series
    assert samples["gordo_server_requests_total"] == [
        ({"endpoint": "anomaly", "status": "200"}, 10.0)
    ]
    # histogram buckets merged; +Inf == count held by the validator
    count = samples["gordo_server_request_duration_seconds_count"]
    assert count == [({"endpoint": "anomaly"}, 10.0)]
    buckets = dict(
        (labels["le"], value)
        for labels, value in
        samples["gordo_server_request_duration_seconds_bucket"]
    )
    assert buckets["0.01"] == 3.0  # only r1's 3 fit the 10ms bucket
    assert buckets["+Inf"] == 10.0
    # gauges per-worker labeled, values intact
    alive = dict(
        (labels["worker"], value)
        for labels, value in samples["gordo_router_workers_alive"]
    )
    assert alive == {"worker-0": 1.0, "worker-1": 2.0}


def test_aggregate_preserves_exemplars_newest_wins():
    r1 = _scoring_registry(0.010, n=1)
    r2 = _scoring_registry(0.010, n=1)
    t1 = _exposed(r1, trace_id="older", exemplars=True)
    time.sleep(0.01)
    t2 = _exposed(r2, trace_id="newer", exemplars=True)
    merged = aggregate.merge_expositions(
        {"w0": t1, "w1": t2}, exemplars=True
    )
    samples, exemplars = exposition.parse_prometheus_text(
        merged, return_exemplars=True
    )
    rows = exemplars["gordo_server_request_duration_seconds_bucket"]
    traces = {ex["labels"]["trace_id"] for _, ex in rows}
    assert traces == {"newer"}
    # exemplars strip cleanly when not requested (strict v0.0.4)
    bare = aggregate.merge_expositions(
        {"w0": t1, "w1": t2}, exemplars=False
    )
    assert " # {" not in bare


def test_aggregate_type_conflict_skips_family_not_scrape():
    good = "# TYPE gordo_server_requests_total counter\n" \
           "gordo_server_requests_total 5\n"
    conflicting = "# TYPE gordo_server_requests_total gauge\n" \
                  "gordo_server_requests_total 7\n"
    merged = aggregate.merge_expositions(
        {"w0": good, "w1": conflicting}
    )
    assert "skipped" in merged
    samples = exposition.parse_prometheus_text(merged)
    assert "gordo_server_requests_total" not in samples


def test_aggregate_rejects_malformed_input():
    with pytest.raises(ValueError):
        aggregate.merge_expositions({"w0": "not { exposition"})


def test_aggregate_bucket_layout_mismatch_skips_family():
    """Mid-rollout skew: two sources exposing DIFFERENT le sets for one
    series cannot be summed per-bucket (non-monotone output) — the
    family is skipped loudly, the scrape survives."""
    a = (
        "# TYPE gordo_server_request_duration_seconds histogram\n"
        'gordo_server_request_duration_seconds_bucket{le="0.1"} 1\n'
        'gordo_server_request_duration_seconds_bucket{le="+Inf"} 2\n'
        "gordo_server_request_duration_seconds_sum 0.3\n"
        "gordo_server_request_duration_seconds_count 2\n"
    )
    b = (
        "# TYPE gordo_server_request_duration_seconds histogram\n"
        'gordo_server_request_duration_seconds_bucket{le="0.5"} 3\n'
        'gordo_server_request_duration_seconds_bucket{le="+Inf"} 4\n'
        "gordo_server_request_duration_seconds_sum 0.9\n"
        "gordo_server_request_duration_seconds_count 4\n"
    )
    merged = aggregate.merge_expositions({"w0": a, "w1": b})
    assert "bucket layouts disagree" in merged
    samples = exposition.parse_prometheus_text(merged)
    assert "gordo_server_request_duration_seconds_bucket" not in samples


def test_aggregate_untyped_family_passes_through_worker_labeled():
    text = "gordo_server_custom_value 7\n"  # no # TYPE line: legal
    merged = aggregate.merge_expositions({"w0": text})
    samples = exposition.parse_prometheus_text(merged)
    assert samples["gordo_server_custom_value"] == [
        ({"worker": "w0"}, 7.0)
    ]


# -- parity with the reference ------------------------------------------------

def _worker_texts(package: str, exemplars: bool):
    """Three workers' expositions rendered by one package's registry: two
    scoring workers and a third with a gauge, an extra label set and a
    labelled histogram of its own."""
    agg, exposition_mod, tracing_mod, registry_cls = PACKAGES[package]
    texts = {}
    for i, (latency, n) in enumerate(((0.004, 3), (0.2, 11), (1.7, 5))):
        registry = _scoring_registry(latency, n, registry_cls)
        registry.gauge("gordo_router_workers_alive", "alive").set(i + 1)
        registry.counter("gordo_server_requests_total", "reqs",
                         labels=("endpoint", "status")).labels("prediction", str(500 + i)).inc(i)
        stage = registry.histogram("gordo_stage_seconds", "stage", labels=("stage",))
        for j in range(i + 2):
            token = tracing_mod.set_trace_id(f"trace-{i}-{j}")
            try:
                stage.labels("device_execute").observe(0.001 * (j + 1) * (i + 1))
            finally:
                tracing_mod.reset_trace_id(token)
        texts[f"worker-{i}"] = exposition_mod.render_prometheus(registry, exemplars=exemplars)
    return texts


@pytest.mark.parametrize("exemplars", [False, True])
def test_merged_exposition_equals_the_reference(exemplars):
    texts = _worker_texts("reference", exemplars)
    ours = aggregate.merge_expositions(texts, exemplars=exemplars)
    theirs = ref_aggregate.merge_expositions(texts, exemplars=exemplars)
    assert ours == theirs
    # the port's own registry renders the same workers to the same merge,
    # exemplar timestamps aside
    if not exemplars:
        assert aggregate.merge_expositions(_worker_texts("port", False)) == theirs


def test_conflicts_and_passthrough_equal_the_reference():
    texts = {
        "w0": "# TYPE gordo_a counter\ngordo_a 5\ngordo_untyped 1\n",
        "w1": "# TYPE gordo_a gauge\ngordo_a 7\n# TYPE gordo_b gauge\ngordo_b{worker=\"x\"} 2\n",
        "w2": "# TYPE gordo_b gauge\ngordo_b NaN\n",
    }
    assert aggregate.merge_expositions(texts) == ref_aggregate.merge_expositions(texts)
