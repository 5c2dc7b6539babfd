"""The port's layout compiler against the reference's, on the CPU.

Seeded ``gordo-layout-input/v1`` documents (rates drawn with numpy: a
Zipf-like skew, cold machines, a few rungs) go through both packages'
``compile_plan``, ``plan_fingerprint``, ``validate_layout_plan`` (the
tamper cases too), ``explain_plan``, ``staleness`` and ``CostModel``. The
results are pure functions of the documents, so they must be EQUAL: the
same JSON bytes, the same fingerprints, the same problem lists and the
same text. There is no float tolerance to state.
"""

import copy
import json

import numpy as np
import pytest

from gordo_components_tpu import layout as ref_layout
from gordo_components_tpu.layout import compiler as ref_compiler
from gordo_components_tpu_torch import layout as our_layout
from gordo_components_tpu_torch.layout import compiler as our_compiler

SEEDS = (0, 1, 2, 3)


def _doc(seed: int, n_machines: int = 24, workers=("worker-0", "worker-1", "worker-2"),
         generated_t: float = 5000.0, horizon: str = "10m") -> dict:
    """A seeded layout-input document: Zipf-skewed rates scaled by a
    lognormal draw, a quarter of the machines cold (rate 0), a rate map
    per horizon, and an f32 and a bf16 rung carrying the byte ledger."""
    rng = np.random.default_rng(seed)
    names = [f"m-{i:03d}" for i in rng.permutation(n_machines)]
    rates = 200.0 / np.arange(1, n_machines + 1) * rng.lognormal(0.0, 0.5, n_machines)
    rates[rng.choice(n_machines, n_machines // 4, replace=False)] = 0.0
    machines = []
    for name, rate in sorted(zip(names, rates.tolist())):
        machines.append({
            "machine": name,
            "count": round(rate * 600.0, 3),
            "error": float(rng.integers(0, 3)),
            "rates": {"1m": round(rate * 1.3, 4), "10m": round(rate, 4),
                      "1h": round(rate * 0.7, 4)},
            "rate": round(rate if horizon == "10m" else rate * 1.3, 4),
        })
    total = float(sum(m["rate"] for m in machines))
    rungs = {}
    for rung, share in (("bf16", 0.25), ("f32", 0.75)):
        requests = total * 600.0 * share
        rungs[rung] = {
            "machines": int(n_machines * share),
            "buckets": 2,
            "device_bytes": int(rng.integers(1 << 28, 1 << 31)),
            "requests": requests,
            "count": requests,
            "rates": {"10m": total * share},
            "dispatch_seconds_total": requests * float(rng.uniform(0.005, 0.05)),
            "latency_s": None,
            "compile_seconds": 0.0,
        }
    return {
        "schema": "gordo-layout-input/v1",
        "generated_t": generated_t,
        "window_s": 600.0,
        "horizon": horizon,
        "source": {"workers": list(workers), "interval_s": 15.0, "coverage_s": 600.0,
                   "sketch_capacity": 512},
        "machines": machines,
        "rungs": rungs,
        "tiers": {"host_cache": {}, "spill": {}},
        "totals": {"count": total * 600.0, "rates": {"10m": total},
                   "machines_tracked": n_machines},
    }


def _same(a, b) -> None:
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cap,budget", [(None, 0.0), (2, 0.0), (None, 0.05), (0, 0.2)])
def test_compile_plan_is_the_references_byte_for_byte(seed, cap, budget):
    doc = _doc(seed)
    ours = our_layout.compile_plan(doc, residency_cap=cap, parity_budget=budget)
    theirs = ref_layout.compile_plan(doc, residency_cap=cap, parity_budget=budget)
    assert json.dumps(ours, indent=2, sort_keys=True) == json.dumps(theirs, indent=2,
                                                                      sort_keys=True)
    assert ours["fingerprint"] == our_layout.plan_fingerprint(ours)
    if budget:
        assert ours["precision"]  # the budget bought downgrades


@pytest.mark.parametrize("seed", SEEDS)
def test_compile_plan_options_agree(seed):
    """Live worker lists, spec-pinned precisions, another vnode count and
    the 1m horizon."""
    doc = _doc(seed, horizon="1m")
    pins = {doc["machines"][0]["machine"]: "f32"}
    for kwargs in ({"workers": ["worker-1", "worker-0"]}, {"vnodes": 16},
                   {"parity_budget": 0.1, "spec_precisions": pins}):
        _same(our_layout.compile_plan(doc, **kwargs), ref_layout.compile_plan(doc, **kwargs))


def test_compile_plan_env_budget_and_errors_agree(monkeypatch):
    monkeypatch.setenv("GORDO_LAYOUT_PARITY_BUDGET", "0.05")
    _same(our_layout.compile_plan(_doc(5)), ref_layout.compile_plan(_doc(5)))
    for bad in ({"schema": "nope"}, {**_doc(0), "source": {"workers": []}}):
        with pytest.raises(ValueError) as ours:
            our_layout.compile_plan(bad)
        with pytest.raises(ValueError) as theirs:
            ref_layout.compile_plan(bad)
        assert str(ours.value) == str(theirs.value)


def _tampered(plan: dict) -> list:
    """Plans edited after emission, or malformed, one way each."""
    cases = []

    def edit(fn):
        doc = copy.deepcopy(plan)
        fn(doc)
        cases.append(doc)

    edit(lambda p: p["weights"].__setitem__("worker-0", 7.77))
    edit(lambda p: p["residency"]["workers"]["worker-1"]["resident"].append("m-999"))
    edit(lambda p: p["prefetch"].__setitem__("worker-2", ["m-000"]))
    edit(lambda p: p["precision"].__setitem__("m-001", "fp8"))
    edit(lambda p: p.__setitem__("schema", "gordo-layout-plan/v0"))
    edit(lambda p: p.pop("fingerprint"))
    edit(lambda p: p.__setitem__("generated_t", "yesterday"))
    edit(lambda p: p.__setitem__("workers", ["worker-0", ""]))
    edit(lambda p: p.__setitem__("weights", {"worker-0": -1.0}))
    edit(lambda p: p["residency"].__setitem__("cap", -3))
    edit(lambda p: p["residency"]["workers"].__setitem__("worker-0", "all"))
    edit(lambda p: p["residency"]["workers"]["worker-0"].__setitem__("expected_hit_rate", 1.5))
    edit(lambda p: p.__setitem__("prefetch", {"worker-0": "m-001"}))
    edit(lambda p: p.__setitem__("source", []))
    edit(lambda p: p.__setitem__("residency", None))
    cases.append([plan])
    return cases


@pytest.mark.parametrize("seed", SEEDS)
def test_validate_layout_plan_agrees_on_clean_and_tampered_plans(seed):
    plan = our_layout.compile_plan(_doc(seed), parity_budget=0.05)
    assert our_layout.validate_layout_plan(plan) == [] == ref_layout.validate_layout_plan(plan)
    for i, doc in enumerate(_tampered(plan)):
        ours = our_layout.validate_layout_plan(doc)
        assert ours, f"tamper case {i} passed validation"
        assert ours == ref_layout.validate_layout_plan(doc), f"tamper case {i}"


@pytest.mark.parametrize("seed", SEEDS)
def test_fingerprint_ignores_provenance_in_both(seed):
    plan = ref_layout.compile_plan(_doc(seed))
    moved = copy.deepcopy(plan)
    moved["generated_t"] += 60.0
    moved["source"]["total_rps"] = 0.0
    moved["moves"] = []
    for doc in (plan, moved):
        assert our_layout.plan_fingerprint(doc) == ref_layout.plan_fingerprint(doc)
    assert our_layout.plan_fingerprint(moved) == our_layout.plan_fingerprint(plan)


@pytest.mark.parametrize("seed", SEEDS)
def test_explain_plan_renders_the_same_text(seed):
    plan = our_layout.compile_plan(_doc(seed), residency_cap=2, parity_budget=0.05)
    assert our_layout.explain_plan(plan) == ref_layout.explain_plan(plan)
    assert our_layout.explain_plan({}) == ref_layout.explain_plan({})


@pytest.mark.parametrize("seed", SEEDS)
def test_staleness_agrees_on_age_drift_and_bad_documents(seed):
    plan = our_layout.compile_plan(_doc(seed))
    fresh_docs = [
        _doc(seed, generated_t=5100.0),            # young, same rates: stands
        _doc(seed, generated_t=5000.0 + 3600.0),   # too old
        _doc(seed + 100, generated_t=5100.0),      # other rates: drifted
        {"machines": "garbage", "generated_t": 5100.0},
    ]
    for doc in fresh_docs:
        for kwargs in ({}, {"max_age_s": 0.0, "drift_limit": 0.9}, {"drift_limit": 0.05}):
            assert our_layout.staleness(plan, doc, **kwargs) == ref_layout.staleness(
                plan, doc, **kwargs)
    assert our_layout.staleness(plan, fresh_docs[0]) is None
    assert our_layout.staleness(plan, fresh_docs[1]) is not None
    assert our_compiler.machine_rates_for_drift({"machines": [{"machine": "a"}]}) == \
        ref_compiler.machine_rates_for_drift({"machines": [{"machine": "a"}]})


@pytest.mark.parametrize("seed", SEEDS)
def test_cost_model_scores_agree(seed):
    doc = _doc(seed)
    ours, theirs = our_layout.CostModel(doc), ref_layout.CostModel(doc)
    assert ours.rates == theirs.rates == our_layout.machine_rates(doc)
    assert (ours.total_rps, ours.bytes_per_machine, ours.base_latency_s) == (
        theirs.total_rps, theirs.bytes_per_machine, theirs.base_latency_s)
    rng = np.random.default_rng(seed)
    workers = doc["source"]["workers"]
    machines = sorted(ours.rates)
    for _ in range(4):
        assignment = {m: workers[int(rng.integers(len(workers)))] for m in machines}
        resident = {w: [m for m, a in assignment.items() if a == w][:3] for w in workers}
        precision = {m: ("bf16", "int8")[int(rng.integers(2))]
                     for m in rng.choice(machines, 5, replace=False).tolist()}
        assert ours.score(assignment, workers, resident, precision) == theirs.score(
            assignment, workers, resident, precision)
        loads = ours.worker_loads(assignment, workers)
        assert loads == theirs.worker_loads(assignment, workers)
        assert ours.p99_proxy_s(loads, 0.5) == theirs.p99_proxy_s(loads, 0.5)
        assert ours.machines_per_gib(precision) == theirs.machines_per_gib(precision)
