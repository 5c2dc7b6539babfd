"""The port's telemetry warehouse against the reference's, on the CPU.

Both warehouses read private registries (each package's own ``Registry``)
fed the same seeded series: machine-labeled counters and histograms,
gauges, a family without a machine label. On one injected clock pair
(monotonic and wall) both tick alike, and ``view(window)``,
``window_view``, ``rate``, ``histogram_window`` and ``build_export`` give
equal JSON, floats within 1e-12. Rotation and the byte budget delete the
same segments; a restart over a torn tail reloads the same records in both;
each package's ``validate_layout_input`` accepts the other's export;
``merge_views``, ``parse_window`` and ``resolve_horizon`` agree.
"""

import json
import os

import numpy as np
import pytest

from gordo_components_tpu.observability import registry as ref_registry
from gordo_components_tpu.observability import telemetry as ref_telemetry
from gordo_components_tpu.observability import traffic as ref_traffic

from gordo_components_tpu_torch.observability import registry, telemetry, traffic

ATOL = 1e-12
PACKAGES = ((registry, telemetry, traffic), (ref_registry, ref_telemetry, ref_traffic))


class FakeClock:
    def __init__(self, start=1000.0):
        self.now = start

    def __call__(self):
        return self.now


def _close(a, b, path="view"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for key in a:
            _close(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= ATOL * max(1.0, abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


class _Side:
    """One package's registry, series, accountant and warehouse."""

    def __init__(self, package, directory, clock, **kwargs):
        reg_mod, tel_mod, tra_mod = package
        self.reg = reg_mod.Registry()
        self.requests = self.reg.counter("gordo_t_requests_total", "requests",
                                         labels=("machine", "status"))
        self.latency = self.reg.histogram("gordo_t_latency_seconds", "latency",
                                          labels=("machine",))
        self.plain = self.reg.counter("gordo_t_ticks_total", "no machine label")
        self.depth = self.reg.gauge("gordo_t_depth", "a gauge", labels=("machine",))
        self.accountant = tra_mod.TrafficAccountant(capacity=16, clock=clock)
        self.warehouse = tel_mod.TelemetryWarehouse(
            directory=directory, registry=self.reg, accountant=self.accountant,
            clock=clock, wall=clock, min_interval=1.0, **kwargs)


def _sides(tmp_path, clock, durable=True, **kwargs):
    return [_Side(package, str(tmp_path / name) if durable else None, clock, **kwargs)
            for package, name in zip(PACKAGES, ("port", "ref"))]


def _feed(sides, clock, seed, ticks=12, per_tick=60):
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, 13)
    for _ in range(ticks):
        machines = rng.choice(12, size=per_tick, p=weights / weights.sum())
        latencies = rng.lognormal(-3.0, 1.0, size=per_tick)
        statuses = rng.choice(["200", "503"], size=per_tick, p=[0.95, 0.05])
        for m, lat, status in zip(machines, latencies, statuses):
            name = f"m-{m:02d}"
            for side in sides:
                side.requests.labels(name, status).inc()
                side.latency.labels(name).observe(float(lat))
                side.accountant.note(name, bucket="L1f10", precision="f32")
        depth = float(rng.integers(0, 8))
        for side in sides:
            side.plain.inc()
            side.depth.labels("m-00").set(depth)
        clock.now += float(rng.uniform(1.0, 40.0))
        for side in sides:
            assert side.warehouse.maybe_tick()


def _view(side, window, now=None):
    view = side.warehouse.view(window=window, now_wall=now)
    view["warehouse"].pop("dir")
    return view


@pytest.mark.parametrize("seed,cardinality", [(0, "64"), (1, "4"), (2, "0")])
def test_views_and_export_match_the_reference(tmp_path, monkeypatch, seed, cardinality):
    monkeypatch.setenv("GORDO_METRICS_MACHINE_CARDINALITY", cardinality)
    monkeypatch.setenv("GORDO_TELEMETRY", "0")  # no sketch nominations: per-family ranking
    clock = FakeClock()
    sides = _sides(tmp_path, clock)
    _feed(sides, clock, seed)
    ours, ref = sides
    assert ours.warehouse.ticks == ref.warehouse.ticks == 12
    for window in (30.0, 120.0, 300.0, 3600.0):
        _close(_view(ours, window), _view(ref, window))
        _close(ours.warehouse.rate("gordo_t_requests_total", window),
               ref.warehouse.rate("gordo_t_requests_total", window))
        _close(ours.warehouse.histogram_window("gordo_t_latency_seconds", window),
               ref.warehouse.histogram_window("gordo_t_latency_seconds", window))
        for horizon in (None, 30.0, 600.0, 7200.0):
            export = telemetry.build_export(_view(ours, window), window=horizon)
            _close(export, ref_telemetry.build_export(_view(ref, window), window=horizon))
            assert json.loads(json.dumps(export)) == export  # strict JSON
    # the records on disk are the same bytes
    for name in sorted(os.listdir(tmp_path / "port")):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    if cardinality == "4":
        # each tick's record names at most four machines and "other"
        for _, _, record in ours.warehouse._index:
            series = record["c"]["gordo_t_requests_total"]
            assert len({key.split(",")[0] for key in series}) <= 5


def test_each_export_passes_the_other_packages_validation(tmp_path):
    clock = FakeClock()
    sides = _sides(tmp_path, clock, durable=False)
    _feed(sides, clock, seed=3, ticks=4)
    ours, ref = (telemetry.build_export(_view(side, 300.0), window=600.0) for side in sides)
    assert telemetry.validate_layout_input(ref) == []
    assert ref_telemetry.validate_layout_input(ours) == []
    broken = dict(ours, schema="gordo-layout-input/v0", machines=[{"machine": 3}])
    assert telemetry.validate_layout_input(broken) == ref_telemetry.validate_layout_input(broken)
    assert len(telemetry.validate_layout_input(broken)) == 2
    assert telemetry.validate_layout_input([]) == ["document is not an object"]


def test_rotation_and_byte_budget_match_the_reference(tmp_path):
    clock = FakeClock()
    sides = _sides(tmp_path, clock, budget=1 << 14, segment_limit=1 << 12)
    _feed(sides, clock, seed=4, ticks=60)
    ours, ref = sides
    assert ours.warehouse.rotations == ref.warehouse.rotations > 3
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref"))
    on_disk = sum(os.path.getsize(tmp_path / "port" / n) for n in os.listdir(tmp_path / "port"))
    assert on_disk == ours.warehouse.total_bytes() == ref.warehouse.total_bytes()
    # under budget, give or take the active segment (never deleted)
    assert on_disk <= ours.warehouse.budget + ours.warehouse.segment_limit
    _close(_view(ours, 1e6), _view(ref, 1e6))
    for side in sides:
        side.warehouse.close()


def test_restart_over_a_torn_tail_matches_the_reference(tmp_path):
    clock = FakeClock()
    sides = _sides(tmp_path, clock)
    _feed(sides, clock, seed=5, ticks=8)
    before = [_view(side, 1e6) for side in sides]
    for side, name in zip(sides, ("port", "ref")):
        side.warehouse.close()
        last = sorted(os.listdir(tmp_path / name))[-1]
        with open(tmp_path / name / last, "a") as fh:
            fh.write('{"v":1,"t":')  # a crash mid-append
    reloaded = []
    for (reg_mod, tel_mod, tra_mod), name, side in zip(PACKAGES, ("port", "ref"), sides):
        warehouse = tel_mod.TelemetryWarehouse(
            directory=str(tmp_path / name), registry=side.reg,
            accountant=tra_mod.TrafficAccountant(capacity=16, clock=clock),
            clock=clock, wall=clock, min_interval=1.0)
        view = warehouse.view(window=1e6)
        view["warehouse"].pop("dir")
        reloaded.append(view)
        warehouse.close()
    _close(reloaded[0], reloaded[1])
    # the reload holds the first run's records and rates, torn line skipped
    for before_view, after_view in zip(before, reloaded):
        assert after_view["warehouse"]["records"] == before_view["warehouse"]["records"]
        assert after_view["window"]["rates"] == before_view["window"]["rates"]


def test_merge_views_matches_the_reference(tmp_path):
    clock = FakeClock()
    first, second = _sides(tmp_path / "a", clock, durable=False), \
        _sides(tmp_path / "b", clock, durable=False)
    _feed(first + second, clock, seed=6, ticks=5)
    ours = telemetry.merge_views({"0": _view(first[0], 300.0), "1": _view(second[0], 300.0)})
    ref = ref_telemetry.merge_views({"0": _view(first[1], 300.0),
                                     "1": _view(second[1], 300.0)})
    _close(ours, ref)
    assert ours["workers"] == ["0", "1"]


@pytest.mark.parametrize("value", [None, "", "600", 600, 0, -3, "1m", "10m", "1h", "90s",
                                   "2.5h", "junk", "h", True, 12.5])
def test_parse_window_and_horizon_match_the_reference(value):
    assert telemetry.parse_window(value) == ref_telemetry.parse_window(value)
    seconds = telemetry.parse_window(value)
    assert telemetry.resolve_horizon(seconds) == ref_telemetry.resolve_horizon(seconds)


def test_knobs_match_the_reference(monkeypatch):
    for env in ({}, {"GORDO_TELEMETRY_INTERVAL": "2", "GORDO_TELEMETRY_MB": "0.01",
                     "GORDO_TELEMETRY_SEGMENT_KB": "1"},
                {"GORDO_TELEMETRY_INTERVAL": "x", "GORDO_TELEMETRY_MB": "y"}):
        for key in ("GORDO_TELEMETRY_INTERVAL", "GORDO_TELEMETRY_MB",
                    "GORDO_TELEMETRY_SEGMENT_KB"):
            monkeypatch.delenv(key, raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for fn in ("tick_interval", "byte_budget", "segment_bytes"):
            assert getattr(telemetry, fn)() == getattr(ref_telemetry, fn)()


def test_a_broken_cost_sampler_leaves_an_empty_costs_block():
    def broken():
        raise RuntimeError("engine gone")

    clock = FakeClock()
    warehouse = telemetry.TelemetryWarehouse(
        registry=registry.Registry(), accountant=traffic.TrafficAccountant(clock=clock),
        cost_sampler=broken, clock=clock, wall=clock, min_interval=0.0)
    clock.now += 5.0
    warehouse.tick()
    assert warehouse.view()["costs"] == {}


class _Store:
    """A duck-typed compile-cache store: ``entries()`` records only."""

    def __init__(self, records):
        self.records = records

    def entries(self):
        return list(self.records)


class _Engine:
    def cost_ledger(self):
        return {"rungs": {"f32": {"machines": 2, "buckets": 1, "device_bytes": 4096,
                                  "requests": 10.0, "dispatch_seconds_total": 0.5}}}


COMPILE_RECORDS = [
    [],
    [{"name": "cc-a", "bytes": 1_310_720, "precision": "f32", "compile_seconds": 7.25},
     {"name": "cc-b", "bytes": 2_000_000, "precision": "bf16", "compile_seconds": 21.5}],
    [{"name": "cc-a", "bytes": 100, "precision": "f32", "compile_seconds": 3.0},
     {"name": "cc-b", "bytes": 50, "precision": "f32", "compile_seconds": None},
     {"name": "cc-c", "bytes": None, "compile_seconds": 2.0},
     {"name": "cc-d", "bytes": 7, "precision": "", "compile_seconds": 1.0},
     {"name": "cc-e", "bytes": 9, "precision": "bf16"}],
]


@pytest.mark.parametrize("records", COMPILE_RECORDS, ids=range(len(COMPILE_RECORDS)))
def test_the_compile_block_matches_the_reference(records):
    """The port's ``sample_costs`` sums a store's entries as the reference's
    does, and the layout export reads the per-rung compile seconds."""
    ours = telemetry.sample_costs(_Engine(), _Store(records))
    theirs = ref_telemetry.sample_costs(_Engine(), _Store(records))
    _close(ours, theirs)
    assert set(ours) == {"engine", "compile"}
    assert telemetry.sample_costs(None, None) == ref_telemetry.sample_costs(None, None) == {}
    view = {"worker": "0", "traffic": {}, "costs": ours}
    rungs = telemetry.build_export(view)["rungs"]
    assert rungs["f32"]["compile_seconds"] == ours["compile"]["by_precision"].get("f32", 0.0)
    _close(rungs, ref_telemetry.build_export(view)["rungs"])
