"""BENCHMARK.json's names, units and files, and a new configuration,
traffic mix and metric found by name as new files alone."""

import json
import shutil

from conftest import BENCH, ROOT
from harness import manifest, traffic


def test_names_units_and_files():
    man = manifest.load(ROOT)
    assert manifest.problems(man) == []
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["paths"] == ["portbench"] and man["command"][1] == "portbench/run.py"
    for entry in man["end_to_end"] + man["per_layer"]:
        assert manifest.UNIT.match(entry["unit"]) and len(entry["unit"]) <= 16
        assert entry["better"] in ("lower", "higher")
    for entry in man["configs"]:
        assert entry["file"].startswith("portbench/configs/")
        config = manifest.config(man, ROOT, entry["name"])
        assert set(entry["reduced"]) <= set(config["changed"])
    for cell in man["workloads"]:
        assert cell["name"] == f"{cell['config']}.{cell['traffic']}" and cell["chips"] == 1
        assert len(cell["why"]) <= 200
    assert not manifest.NAME.match("has space") and not manifest.NAME.match("a/b")
    assert not manifest.UNIT.match("tokens per second") and not manifest.UNIT.match("x" * 17)


def test_a_dummy_config_traffic_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "configs" / "dummy-cfg.json").write_text(json.dumps({"model": {"d": 1}}))
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"loop": "closed", "fleet": 2, "bodies_per_machine": 1, "warmup_rounds": [1]}))
    (bench / "metrics" / "dummy_metric.dummy.py").write_text("def read(run):\n    return 42.0\n")
    man = manifest.load(ROOT)
    man["configs"].append({"name": "dummy-cfg", "file": str(bench / "configs" / "dummy-cfg.json"),
                           "reduced": []})
    man["workloads"].append({"name": "dummy-cfg.dummy-mix", "config": "dummy-cfg",
                             "traffic": "dummy-mix", "chips": 1})
    man["per_layer"].append({"name": "dummy_metric.dummy", "unit": "%", "moves": "setup_s",
                             "workloads": ["dummy-cfg.dummy-mix"]})
    assert manifest.config(man, ROOT, "dummy-cfg") == {"model": {"d": 1}}
    mix = manifest.traffic("dummy-mix", str(bench))
    assert traffic.plan(mix, 1, 5.0)["bodies"] == [0, 1]
    assert manifest.reader("dummy_metric.dummy", str(bench))(None) == 42.0
    names = [m["name"] for m in manifest.metrics_of(man, "dummy-cfg.dummy-mix", True)]
    assert names == ["dummy_metric.dummy"]
    # nothing that was there changed
    assert all(p.read_bytes() == data for p, data in before.items())
