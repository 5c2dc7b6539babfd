"""The port's ``gordo build`` path on the CPU: the cache key, the idempotent
``provide_saved_model``, a build from a data config held against the JAX
package's, and the ``build`` / ``rollback`` commands with their exit
codes, down to a PatchTST served from its generation root.

Tolerances: cache keys, dataset metadata and exit codes exactly; a
port-built dense artifact loaded by the reference predicts what the port
predicts within 1e-5 of the predictions' magnitude (float32 both sides,
products summed in other orders); a served response equals the loaded
model's own ``predict`` within 1e-5 relative (the same CPU arithmetic
through the engine's batched program).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.builder import build_model as ref_build_model  # noqa: E402
from gordo_components_tpu.builder import calculate_model_key as ref_calculate_model_key  # noqa: E402,E501
from gordo_components_tpu.serializer import load as ref_load  # noqa: E402

from gordo_components_tpu_torch import __version__  # noqa: E402
from gordo_components_tpu_torch.builder import (  # noqa: E402
    build_model,
    calculate_model_key,
    provide_saved_model,
)
from gordo_components_tpu_torch.cli import cli  # noqa: E402
from gordo_components_tpu_torch.observability.registry import REGISTRY  # noqa: E402
from gordo_components_tpu_torch.precision import QUANT_INT8_FILE  # noqa: E402
from gordo_components_tpu_torch.serializer import load, load_metadata  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer  # noqa: E402
from gordo_components_tpu_torch.store.generations import (  # noqa: E402
    current_generation,
    list_generations,
)

DATA = {
    "type": "gordo_components_tpu.dataset.dataset.TimeSeriesDataset",
    "train_start_date": "2023-01-01T00:00:00+00:00",
    "train_end_date": "2023-01-03T00:00:00+00:00",
    "tag_list": ["TAG-1", "TAG-2", "TAG-3"],
    "data_provider": {"type": "RandomDataProvider", "min_size": 300, "max_size": 400},
}


def _detector(estimator, **kwargs):
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {estimator: kwargs}]}},
        "transformer": "MinMaxScaler"}}}}


DENSE = _detector("DenseAutoEncoder", kind="feedforward_hourglass", epochs=2)
PATCHTST = _detector("PatchTSTAutoEncoder", lookback_window=32, patch_length=8, stride=4,
                     d_model=32, n_heads=2, n_layers=2, attention_impl="flash", epochs=1,
                     batch_size=16)


def _builds():
    return dict(REGISTRY.counter("gordo_builds_total", labels=("outcome",)).collect())


@pytest.mark.parametrize("case", [
    dict(),
    dict(evaluation_config={"cv_mode": "build_only", "n_splits": 2}),
    dict(precision="int8"),
    dict(precision="bf16", evaluation_config={"cv_mode": "full_build"}),
    dict(gordo_version="9.9.9"),
])
def test_calculate_model_key_equals_the_reference(case):
    case = {"gordo_version": __version__, **case}
    ours = calculate_model_key("m-1", DENSE, DATA, **case)
    assert ours == ref_calculate_model_key("m-1", DENSE, DATA, **case)
    assert len(ours) == 32
    assert ours != calculate_model_key("m-2", DENSE, DATA, **case)
    if case.get("precision", "f32") == "f32":
        assert ours == calculate_model_key("m-1", DENSE, DATA, **{**case, "precision": "f32"})


def test_provide_saved_model_hit_torn_rebuild_precision_and_replace(tmp_path, monkeypatch):
    out, reg = str(tmp_path / "m"), str(tmp_path / "reg")
    evaluation = {"cv_mode": "build_only"}

    def provide(**kwargs):
        return provide_saved_model("m", DENSE, DATA, out, model_register_dir=reg,
                                   evaluation_config=evaluation, device="cpu", **kwargs)

    before = _builds()

    def delta():
        now = _builds()
        return {k: now.get(k, 0) - before.get(k, 0) for k in (("built",), ("cached",))}

    assert provide() == out
    assert list_generations(out) == ["gen-0001"] and current_generation(out) == "gen-0001"
    meta = load_metadata(out)
    key = calculate_model_key("m", DENSE, DATA, evaluation_config=evaluation)
    assert meta["model"]["cache_key"] == key and meta["precision"] == "f32"
    assert os.listdir(reg) == [f"{key}.md5"]
    assert provide() == out  # the hit
    assert list_generations(out) == ["gen-0001"]
    assert delta() == {("built",): 1, ("cached",): 1}

    os.remove(os.path.join(out, "gen-0001", "state.npz"))  # torn: a structural miss
    provide()
    assert current_generation(out) == "gen-0002"
    assert delta() == {("built",): 2, ("cached",): 1}

    provide(precision="int8")  # another rung: another key, a new generation
    assert current_generation(out) == "gen-0003"
    assert os.path.isfile(os.path.join(out, "gen-0003", QUANT_INT8_FILE))
    assert load_metadata(out)["precision"] == "int8"
    assert len(os.listdir(reg)) == 2
    # the f32 key's entry now points at a root serving int8: a rebuild
    provide()
    assert current_generation(out) == "gen-0004" and load_metadata(out)["precision"] == "f32"
    provide(replace_cache=True)
    assert current_generation(out) == "gen-0005"
    assert delta() == {("built",): 5, ("cached",): 1}
    assert len(list_generations(out)) == 3  # GORDO_STORE_KEEP_GENERATIONS default

    monkeypatch.setenv("GORDO_PRECISION_DEFAULT", "int8")
    provide()  # the int8 key is registered and CURRENT serves f32: a rebuild at int8
    assert load_metadata(out)["precision"] == "int8"
    assert provide() == out
    assert delta() == {("built",): 6, ("cached",): 2}
    monkeypatch.setenv("GORDO_PRECISION_DEFAULT", "fp8")
    with pytest.raises(ValueError, match="unknown precision"):
        provide()
    with pytest.raises(ValueError, match="cross_val_only"):
        provide_saved_model("m", DENSE, DATA, out, evaluation_config={"cv_mode": "cross_val_only"},
                            precision="f32", device="cpu")


def test_dense_build_from_a_data_config_equals_the_reference(tmp_path):
    """The port's build_model and the reference's on the same data config:
    the same dataset metadata (the rows, per-tag counts, shapes), the
    reference's metadata keys, and an artifact the reference loads and
    predicts with."""
    evaluation = {"cv_mode": "full_build", "n_splits": 3}
    model, meta = build_model("m", DENSE, DATA, metadata={"owner": "x"},
                              evaluation_config=evaluation, device="cpu")
    ref_model, ref_meta = ref_build_model("m", DENSE, DATA, metadata={"owner": "x"},
                                          evaluation_config=evaluation)
    assert json.loads(json.dumps(meta["dataset"]).replace("gordo_components_tpu_torch.",
                                                          "gordo_components_tpu.")) == \
        json.loads(json.dumps(ref_meta["dataset"]))
    assert meta["dataset"]["x_shape"] == [288, 3]
    assert set(meta) - {"gordo_components_tpu_torch_version"} == \
        set(ref_meta) - {"gordo_components_tpu_version"}
    assert set(meta["model"]) == set(ref_meta["model"])
    assert set(meta["build_phases"]) == set(ref_meta["build_phases"]) == {
        "data_fetch", "cross_validation", "fit"}
    assert meta["user_defined"] == {"owner": "x"}
    assert len(meta["model"]["cross_validation"]["splits"]) == 3

    out = provide_saved_model("m", DENSE, DATA, str(tmp_path / "m"), device="cpu")
    rows = np.random.default_rng(3).normal(size=(50, 3)).astype(np.float32)
    ours = load(out, device="cpu").predict(rows)
    np.testing.assert_allclose(ref_load(out).predict(rows), ours,
                               atol=1e-5 * np.abs(ours).max())
    seconds = REGISTRY.counter("gordo_build_phase_seconds_total", labels=("phase",)).collect()
    assert {("data_fetch",), ("cross_validation",), ("fit",)} <= set(seconds)


def _cli(*args):
    return cli.main([*args])


def test_cli_builds_a_patchtst_and_the_server_serves_its_generation_root(tmp_path, capsys):
    models = tmp_path / "models"
    model_file = tmp_path / "model.json"
    model_file.write_text(json.dumps(PATCHTST))
    args = ["build", "slice", "--model-config", str(model_file), "--data-config",
            json.dumps(DATA), "--output-dir", str(models / "slice"), "--model-register-dir",
            str(tmp_path / "reg"), "--n-splits", "2", "--print-cv-scores", "--device", "cpu"]
    assert _cli(*args) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == str(models / "slice")
    assert set(json.loads(printed[1])) == {"explained_variance_score", "r2_score",
                                           "mean_squared_error", "mean_absolute_error"}
    assert _cli(*args) == 0  # a cache hit: no new generation
    assert list_generations(str(models / "slice")) == ["gen-0001"]
    assert capsys.readouterr().out.splitlines()[0] == str(models / "slice")

    server = ModelServer(str(models), device="cpu")
    try:
        X = (np.random.default_rng(5).normal(size=(47, 3)) * 2 + 1).astype(np.float32)
        response = server.handle("POST", "/gordo/v0/project/slice/anomaly/prediction",
                                 {"Content-Type": "application/json"},
                                 json.dumps({"X": X.tolist()}).encode())
        assert response.status == 200, response.body
        data = json.loads(response.body)["data"]
        ours = np.asarray(data["model-output"], np.float64)
        expected = load(str(models / "slice"), device="cpu").predict(X)
        assert ours.shape == expected.shape == (16, 3)
        np.testing.assert_allclose(ours, expected, rtol=1e-5, atol=1e-5 * np.abs(expected).max())
        health = json.loads(server.handle("GET", "/gordo/v0/project/slice/healthz", {},
                                          b"").body)
        assert health["generation"] == "gen-0001"
    finally:
        server.close()


def test_cli_int8_rebuild_rollback_and_list(tmp_path, capsys):
    out = str(tmp_path / "m")
    base = ["build", "m", "--model-config", json.dumps(DENSE), "--data-config",
            json.dumps(DATA), "--output-dir", out, "--model-register-dir",
            str(tmp_path / "reg"), "--cv-mode", "build_only", "--device", "cpu"]
    assert _cli("rollback", out) == cli.EXIT_CONFIG  # nothing to roll back to
    assert _cli(*base) == 0
    assert _cli(*base, "--precision", "int8", "--trace-dir", str(tmp_path / "trace")) == 0
    assert os.path.isfile(tmp_path / "trace" / "trace.json")
    assert list_generations(out) == ["gen-0001", "gen-0002"]
    assert os.path.isfile(os.path.join(out, "gen-0002", QUANT_INT8_FILE))
    capsys.readouterr()
    assert _cli("rollback", out) == 0
    assert capsys.readouterr().out.strip() == os.path.join(out, "gen-0001")
    assert current_generation(out) == "gen-0001"
    assert _cli("rollback", "--list", out) == 0
    status = json.loads(capsys.readouterr().out)
    assert status == {"generation": "gen-0001", "generations": ["gen-0001", "gen-0002"],
                      "verified": True, "error": None}
    assert _cli("rollback", out) == cli.EXIT_CONFIG  # gen-0001 has no predecessor


def test_cli_reads_the_environment_and_yaml(tmp_path, monkeypatch, capsys):
    yaml = pytest.importorskip("yaml")
    model_file = tmp_path / "model.yaml"
    model_file.write_text(yaml.safe_dump(DENSE))
    monkeypatch.setenv("MODEL_CONFIG", str(model_file))
    monkeypatch.setenv("DATA_CONFIG", yaml.safe_dump(DATA))
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "env-out"))
    monkeypatch.setenv("MODEL_REGISTER_DIR", str(tmp_path / "env-reg"))
    monkeypatch.setenv("METADATA", "owner: plant-ops\n")
    assert _cli("build", "m", "--cv-mode", "build_only", "--device", "cpu") == 0
    assert capsys.readouterr().out.strip() == str(tmp_path / "env-out")
    assert load_metadata(str(tmp_path / "env-out"))["user_defined"] == {"owner": "plant-ops"}
    assert os.listdir(tmp_path / "env-reg")


@pytest.mark.parametrize("change,code", [
    (dict(data={**DATA, "row_threshold": 100_000}), 66),
    (dict(data={**DATA, "train_end_date": "2023-01-01T00:00:00+00:00"}), 64),
    (dict(data={**DATA, "data_provider": {"type": "NoSuchProvider"}}), 64),
    (dict(model={"NoSuchEstimator": {}}), 64),
    (dict(model="[1, 2]"), 64),
    (dict(model=""), 64),
    (dict(args=["--cv-mode", "cross_val_only"]), 64),
])
def test_cli_exit_codes(tmp_path, change, code, monkeypatch):
    for name in ("MODEL_CONFIG", "DATA_CONFIG"):
        monkeypatch.delenv(name, raising=False)
    model = change.get("model", DENSE)
    args = ["build", "m", "--model-config", model if isinstance(model, str) else json.dumps(model),
            "--data-config", json.dumps(change.get("data", DATA)),
            "--output-dir", str(tmp_path / "m"), "--device", "cpu", *change.get("args", [])]
    assert _cli(*args) == code
    assert not os.path.exists(tmp_path / "m" / "CURRENT")


def test_cli_refuses_an_unknown_precision_and_a_missing_output_dir(monkeypatch):
    monkeypatch.delenv("OUTPUT_DIR", raising=False)
    with pytest.raises(SystemExit) as exc:
        _cli("build", "m", "--precision", "fp8", "--output-dir", "x")
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        _cli("build", "m")
    assert exc.value.code == 2
