"""The PyTorch port serves the reference's dense and LSTM anomaly artifacts.

``DiffBasedAnomalyDetector`` pipelines around ``DenseAutoEncoder``,
``LSTMAutoEncoder`` and ``LSTMForecast`` (horizon 3) are fitted one epoch
by the JAX package at small width and dumped by its serializer; the port
loads them on the CPU and its ``ServingEngine.anomaly`` must give the four
``ScoreResult`` arrays of the reference engine on the same X. Tolerance:
atol 1e-4 in raw tag units (values around 5 ± 3), the bound of the
reference's own engine-vs-host parity tests — both sides compute in
float32 on the CPU (at the bf16 rung too: the architectures are float32,
so bf16-rounded weights and inputs are promoted back) and differ only in
summation order.
"""

import json
import shutil
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.models import models as ref_models  # noqa: E402
from gordo_components_tpu.serializer import (  # noqa: E402
    dump as ref_dump,
    load as ref_load,
    pipeline_from_definition as ref_from_definition,
)
from gordo_components_tpu.server.engine import ServingEngine as RefEngine  # noqa: E402
from gordo_components_tpu.server.engine import _lift_machine as ref_lift_machine  # noqa: E402

from gordo_components_tpu_torch import wire  # noqa: E402
from gordo_components_tpu_torch.serializer import (  # noqa: E402
    dump,
    load,
    pipeline_from_definition,
)
from gordo_components_tpu_torch.server.engine import ServingEngine  # noqa: E402
from gordo_components_tpu_torch.server.server import make_server  # noqa: E402
from gordo_components_tpu_torch.store.manifest import write_manifest  # noqa: E402

TAGS = [f"tag-{i}" for i in range(5)]
SUBSET = [0, 2, 4]
LOOKBACK = 8
MACHINES = {  # name -> (estimator, kwargs, target columns or None)
    "dense": ("DenseAutoEncoder", dict(kind="feedforward_hourglass"), None),
    "dense-sub": ("DenseAutoEncoder", dict(kind="feedforward_symmetric", dims=[6, 3]), SUBSET),
    "lstm-ae": ("LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[6],
                                        lookback_window=LOOKBACK), None),
    "lstm-forecast": ("LSTMForecast", dict(kind="lstm_symmetric", dims=[6],
                                           lookback_window=LOOKBACK, horizon=3), None),
}
N_ROWS = {"dense": 60, "dense-sub": 60, "lstm-ae": 60 - LOOKBACK + 1,
          "lstm-forecast": 60 - LOOKBACK + 1 - 3}


def _config(estimator, kwargs):
    return {
        "DiffBasedAnomalyDetector": {
            "base_estimator": {
                "TransformedTargetRegressor": {
                    "regressor": {"Pipeline": {"steps": [
                        "MinMaxScaler",
                        {estimator: {**kwargs, "epochs": 1, "batch_size": 16}},
                    ]}},
                    "transformer": "MinMaxScaler",
                }
            }
        }
    }


def _fit(estimator, kwargs, X, cols):
    """One epoch, then the error scaler and thresholds on the training
    residuals (as tests/test_torch_serving.py does)."""
    model = ref_from_definition(_config(estimator, kwargs))
    y = X if cols is None else X[:, cols]
    model.fit(X, y)
    pred = model.predict(X)
    residual = np.abs(y[len(y) - len(pred):] - pred)
    model.scaler.fit(residual)
    scaled = model.scaler.transform(residual)
    model.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
    model.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    return model


def _multi_step_artifact(dest, X):
    """A joint ``MultiStepForecast`` detector built by the port (the
    reference's detector refuses to fit one): scalers fitted on X, flax
    init weights of the widened head."""
    definition = _config("MultiStepForecast", dict(kind="lstm_symmetric", dims=[4],
                                                   lookback_window=LOOKBACK, horizon=2))
    model = pipeline_from_definition(definition)
    ttr = model.base_estimator
    scaler, est = (step for _, step in ttr.regressor.steps)
    scaler.fit(X)
    ttr.transformer.fit(X)
    ref_est = ref_models.MultiStepForecast(kind="lstm_symmetric", dims=[4],
                                           lookback_window=LOOKBACK, horizon=2)
    params = ref_est._make_spec(len(TAGS), len(TAGS)).module.init(
        jax.random.PRNGKey(0), X[None, :LOOKBACK])["params"]
    est.to("cpu").set_state({"params": jax.tree_util.tree_map(np.asarray, dict(params)),
                             "n_features": len(TAGS), "n_features_out": len(TAGS)})
    dump(model, dest, metadata={"dataset": {"tag_list": TAGS}})
    return model


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(60, len(TAGS))) * 3 + 5).astype(np.float32)
    root = tmp_path_factory.mktemp("models")
    models = {}
    for name, (estimator, kwargs, cols) in MACHINES.items():
        models[name] = _fit(estimator, kwargs, X, cols)
        dataset = {"tag_list": TAGS}
        if cols is not None:
            dataset["target_tag_list"] = [TAGS[c] for c in cols]
        ref_dump(models[name], str(root / name), metadata={"dataset": dataset})
    return root, models, X


def _assert_scores_match(ours, ref):
    for name, a, b in zip(wire.SCORE_FIELDS, ours, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(MACHINES))
def test_score_result_matches_reference_engine(zoo, name, precision):
    root, models, X = zoo
    cols = MACHINES[name][2]
    target_cols = {name: cols}
    precisions = {name: precision}
    ours = ServingEngine({name: load(str(root / name), device="cpu")},
                         target_cols=target_cols, precisions=precisions, device="cpu")
    ref = RefEngine({name: models[name]}, target_cols=target_cols, precisions=precisions)
    scored = ours.anomaly(name, X)
    assert scored.model_output.shape == (N_ROWS[name], len(cols or TAGS))
    _assert_scores_match(scored, ref.anomaly(name, X))


def test_dense_scores_one_row_per_input_row(zoo):
    root, _, X = zoo
    engine = ServingEngine({"m": load(str(root / "dense"), device="cpu")}, device="cpu")
    for rows in (1, 7):
        scored = engine.anomaly("m", X[:rows])
        np.testing.assert_array_equal(scored.model_input, X[:rows])
        assert scored.total_anomaly_score.shape == (rows,)


def test_keras_class_path_loads(zoo, tmp_path):
    """A definition that names ``gordo_components.model.models.KerasAutoEncoder``
    (the class path of the original gordo's configs) loads as the dense AE."""
    root, models, X = zoo
    artifact = tmp_path / "keras"
    shutil.copytree(root / "dense", artifact)
    definition = (artifact / "definition.json").read_text()
    ref_path = "gordo_components_tpu.models.models.DenseAutoEncoder"
    assert ref_path in definition
    (artifact / "definition.json").write_text(
        definition.replace(ref_path, "gordo_components.model.models.KerasAutoEncoder"))
    write_manifest(str(artifact))
    scored = ServingEngine({"m": load(str(artifact), device="cpu")}, device="cpu").anomaly("m", X)
    _assert_scores_match(scored, RefEngine({"m": models["dense"]}).anomaly("m", X))
    for short in ("KerasAutoEncoder", "DenseAutoEncoder"):
        est = pipeline_from_definition({"Pipeline": {"steps": [{short: {}}]}}).steps[0][1]
        assert type(est).__name__ == "DenseAutoEncoder" and est.kind == "feedforward_hourglass"


@pytest.mark.parametrize("name", ["dense", "lstm-ae", "lstm-forecast"])
def test_port_dump_loads_in_reference(zoo, name, tmp_path):
    root, _, X = zoo
    ported = load(str(root / name), device="cpu")
    dump(ported, str(tmp_path / name), metadata={"dataset": {"tag_list": TAGS}})
    again = json.loads((tmp_path / name / "definition.json").read_text())
    assert again == json.loads((root / name / "definition.json").read_text())
    scored = ServingEngine({"m": load(str(tmp_path / name), device="cpu")},
                           device="cpu").anomaly("m", X)
    _assert_scores_match(scored, RefEngine({"m": ref_load(str(tmp_path / name))}).anomaly("m", X))


def test_multi_step_forecast_is_skipped_with_the_reference_reason(zoo, tmp_path):
    _, _, X = zoo
    model = _multi_step_artifact(str(tmp_path / "joint"), X)
    est = model.base_estimator.regressor.steps[-1][1]
    assert est.predict_steps(X).shape == (60 - LOOKBACK + 1 - 2, 2, len(TAGS))
    reloaded = ref_load(str(tmp_path / "joint"))  # the port's dump, in the reference
    ref_est = reloaded.base_estimator.regressor.steps[-1][1]
    X_scaled = model.base_estimator.regressor.steps[0][1].transform(X)
    np.testing.assert_allclose(est.predict(X_scaled), ref_est.predict(X_scaled), atol=1e-5)
    engine = ServingEngine({"joint": load(str(tmp_path / "joint"), device="cpu")}, device="cpu")
    assert not engine.can_score("joint")
    with pytest.raises(ValueError) as ref_err:
        ref_lift_machine("joint", reloaded, None, "f32", None)
    assert engine.skipped["joint"] == str(ref_err.value)


def test_http_serves_the_zoo_and_503s_the_joint_forecaster(zoo, tmp_path):
    root, models, X = zoo
    served = tmp_path / "served"
    shutil.copytree(root, served)
    _multi_step_artifact(str(served / "joint"), X)
    httpd = make_server(str(served), port=0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(machine):
        req = urllib.request.Request(
            f"{base}/gordo/v0/project/{machine}/anomaly/prediction",
            data=json.dumps({"X": X.tolist()}).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert sorted(health["skipped"]) == ["joint"]
        status, payload = post("lstm-forecast")
        assert status == 200
        ref = RefEngine({"m": models["lstm-forecast"]}).anomaly("m", X)
        np.testing.assert_allclose(np.asarray(payload["data"]["model-output"]),
                                   ref.model_output, atol=1e-4)
        status, payload = post("joint")
        assert status == 503 and "one row per timestamp" in json.dumps(payload)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
