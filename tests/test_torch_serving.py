"""The PyTorch port serves a reference-built PatchTST anomaly artifact.

A JAX ``DiffBasedAnomalyDetector`` PatchTST pipeline is fitted at small
width, dumped by the reference serializer, loaded by the port on the CPU
and scored; the four ``ScoreResult`` arrays must match the reference
``ServingEngine.anomaly`` on the same X. Tolerance: atol 1e-4 in raw tag
units (values around 5 ± 3), the bound the reference's own engine-vs-host
parity tests use — both sides compute in float32 on the CPU and differ
only in summation order.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu import wire as ref_wire  # noqa: E402
from gordo_components_tpu.serializer import (  # noqa: E402
    dump as ref_dump,
    pipeline_from_definition as ref_from_definition,
)
from gordo_components_tpu.server.engine import ServingEngine as RefEngine  # noqa: E402

from gordo_components_tpu_torch import wire  # noqa: E402
from gordo_components_tpu_torch.serializer import dump, load  # noqa: E402
from gordo_components_tpu_torch.server.engine import ServingEngine  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer, make_server  # noqa: E402

LOOKBACK = 24
TAGS = [f"tag-{i}" for i in range(4)]
SUBSET = [1, 3]


def _config():
    return {
        "DiffBasedAnomalyDetector": {
            "base_estimator": {
                "TransformedTargetRegressor": {
                    "regressor": {
                        "Pipeline": {
                            "steps": [
                                "MinMaxScaler",
                                {
                                    "PatchTSTAutoEncoder": {
                                        "lookback_window": LOOKBACK,
                                        "patch_length": 8,
                                        "stride": 4,
                                        "d_model": 16,
                                        "n_heads": 2,
                                        "n_layers": 1,
                                        "attention_impl": "flash",
                                        "epochs": 1,
                                        "batch_size": 16,
                                    }
                                },
                            ]
                        }
                    },
                    "transformer": "MinMaxScaler",
                }
            }
        }
    }


def _fit(X, cols=None):
    """One epoch of training, then the error scaler and thresholds fitted
    on the training residuals (the reference's cross_validate fits them on
    out-of-fold residuals the same way, at three times the training)."""
    model = ref_from_definition(_config())
    y = X if cols is None else X[:, cols]
    model.fit(X, y)
    pred = model.predict(X)
    residual = np.abs(y[len(y) - len(pred):] - pred)
    model.scaler.fit(residual)
    scaled = model.scaler.transform(residual)
    model.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
    model.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    return model


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(72, len(TAGS))) * 3 + 5).astype(np.float32)
    root = tmp_path_factory.mktemp("models")
    full = _fit(X)
    sub = _fit(X, SUBSET)
    ref_dump(full, str(root / "full"), metadata={"dataset": {"tag_list": TAGS}})
    ref_dump(
        sub, str(root / "sub"),
        metadata={"dataset": {"tag_list": TAGS,
                              "target_tag_list": [TAGS[c] for c in SUBSET]}},
    )
    return root, {"full": full, "sub": sub}, X


def _assert_scores_match(ours, ref):
    for name, a, b in zip(wire.SCORE_FIELDS, ours, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_score_result_matches_reference_engine(artifacts, precision):
    root, models, X = artifacts
    ported = {name: load(str(root / name), device="cpu") for name in models}
    target_cols = {"sub": SUBSET}
    precisions = {name: precision for name in models}
    ours = ServingEngine(ported, target_cols=target_cols, precisions=precisions,
                         device="cpu")
    ref = RefEngine(models, target_cols=target_cols, precisions=precisions)
    for name in models:
        scored = ours.anomaly(name, X)
        assert len(scored.total_anomaly_score) == len(X) - LOOKBACK + 1
        _assert_scores_match(scored, ref.anomaly(name, X))
    assert ours.anomaly("sub", X).model_output.shape == (len(X) - LOOKBACK + 1, 2)


def test_engine_rejects_bad_requests_and_int8(artifacts):
    root, models, X = artifacts
    model = load(str(root / "full"), device="cpu")
    engine = ServingEngine({"m": model}, device="cpu")
    with pytest.raises(ValueError, match="lookback_window"):
        engine.anomaly("m", X[: LOOKBACK - 1])
    with pytest.raises(ValueError, match="features"):
        engine.anomaly("m", X[:, :3])
    with pytest.raises(KeyError):
        engine.anomaly("nope", X)
    # the int8 rung serves: the reference engine's int8 scores
    int8 = ServingEngine({"m": model}, precisions={"m": "int8"}, device="cpu")
    ref_int8 = RefEngine({"m": models["full"]}, precisions={"m": "int8"})
    _assert_scores_match(int8.anomaly("m", X), ref_int8.anomaly("m", X))
    blind = ServingEngine({"sub": load(str(root / "sub"), device="cpu")}, device="cpu")
    assert not blind.can_score("sub") and "subset" in blind.skipped["sub"]


def test_port_dump_round_trips_and_reference_loads_it(artifacts, tmp_path):
    """The port writes the reference's format: the reference package loads
    the port's dump and scores it identically."""
    from gordo_components_tpu.serializer import load as ref_load

    root, models, X = artifacts
    ported = load(str(root / "full"), device="cpu")
    dump(ported, str(tmp_path / "again"), metadata={"dataset": {"tag_list": TAGS}})
    again = load(str(tmp_path / "again"), device="cpu")
    scored = ServingEngine({"m": again}, device="cpu").anomaly("m", X)
    _assert_scores_match(scored, RefEngine({"m": ref_load(str(tmp_path / "again"))}).anomaly("m", X))
    (tmp_path / "again" / "state.npz").write_bytes(b"torn")
    with pytest.raises(Exception, match="state.npz"):
        load(str(tmp_path / "again"), device="cpu")


def test_json_body_matches_reference_encoder(artifacts):
    root, models, X = artifacts
    app = ModelServer(str(root), device="cpu")
    body = json.dumps({"X": X.tolist()}).encode()
    for name in models:
        response = app.handle("POST", f"/gordo/v0/project/{name}/anomaly/prediction", {}, body)
        text = response.body.decode()
        scored = app.engine.anomaly(name, X)
        model = models[name]
        extras = {
            "tag-thresholds": [float(v) for v in model.tag_thresholds_],
            "total-threshold": model.total_threshold_,
        }
        expected = ref_wire.encode_scored_json(
            dict(zip(ref_wire.SCORE_FIELDS, scored)), None, extras
        )
        assert text == expected


def test_http_round_trip_and_400s(artifacts):
    root, _, X = artifacts
    httpd = make_server(str(root), port=0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            assert json.loads(resp.read())["machines"] == ["full", "sub"]
        path = "/gordo/v0/project/full/anomaly/prediction"
        records = [dict(zip(TAGS, row)) for row in X.tolist()]
        status, payload = post(path, {"X": records})
        assert status == 200
        assert np.asarray(payload["data"]["model-output"]).shape == (len(X) - LOOKBACK + 1, 4)
        assert len(payload["tag-thresholds"]) == 4
        assert post(path, {"X": X[:5].tolist()})[0] == 400  # too short for the window
        status, payload = post(path, {"X": X[:, :3].tolist()})
        assert status == 400 and payload["expected_features"] == 4
        bad = X.copy()
        bad[3, 2] = np.nan
        status, payload = post(path, {"X": json.loads(json.dumps(bad.tolist()))})
        assert status == 400 and payload["non_finite_columns"] == [2]
        assert post("/anomaly/prediction", {"X": X.tolist()})[0] == 404  # two machines
        assert post("/gordo/v0/project/nope/anomaly/prediction", {"X": []})[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
