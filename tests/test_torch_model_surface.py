"""The port's model-object surface against the JAX package's, on the CPU:
``FeatureUnion`` from the reference's definitions (fitted on the same
data, the same transforms), ``Pipeline.transform`` / ``score`` /
``__getitem__``, ``TransformedTargetRegressor.score``, the detector's
``score`` and ``anomaly``, ``dumps`` / ``loads`` both ways between the
packages with the tar bounds, ``into_definition_yaml``, ``list_kinds``,
and ``GET /download-model``.

Tolerances: the scalers' transforms to 1e-6 of their magnitude (float32,
each package's own min/max arithmetic); a model fitted by the JAX package
and loaded by the port predicts and scores within ``FUSED_RTOL`` (1e-5)
of the predictions' magnitude (float32 products summed in other orders);
scores (explained variance) within 1e-5; definitions, YAML text, kinds,
tar members, column names and thresholds exactly.
"""

import io
import json
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.models.register import list_kinds as ref_list_kinds  # noqa: E402
from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402
from gordo_components_tpu.serializer import dumps as ref_dumps  # noqa: E402
from gordo_components_tpu.serializer import loads as ref_loads  # noqa: E402
from gordo_components_tpu.serializer import pipeline_from_definition as ref_from_def  # noqa: E402
from gordo_components_tpu.serializer.into_definition import (  # noqa: E402
    into_definition_yaml as ref_into_yaml,
)

from gordo_components_tpu_torch.models import list_kinds  # noqa: E402
from gordo_components_tpu_torch.models.anomaly import AnomalyFrame  # noqa: E402
from gordo_components_tpu_torch.models.pipeline import (  # noqa: E402
    FeatureUnion,
    Pipeline,
    clone_pipeline,
)
from gordo_components_tpu_torch.models.transformers import MinMaxScaler  # noqa: E402
from gordo_components_tpu_torch.serializer import (  # noqa: E402
    dumps,
    into_definition_yaml,
    load,
    loads,
    pipeline_from_definition,
    pipeline_into_definition,
)
from gordo_components_tpu_torch.serializer import persistence  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer  # noqa: E402

FUSED_RTOL = 1e-5
SCALER_RTOL = 1e-6
TAGS = ["s-a", "s-b", "s-c", "s-d"]


def _rows(seed, n=96, tags=len(TAGS)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, tags)) * [1, 3, 5, 7][:tags] + 10).astype(np.float32)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, float(np.abs(want).max())))


def _detector(estimator, **kwargs):
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {estimator: kwargs}]}},
        "transformer": "MinMaxScaler"}}}}


DETECTORS = {
    "dense": _detector("DenseAutoEncoder", kind="feedforward_hourglass", epochs=2,
                       batch_size=16),
    "patchtst": _detector("PatchTSTAutoEncoder", lookback_window=32, patch_length=8, stride=4,
                          d_model=32, n_heads=2, n_layers=1, ff_dim=32, attention_impl="flash",
                          epochs=1, batch_size=64),
}


@pytest.fixture(scope="module", params=sorted(DETECTORS))
def fitted(request):
    """(reference detector, the port's load of its artifact, scoring rows)."""
    tmp = request.getfixturevalue("tmp_path_factory").mktemp(request.param)
    ref = ref_from_def(DETECTORS[request.param])
    ref.cross_validate(_rows(0), n_splits=2)
    ref.fit(_rows(0))
    ref_dump(ref, str(tmp / "m"), metadata={"dataset": {"tag_list": TAGS}})
    return ref, load(str(tmp / "m"), device="cpu"), _rows(1, n=48), str(tmp / "m")


# -- FeatureUnion --------------------------------------------------------------

UNIONS = [
    {"sklearn.pipeline.FeatureUnion": {"transformer_list": [
        "sklearn.preprocessing.MinMaxScaler",
        {"sklearn.preprocessing.StandardScaler": {"with_mean": True}}]}},
    {"FeatureUnion": {"transformer_list": ["MinMaxScaler", "StandardScaler"],
                      "transformer_weights": None}},
    {"FeatureUnion": {"transformer_list": [["a", "MinMaxScaler"], ["b", "MinMaxScaler"]],
                      "transformer_weights": {"b": 2.0}}},
]


@pytest.mark.parametrize("definition", UNIONS, ids=["sklearn-path", "short", "weights"])
def test_feature_union_from_the_reference_definitions(definition):
    ours, ref = pipeline_from_definition(definition), ref_from_def(definition)
    assert isinstance(ours, FeatureUnion)
    X = _rows(2, n=50, tags=3)
    out = ours.fit_transform(X)
    _close(out, ref.fit_transform(X), SCALER_RTOL)
    assert out.shape == (50, 6) and out.dtype == np.float32
    _close(ours.transform(_rows(3, tags=3)), ref.transform(_rows(3, tags=3)), SCALER_RTOL)
    assert pipeline_into_definition(ours) == json.loads(json.dumps(
        _ref_definition(ref)))


def _ref_definition(obj):
    from gordo_components_tpu.serializer import pipeline_into_definition as ref_into

    return ref_into(obj)


def test_feature_union_inside_a_pipeline_round_trips():
    definition = {"Pipeline": {"steps": [
        {"FeatureUnion": {"transformer_list": ["MinMaxScaler", "StandardScaler"]}},
        {"DenseAutoEncoder": {"kind": "feedforward_hourglass", "epochs": 1, "batch_size": 16}},
    ]}}
    pipe = pipeline_from_definition(definition)
    assert isinstance(pipe.steps[0][1], FeatureUnion)
    rebuilt = pipeline_from_definition(pipeline_into_definition(pipe))
    assert isinstance(rebuilt.steps[0][1], FeatureUnion)
    pipe.steps[1][1].to("cpu")
    X = _rows(4, n=64)
    pipe.fit(X)
    assert pipe.predict(X).shape == (64, 8)


def test_feature_union_weights_unknown_names_and_state():
    with pytest.raises(ValueError, match="match no"):
        FeatureUnion([("a", MinMaxScaler())], transformer_weights={"z": 1.0})
    union = FeatureUnion([("a", MinMaxScaler()), ("b", MinMaxScaler())],
                         transformer_weights={"b": 2.0})
    X = _rows(5, n=20, tags=2)
    out = union.fit_transform(X)
    np.testing.assert_allclose(out[:, 2:], out[:, :2] * 2.0, atol=1e-6)
    fresh = clone_pipeline(union)
    assert fresh.transformer_list[0][1].params_ is None
    assert fresh.transformer_weights == {"b": 2.0}
    fresh.set_state(union.get_state())
    np.testing.assert_array_equal(fresh.transform(X), union.transform(X))
    # the state a reference union reads
    ref = ref_from_def(UNIONS[2])
    ref.set_state(union.get_state())
    _close(ref.transform(X), union.transform(X), SCALER_RTOL)


# -- Pipeline, TransformedTargetRegressor, the detector ------------------------

def test_pipeline_transform_and_getitem():
    definition = {"Pipeline": {"steps": [["imp", "InfImputer"], ["mm", "MinMaxScaler"],
                                         ["std", "StandardScaler"]]}}
    ours, ref = pipeline_from_definition(definition), ref_from_def(definition)
    X = _rows(6)
    ours.fit(X)
    ref.fit(X)
    _close(ours.transform(X), ref.transform(X), SCALER_RTOL)
    assert type(ours[1]).__name__ == type(ref[1]).__name__ == "MinMaxScaler"
    assert ours["std"] is ours.steps[2][1]
    head = ours[:2]
    assert isinstance(head, Pipeline) and [n for n, _ in head.steps] == ["imp", "mm"]
    _close(head.transform(X), ref[:2].transform(X), SCALER_RTOL)


def test_scores_equal_the_reference(fitted):
    ref, ours, X, _ = fitted
    ttr, ref_ttr = ours.base_estimator, ref.base_estimator
    assert abs(ours.score(X) - ref.score(X)) < 1e-5
    assert abs(ttr.score(X, X) - ref_ttr.score(X, X)) < 1e-5
    pipe, ref_pipe = ttr.regressor, ref_ttr.regressor
    assert abs(pipe.score(X) - ref_pipe.score(X)) < 1e-5
    _close(pipe.predict(X), ref_pipe.predict(X), FUSED_RTOL)


@pytest.mark.parametrize("named", [False, True])
def test_anomaly_equals_the_reference(fitted, named):
    import pandas as pd

    ref, ours, X, _ = fitted
    index = pd.date_range("2023-01-01", periods=len(X), freq="10min", tz="UTC")
    if named:
        frame = ours.anomaly(X, x_columns=TAGS, index=index.as_unit("ns").asi8)
        ref_frame = ref.anomaly(pd.DataFrame(X, columns=TAGS, index=index))
    else:
        frame = ours.anomaly(X)
        ref_frame = ref.anomaly(X)
    assert isinstance(frame, AnomalyFrame)
    assert frame.columns == list(ref_frame.columns)
    _close(frame.values, ref_frame.to_numpy(), FUSED_RTOL)
    np.testing.assert_array_equal(frame["model-input"], ref_frame["model-input"].to_numpy())
    _close(frame["total-anomaly-score"], ref_frame["total-anomaly-score"].to_numpy(), FUSED_RTOL)
    if named:
        np.testing.assert_array_equal(frame.index, ref_frame.index.as_unit("ns").asi8)
    else:
        assert frame.index is None
    # separate targets name the output columns
    assert ours.anomaly(X, y=X, y_columns=[f"y{i}" for i in range(4)]).columns[4] == \
        ("model-output", "y0")


def test_anomaly_needs_thresholds_when_asked():
    model = pipeline_from_definition(DETECTORS["dense"])
    model.require_thresholds = True
    with pytest.raises(ValueError, match="cross_validate"):
        model.anomaly(_rows(7))


# -- dumps / loads ---------------------------------------------------------------

def _members(blob):
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r:gz") as tar:
        return {m.name: tar.extractfile(m).read() for m in tar.getmembers()}


def test_dumps_and_loads_cross_between_the_packages(fitted):
    ref, ours, X, _ = fitted
    blob, ref_blob = dumps(ours, metadata={"dataset": {"tag_list": TAGS}}), ref_dumps(ref)
    assert dumps(ours, metadata={"dataset": {"tag_list": TAGS}}) == blob  # deterministic
    assert set(_members(ref_blob)) - {"metadata.json"} <= set(_members(blob))
    assert _members(blob)["state.npz"] == _members(ref_blob)["state.npz"]
    from_ours, from_ref = ref_loads(blob), loads(ref_blob, device="cpu")
    want = ref.predict(X)
    _close(from_ours.predict(X), want, FUSED_RTOL)
    _close(from_ref.predict(X), want, FUSED_RTOL)
    np.testing.assert_array_equal(from_ref.tag_thresholds_, ref.tag_thresholds_)


def _tar(members):
    buffer = io.BytesIO()
    with tarfile.open(fileobj=buffer, mode="w:gz") as tar:
        for info, data in members:
            tar.addfile(info, io.BytesIO(data) if data is not None else None)
    return buffer.getvalue()


def _file(name, data=b"x"):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    return info, data


def _link(name, target):
    info = tarfile.TarInfo(name)
    info.type = tarfile.SYMTYPE
    info.linkname = target
    return info, None


@pytest.mark.parametrize("case,match", [
    ("members", "members"),
    ("bytes", "decompressed bytes"),
    ("traversal", "outside"),
    ("absolute", "outside"),
    ("link", "non-regular"),
    ("duplicate", "repeats"),
])
def test_loads_refuses_unbounded_or_escaping_tars(case, match, monkeypatch):
    if case == "members":
        blob = _tar([_file(f"f{i}") for i in range(persistence.MAX_TAR_MEMBERS + 1)])
    elif case == "bytes":
        monkeypatch.setenv(persistence.MAX_TAR_TOTAL_BYTES_ENV, "100")
        blob = _tar([_file("state.npz", b"0" * 101)])
    elif case == "traversal":
        blob = _tar([_file("../evil.json")])
    elif case == "absolute":
        blob = _tar([_file("/tmp/evil.json")])
    elif case == "link":
        blob = _tar([_link("state.npz", "/etc/passwd")])
    else:
        blob = _tar([_file("definition.json"), _file("definition.json")])
    with pytest.raises(ValueError, match=match):
        loads(blob, device="cpu")
    with pytest.raises(Exception):
        ref_loads(blob)  # the reference refuses it too


# -- definitions, kinds -----------------------------------------------------------

@pytest.mark.parametrize("definition", [DETECTORS["dense"], DETECTORS["patchtst"], UNIONS[2],
                                        {"Pipeline": {"steps": [UNIONS[0], "MinMaxScaler"]}}],
                         ids=["dense", "patchtst", "union", "pipeline-union"])
def test_into_definition_yaml_equals_the_reference(definition):
    assert into_definition_yaml(pipeline_from_definition(definition)) == ref_into_yaml(
        ref_from_def(definition))


def test_list_kinds_equals_the_reference():
    import gordo_components_tpu.models.factories  # noqa: F401 - registers the reference's kinds

    assert list_kinds() == ref_list_kinds()


# -- GET /download-model ------------------------------------------------------------

def test_download_model_is_loaded_by_the_jax_package(fitted):
    ref, _, X, artifact = fitted
    fleet = ModelServer({"m": artifact}, device="cpu")
    single = ModelServer(artifact, device="cpu")
    try:
        scoped = fleet.handle("GET", "/gordo/v0/project/m/download-model", {}, b"")
        bare = single.handle("GET", "/download-model", {}, b"")
        missing = fleet.handle("GET", "/gordo/v0/project/nope/download-model", {}, b"")
    finally:
        fleet.close()
        single.close()
    assert scoped.status == bare.status == 200 and missing.status == 404
    assert scoped.content_type == "application/octet-stream"
    assert scoped.body == bare.body
    _close(ref_loads(scoped.body).predict(X), ref.predict(X), FUSED_RTOL)
    _close(loads(scoped.body, device="cpu").predict(X), ref.predict(X), FUSED_RTOL)
