"""The port's int8 rung against the reference engine's, on the CPU.

Anomaly machines are fitted by the JAX package (a dense pair of one
architecture, an LSTM autoencoder, a horizon-3 LSTM forecaster, and a
two-tag PatchTST at 129 patches with ``attention_impl="flash"``: flax init
weights, scalers and thresholds fitted through dense attention, as in
``tests/test_torch_engine_stacked.py``) and committed as int8 generations
by the reference's ``write_artifact_files(..., precision="int8")``, so each
carries ``quant_int8.npz``. The port loads them on the CPU, where its flash
operator runs the kernel's plain version; the reference runs its Pallas
kernel in interpret mode. Both engines serve them at int8, from the
sidecar and quantizing on the fly, and must give the four ``ScoreResult``
arrays within atol 1e-4 in raw tag units (values around 5 ± 3), the bound
of ``tests/test_torch_zoo_serving.py``: both dequantize to the same float32
weights and differ only in summation order.
"""

import logging

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu import precision as ref_precision  # noqa: E402
from gordo_components_tpu.serializer import pipeline_from_definition as ref_from_definition  # noqa: E402
from gordo_components_tpu.serializer.persistence import (  # noqa: E402
    write_artifact_files as ref_write_artifact_files,
)
from gordo_components_tpu.server.engine import ServingEngine as RefEngine  # noqa: E402
from gordo_components_tpu.store import commit_generation  # noqa: E402

from gordo_components_tpu_torch import precision, wire  # noqa: E402
from gordo_components_tpu_torch.serializer import load  # noqa: E402
from gordo_components_tpu_torch.server.engine import ServingEngine, _Item  # noqa: E402

TAGS = [f"tag-{i}" for i in range(5)]
PATCHTST_TAGS = 2
LOOKBACK = 8
PATCHTST = dict(lookback_window=130, patch_length=2, stride=1, d_model=8, n_heads=1,
                n_layers=1, attention_impl="flash")  # 129 patches: the kernel path runs
MACHINES = {  # name -> (estimator, kwargs, data seed)
    "dense-a": ("DenseAutoEncoder", dict(kind="feedforward_hourglass"), 1),
    "dense-b": ("DenseAutoEncoder", dict(kind="feedforward_hourglass"), 2),
    "lstm-ae": ("LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[6],
                                        lookback_window=LOOKBACK), 4),
    "lstm-forecast": ("LSTMForecast", dict(kind="lstm_symmetric", dims=[6],
                                           lookback_window=LOOKBACK, horizon=3), 5),
    "patchtst": ("PatchTSTAutoEncoder", PATCHTST, 6),
    # gate kernels with peaks 100x apart: a scale shared over the
    # concatenated LSTM kernel would round the small gates to zero
    "lstm-gates": ("LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[6],
                                           lookback_window=LOOKBACK), 7),
}


def _config(estimator, kwargs):
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": [
            "MinMaxScaler", {estimator: {**kwargs, "epochs": 1, "batch_size": 16}}]}},
        "transformer": "MinMaxScaler",
    }}}}


def _width(name):
    return PATCHTST_TAGS if name == "patchtst" else len(TAGS)


def _thresholds(model, X):
    pred = model.predict(X)
    residual = np.abs(X[len(X) - len(pred):] - pred)
    model.scaler.fit(residual)
    scaled = model.scaler.transform(residual)
    model.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
    model.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    return model


def _build(name, estimator, kwargs, seed):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(160, _width(name))) * 3 + 5).astype(np.float32)
    if estimator != "PatchTSTAutoEncoder":
        model = ref_from_definition(_config(estimator, kwargs))
        model.fit(X, X)
        if name == "lstm-gates":
            est = model.base_estimator.regressor.steps[-1][1]
            params = jax.tree_util.tree_map(np.asarray, est.params_)
            # scaled down, not up: 100x larger pre-activations would scale
            # the float32 summation-order noise of both engines with them
            for cell in (v for k, v in params.items() if k.startswith("OptimizedLSTMCell")):
                for gate in ("i", "g"):
                    cell[f"i{gate}"]["kernel"] = cell[f"i{gate}"]["kernel"] / 100
                    cell[f"h{gate}"]["kernel"] = cell[f"h{gate}"]["kernel"] / 100
            est.set_state({**est.get_state(), "params": params})
        return _thresholds(model, X)
    model = ref_from_definition(_config(estimator, {**kwargs, "attention_impl": "dense"}))
    ttr = model.base_estimator
    scaler, est = (step for _, step in ttr.regressor.steps)
    scaler.fit(X)
    ttr.transformer.fit(X)
    spec = est._make_spec(X.shape[1], X.shape[1])
    params = spec.module.init(jax.random.PRNGKey(seed), X[None, : PATCHTST["lookback_window"]],
                              deterministic=True)["params"]
    est.set_state({"params": jax.tree_util.tree_map(np.asarray, dict(params)),
                   "n_features": X.shape[1], "n_features_out": X.shape[1]})
    _thresholds(model, X)
    est.factory_kwargs["attention_impl"] = "flash"
    est.set_state(est.get_state())
    return model


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """{name: (reference model, generation root, generation dir)}, and X."""
    root = tmp_path_factory.mktemp("int8")
    built = {}
    for name, (estimator, kwargs, seed) in MACHINES.items():
        model = _build(name, estimator, kwargs, seed)
        metadata = {"dataset": {"tag_list": TAGS[: _width(name)]}, "precision": "int8"}
        gen = commit_generation(str(root / name), lambda staging: ref_write_artifact_files(
            model, staging, metadata=metadata, precision="int8"))
        built[name] = (model, str(root / name), gen)
    X = (np.random.default_rng(9).normal(size=(140, len(TAGS))) * 3 + 5).astype(np.float32)
    return built, X


def _X(name, X):
    return X[:, : _width(name)]


def _assert_scores_match(ours, ref, atol=1e-4):
    for field, a, b in zip(wire.SCORE_FIELDS, ours, ref):
        assert a.shape == b.shape, field
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=field)


_REF = {}


def _reference(fleet, name, mode):
    """The reference engine's int8 scores, once per machine and mode."""
    if (name, mode) not in _REF:
        built, X = fleet
        model, _, gen = built[name]
        quantized = {name: ref_precision.load_quantized(gen)} if mode == "sidecar" else None
        engine = RefEngine({name: model}, precisions={name: "int8"}, quantized=quantized)
        _REF[name, mode] = engine.anomaly(name, _X(name, X))
    return _REF[name, mode]


def _ours(fleet, names, mode="sidecar", quantized=None):
    built, _ = fleet
    if quantized is None and mode == "sidecar":
        quantized = {n: precision.load_quantized(built[n][2]) for n in names}
    return ServingEngine({n: load(built[n][1], device="cpu") for n in names},
                         precisions={n: "int8" for n in names}, quantized=quantized,
                         device="cpu")


@pytest.mark.parametrize("mode", ["sidecar", "on-the-fly"])
@pytest.mark.parametrize("name", sorted(MACHINES))
def test_int8_scores_match_the_reference_engine(fleet, name, mode):
    engine = _ours(fleet, [name], mode)
    scored = engine.anomaly(name, _X(name, fleet[1]))
    _assert_scores_match(scored, _reference(fleet, name, mode))
    assert engine.stats()["precision"] == {"machines": {"int8": 1}, "requests": {"int8": 1}}
    engine.close()


def test_sidecar_and_on_the_fly_are_the_same_weights(fleet):
    names = ["lstm-ae", "patchtst"]
    stored, fresh = _ours(fleet, names, "sidecar"), _ours(fleet, names, "on-the-fly")
    for a, b in zip(stored._buckets, fresh._buckets):
        for key in ("params", "params_scale"):
            for name, value in a.stacked[key].items():
                assert torch.equal(value, b.stacked[key][name]), (key, name)


def test_stale_sidecar_falls_back_with_the_warning(fleet, caplog):
    built, X = fleet
    q_tree, s_tree = precision.load_quantized(built["dense-a"][2])
    kernel = q_tree["Dense_0"]["kernel"]
    q_tree["Dense_0"]["kernel"] = np.zeros((kernel.shape[0] + 1, kernel.shape[1]), np.int8)
    with caplog.at_level(logging.WARNING):
        engine = _ours(fleet, ["dense-a"], quantized={"dense-a": (q_tree, s_tree)})
    assert "quantizing on the fly" in caplog.text and "dense-a" in caplog.text
    _assert_scores_match(engine.anomaly("dense-a", _X("dense-a", X)),
                         _reference(fleet, "dense-a", "on-the-fly"))


@pytest.mark.parametrize("names", [["dense-a", "dense-b"], ["patchtst"]])
def test_fused_int8_dispatch_matches_lone_requests(fleet, names):
    """k requests in one dispatch (``vmap``, the stacked scales broadcast
    against their leaves) give each machine's lone score."""
    engine = _ours(fleet, names)
    bucket, _ = engine._by_name[names[0]]
    X = _X(names[0], fleet[1])
    x_padded, m_valid = engine._prepare(bucket, X)

    def dispatch(idxs):
        items = [_Item(i, x_padded, m_valid) for i in idxs]
        out = bucket._host(bucket._enqueue(idxs, bucket._batch_inputs(items)))
        return [[a[j] for a in out] for j in range(len(idxs))]

    lone = {i: dispatch([i])[0] for i in range(len(names))}
    for k in (2, 4):
        idxs = [i % len(names) for i in range(k)]
        for idx, scored in zip(idxs, dispatch(idxs)):
            for a, b in zip(scored, lone[idx]):
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    engine.close()


def test_stacked_int8_leaves_and_bytes(fleet):
    names = sorted(MACHINES)
    int8 = _ours(fleet, names)
    built, _ = fleet
    f32 = ServingEngine({n: load(built[n][1], device="cpu") for n in names}, device="cpu")
    assert len(int8._buckets) == len(f32._buckets)
    for a, b in zip(int8._buckets, f32._buckets):
        assert a.names == b.names and a.precision == "int8" and b.precision == "f32"
        assert all(t.dtype == torch.int8 for t in a.stacked["params"].values())
        assert all(t.dtype == torch.float32 for t in a.stacked["params_scale"].values())
        int8_params = sum(t.numel() * t.element_size() for t in a.stacked["params"].values())
        f32_params = sum(t.numel() * t.element_size() for t in b.stacked["params"].values())
        assert 4 * int8_params == f32_params
        if a.names == ["patchtst"]:  # weights dominate its tree
            assert a.stacked_nbytes() < b.stacked_nbytes() / 3
    lstm, idx = int8._by_name["lstm-gates"]
    scale = lstm.stacked["params_scale"]["cells.0.input_kernel"]
    assert scale.shape == (len(lstm.names), 24)
    assert len(set(scale[idx].tolist())) == 4  # one per gate
