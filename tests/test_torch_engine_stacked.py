"""The port's stacked engine against the reference's ``ServingEngine``.

Anomaly artifacts are built by the JAX package and dumped by its
serializer: a dense pair of one architecture (one bucket, two machines), a
target-subset dense machine, an LSTM autoencoder, a horizon-3 LSTM
forecaster (fitted one epoch at small width) and a two-tag, one-head
PatchTST machine with ``attention_impl="flash"`` at 129 patches, so the
kernel path runs (flax init weights; its scalers and thresholds fitted with
dense attention, which the Pallas kernel in interpret mode makes slow, then
the flash variant built on the same weights). The port loads them on the CPU,
where its flash operator runs the kernel's plain version; the reference
runs its Pallas kernel in interpret mode. Both engines must group the
same machines into the same buckets, skip the same machines for the same
reasons, and give the four ``ScoreResult`` arrays within atol 1e-4 in raw
tag units (values around 5 ± 3) at the f32 and the bf16 rung: the bound of
the reference's own engine-vs-host parity tests; both sides compute in
float32 on the CPU and differ only in summation order.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.serializer import (  # noqa: E402
    dump as ref_dump,
    pipeline_from_definition as ref_from_definition,
)
from gordo_components_tpu.server.engine import ServingEngine as RefEngine  # noqa: E402

from gordo_components_tpu_torch import wire  # noqa: E402
from gordo_components_tpu_torch.serializer import load  # noqa: E402
from gordo_components_tpu_torch.server.engine import ServingEngine  # noqa: E402

TAGS = [f"tag-{i}" for i in range(5)]
PATCHTST_TAGS = 2  # the PatchTST machine reads the first two tags
SUBSET = [0, 2, 4]
LOOKBACK = 8
PATCHTST = dict(lookback_window=130, patch_length=2, stride=1, d_model=8, n_heads=1,
                n_layers=1, attention_impl="flash")  # (130 - 2) / 1 + 1 = 129 patches
MACHINES = {  # name -> (estimator, kwargs, target columns, data seed)
    "dense-a": ("DenseAutoEncoder", dict(kind="feedforward_hourglass"), None, 1),
    "dense-b": ("DenseAutoEncoder", dict(kind="feedforward_hourglass"), None, 2),
    "dense-sub": ("DenseAutoEncoder", dict(kind="feedforward_symmetric", dims=[6, 3]),
                  SUBSET, 3),
    "lstm-ae": ("LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[6],
                                        lookback_window=LOOKBACK), None, 4),
    "lstm-forecast": ("LSTMForecast", dict(kind="lstm_symmetric", dims=[6],
                                           lookback_window=LOOKBACK, horizon=3), None, 5),
    "patchtst": ("PatchTSTAutoEncoder", PATCHTST, None, 6),
}
BUCKETS = [{"dense-a", "dense-b"}, {"dense-sub"}, {"lstm-ae"}, {"lstm-forecast"}, {"patchtst"}]


def _config(estimator, kwargs):
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": [
            "MinMaxScaler", {estimator: {**kwargs, "epochs": 1, "batch_size": 16}}]}},
        "transformer": "MinMaxScaler",
    }}}}


def _thresholds(model, X, y):
    """The error scaler and thresholds on the training residuals."""
    pred = model.predict(X)
    residual = np.abs(y[len(y) - len(pred):] - pred)
    model.scaler.fit(residual)
    scaled = model.scaler.transform(residual)
    model.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
    model.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    return model


def _width(name):
    return PATCHTST_TAGS if name == "patchtst" else len(TAGS)


def _build(name, estimator, kwargs, cols, seed):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(160, _width(name))) * 3 + 5).astype(np.float32)
    y = X if cols is None else X[:, cols]
    if estimator != "PatchTSTAutoEncoder":
        model = ref_from_definition(_config(estimator, kwargs))
        model.fit(X, y)
        return _thresholds(model, X, y)
    # flax init weights, and the scalers and thresholds fitted through dense
    # attention (the interpret-mode kernel is slow); then the estimator is
    # rebuilt with flash attention on the same weights
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
    _thresholds(model, X, y)
    est.factory_kwargs["attention_impl"] = "flash"
    est.set_state(est.get_state())
    return model


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    models = {}
    for name, (estimator, kwargs, cols, seed) in MACHINES.items():
        models[name] = _build(name, estimator, kwargs, cols, seed)
        dataset = {"tag_list": TAGS[: _width(name)]}
        if cols is not None:
            dataset["target_tag_list"] = [TAGS[c] for c in cols]
        ref_dump(models[name], str(root / name), metadata={"dataset": dataset})
    X = (np.random.default_rng(9).normal(size=(140, len(TAGS))) * 3 + 5).astype(np.float32)
    return root, models, X


def _ported(root, names=MACHINES):
    return {name: load(str(root / name), device="cpu") for name in names}


TARGET_COLS = {"dense-sub": SUBSET}


def _assert_scores_match(ours, ref, atol=1e-4, rtol=0.0):
    for name, a, b in zip(wire.SCORE_FIELDS, ours, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)


def _bucket_names(engine):
    return sorted(sorted(b.names) for b in engine._buckets)


def test_buckets_and_skipped_reasons_match_reference(fleet):
    root, models, _ = fleet
    # dense-sub without its mapping and dense-b at an unknown rung are
    # skipped; the rest group as the reference groups them
    precisions = {"dense-b": "fp16"}
    ours = ServingEngine(_ported(root), precisions=precisions, device="cpu")
    ref = RefEngine(models, precisions=precisions)
    assert sorted(ours.skipped) == ["dense-b", "dense-sub"]
    assert ours.skipped == ref.skipped
    assert _bucket_names(ours) == _bucket_names(ref)
    full = ServingEngine(_ported(root), target_cols=TARGET_COLS, device="cpu")
    assert _bucket_names(full) == sorted(sorted(b) for b in BUCKETS)
    assert _bucket_names(full) == _bucket_names(RefEngine(models, target_cols=TARGET_COLS))
    assert full.stats()["machines"] == len(MACHINES) and full.stats()["buckets"] == len(BUCKETS)
    for bucket in full._buckets:  # the template holds no weights
        assert all(p.device.type == "meta" for p in bucket.template.parameters())
        assert all(a.shape[0] == len(bucket.names)
                   for a in bucket.stacked["params"].values())
    # an int8 machine lifts into a bucket of its own rung, as in the reference
    int8 = {"dense-a": "int8"}
    mixed = ServingEngine(_ported(root), target_cols=TARGET_COLS, precisions=int8, device="cpu")
    assert _bucket_names(mixed) == _bucket_names(
        RefEngine(models, target_cols=TARGET_COLS, precisions=int8))
    assert mixed.stats()["precision"]["machines"]["int8"] == 1
    mixed.close()
    ours.close()
    full.close()


_ENGINES = {}


def _engines(fleet, precision):
    """One port engine and one reference engine per rung, for the module."""
    if precision not in _ENGINES:
        root, models, _ = fleet
        precisions = {name: precision for name in MACHINES}
        _ENGINES[precision] = (
            ServingEngine(_ported(root), target_cols=TARGET_COLS, precisions=precisions,
                          device="cpu"),
            RefEngine(models, target_cols=TARGET_COLS, precisions=precisions),
        )
    return _ENGINES[precision]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(MACHINES))
def test_score_result_matches_reference_engine(fleet, name, precision):
    _, _, X = fleet
    X = X[:, : _width(name)]
    ours, ref = _engines(fleet, precision)
    scored = ours.anomaly(name, X)
    _assert_scores_match(scored, ref.anomaly(name, X))
    assert np.isfinite(scored.total_anomaly_score).all()


def test_dense_pair_fused_in_one_dispatch_matches_reference(fleet):
    """Both machines of the dense bucket in ONE fused dispatch (driven
    through the bucket's dispatch directly), each against the reference."""
    from gordo_components_tpu_torch.server.engine import _Item

    _, _, X = fleet
    ours, ref = _engines(fleet, "f32")
    bucket, _ = ours._by_name["dense-a"]
    items = []
    for i, name in enumerate(("dense-a", "dense-b")):
        x, m_valid = ours._prepare(bucket, X[: 100 + 20 * i])
        items.append(_Item(ours._by_name[name][1], x, m_valid))
    before = bucket.dispatch_count
    bucket._dispatch(items[0].x.shape[0], items, defer=False)
    assert bucket.dispatch_count == before + 1 and bucket.max_batch_seen == 2
    for i, (name, item) in enumerate(zip(("dense-a", "dense-b"), items)):
        assert item.done.wait(30) and item.error is None
        _assert_scores_match(item.result, ref.anomaly(name, X[: 100 + 20 * i]))


@pytest.mark.parametrize("name,cap,rows", [("dense-a", 48, 330), ("lstm-ae", 40, 330),
                                           ("lstm-forecast", 40, 330), ("patchtst", 160, 250)])
def test_chunked_scoring_matches_reference_and_unchunked(fleet, name, cap, rows):
    """A request longer than ``max_rows_dispatch`` scores in overlapping
    chunks: the stitched result matches the reference (which scores it
    unchunked) at 1e-4 and the port's unchunked result at 1e-5 absolute and
    relative (float32, the same windows; products of other shapes round
    differently, a few ulps of values around 5, more through the deeper
    PatchTST)."""
    root, models, _ = fleet
    X = (np.random.default_rng(11).normal(size=(rows, _width(name))) * 3 + 5).astype(np.float32)
    model = _ported(root, [name])
    chunked = ServingEngine(model, max_rows_dispatch=cap, min_rows_bucket=16, device="cpu")
    whole = ServingEngine(model, device="cpu")
    scored = chunked.anomaly(name, X)
    assert chunked.stats()["dispatches"] >= 2  # it really chunked
    _assert_scores_match(scored, RefEngine({name: models[name]}).anomaly(name, X))
    _assert_scores_match(scored, whole.anomaly(name, X), atol=1e-5, rtol=1e-5)
    chunked.close()
    whole.close()


@pytest.mark.parametrize("name", ["dense-a", "lstm-forecast", "patchtst"])
def test_row_trim_equals_full_padded_compute(fleet, name):
    """A dispatch computes only the rows its longest real request holds;
    the program run over every padded row gives the same fanned-out
    results (float32, products of other shapes: 1e-5 absolute and relative)."""
    from gordo_components_tpu_torch.server.engine import _Item

    _, _, X = fleet
    X = X[:, : _width(name)]
    ours, _ = _engines(fleet, "f32")
    bucket, idx = ours._by_name[name]
    x_padded, m_valid = ours._prepare(bucket, X)
    rows = x_padded.shape[0]
    assert rows == 256 and len(X) == 140  # padded to the power-of-two bucket
    item = _Item(idx, x_padded, m_valid)
    trimmed = bucket._batch_inputs([item])
    assert trimmed.shape[1] == len(X)
    full = bucket._host(bucket._enqueue([idx], x_padded[None]))
    short = bucket._host(bucket._enqueue([idx], trimmed))
    for a, b in zip(full, short):
        np.testing.assert_allclose(a[0][:m_valid], b[0][:m_valid], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(short[0][0][:m_valid], X[len(X) - m_valid:])
