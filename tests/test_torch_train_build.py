"""The port's build path — cross-validation, the detector's thresholds, the
artifact it dumps, the parameter converters, ``remat`` and the initial
distributions — against the JAX package, on the CPU.

- ``time_series_split`` gives sklearn's ``TimeSeriesSplit`` indices, and a
  detector's ``cross_validate`` over a deterministic numpy estimator (the
  same on both sides) gives the reference's fold records, thresholds and
  error scaler exactly: the same numpy arithmetic on the same residuals;
- a pipeline trained by the port and dumped by its serializer loads in
  ``gordo_components_tpu.serializer.load`` and predicts what the port
  predicts within 1e-5 of the predictions' magnitude (float32 on both
  sides, the same parameters, products summed in other orders);
- ``flax_from_params`` inverts ``params_from_flax`` bit for bit;
- ``remat=True`` trains the same losses as ``remat=False``, dropout on;
- port-side initial parameters follow flax's distributions: standard
  deviations within 5 % of flax's on 512 × 512 kernels, recurrent kernels
  orthogonal per gate.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.models.anomaly.diff import (  # noqa: E402
    DiffBasedAnomalyDetector as RefDetector,
)
from gordo_components_tpu.models.metrics import METRICS as REF_METRICS  # noqa: E402
from gordo_components_tpu.models.register import get_factory as ref_factory  # noqa: E402
from gordo_components_tpu.models.transformers import (  # noqa: E402
    FunctionTransformer as RefFunctionTransformer,
    InfImputer as RefInfImputer,
    MinMaxScaler as RefMinMaxScaler,
)
from gordo_components_tpu.serializer import (  # noqa: E402
    load as ref_load,
    pipeline_from_definition as ref_from_definition,
)

from gordo_components_tpu_torch.builder.build_model import _build_from_rows  # noqa: E402
from gordo_components_tpu_torch.models import (  # noqa: E402
    DenseAutoEncoder,
    LSTMAutoEncoder,
    PatchTSTAutoEncoder,
)
from gordo_components_tpu_torch.models.anomaly.diff import (  # noqa: E402
    DiffBasedAnomalyDetector,
    time_series_split,
)
from gordo_components_tpu_torch.models.convert import (  # noqa: E402
    flax_from_params,
    params_from_flax,
)
from gordo_components_tpu_torch.models.metrics import METRICS  # noqa: E402
from gordo_components_tpu_torch.models.models import init_flax_distributions  # noqa: E402
from gordo_components_tpu_torch.models.pipeline import clone_pipeline  # noqa: E402
from gordo_components_tpu_torch.models.register import get_factory  # noqa: E402
from gordo_components_tpu_torch.models.transformers import (  # noqa: E402
    FunctionTransformer,
    InfImputer,
    MinMaxScaler,
)
from gordo_components_tpu_torch.serializer import dump, load  # noqa: E402


@pytest.mark.parametrize("n,splits", [(12, 3), (100, 3), (101, 5), (7, 2), (4, 3)])
def test_time_series_split_matches_sklearn(n, splits):
    from sklearn.model_selection import TimeSeriesSplit

    ours = list(time_series_split(n, splits))
    theirs = list(TimeSeriesSplit(n_splits=splits).split(np.zeros((n, 1))))
    assert len(ours) == len(theirs) == splits
    for (a_train, a_test), (b_train, b_test) in zip(ours, theirs):
        np.testing.assert_array_equal(a_train, b_train)
        np.testing.assert_array_equal(a_test, b_test)
    with pytest.raises(ValueError, match="folds"):
        list(time_series_split(splits, splits))


class _ColumnMeans:
    """A numpy-only estimator that predicts each column's training mean for
    every row but the first: the same on both sides of the comparison."""

    def fit(self, X, y=None):
        self.mean_ = np.asarray(X if y is None else y, np.float32).mean(axis=0)
        return self

    def predict(self, X):
        return np.tile(self.mean_, (len(X) - 1, 1)) + 0.01 * np.asarray(X)[1:]


def test_cross_validate_matches_reference():
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(90, 4)) * [1, 2, 3, 4] + 10).astype(np.float32)
    ours = DiffBasedAnomalyDetector(base_estimator=_ColumnMeans(), scaler=MinMaxScaler())
    ref = RefDetector(base_estimator=_ColumnMeans(), scaler=RefMinMaxScaler())
    cv, ref_cv = ours.cross_validate(X, n_splits=4), ref.cross_validate(X, n_splits=4)
    assert cv["n_splits"] == ref_cv["n_splits"] == 4
    for a, b in zip(cv["splits"], ref_cv["splits"]):
        assert (a["fold"], a["n_train"], a["n_test"]) == (b["fold"], b["n_train"], b["n_test"])
        assert a["scores"] == b["scores"]
    assert cv["scores"] == ref_cv["scores"]
    np.testing.assert_array_equal(ours.tag_thresholds_, ref.tag_thresholds_)
    assert ours.total_threshold_ == ref.total_threshold_
    np.testing.assert_array_equal(ours.scaler.params_.scale, ref.scaler.params_.scale)
    assert ours.get_metadata().keys() == ref.get_metadata().keys()


def test_metrics_match_reference():
    rng = np.random.default_rng(4)
    y, p = rng.normal(size=(30, 3)), rng.normal(size=(30, 3))
    y[:, 2] = 1.0  # a zero-variance column
    assert sorted(METRICS) == sorted(REF_METRICS)
    for name, fn in METRICS.items():
        assert fn(y, p) == REF_METRICS[name](y, p)
        assert fn(y, y) == REF_METRICS[name](y, y)


def test_imputer_and_function_transformer_match_reference():
    X = np.array([[1.0, np.inf, 3.0], [-np.inf, 2.0, 5.0], [4.0, -1.0, np.inf]], np.float32)
    for kwargs in ({}, {"inf_fill_value": 9.0, "neg_inf_fill_value": -9.0}):
        ours, ref = InfImputer(**kwargs), RefInfImputer(**kwargs)
        np.testing.assert_array_equal(ours.fit_transform(X), ref.fit_transform(X))
        assert ours.get_state().keys() == ref.get_state().keys()
    path = "gordo_components.model.transformer_funcs.general.multiply"
    ours = FunctionTransformer(func=path, kw_args={"factor": 3.0})
    ref = RefFunctionTransformer(func=path, kw_args={"factor": 3.0})
    np.testing.assert_array_equal(ours.fit_transform(X), ref.fit_transform(X))
    with pytest.raises(ValueError, match="not a function the port knows"):
        FunctionTransformer(func="os.system").transform(X)


def _detector_config(estimator, kwargs):
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {estimator: kwargs}]}},
        "transformer": "MinMaxScaler",
    }}}}


ARTIFACTS = {
    "dense": ("DenseAutoEncoder", dict(kind="feedforward_hourglass", epochs=2)),
    "lstm": ("LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[6], lookback_window=8,
                                     epochs=1, batch_size=16)),
    "patchtst": ("PatchTSTAutoEncoder", dict(lookback_window=24, patch_length=8, stride=4,
                                             d_model=8, n_heads=2, n_layers=1, epochs=1,
                                             batch_size=16)),
}


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_port_trained_artifact_loads_in_the_reference(name, tmp_path):
    """The model phase of a build (definition → cross-validation → fit),
    dumped by the port: the reference loads it and predicts what the port
    predicts; the port loads it back to the same predictions; the build
    metadata carries the reference's keys."""
    estimator, kwargs = ARTIFACTS[name]
    rng = np.random.default_rng(6)
    X = (rng.normal(size=(160, 5)) * 3 + 5).astype(np.float32)
    config = _detector_config(estimator, kwargs)
    model, metadata = _build_from_rows(name, config, X, device="cpu",
                                       dataset_metadata={"tag_list": [f"t{i}" for i in range(5)]})
    path = dump(model, str(tmp_path / name), metadata=metadata)
    ours = model.predict(X)
    np.testing.assert_allclose(ref_load(path).predict(X), ours,
                               atol=1e-5 * np.abs(ours).max())
    np.testing.assert_array_equal(load(path, device="cpu").predict(X), ours)

    ref_model = ref_from_definition(config)
    ref_model.cross_validate(X, n_splits=3)["cv_duration_s"] = 0.0  # as the build adds it
    ref_model.fit(X)
    assert set(metadata["model"]) == {"model_config", "model_builder_metadata",
                                      "cross_validation", "model_training_duration_s",
                                      "model_creation_date"}

    def keys(tree):
        if isinstance(tree, dict):
            return {k: keys(v) for k, v in tree.items() if k not in ("history",)}
        return None

    assert keys(metadata["model"]["model_builder_metadata"]) == keys(ref_model.get_metadata())
    assert set(metadata["model"]["cross_validation"]) == {"n_splits", "splits", "scores",
                                                          "cv_duration_s"}
    assert len(model.base_estimator.regressor.steps[-1][1].history_) == kwargs["epochs"]


FLAX_CASES = {
    "dense": ("feedforward_symmetric", dict(n_features=6, n_features_out=3, dims=(8, 4)), (1, 6)),
    "lstm": ("lstm_symmetric", dict(n_features=5, lookback_window=4, dims=(6, 3)), (1, 4, 5)),
    "patchtst": ("patchtst", dict(n_features=3, n_features_out=2, lookback_window=32,
                                  patch_length=8, stride=4, d_model=8, n_heads=2,
                                  n_layers=2), (1, 32, 3)),
}


@pytest.mark.parametrize("case", sorted(FLAX_CASES))
def test_flax_from_params_inverts_params_from_flax(case):
    kind, kw, shape = FLAX_CASES[case]
    tree = ref_factory(kind)(**kw).module.init(
        jax.random.PRNGKey(2), np.zeros(shape, np.float32), deterministic=True)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    module = params_from_flax(get_factory(kind)(**kw).module, tree)
    back = flax_from_params(module)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    again = params_from_flax(get_factory(kind)(**kw).module, back)
    for (name, a), b in zip(module.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name


def test_remat_trains_the_same_losses():
    """``remat`` recomputes each encoder layer in the backward pass, with
    the dropout masks it drew the first time: the same losses and the same
    parameter tree."""
    X = np.random.default_rng(8).normal(size=(70, 3)).astype(np.float32)
    kw = dict(lookback_window=24, patch_length=8, stride=4, d_model=8, n_heads=2, n_layers=2,
              epochs=2, batch_size=8, dropout=0.2)
    plain = PatchTSTAutoEncoder(**kw).to("cpu").fit(X)
    remat = PatchTSTAutoEncoder(**kw, remat=True).to("cpu").fit(X)
    assert remat.history_ == plain.history_
    for a, b in zip(jax.tree_util.tree_leaves(remat.params_),
                    jax.tree_util.tree_leaves(plain.params_)):
        np.testing.assert_array_equal(a, b)
    no_dropout = PatchTSTAutoEncoder(**{**kw, "dropout": 0.0}).to("cpu").fit(X)
    assert no_dropout.history_ != plain.history_  # dropout really ran


def test_fit_is_seeded_and_clone_is_unfitted():
    X = np.random.default_rng(9).normal(size=(60, 4)).astype(np.float32)
    a = LSTMAutoEncoder(kind="lstm_symmetric", dims=[3], lookback_window=5, seed=3).to("cpu")
    b = clone_pipeline(a)
    assert b.module_ is None and b.device == a.device and b.get_params() == a.get_params()
    np.testing.assert_array_equal(a.fit(X).predict(X), b.fit(X).predict(X))
    c = LSTMAutoEncoder(kind="lstm_symmetric", dims=[3], lookback_window=5, seed=4).to("cpu")
    assert c.fit(X).history_ != a.history_


def test_initial_distributions_follow_flax():
    """Dense kernels lecun-normal (std sqrt(1/fan_in), truncated at two
    standard deviations), zero biases; LSTM input kernels lecun-normal,
    recurrent kernels orthogonal per gate, zero biases; LayerNorm ones and
    zeros; pos_embedding std 0.02."""
    gen = torch.Generator().manual_seed(0)
    dense = init_flax_distributions(
        get_factory("feedforward_model")(n_features=512, encoding_dim=(512,),
                                         decoding_dim=(512,)).module, gen)
    ref_tree = ref_factory("feedforward_model")(
        n_features=512, encoding_dim=(512,), decoding_dim=(512,)).module.init(
        jax.random.PRNGKey(0), np.zeros((1, 512), np.float32))["params"]
    ours, theirs = dense.layers[1].weight.detach().numpy(), np.asarray(ref_tree["Dense_1"]["kernel"])
    assert abs(ours.std() / theirs.std() - 1) < 0.05
    assert abs(ours.std() - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert np.abs(ours).max() <= 2 * 512 ** -0.5 / 0.87962566103423978 + 1e-6
    assert not dense.layers[1].bias.any()

    lstm = init_flax_distributions(
        get_factory("lstm_model")(n_features=512, units=(64,), lookback_window=2).module, gen)
    cell = lstm.cells[0]
    ref_cell = ref_factory("lstm_model")(n_features=512, units=(64,), lookback_window=2).module.init(
        jax.random.PRNGKey(0), np.zeros((1, 2, 512), np.float32))["params"]["OptimizedLSTMCell_0"]
    ours_in = cell.input_kernel.detach().numpy()
    assert abs(ours_in.std() / np.asarray(ref_cell["ii"]["kernel"]).std() - 1) < 0.05
    for gate in cell.recurrent_kernel.detach().split(64, dim=1):
        np.testing.assert_allclose(gate.T @ gate, np.eye(64), atol=1e-5)
    hg = np.asarray(ref_cell["hg"]["kernel"])
    np.testing.assert_allclose(hg.T @ hg, np.eye(64), atol=1e-5)
    assert not cell.recurrent_bias.any()

    patchtst = init_flax_distributions(get_factory("patchtst")(
        n_features=2, lookback_window=2048, patch_length=8, stride=8, d_model=64).module, gen)
    assert abs(patchtst.pos_embedding.std().item() / 0.02 - 1) < 0.05
    assert torch.equal(patchtst.norm.weight, torch.ones(64)) and not patchtst.norm.bias.any()


def test_dense_estimator_fit_reduces_loss_and_scores():
    X = np.random.default_rng(10).normal(size=(120, 6)).astype(np.float32)
    est = DenseAutoEncoder(kind="feedforward_symmetric", dims=[5, 4], epochs=4).to("cpu")
    est.fit(X)
    assert len(est.history_) == 4 and est.history_[-1] < est.history_[0]
    assert est.fit_duration_ > 0 and np.isfinite(est.score(X))
    meta = est.get_metadata()
    assert meta["history"]["loss"] == est.history_ and meta["num_parameters"] > 0
