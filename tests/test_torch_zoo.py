"""The dense and LSTM model zoo of the PyTorch port against the flax modules.

Params come from the reference module's ``init`` (no training) and pass
through ``params_from_flax``; both forwards see the same seeded inputs.

Tolerances:

- float32: atol 1e-5 on outputs of order 1 (the same arithmetic in
  another summation order; the LSTM's input projection of all steps is one
  product over ``(B·L, F)`` here and one per step in flax).
- bfloat16 compute: 8 bf16 units in the last place of the largest output
  (2^-4 relative). A Dense layer rounds exactly as flax does (the product,
  then the bias), so the dense stack agrees to the bit; flax's gate sigmoid
  is XLA's ``1 / (1 + exp(-x))`` with a bf16 rounding after each of the
  three operations, PyTorch's rounds once, so an LSTM gate may differ by
  one ulp at any step and the carry carries it on. A gate order or a
  transposed kernel moves outputs by O(1).
"""

import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.models import models as ref_models  # noqa: E402
from gordo_components_tpu.models.factories.feedforward import (  # noqa: E402
    hourglass_calc_dims as ref_hourglass_calc_dims,
)
from gordo_components_tpu.models.register import get_factory as ref_factory  # noqa: E402

from gordo_components_tpu_torch.models import models  # noqa: E402
from gordo_components_tpu_torch.models.convert import params_from_flax  # noqa: E402
from gordo_components_tpu_torch.models.factories.feedforward import (  # noqa: E402
    hourglass_calc_dims,
)
from gordo_components_tpu_torch.models.register import get_factory  # noqa: E402

F32_ATOL = 1e-5
BF16_ULPS = 8

CASES = {
    "ff-model": ("feedforward_model", dict(
        n_features=6, encoding_dim=(8, 4), encoding_func=("tanh", "relu"),
        decoding_dim=(4, 8), decoding_func="elu")),
    "ff-symmetric-subset": ("feedforward_symmetric", dict(
        n_features=6, n_features_out=3, dims=(8, 4), funcs="relu", out_func="tanh")),
    "ff-hourglass": ("feedforward_hourglass", dict(n_features=10)),
    "lstm-model": ("lstm_model", dict(n_features=5, lookback_window=7, units=(8, 6, 4))),
    "lstm-symmetric-relu-subset": ("lstm_symmetric", dict(
        n_features=5, n_features_out=2, lookback_window=7, dims=(6,), funcs="relu")),
    "lstm-hourglass-elu": ("lstm_hourglass", dict(
        n_features=6, lookback_window=7, func="elu", dropout=0.1)),
}


def _inputs(kw, batch=9):
    shape = (batch, kw["n_features"])
    if "lookback_window" in kw:
        shape = (batch, kw["lookback_window"], kw["n_features"])
    return (3 * np.random.default_rng(1).normal(size=shape)).astype(np.float32)


def _flax_params(kind, kw, x):
    spec = ref_factory(kind)(**kw)
    params = spec.module.init(jax.random.PRNGKey(0), x)["params"]
    return spec, jax.tree_util.tree_map(np.asarray, dict(params))


def bf16_atol(ref: np.ndarray) -> float:
    """BF16_ULPS units in the last place of the largest |ref| (bf16 keeps 8
    significant bits)."""
    return BF16_ULPS * math.ldexp(1.0, math.frexp(float(np.abs(ref).max()))[1] - 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_flax(case, dtype):
    kind, kw = CASES[case]
    kw = {**kw, "compute_dtype": dtype}
    x = _inputs(kw)
    ref_spec, params = _flax_params(kind, kw, x)
    ref = np.asarray(ref_spec.module.apply({"params": params}, x))
    module = params_from_flax(get_factory(kind)(**kw).module, params)
    with torch.no_grad():
        ours = module(torch.from_numpy(x))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    atol = F32_ATOL if dtype == "float32" else bf16_atol(ref)
    np.testing.assert_allclose(ours.numpy(), ref, atol=atol, rtol=0)


def test_lstm_activation_applies_to_the_cell_state_too():
    """flax's ``h' = o * act(c')``: with relu, a cell that applied tanh to
    the cell state (as ``torch.nn.LSTM`` does) would differ well past the
    float32 tolerance."""
    kind, kw = CASES["lstm-symmetric-relu-subset"]
    x = _inputs(kw)
    ref_spec, params = _flax_params(kind, kw, x)
    ref = np.asarray(ref_spec.module.apply({"params": params}, x))
    tanh_spec, _ = _flax_params(kind, {**kw, "funcs": "tanh"}, x)
    tanh_ref = np.asarray(tanh_spec.module.apply({"params": params}, x))
    assert np.abs(ref - tanh_ref).max() > 100 * F32_ATOL


@pytest.mark.parametrize("kind", sorted({kind for kind, _ in CASES.values()}))
def test_factory_config_matches_reference(kind):
    kw = next(kw for k, kw in CASES.values() if k == kind)
    ours, ref = get_factory(kind)(**kw), ref_factory(kind)(**kw)
    assert ours.config == ref.config
    assert (ours.input_kind, ours.loss) == (ref.input_kind, ref.loss)


@pytest.mark.parametrize("kind,bad", [
    ("feedforward_model", dict(frobnicate=1)),
    ("feedforward_model", dict(encoding_func=("tanh",))),
    ("feedforward_symmetric", dict(dims=())),
    ("feedforward_hourglass", dict(compression_factor=1.5)),
    ("feedforward_hourglass", dict(encoding_layers=0)),
    ("lstm_model", dict(lookback_window=0)),
    ("lstm_symmetric", dict(dims=())),
    ("lstm_hourglass", dict(func=("tanh",))),
], ids=lambda v: v if isinstance(v, str) else "-".join(v))
def test_factory_errors_match_reference(kind, bad):
    kw = {"n_features": 6, **bad}
    with pytest.raises(ValueError):
        ref_factory(kind)(**kw)
    with pytest.raises(ValueError):
        get_factory(kind)(**kw)


@pytest.mark.parametrize("args,dims", [
    ((0.5, 3, 10), (8, 7, 5)),
    ((0.2, 3, 5), (4, 2, 1)),
    ((1.0, 3, 10), (10, 10, 10)),
    ((0.5, 1, 128), (64,)),
    ((0.5, 3, 100), (83, 67, 50)),
])
def test_hourglass_calc_dims_goldens(args, dims):
    assert hourglass_calc_dims(*args) == dims == ref_hourglass_calc_dims(*args)


def _cut(tree, path, leaf=None):
    """``tree`` with the scope at ``path`` removed, or its ``leaf`` array
    cut by one along its last axis."""
    out = dict(tree)
    node = out
    for key in path[:-1]:
        node[key] = dict(node[key])
        node = node[key]
    if leaf is None:
        del node[path[-1]]
    else:
        node[path[-1]] = {**node[path[-1]], leaf: node[path[-1]][leaf][..., :-1]}
    return out


@pytest.mark.parametrize("case,missing,extra,wrong", [
    ("ff-hourglass", ("Dense_6",), "Dense_7", (("Dense_0",), "bias")),
    ("lstm-model", ("OptimizedLSTMCell_1", "hi"), "RNN_0",
     (("OptimizedLSTMCell_2", "hg"), "kernel")),
], ids=["dense", "lstm"])
def test_params_from_flax_rejects_mismatched_tree(case, missing, extra, wrong):
    kind, kw = CASES[case]
    _, params = _flax_params(kind, kw, _inputs(kw))
    module = get_factory(kind)(**kw).module
    with pytest.raises(ValueError, match=f"no scope {missing[-1]!r}"):
        params_from_flax(module, _cut(params, missing))
    with pytest.raises(ValueError, match=f"unexpected flax scopes \\['{extra}'\\]"):
        params_from_flax(module, {**params, extra: params["Dense_0"]})
    path, leaf = wrong
    with pytest.raises(ValueError, match=f"{'/'.join(path)}/{leaf} has shape"):
        params_from_flax(module, _cut(params, path, leaf))
    with pytest.raises(TypeError, match="LSTMModule"):
        params_from_flax(torch.nn.Linear(2, 2), params)


ESTIMATORS = {
    "DenseAutoEncoder": dict(kind="feedforward_symmetric", dims=[8, 4]),
    "LSTMAutoEncoder": dict(kind="lstm_hourglass", lookback_window=6),
    "LSTMForecast": dict(kind="lstm_symmetric", lookback_window=6, dims=[8], horizon=3),
    "MultiStepForecast": dict(kind="lstm_symmetric", lookback_window=6, dims=[8], horizon=2),
}


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_estimator_predict_matches_reference(name):
    """Windowing contract, output alignment and (for the joint forecaster)
    the widened head, through ``set_state`` of the same state on both sides."""
    n_features, n_out = 5, 3
    X = np.random.default_rng(2).normal(size=(20, n_features)).astype(np.float32)
    ref_est = getattr(ref_models, name)(**ESTIMATORS[name])
    spec = ref_est._make_spec(n_features, n_out)
    sample = X[:1] if ref_est.lookahead is None else X[None, : ref_est.lookback_window]
    params = spec.module.init(jax.random.PRNGKey(3), sample)["params"]
    state = {"params": jax.tree_util.tree_map(np.asarray, dict(params)),
             "n_features": n_features, "n_features_out": n_out, "history": []}
    ref = ref_est.set_state(state).predict(X)
    ours = getattr(models, name)(**ESTIMATORS[name]).to("cpu").set_state(state)
    np.testing.assert_allclose(ours.predict(X), ref, atol=F32_ATOL, rtol=0)
    if name == "MultiStepForecast":
        assert ours.predict_steps(X).shape == (len(ref), 2, n_out)
        np.testing.assert_allclose(ours.predict_steps(X), ref_est.predict_steps(X),
                                   atol=F32_ATOL, rtol=0)
    assert ours.get_params() == ref_est.get_params()


def test_keras_aliases_are_the_zoo_classes():
    assert models.KerasAutoEncoder is models.DenseAutoEncoder
    assert models.KerasLSTMAutoEncoder is models.LSTMAutoEncoder
    assert models.KerasLSTMForecast is models.LSTMForecast


def test_detector_defaults_to_dense_autoencoder():
    from gordo_components_tpu.models.anomaly.diff import (
        DiffBasedAnomalyDetector as RefDetector,
    )

    from gordo_components_tpu_torch.models.anomaly.diff import DiffBasedAnomalyDetector

    ours, ref = DiffBasedAnomalyDetector().base_estimator, RefDetector().base_estimator
    assert type(ours).__name__ == type(ref).__name__ == "DenseAutoEncoder"
    assert ours.get_params() == ref.get_params()
