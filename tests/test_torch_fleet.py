"""The port's stacked fleet program (``gordo_components_tpu_torch.parallel.
fleet``) against the JAX package's, on the CPU.

The same seeded numpy inputs go through both sides:

- the masked statistics: ``_masked_minmax``, ``_masked_standard``,
  ``_fit_scaler``, ``_masked_metrics`` and ``timeseries_fold_masks`` over
  a stack of machines with padding rows at the front, the back and inside,
  and one all-padding machine, against the reference's functions under
  ``jax.vmap`` (float32 sums in other orders: rtol 1e-5, atol 1e-6), and
  the fold masks against sklearn's ``TimeSeriesSplit`` (exact);
- ``train_fleet_arrays`` for a dense bucket, an LSTM bucket (windows
  gathered per batch from the row stack) and a tiny PatchTST at 129
  patches on the port's flash path (its plain version here), with
  ``cv_parallel`` true and false and ``n_splits`` 0, from the reference's
  initial parameters and permutations, injected (``module.init`` with
  each machine's init key, the permutations its fit and fold keys draw).
  Loss histories within rtol 1e-5 and final parameters within atol 2e-5
  (the one-fit bounds of tests/test_torch_train.py); scalers, error scalers, thresholds and CV
  scores within rtol 1e-4. The PatchTST reference runs its dense
  attention, the Pallas kernel's plain reference (the reference's own
  ``tests/test_transformer.py`` holds its flash and dense fleet fits to
  each other): its losses within rtol 1e-4;
- stacking is exact: the port's stack of M machines (one of them all
  padding) equals each machine fitted alone at M = 1 from the same
  parameters and permutations, and the padding machine ends untouched:
  identity scalers, zero thresholds, its initial parameters;
- dropout under the stacked ``vmap``: every fit draws its own mask, at the
  configured rate.
"""

import copy
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sklearn.model_selection import TimeSeriesSplit  # noqa: E402

from gordo_components_tpu.models.analysis import analyze_model as ref_analyze  # noqa: E402
from gordo_components_tpu.parallel import fleet as ref_fleet  # noqa: E402
from gordo_components_tpu.serializer import (  # noqa: E402
    pipeline_from_definition as ref_from_definition,
)

from gordo_components_tpu_torch.models.analysis import analyze_model  # noqa: E402
from gordo_components_tpu_torch.models.convert import (  # noqa: E402
    flax_from_params,
    params_from_flax,
)
from gordo_components_tpu_torch.models.modules import KeyStream, dropout  # noqa: E402
from gordo_components_tpu_torch.parallel import fleet  # noqa: E402
from gordo_components_tpu_torch.serializer import pipeline_from_definition  # noqa: E402

# the packages export a function named build_fleet over the module's name
ref_build = importlib.import_module("gordo_components_tpu.parallel.build_fleet")
port_build = importlib.import_module("gordo_components_tpu_torch.parallel.build_fleet")

RTOL = 1e-5
ATOL = 1e-6
PARAMS_ATOL = 2e-5
RESULT_RTOL = 1e-4


def _weights(n_machines, n_rows):
    """Row weights with padding at the front (machine 0), the back (1),
    inside (2), everywhere (3, all padding) and nowhere (the rest)."""
    w = np.ones((n_machines, n_rows), np.float32)
    w[0, :7] = 0
    w[1, -5:] = 0
    w[2, 10:16] = 0
    w[3] = 0
    return w


def _stack(rng, n_machines=5, n_rows=40, cols=3):
    X = (rng.normal(size=(n_machines, n_rows, cols)) * [1.0, 5.0, 0.01]).astype(np.float32)
    X[:, :, 2] += 3.0
    X[4, :, 1] = 2.5  # a constant column: zero span / zero variance
    return X, _weights(n_machines, n_rows)


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind,options,feature_range", [
    ("minmax", (True, True), (0.0, 1.0)),
    ("minmax", (True, True), (-1.0, 2.0)),
    ("standard", (True, True), (0.0, 1.0)),
    ("standard", (False, True), (0.0, 1.0)),
    ("standard", (True, False), (0.0, 1.0)),
    ("none", (True, True), (0.0, 1.0)),
])
def test_masked_scalers_match_reference(kind, options, feature_range):
    X, w = _stack(np.random.default_rng(1))
    ref = jax.vmap(lambda x, wt: ref_fleet._fit_scaler(kind, options, feature_range, x, wt))(X, w)
    ours = fleet._fit_scaler(kind, options, feature_range, torch.from_numpy(X),
                             torch.from_numpy(w))
    _close(ours.scale, ref.scale)
    _close(ours.offset, ref.offset)
    if kind == "minmax":  # the all-padding machine: the identity's span
        _close(ours.scale[3], np.full(3, feature_range[1] - feature_range[0]))
        _close(ours.offset[3], np.full(3, feature_range[0]))


def test_masked_metrics_match_reference():
    rng = np.random.default_rng(2)
    y, w = _stack(rng)
    pred = y + rng.normal(size=y.shape).astype(np.float32) * 0.3
    pred[4, :, 1] = 2.5  # a constant column predicted exactly
    ref = np.asarray(jax.vmap(ref_fleet._masked_metrics)(y, pred, w))
    ours = fleet._masked_metrics(*(torch.from_numpy(a) for a in (y, pred, w))).numpy()
    assert np.isnan(ours[3]).all() and np.isnan(ref[3]).all()  # an empty fold: missing
    _close(ours, ref, rtol=1e-5, atol=1e-5)
    assert ours.shape == (5, len(fleet.FLEET_CV_METRICS))
    assert fleet.FLEET_CV_METRICS == ref_fleet.FLEET_CV_METRICS


@pytest.mark.parametrize("n_splits", [1, 2, 3, 5])
def test_fold_masks_match_reference_and_sklearn(n_splits):
    _, w = _stack(np.random.default_rng(3))
    w = np.concatenate([w, np.zeros((1, w.shape[1]), np.float32)])
    w[5, -4:] = 1  # a machine too short for most splits
    ours = fleet.timeseries_fold_masks(torch.from_numpy(w), n_splits)
    ref = jax.vmap(lambda wt: ref_fleet.timeseries_fold_masks(wt, n_splits))(w)
    assert len(ours) == len(ref) == n_splits
    for (train, test), (ref_train, ref_test) in zip(ours, ref):
        np.testing.assert_array_equal(train.numpy(), np.asarray(ref_train))
        np.testing.assert_array_equal(test.numpy(), np.asarray(ref_test))
    for m in range(len(w) if n_splits > 1 else 0):  # sklearn takes 2 splits or more
        real = np.flatnonzero(w[m] > 0)
        if len(real) < n_splits + 1:  # sklearn refuses; no fold tests anything
            assert all(test[m].sum() == 0 for _, test in ours)
            continue
        for (train, test), (tr, te) in zip(ours, TimeSeriesSplit(n_splits).split(real)):
            np.testing.assert_array_equal(np.flatnonzero(train[m].numpy()), real[tr])
            np.testing.assert_array_equal(np.flatnonzero(test[m].numpy()), real[te])


def _detector(estimator, kwargs):
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {estimator: kwargs}]}},
        "transformer": "MinMaxScaler"}}}}


def _ref_perms(key, epochs, n):
    """The permutations the reference's fit draws from ``key``."""
    perms = []
    for epoch_key in jax.random.split(key, epochs):
        perm_key, _ = jax.random.split(epoch_key)
        perms.append(np.asarray(jax.random.permutation(perm_key, n)))
    return perms


def _specs(config, n_features, n_splits, cv_parallel, ref_config=None):
    ref_spec = ref_build._spec_for(ref_analyze(ref_from_definition(ref_config or config)),
                                   n_features, n_features, n_splits, cv_parallel=cv_parallel)
    spec = port_build._spec_for(analyze_model(pipeline_from_definition(config)),
                                n_features, n_features, n_splits, cv_parallel=cv_parallel)
    return ref_spec, spec


def _reference_draws(ref_spec, spec, keys, n_rows, n_features):
    """The reference's initial parameters (in the port's layout, stacked)
    and permutations ``[m][fit][epoch]`` for each machine's key."""
    L, la = ref_spec.lookback_window, ref_spec.lookahead
    n_samples = n_rows if la is None else n_rows - L + 1 - la
    padded = -(-n_samples // spec.batch_size) * spec.batch_size
    sample = jnp.zeros((1, n_features) if la is None else (1, L, n_features), jnp.float32)
    params0, perms = [], []
    K = ref_spec.n_splits
    for key in keys:
        split = jax.random.split(key, K + 2)
        tree = ref_spec.module.init(split[0], sample, deterministic=True)["params"]
        module = params_from_flax(copy.deepcopy(spec.module),
                                  jax.tree_util.tree_map(np.asarray, tree))
        params0.append({n: p.detach() for n, p in module.named_parameters()})
        perms.append([_ref_perms(split[2 + j], ref_spec.epochs, padded) for j in range(K)]
                     + [_ref_perms(split[1], ref_spec.epochs, padded)])
    return {n: torch.stack([p[n] for p in params0]) for n in params0[0]}, perms


def _flax_of(spec, params, m):
    module = copy.deepcopy(spec.module)
    module.load_state_dict({n: v[m] for n, v in params.items()})
    return flax_from_params(module)


FLEET_CASES = {
    # name: (estimator, kwargs, tags, rows, machines, n_splits, cv_parallel)
    "dense-cv-parallel": ("DenseAutoEncoder", dict(kind="feedforward_hourglass", batch_size=16,
                                                   epochs=2), 5, 70, 4, 2, True),
    "dense-cv-sequential": ("DenseAutoEncoder", dict(kind="feedforward_hourglass",
                                                     batch_size=16, epochs=2), 5, 70, 4, 2, False),
    "dense-no-cv": ("DenseAutoEncoder", dict(kind="feedforward_symmetric", dims=[4, 3],
                                             batch_size=16, epochs=2), 5, 70, 3, 0, True),
    "lstm-cv-parallel": ("LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[5],
                                                 lookback_window=6, batch_size=8, epochs=2),
                         4, 50, 3, 2, True),
    "lstm-cv-sequential": ("LSTMForecast", dict(kind="lstm_symmetric", dims=[5],
                                                lookback_window=6, batch_size=8, epochs=2),
                           4, 50, 3, 1, False),
}


def _run_both(estimator, kwargs, tags, n_rows, n_machines, n_splits, cv_parallel, seed,
              ref_kwargs=None):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n_machines, n_rows, tags)) * 2 + 1).astype(np.float32)
    X += np.linspace(0, 3, n_rows, dtype=np.float32)[None, :, None]
    w = np.ones((n_machines, n_rows), np.float32)
    w[0, :9] = 0  # a machine with a shorter history, left-padded
    config = _detector(estimator, kwargs)
    ref_config = _detector(estimator, ref_kwargs) if ref_kwargs else None
    ref_spec, spec = _specs(config, tags, n_splits, cv_parallel, ref_config)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_machines)
    ref = jax.tree_util.tree_map(
        np.asarray, ref_fleet.train_fleet_arrays(ref_spec, ref_fleet.MachineBatch(X, X, w, keys)))
    params0, perms = _reference_draws(ref_spec, spec, keys, n_rows, tags)
    ours = fleet.train_fleet_arrays(spec, fleet.MachineBatch(X, X, w, np.arange(n_machines)),
                                    device="cpu", params0=params0, perms=perms)
    return ref, ours, spec


def _assert_results(ref, ours, loss_rtol):
    _close(ours.loss_history, ref.loss_history, rtol=loss_rtol, atol=0)
    for a, b in ((ours.input_scaler, ref.input_scaler), (ours.target_scaler, ref.target_scaler),
                 (ours.error_scaler, ref.error_scaler)):
        _close(a.scale, b.scale, rtol=RESULT_RTOL, atol=ATOL)
        _close(a.offset, b.offset, rtol=RESULT_RTOL, atol=1e-5)
    _close(ours.tag_thresholds, ref.tag_thresholds, rtol=RESULT_RTOL, atol=ATOL)
    _close(ours.total_threshold, ref.total_threshold, rtol=RESULT_RTOL, atol=ATOL)
    assert ours.cv_scores.shape == ref.cv_scores.shape
    _close(ours.cv_scores, ref.cv_scores, rtol=RESULT_RTOL, atol=1e-5)


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_train_fleet_arrays_matches_reference(case):
    estimator, kwargs, tags, n_rows, n_machines, n_splits, cv_parallel = FLEET_CASES[case]
    ref, ours, spec = _run_both(estimator, kwargs, tags, n_rows, n_machines, n_splits,
                                cv_parallel, seed=len(case))
    assert spec.cv_parallel == cv_parallel and spec.n_splits == n_splits
    _assert_results(ref, ours, RTOL)
    for m in range(n_machines):
        theirs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: a[m], ref.params))
        mine = jax.tree_util.tree_leaves(_flax_of(spec, ours.params, m))
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a, b, atol=PARAMS_ATOL)


@pytest.mark.parametrize("cv_parallel", [True, False])
def test_train_fleet_arrays_flash_patchtst_matches_reference(cv_parallel):
    """129 patches: the port's flash_attention takes the flash path (the
    operator's plain version here, under the stack's vmap) and not its
    one-tile dense shortcut; the reference runs dense attention."""
    kwargs = dict(kind="patchtst", lookback_window=1040, patch_length=16, stride=8,
                  d_model=16, n_heads=2, n_layers=1, ff_dim=16, batch_size=16, epochs=1,
                  attention_impl="flash")
    ref, ours, spec = _run_both("PatchTSTAutoEncoder", kwargs, 3, 1100, 2, 1, cv_parallel,
                                seed=9, ref_kwargs={**kwargs, "attention_impl": "dense"})
    assert spec.module.layers[0].attn.attention_impl == "flash"
    assert spec.module.n_patches == 129
    _assert_results(ref, ours, RESULT_RTOL)


def _tiny_bucket(rng, n_machines, n_rows=60, tags=4):
    X = (rng.normal(size=(n_machines, n_rows, tags)) + 2).astype(np.float32)
    w = np.ones((n_machines, n_rows), np.float32)
    w[0, :11] = 0
    w[-1] = 0  # a padding machine
    X[-1] = 0
    return X, w


@pytest.mark.parametrize("cv_parallel", [True, False])
def test_stacked_fit_equals_each_machine_alone(cv_parallel):
    config = _detector("LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[4],
                                               lookback_window=5, batch_size=8, epochs=2))
    spec = port_build._spec_for(analyze_model(pipeline_from_definition(config)), 4, 4, 2,
                                cv_parallel=cv_parallel)
    X, w = _tiny_bucket(np.random.default_rng(4), 3)
    keys = np.array([11, 12, 13])
    params0 = fleet.initial_params(spec.module, keys)
    stacked = fleet.train_fleet_arrays(spec, fleet.MachineBatch(X, X, w, keys), device="cpu",
                                       params0=params0)
    for m in range(3):
        alone = fleet.train_fleet_arrays(
            spec, fleet.MachineBatch(X[m:m + 1], X[m:m + 1], w[m:m + 1], keys[m:m + 1]),
            device="cpu", params0={n: v[m:m + 1] for n, v in params0.items()})
        for field in ("loss_history", "tag_thresholds", "total_threshold", "cv_scores"):
            _close(getattr(stacked, field)[m:m + 1], getattr(alone, field), rtol=1e-5,
                   atol=1e-6)
        for a, b in zip((stacked.error_scaler, stacked.input_scaler),
                        (alone.error_scaler, alone.input_scaler)):
            _close(a.scale[m:m + 1], b.scale, rtol=1e-5, atol=1e-6)
            _close(a.offset[m:m + 1], b.offset, rtol=1e-5, atol=1e-6)
        for name, value in stacked.params.items():
            _close(value[m:m + 1], alone.params[name], rtol=1e-5, atol=1e-6)
    # the padding machine: untouched parameters, identity scalers, zero thresholds
    for name, value in stacked.params.items():
        np.testing.assert_array_equal(value[2].numpy(), params0[name][2].numpy())
    np.testing.assert_array_equal(stacked.input_scaler.scale[2].numpy(), np.ones(4))
    np.testing.assert_array_equal(stacked.input_scaler.offset[2].numpy(), np.zeros(4))
    np.testing.assert_array_equal(stacked.error_scaler.scale[2].numpy(), np.ones(4))
    np.testing.assert_array_equal(stacked.tag_thresholds[2].numpy(), np.zeros(4))
    assert float(stacked.total_threshold[2]) == 0.0
    assert float(stacked.loss_history[2].abs().max()) == 0.0
    assert torch.isnan(stacked.cv_scores[2]).all()


def test_key_stream_masks_are_per_fit_at_the_rate():
    """Under vmap every key draws its own mask; the same key draws the same
    mask again; the kept share is 1 - rate."""
    rate = 0.3
    keys = torch.tensor([5, 6, 7, 5])
    x = torch.ones(4, 64, 128)

    def masked(x, key):
        return dropout(x, rate, KeyStream(key))

    out = torch.func.vmap(masked)(x, keys)
    kept = out != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.01
    np.testing.assert_allclose(out[kept].numpy(), 1 / (1 - rate), rtol=1e-6)
    assert torch.equal(kept[0], kept[3])
    for a, b in ((0, 1), (0, 2), (1, 2)):
        agree = (kept[a] == kept[b]).float().mean().item()
        expected = (1 - rate) ** 2 + rate ** 2  # independent masks
        assert abs(agree - expected) < 0.015
    stream = KeyStream(torch.tensor(9))
    first, second = stream.keep((1000,), rate, "cpu"), stream.keep((1000,), rate, "cpu")
    assert not torch.equal(first, second)  # successive draws differ
    assert torch.equal(stream.replay().keep((1000,), rate, "cpu"), first)


def test_dropout_fleet_draws_independent_masks_per_machine():
    """Two machines with the same rows and initial parameters but other
    keys train apart under dropout; the same key trains alike."""
    config = _detector("LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[6], dropout=0.5,
                                               lookback_window=4, batch_size=8, epochs=2))
    spec = port_build._spec_for(analyze_model(pipeline_from_definition(config)), 3, 3, 0)
    assert spec.use_dropout
    rng = np.random.default_rng(5)
    X = np.repeat(rng.normal(size=(1, 40, 3)).astype(np.float32), 3, axis=0)
    w = np.ones((3, 40), np.float32)
    params0 = fleet.initial_params(spec.module, [1])
    params0 = {n: v.expand(3, *v.shape[1:]) for n, v in params0.items()}
    result = fleet.train_fleet_arrays(spec, fleet.MachineBatch(X, X, w, np.array([1, 2, 1])),
                                      device="cpu", params0=params0)
    hist = result.loss_history.numpy()
    np.testing.assert_array_equal(hist[0], hist[2])
    assert np.abs(hist[0] - hist[1]).max() > 1e-6


def test_spec_derivation_matches_reference():
    for config in (
        _detector("DenseAutoEncoder", {"kind": "feedforward_hourglass"}),
        _detector("PatchTSTAutoEncoder", {"kind": "patchtst", "lookback_window": 32,
                                          "remat": True}),
        {"Pipeline": {"steps": [{"StandardScaler": {"with_mean": False}},
                                {"LSTMForecast": {"kind": "lstm_symmetric",
                                                  "lookback_window": 4}}]}},
    ):
        assert port_build._derived_cv_parallel(config) == ref_build._derived_cv_parallel(config)
        ref_spec, spec = _specs(config, 3, 2, None)
        for field in fleet.FleetSpec._fields:
            if field not in ("module", "optimizer"):
                assert getattr(spec, field) == getattr(ref_spec, field), field


def test_spec_refuses_what_the_fleet_cannot_build():
    joint = _detector("MultiStepForecast", {"kind": "lstm_symmetric", "lookback_window": 4})
    with pytest.raises(ValueError, match="joint horizon"):
        port_build._spec_for(analyze_model(pipeline_from_definition(joint)), 3, 3, 1)
    standard = {"DiffBasedAnomalyDetector": {
        "base_estimator": {"DenseAutoEncoder": {"kind": "feedforward_hourglass"}},
        "scaler": "StandardScaler"}}
    with pytest.raises(ValueError, match="MinMaxScaler anomaly error scaler"):
        port_build._spec_for(analyze_model(pipeline_from_definition(standard)), 3, 3, 1)
    short = _detector("LSTMAutoEncoder", {"kind": "lstm_symmetric", "lookback_window": 8,
                                          "batch_size": 32})
    spec = port_build._spec_for(analyze_model(pipeline_from_definition(short)), 2, 2, 0)
    X = np.zeros((1, 20, 2), np.float32)
    with pytest.raises(ValueError, match="batch_size"):
        fleet.train_fleet_arrays(spec, fleet.MachineBatch(X, X, np.ones((1, 20)), [0]),
                                 device="cpu")
