"""PatchTST of the PyTorch port against the flax module with the same params.

The params come from ``module.init`` (no training), pass through
``params_from_flax`` and both forwards see the same seeded windows. Run at
a window whose patch count fits one tile (P = 7: both sides take dense
attention) and at ``lookback_window=1040, patch_length=16, stride=8``
(P = 129: the reference runs its Pallas kernel in interpret mode, the port
its kernel's plain version). Tolerance atol 5e-5, the reference's own
flash-vs-dense bound for this module.

In bf16 compute, the outputs are held to 8 bf16 units in the last place of
the largest output (as ``tests/test_torch_zoo.py`` holds the zoo): every
Dense rounds its product and then its bias add, as flax's does, and flax's
gelu, XLA's tanh-form polynomial rounded after each operation, differs
from PyTorch's by an ulp here and there. One Dense alone must match flax's
at all but a few outputs, and a lone bf16 request must equal the same
request fused with another machine's in one stacked dispatch.
"""

import math


import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.models.register import get_factory as ref_factory  # noqa: E402

from gordo_components_tpu_torch.models.convert import params_from_flax  # noqa: E402
from gordo_components_tpu_torch.models.register import get_factory  # noqa: E402


def _kwargs(lookback, **extra):
    base = dict(n_features=3, lookback_window=lookback, patch_length=16, stride=8,
                d_model=16, n_heads=2, n_layers=2, attention_impl="flash")
    return {**base, **extra}


@pytest.mark.parametrize(
    "lookback,extra",
    [(64, {}), (64, {"n_features_out": 2, "out_func": "tanh"}), (1040, {"n_layers": 1})],
    ids=["one-tile", "target-head", "P129-kernel"],
)
def test_forward_matches_flax(lookback, extra):
    kw = _kwargs(lookback, **extra)
    x = np.random.default_rng(1).normal(size=(1, lookback, 3)).astype(np.float32)
    # init through the dense spec (same param tree) so the interpret-mode
    # kernel runs once, in the compared apply
    init_spec = ref_factory("patchtst")(**{**kw, "attention_impl": "dense"})
    params = init_spec.module.init(jax.random.PRNGKey(0), x, deterministic=True)["params"]
    ref = ref_factory("patchtst")(**kw).module.apply({"params": params}, x, deterministic=True)
    spec = get_factory("patchtst")(**kw)
    module = params_from_flax(spec.module, jax.tree_util.tree_map(np.asarray, params))
    assert spec.module.n_patches == (lookback - 16) // 8 + 1
    with torch.no_grad():
        ours = module(torch.from_numpy(x))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-5)


def test_factory_validation_matches_reference():
    for bad in (dict(lookback_window=8), dict(d_model=15), dict(attention_impl="nope"),
                dict(frobnicate=1)):
        kw = {**_kwargs(64), **bad}
        with pytest.raises(ValueError):
            get_factory("patchtst")(**kw)
        with pytest.raises(ValueError):
            ref_factory("patchtst")(**kw)
    for impl in ("ring", "ring_flash"):
        # 8 patches: the reference's ring spans this suite's 8 CPU devices,
        # the port's one rank (no ring group set)
        built = get_factory("patchtst")(**_kwargs(72, attention_impl=impl))
        assert built.config == ref_factory("patchtst")(**_kwargs(72, attention_impl=impl)).config
        assert {layer.attn.attention_impl for layer in built.module.layers} == {impl}
    ours = get_factory("patchtst")(**_kwargs(64))
    ref = ref_factory("patchtst")(**_kwargs(64))
    assert ours.config == ref.config and ours.input_kind == ref.input_kind


def test_params_from_flax_rejects_mismatched_tree():
    spec = get_factory("patchtst")(**_kwargs(64))
    x = np.zeros((1, 64, 3), np.float32)
    params = ref_factory("patchtst")(**_kwargs(64)).module.init(
        jax.random.PRNGKey(0), x, deterministic=True)["params"]
    tree = jax.tree_util.tree_map(np.asarray, dict(params))
    narrow = {**tree, "pos_embedding": tree["pos_embedding"][:, :8]}
    with pytest.raises(ValueError, match="shape"):
        params_from_flax(spec.module, narrow)
    del tree["Dense_1"]
    with pytest.raises(ValueError, match="Dense_1"):
        params_from_flax(spec.module, tree)
    with pytest.raises(ValueError, match="unexpected"):
        params_from_flax(spec.module, {**params, "Dense_1": params["Dense_1"], "extra": {}})


BF16_ULPS = 8


def _bf16_ulp_bound(ref):
    return BF16_ULPS * math.ldexp(1.0, math.frexp(float(np.abs(ref).max()))[1] - 8)


@pytest.mark.parametrize(
    "lookback,extra",
    [(64, {}), (64, {"n_features_out": 2, "out_func": "tanh"}), (1040, {"n_layers": 1})],
    ids=["one-tile", "target-head", "P129-kernel"],
)
def test_bf16_forward_matches_flax(lookback, extra):
    kw = _kwargs(lookback, compute_dtype="bfloat16", **extra)
    x = np.random.default_rng(2).normal(size=(2, lookback, 3)).astype(np.float32)
    init_spec = ref_factory("patchtst")(**{**kw, "attention_impl": "dense"})
    params = init_spec.module.init(jax.random.PRNGKey(1), x, deterministic=True)["params"]
    ref = np.asarray(
        ref_factory("patchtst")(**kw).module.apply({"params": params}, x, deterministic=True))
    module = params_from_flax(get_factory("patchtst")(**kw).module,
                              jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        ours = module(torch.from_numpy(x)).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=_bf16_ulp_bound(ref), rtol=0)


def test_bf16_dense_rounds_like_flax():
    """A bf16 Dense of the PatchTST module (product rounded, then the bias
    add rounded) against flax's ``nn.Dense(dtype=bfloat16)`` on 256 x 512
    inputs: equal at all but a handful of 131,072 outputs (a fused bias
    rounds once and differs at about a quarter of them), never by more
    than one ulp."""
    import flax.linen as fnn
    import jax.numpy as jnp

    from gordo_components_tpu_torch.models.factories import transformer

    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 512)).astype(np.float32)
    layer = fnn.Dense(256, dtype=jnp.bfloat16)
    params = layer.init(jax.random.PRNGKey(0), x)["params"]
    params = {"kernel": params["kernel"],
              "bias": jnp.asarray(rng.normal(size=256).astype(np.float32))}
    ref = np.asarray(layer.apply({"params": params}, jnp.asarray(x, jnp.bfloat16)), np.float32)
    linear = torch.nn.Linear(512, 256)
    with torch.no_grad():
        linear.weight.copy_(torch.from_numpy(np.array(params["kernel"]).T))
        linear.bias.copy_(torch.from_numpy(np.array(params["bias"])))
        ours = transformer.linear(torch.from_numpy(x).to(torch.bfloat16), linear).float().numpy()
    differ = ours != ref
    assert differ.sum() <= 64, differ.sum()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert (np.abs(ours - ref) <= ulp)[differ].all()


def test_bf16_lone_request_equals_fused_dispatch(tmp_path):
    """Two bf16 PatchTST machines of one architecture, trained and dumped by
    the port, in one engine bucket: machine a's request alone (one
    unbatched dispatch) equals the same request fused with machine b's in
    one stacked dispatch, to the bit."""
    from gordo_components_tpu_torch.builder.build_model import _build_from_rows
    from gordo_components_tpu_torch.serializer import dump, load
    from gordo_components_tpu_torch.server.engine import ServingEngine, _Item

    config = {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {"PatchTSTAutoEncoder": dict(
            lookback_window=24, patch_length=8, stride=4, d_model=16, n_heads=2, n_layers=1,
            compute_dtype="bfloat16", batch_size=16)}]}},
        "transformer": "MinMaxScaler"}}}}
    models = {}
    for seed, name in enumerate(("a", "b")):
        X = (np.random.default_rng(seed).normal(size=(120, 3)) * 2 + 4).astype(np.float32)
        model, _ = _build_from_rows(name, config, X, device="cpu",
                                    evaluation_config={"cv_mode": "build_only"})
        model.scaler.fit(np.abs(X[23:] - model.predict(X)))
        dump(model, str(tmp_path / name), metadata={"dataset": {"tag_list": ["x", "y", "z"]}})
        models[name] = load(str(tmp_path / name), device="cpu")
    engine = ServingEngine(models, device="cpu")
    X = (np.random.default_rng(7).normal(size=(60, 3)) * 2 + 4).astype(np.float32)
    lone = engine.anomaly("a", X)
    bucket, _ = engine._by_name["a"]
    assert sorted(bucket.names) == ["a", "b"]
    items = []
    for name in ("a", "b"):
        x, m_valid = engine._prepare(bucket, X)
        items.append(_Item(engine._by_name[name][1], x, m_valid))
    bucket._dispatch(items[0].x.shape[0], items, defer=False)
    assert items[0].done.wait(30) and items[0].error is None and bucket.max_batch_seen == 2
    for field, a, b in zip(("output", "tag", "total"), lone[1:], items[0].result[1:]):
        np.testing.assert_array_equal(a, b, err_msg=field)
    engine.close()
