"""PatchTST of the PyTorch port against the flax module with the same params.

The params come from ``module.init`` (no training), pass through
``params_from_flax`` and both forwards see the same seeded windows. Run at
a window whose patch count fits one tile (P = 7: both sides take dense
attention) and at ``lookback_window=1040, patch_length=16, stride=8``
(P = 129: the reference runs its Pallas kernel in interpret mode, the port
its kernel's plain version). Tolerance atol 5e-5, the reference's own
flash-vs-dense bound for this module.
"""

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
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_factory("patchtst")(**_kwargs(64, attention_impl=impl))
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
