"""The port's precision ladder against the reference's ``precision`` module.

The quantizer must give the reference's bytes (a sidecar written by either
package serves the other), the parity ruler and budgets must agree, and an
int8 tree carried into the port's layout must dequantize to exactly the
parameters the dequantized flax tree loads: the same float32 multiply of
the same int8 value and scale, then only reshapes, transposes and
concatenations. Arrays come from seeded numpy.
"""

import json
import logging
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu import precision as ref_precision  # noqa: E402
from gordo_components_tpu.serializer import pipeline_from_definition as ref_from_definition  # noqa: E402
from gordo_components_tpu.serializer.persistence import (  # noqa: E402
    write_artifact_files as ref_write_artifact_files,
)
from gordo_components_tpu.server.engine import _sidecar_matches as ref_sidecar_matches  # noqa: E402
from gordo_components_tpu.store import commit_generation  # noqa: E402

from gordo_components_tpu_torch import precision  # noqa: E402
from gordo_components_tpu_torch.models.convert import (  # noqa: E402
    params_from_flax,
    quantized_params_from_flax,
)
from gordo_components_tpu_torch.models.register import get_factory  # noqa: E402
from gordo_components_tpu_torch.serializer import dump, load, write_artifact_files  # noqa: E402
from gordo_components_tpu_torch.server.engine import _sidecar_matches  # noqa: E402
from gordo_components_tpu_torch.store.manifest import MANIFEST_FILE  # noqa: E402

_RNG = np.random.default_rng(0)
ARRAYS = {
    "random": (_RNG.normal(size=(7, 5)) * 3).astype(np.float32),
    "wide-range": np.concatenate([_RNG.normal(size=40) * 1e-4, [250.0, -3.0]]).astype(np.float32),
    "all-zero": np.zeros((4, 3), np.float32),
    "single": np.asarray([-0.37], np.float32),
    "scalar": np.asarray(2.5, np.float32),
    "empty": np.zeros((0, 3), np.float32),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_quantize_array_int8_is_the_reference_bytes(name):
    q, scale = precision.quantize_array_int8(ARRAYS[name])
    ref_q, ref_scale = ref_precision.quantize_array_int8(ARRAYS[name])
    assert q.dtype == np.int8 and q.shape == ref_q.shape
    assert q.tobytes() == ref_q.tobytes()
    assert np.float32(scale).tobytes() == np.float32(ref_scale).tobytes()
    if name == "all-zero":
        assert scale == 1.0


@pytest.mark.parametrize("value", [None, "", "F32", " int8 ", "bf16", "fp16", "int4"])
def test_validate_and_of_metadata_follow_the_reference(value):
    try:
        expected = ref_precision.validate(value)
    except ValueError:
        with pytest.raises(ValueError, match="unknown precision"):
            precision.validate(value)
        return
    assert precision.validate(value) == expected
    assert precision.of_metadata({"precision": value}) == ref_precision.of_metadata(
        {"precision": value})
    assert precision.of_metadata({}) == "f32"


@pytest.mark.parametrize("env", [None, "0.5", "-1", "junk"])
@pytest.mark.parametrize("rung", ["f32", "bf16", "int8"])
def test_error_budget_and_its_env_override(rung, env, monkeypatch, caplog):
    for name in ("GORDO_PARITY_RTOL_BF16", "GORDO_PARITY_RTOL_INT8"):
        if env is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, env)
    with caplog.at_level(logging.WARNING):
        budget = precision.error_budget(rung)
    assert budget == ref_precision.error_budget(rung)
    if env is None:
        assert budget == {"f32": 0.0, "bf16": 0.02, "int8": 0.08}[rung]
    if env == "junk" and rung != "f32":
        assert "not a float" in caplog.text


@pytest.mark.parametrize("case", ["noise", "zero-reference", "shifted"])
def test_parity_error_is_the_reference_ruler(case):
    rng = np.random.default_rng(3)
    reference = np.abs(rng.normal(size=50)).astype(np.float32) + 1
    candidate = reference + rng.normal(scale=1e-2, size=50).astype(np.float32)
    if case == "zero-reference":
        reference = np.zeros(50, np.float32)
    if case == "shifted":
        candidate = reference + 0.5
    assert precision.parity_error(reference, candidate) == ref_precision.parity_error(
        reference, candidate)


def _tree(rng):
    return {"Dense_0": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                        "bias": np.zeros(3, np.float32)},
            "LayerNorm_0": {"scale": (1 + 0.1 * rng.normal(size=3)).astype(np.float32)},
            "pos_embedding": rng.normal(size=(5, 3)).astype(np.float32)}


def test_tree_quantize_and_dequantize_equal_the_reference():
    tree = _tree(np.random.default_rng(4))
    q, s = precision.quantize_tree_int8(tree)
    ref_q, ref_s = ref_precision.quantize_tree_int8(tree)
    flat = lambda t: jax.tree_util.tree_leaves(t)  # noqa: E731
    assert jax.tree_util.tree_structure(q) == jax.tree_util.tree_structure(ref_q)
    for a, b in zip(flat(q) + flat(s), flat(ref_q) + flat(ref_s)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    for a, b in zip(flat(precision.dequantize_tree_int8(q, s)),
                    flat(ref_precision.dequantize_tree_int8(ref_q, ref_s))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("change", ["same", "leaf-shape", "missing-leaf", "extra-scope"])
def test_sidecar_match_rule_is_the_reference_rule(change):
    params = _tree(np.random.default_rng(5))
    q, _ = precision.quantize_tree_int8(params)
    if change == "leaf-shape":
        q["Dense_0"]["kernel"] = np.zeros((4, 4), np.int8)
    elif change == "missing-leaf":
        del q["Dense_0"]["bias"]
    elif change == "extra-scope":
        q["Dense_9"] = {"kernel": np.zeros((1, 1), np.int8)}
    assert _sidecar_matches(q, params) == ref_sidecar_matches(q, params)
    assert _sidecar_matches(q, params) == (change == "same")


# -- artifacts ------------------------------------------------------------------
TAGS = [f"tag-{i}" for i in range(5)]
_DENSE = {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
    "regressor": {"Pipeline": {"steps": [
        "MinMaxScaler",
        {"DenseAutoEncoder": {"kind": "feedforward_hourglass", "epochs": 1, "batch_size": 16}},
    ]}},
    "transformer": "MinMaxScaler",
}}}}


@pytest.fixture(scope="module")
def ref_int8(tmp_path_factory):
    """A dense detector fitted by the reference and committed at int8 as a
    generation (``quant_int8.npz`` hashed by the manifest)."""
    X = (np.random.default_rng(6).normal(size=(60, len(TAGS))) * 3 + 5).astype(np.float32)
    model = ref_from_definition(_DENSE)
    model.fit(X, X)
    root = str(tmp_path_factory.mktemp("ref") / "m")
    metadata = {"dataset": {"tag_list": TAGS}, "precision": "int8"}
    gen = commit_generation(root, lambda staging: ref_write_artifact_files(
        model, staging, metadata=metadata, precision="int8"))
    return model, root, gen


def test_load_quantized_reads_the_reference_sidecar(ref_int8):
    _, _, gen = ref_int8
    ours = precision.load_quantized(gen)
    ref = ref_precision.load_quantized(gen)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(ref)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(ref)
    assert precision.load_quantized(os.path.dirname(gen)) is None  # the root holds none


def test_port_sidecar_is_the_reference_sidecar(ref_int8, tmp_path):
    """The port's ``quantized_arrays_for`` of the loaded model equals the
    reference's of the fitted one, and the port's writer produces the
    reference's ``quant_int8.npz`` byte for byte."""
    model, root, gen = ref_int8
    ported = load(root, device="cpu")
    ours = precision.quantized_arrays_for(ported)
    ref = ref_precision.quantized_arrays_for(model)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype and ours[key].tobytes() == ref[key].tobytes()
    write_artifact_files(ported, str(tmp_path), precision="int8")
    with open(os.path.join(gen, precision.QUANT_INT8_FILE), "rb") as fh:
        expected = fh.read()
    assert (tmp_path / precision.QUANT_INT8_FILE).read_bytes() == expected
    assert precision.quantized_arrays_for(object()) is None


@pytest.mark.parametrize("rung", [None, "f32", "bf16", "int8"])
def test_dump_writes_the_sidecar_only_at_int8_and_the_manifest_hashes_it(ref_int8, tmp_path, rung):
    _, root, _ = ref_int8
    dest = dump(load(root, device="cpu"), str(tmp_path / "m"), precision=rung)
    manifest = json.loads(open(os.path.join(dest, MANIFEST_FILE)).read())
    assert (precision.QUANT_INT8_FILE in manifest["files"]) == (rung == "int8")
    if rung == "int8":  # and the reference reads the port's sidecar
        ours = ref_precision.load_quantized(dest)
        ref = ref_precision.load_quantized(ref_int8[2])
        for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(ref)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# -- the port's layout ------------------------------------------------------------
def _flax_tree(module_kind, rng):
    """A random flax tree for a small module of each loader, and the
    module's factory."""
    if module_kind == "dense":
        make = lambda: get_factory("feedforward_symmetric")(n_features=5, dims=(4, 3)).module  # noqa: E731
        dims = [5, 4, 3, 3, 4, 5]
        tree = {f"Dense_{i}": {"kernel": rng.normal(size=(a, b)).astype(np.float32),
                               "bias": rng.normal(size=b).astype(np.float32)}
                for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    elif module_kind == "lstm":
        make = lambda: get_factory("lstm_symmetric")(  # noqa: E731
            n_features=5, dims=(6,), lookback_window=4).module
        tree = {}
        for i, (n_in, units) in enumerate([(5, 6), (6, 6)]):
            cell = {}
            for k, gate in enumerate("ifgo"):
                # gate peaks 100x apart: one shared scale would crush the
                # small gates to a few levels
                peak = 10.0 ** (2 * (k % 2))
                cell[f"i{gate}"] = {"kernel": (peak * rng.normal(size=(n_in, units))).astype(np.float32)}
                cell[f"h{gate}"] = {"kernel": (peak * rng.normal(size=(units, units))).astype(np.float32),
                                    "bias": (peak * rng.normal(size=units)).astype(np.float32)}
            tree[f"OptimizedLSTMCell_{i}"] = cell
        tree["Dense_0"] = {"kernel": rng.normal(size=(6, 5)).astype(np.float32),
                           "bias": rng.normal(size=5).astype(np.float32)}
    else:
        make = lambda: get_factory("patchtst")(  # noqa: E731
            n_features=2, lookback_window=12, patch_length=4, stride=2, d_model=8, n_heads=2,
            n_layers=1, ff_dim=16).module
        from gordo_components_tpu.models.register import get_factory as ref_factory

        spec = ref_factory("patchtst")(n_features=2, lookback_window=12, patch_length=4,
                                       stride=2, d_model=8, n_heads=2, n_layers=1, ff_dim=16)
        params = spec.module.init(jax.random.PRNGKey(1), np.zeros((1, 12, 2), np.float32),
                                  deterministic=True)["params"]
        tree = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + rng.normal(size=np.shape(a)).astype(np.float32),
            dict(params))
    return make, tree


@pytest.mark.parametrize("kind", ["dense", "lstm", "patchtst"])
def test_quantized_layout_dequantizes_to_the_reference_parameters(kind):
    make, tree = _flax_tree(kind, np.random.default_rng(7))
    q_tree, s_tree = ref_precision.quantize_tree_int8(tree)
    q_state, s_state = quantized_params_from_flax(make, q_tree, s_tree)
    expected = params_from_flax(make(), ref_precision.dequantize_tree_int8(q_tree, s_tree))
    for name, value in expected.state_dict().items():
        assert q_state[name].dtype == torch.int8
        got = q_state[name].to(torch.float32) * s_state[name]
        assert got.shape == value.shape
        assert torch.equal(got, value), name  # bit for bit
        assert s_state[name].dim() <= 1
    if kind == "lstm":
        # a scale per gate along the concatenated axis, four distinct ones
        scale = s_state["cells.0.input_kernel"]
        assert scale.shape == (24,)
        assert len(set(scale.tolist())) == 4
        # one scale shared over the concatenated kernel is not the reference
        f32 = params_from_flax(make(), tree).state_dict()["cells.0.input_kernel"]
        q, shared = precision.quantize_array_int8(f32.numpy())
        assert not np.array_equal(q.astype(np.float32) * shared,
                                  expected.state_dict()["cells.0.input_kernel"].numpy())
    else:
        assert all(s.dim() == 0 for s in s_state.values())
