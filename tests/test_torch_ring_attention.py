"""Ring and ``ring_flash`` attention of the PyTorch port against the JAX
package's ``ring_attention`` on the CPU.

The reference runs on the 8-device CPU mesh of ``tests/conftest.py``
(``fleet_mesh(8, axis_name="seq")``, its flash hops in interpret mode);
the port runs at one rank in this process and over gloo at 2 and 4 ranks
in processes of this file (one spawn per world size runs every check of
that size; rendezvous through a ``file://`` store). Inputs are made from a
numpy seed and are the same everywhere.

- ring parity: the forward on ``(2, 64, 4, 16)`` within 2e-5 of the
  reference's, and dq, dk, dv of Σout² within 2e-5 (``ring``) and 1e-5
  (``ring_flash``) of ``jax.grad``'s, the bounds of the reference's own
  ring tests; every rank returns the same output and gradients;
- the reference's two ``ValueError``s (an unknown ``block_impl``; a
  sequence that does not divide over the ranks), the factory's
  divisibility error against the ring group's size, and a clear error for
  the ring across ranks under ``torch.func.vmap``;
- PatchTST (lookback 64, patch 8, stride 8: 8 patches, d_model 16, 2
  heads, 1 layer, params through ``params_from_flax``): the outputs within
  5e-5 (the flash module's bound in ``tests/test_torch_patchtst.py``), and
  the loss (rtol 1e-5) and gradients (atol 2e-5) of one step of mean(out²);
  at one rank the module also passes ``torch.func.vmap``;
- a reference-built ``ring_flash`` artifact (fitted at ``dense``, whose
  parameter tree is the same, then switched to ``ring_flash`` and dumped by
  the reference) is served by the port's engine as the reference's host
  path (``model.anomaly``) answers, atol 1e-4 (the reference's predict pads
  to 256 windows, each a sequence of its interpret-mode kernel on the CPU:
  here its bucket floor is 8, which changes no answered row);
- ``flash_dtype()`` reports ``ring_flash`` at any patch count.

This file is also the rank process: ``python tests/test_torch_ring_attention.py
--rank R --world W --init FILE --inputs NPZ --out DIR`` imports no jax.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SHAPE = (2, 64, 4, 16)
PATCHTST = dict(n_features=3, lookback_window=64, patch_length=8, stride=8, d_model=16,
                n_heads=2, n_layers=1)
UNEVEN_LOOKBACK = 72  # 9 patches: divide over neither 2, 4 nor 8
FWD_ATOL = 2e-5
GRAD_ATOL = {"dense": 2e-5, "flash": 1e-5}
MODULE_ATOL = 5e-5
LOSS_RTOL = 1e-5
MODULE_GRAD_ATOL = 2e-5
SPAWN_TIMEOUT_S = 120.0
IMPLS = {"ring": "dense", "ring_flash": "flash"}


def _inputs():
    rng = np.random.default_rng(21)
    q, k, v = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(3))
    x = rng.normal(size=(2, PATCHTST["lookback_window"], PATCHTST["n_features"]))
    return {"q": q, "k": k, "v": v, "x": x.astype(np.float32)}


def _flatten(tree, prefix=""):
    flat = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update(_flatten(value, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = np.asarray(value)
    return flat


def _unflatten(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        *scopes, leaf = path.split("/")
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[leaf] = value
    return tree


# --------------------------------------------------------------------------
# the port's side: the same checks at one rank and in each rank process
# --------------------------------------------------------------------------

def _port_results(inputs, params, group):
    """Everything the port computes for the comparison, as flat arrays:
    ring outputs and gradients, the PatchTST outputs, losses and gradients
    (in the flax layout), and 1.0/0.0 flags for the errors."""
    import torch

    from gordo_components_tpu_torch.models.convert import flax_from_params, params_from_flax
    from gordo_components_tpu_torch.models.register import get_factory
    from gordo_components_tpu_torch.ops.attention import ring_attention, set_ring_group

    out = {}
    for impl in IMPLS.values():
        q, k, v = (torch.tensor(inputs[name], requires_grad=True) for name in "qkv")
        got = ring_attention(q, k, v, group=group, block_impl=impl)
        grads = torch.autograd.grad((got ** 2).sum(), (q, k, v))
        out[f"{impl}/out"] = got.detach().numpy()
        for name, grad in zip("qkv", grads):
            out[f"{impl}/d{name}"] = grad.numpy()
    q = torch.tensor(inputs["q"])
    try:
        ring_attention(q, q, q, group=group, block_impl="nope")
    except ValueError as exc:
        out["error/block_impl"] = np.float32("block_impl" in str(exc))
    uneven = q[:, : SHAPE[1] - 1]
    try:
        ring_attention(uneven, uneven, uneven, group=group)
        out["error/divide"] = np.float32(group is None)  # one rank divides any length
    except ValueError as exc:
        out["error/divide"] = np.float32("must divide" in str(exc))
    previous = set_ring_group(group)
    try:
        try:
            get_factory("patchtst")(**{**PATCHTST, "lookback_window": UNEVEN_LOOKBACK},
                                    attention_impl="ring_flash")
            out["error/factory"] = np.float32(group is None)
        except ValueError as exc:
            out["error/factory"] = np.float32("do not divide evenly" in str(exc))
        if group is not None:
            try:
                torch.func.vmap(lambda a: ring_attention(a, a, a, group=group))(q[None])
                out["error/vmap"] = np.float32(0.0)
            except RuntimeError as exc:
                out["error/vmap"] = np.float32("vmap" in str(exc))
        x = torch.tensor(inputs["x"])
        for impl in IMPLS:
            module = params_from_flax(get_factory("patchtst")(**PATCHTST, attention_impl=impl)
                                      .module, params)
            pred = module(x)
            loss = (pred ** 2).mean()
            named = dict(module.named_parameters())
            grads = torch.autograd.grad(loss, list(named.values()))
            with torch.no_grad():
                for param, grad in zip(named.values(), grads):
                    param.copy_(grad)
            out[f"{impl}/pred"] = pred.detach().numpy()
            out[f"{impl}/loss"] = loss.detach().numpy()
            for path, grad in _flatten(flax_from_params(module)).items():
                out[f"{impl}/grad/{path}"] = grad
    finally:
        set_ring_group(previous)
    return out


def _rank_main(argv):
    parser = argparse.ArgumentParser()
    for name in ("--rank", "--world"):
        parser.add_argument(name, type=int, required=True)
    for name in ("--init", "--inputs", "--out"):
        parser.add_argument(name, required=True)
    args = parser.parse_args(argv)
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{args.init}", rank=args.rank,
                            world_size=args.world, timeout=timedelta(seconds=60))
    with np.load(args.inputs) as data:
        inputs = {name: data[name] for name in ("q", "k", "v", "x")}
        params = _unflatten({key[len("param/"):]: data[key] for key in data.files
                             if key.startswith("param/")})
    results = _port_results(inputs, params, dist.group.WORLD)
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **results)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {args.rank} of {args.world}: ok", flush=True)


# --------------------------------------------------------------------------
# the reference's side and the comparisons
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The reference's ring on its 8-device mesh and its ring PatchTSTs,
    from the same inputs; and the flax params both sides load."""
    import jax
    import jax.numpy as jnp

    from gordo_components_tpu.models.register import get_factory as ref_factory
    from gordo_components_tpu.ops.attention import ring_attention as ref_ring
    from gordo_components_tpu.parallel import fleet_mesh

    inputs = _inputs()
    mesh = fleet_mesh(8, axis_name="seq")
    q, k, v = (jnp.asarray(inputs[name]) for name in "qkv")
    ref = {}
    for impl in IMPLS.values():
        def loss(q, k, v, impl=impl):
            return jnp.sum(ref_ring(q, k, v, mesh, block_impl=impl) ** 2)

        ref[f"{impl}/out"] = np.asarray(ref_ring(q, k, v, mesh, block_impl=impl))
        for name, grad in zip("qkv", jax.grad(loss, argnums=(0, 1, 2))(q, k, v)):
            ref[f"{impl}/d{name}"] = np.asarray(grad)
    x = jnp.asarray(inputs["x"])
    init = ref_factory("patchtst")(**PATCHTST, attention_impl="dense")
    params = init.module.init(jax.random.PRNGKey(3), x, deterministic=True)["params"]
    for impl in IMPLS:
        module = ref_factory("patchtst")(**PATCHTST, attention_impl=impl).module

        def mean_square(p, module=module):
            pred = module.apply({"params": p}, x, deterministic=True)
            return jnp.mean(pred ** 2), pred

        (loss_value, pred), grads = jax.value_and_grad(mean_square, has_aux=True)(params)
        ref[f"{impl}/pred"] = np.asarray(pred)
        ref[f"{impl}/loss"] = np.asarray(loss_value)
        for path, grad in _flatten(jax.tree_util.tree_map(np.asarray, grads)).items():
            ref[f"{impl}/grad/{path}"] = grad
    flat_params = _flatten(jax.tree_util.tree_map(np.asarray, params))
    return inputs, _unflatten(flat_params), flat_params, ref


def _compare(got, ref, label):
    for impl in IMPLS.values():
        np.testing.assert_allclose(got[f"{impl}/out"], ref[f"{impl}/out"], atol=FWD_ATOL,
                                   err_msg=f"{label} {impl} out")
        for name in "qkv":
            np.testing.assert_allclose(got[f"{impl}/d{name}"], ref[f"{impl}/d{name}"],
                                       atol=GRAD_ATOL[impl], err_msg=f"{label} {impl} d{name}")
    for impl in IMPLS:
        np.testing.assert_allclose(got[f"{impl}/pred"], ref[f"{impl}/pred"], atol=MODULE_ATOL,
                                   err_msg=f"{label} {impl} pred")
        np.testing.assert_allclose(got[f"{impl}/loss"], ref[f"{impl}/loss"], rtol=LOSS_RTOL,
                                   err_msg=f"{label} {impl} loss")
        grads = sorted(key for key in ref if key.startswith(f"{impl}/grad/"))
        assert grads == sorted(key for key in got if key.startswith(f"{impl}/grad/"))
        for key in grads:
            np.testing.assert_allclose(got[key], ref[key], atol=MODULE_GRAD_ATOL,
                                       err_msg=f"{label} {key}")
    assert got["error/block_impl"] == 1.0
    assert got["error/divide"] == 1.0
    assert got["error/factory"] == 1.0


def test_one_rank_matches_the_reference(reference):
    inputs, params, _, ref = reference
    _compare(_port_results(inputs, params, None), ref, "world 1")


def _spawn(world, inputs, flat_params, tmp_path):
    data = tmp_path / "inputs.npz"
    np.savez(data, **inputs, **{f"param/{key}": value for key, value in flat_params.items()})
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(rank), "--world",
         str(world), "--init", str(tmp_path / "rendezvous"), "--inputs", str(data),
         "--out", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        start_new_session=True) for rank in range(world)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    outputs = []
    for proc in procs:
        try:
            outputs.append(proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            # one rank's death or hang ends the whole group
            for other in procs:
                other.kill()
            outputs.append(proc.communicate()[0] + "\n[killed at the spawn's timeout]")
    for proc in procs:
        proc.wait()
    assert [proc.returncode for proc in procs] == [0] * world, "\n".join(outputs)
    results = []
    for rank in range(world):
        with np.load(tmp_path / f"rank{rank}.npz") as got:
            results.append({key: got[key] for key in got.files})
    return results


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_over_gloo_match_the_reference(reference, world, tmp_path):
    inputs, _, flat_params, ref = reference
    results = _spawn(world, inputs, flat_params, tmp_path)
    for rank, got in enumerate(results):
        _compare(got, ref, f"world {world} rank {rank}")
        assert got["error/vmap"] == 1.0
        for key, value in got.items():
            # the global tensors are replicated: every rank returns the same
            np.testing.assert_array_equal(value, results[0][key], err_msg=f"rank {rank} {key}")


def test_one_rank_passes_vmap(reference):
    import torch

    from gordo_components_tpu_torch.models.convert import params_from_flax
    from gordo_components_tpu_torch.models.register import get_factory

    inputs, params, _, _ = reference
    x = torch.tensor(inputs["x"])
    xs = torch.stack([x, x.flip(0) * 0.5])
    for impl in IMPLS:
        module = params_from_flax(get_factory("patchtst")(**PATCHTST, attention_impl=impl)
                                  .module, params)
        with torch.no_grad():
            mapped = torch.func.vmap(module)(xs)
            for i in range(len(xs)):
                # a mapped product may sum in another order: the bound of
                # tests/test_torch_megabatch.py for fused against lone
                np.testing.assert_allclose(mapped[i].numpy(), module(xs[i]).numpy(),
                                           rtol=1e-4, atol=1e-5, err_msg=impl)


def test_factory_builds_both_ring_kinds_and_flash_dtype():
    import torch

    from gordo_components_tpu.models.register import get_factory as ref_factory
    from gordo_components_tpu_torch.models.register import get_factory
    from gordo_components_tpu_torch.ops import _kernels

    for impl in IMPLS:
        ours, ref = (factory("patchtst")(**PATCHTST, attention_impl=impl)
                     for factory in (get_factory, ref_factory))
        assert ours.config == ref.config
    # a ring_flash hop launches the kernel whatever the patch count (8 here,
    # one tile for flash_attention), so the library must be resolved
    ring_flash = get_factory("patchtst")(**PATCHTST, attention_impl="ring_flash").module
    assert ring_flash.flash_dtype() == torch.float32
    assert _kernels.libraries_for(ring_flash, backward=True) == ["flash_bwd_f32",
                                                                "flash_fwd_f32"]
    bf16 = get_factory("patchtst")(**PATCHTST, attention_impl="ring_flash",
                                   compute_dtype="bfloat16").module
    assert bf16.flash_dtype() == torch.bfloat16
    for impl in ("ring", "flash", "dense"):
        assert get_factory("patchtst")(**PATCHTST, attention_impl=impl).module.flash_dtype() \
            is None
    with pytest.raises(ValueError, match="attention_impl"):
        get_factory("patchtst")(**PATCHTST, attention_impl="rings")


def _ring_flash_artifact(root):
    """A reference DiffBasedAnomalyDetector PatchTST pipeline, fitted at
    ``dense`` (its parameter tree is ``ring_flash``'s) with its error
    scaler and thresholds, switched to ``ring_flash`` and dumped by the
    reference serializer; and rows to score (7 windows)."""
    from gordo_components_tpu.serializer import dump as ref_dump
    from gordo_components_tpu.serializer import pipeline_from_definition

    estimator = {"PatchTSTAutoEncoder": {**{key: PATCHTST[key] for key in (
        "lookback_window", "patch_length", "stride", "d_model", "n_heads", "n_layers")},
        "attention_impl": "dense", "epochs": 1, "batch_size": 16}}
    model = pipeline_from_definition({"DiffBasedAnomalyDetector": {"base_estimator": {
        "Pipeline": {"steps": ["MinMaxScaler", estimator]}}}})
    rng = np.random.default_rng(5)
    X = (rng.normal(size=(80, PATCHTST["n_features"])) * 3 + 5).astype(np.float32)
    model.fit(X, X)
    pred = model.predict(X)
    residual = np.abs(X[len(X) - len(pred):] - pred)
    model.scaler.fit(residual)
    scaled = model.scaler.transform(residual)
    model.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
    model.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    est = model.base_estimator.steps[-1][1]
    est.set_params(attention_impl="ring_flash")
    est._spec = est._make_spec(est.n_features_, est.n_features_out_)
    est._predict_jit = est._build_predict_jit()
    tags = [f"tag-{i}" for i in range(PATCHTST["n_features"])]
    ref_dump(model, str(root / "ring-flash"), metadata={"dataset": {"tag_list": tags}})
    return model, X[: PATCHTST["lookback_window"] + 6]


def test_a_reference_ring_flash_artifact_serves(tmp_path, monkeypatch):
    from gordo_components_tpu.models import models as ref_models
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine

    model, X = _ring_flash_artifact(tmp_path)
    ported = load(str(tmp_path / "ring-flash"), device="cpu")
    assert ported.base_estimator.steps[-1][1].get_params()["attention_impl"] == "ring_flash"
    engine = ServingEngine({"ring-flash": ported}, device="cpu")
    assert not engine.skipped
    ours = engine.anomaly("ring-flash", X)
    floor = ref_models._round_up_bucket
    monkeypatch.setattr(ref_models, "_round_up_bucket", lambda n, minimum=8: floor(n, 8))
    frame = model.anomaly(X)
    ref = (frame["model-input"].values, frame["model-output"].values,
           frame["tag-anomaly-scores"].values, np.ravel(frame["total-anomaly-score"].values))
    for name, a, b in zip(wire.SCORE_FIELDS, ours, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=name)


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
