"""The port's training path against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the reference and the
port:

- the flash backward: ``flash_bwd_reference`` and the port's autograd rule
  against ``jax.grad`` through the reference's ``_flash_3d`` /
  ``flash_attention`` and ``flash_block_with_lse`` (with an lse
  cotangent), whose forward runs the Pallas kernel in interpret mode as
  ``tests/test_flash_attention.py`` runs it; S = 200 and 129 are not
  multiples of the 128-key block. Float32, atol 1e-5: the same arithmetic
  summed in other orders;
- the seven optimizers against optax through each side's
  ``make_optimizer`` with Keras spellings, 20 steps of fixed gradients:
  rtol 1e-5 / atol 1e-6 (float32, rsqrt and pow evaluated by other
  libraries);
- the three losses (and their aliases) with padding weights: 1e-6;
- ``make_fit_fn`` for a dense autoencoder, an LSTM autoencoder and a
  PatchTST at 129 patches on the flash path, from the same converted
  initial parameters and the reference's permutations (drawn with
  ``jax.random`` as its fit draws them), dropout off, two epochs: loss
  histories within rtol 1e-5 and final parameters within atol 2e-5 (Adam
  steps of 1e-3 from float32 gradients that differ in the last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.models import train as ref_train  # noqa: E402
from gordo_components_tpu.models.factories.spec import (  # noqa: E402
    make_optimizer as ref_make_optimizer,
)
from gordo_components_tpu.models.register import get_factory as ref_factory  # noqa: E402
from gordo_components_tpu.ops import flash_attention as ref_flash  # noqa: E402
from gordo_components_tpu.ops.windowing import sliding_windows as ref_sliding_windows  # noqa: E402

from gordo_components_tpu_torch.models import train  # noqa: E402
from gordo_components_tpu_torch.models.convert import (  # noqa: E402
    flax_from_params,
    params_from_flax,
)
from gordo_components_tpu_torch.models.factories.spec import (  # noqa: E402
    apply_updates,
    make_optimizer,
)
from gordo_components_tpu_torch.models.register import get_factory  # noqa: E402
from gordo_components_tpu_torch.ops import _kernels, windowing  # noqa: E402
from gordo_components_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_block_with_lse,
    flash_bwd_reference,
    flash_fwd,
)

BWD_ATOL = 1e-5


def _normal(rng, shape, scale=0.5):
    return (scale * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize(
    "bh,seq,d", [(3, 200, 8), (2, 129, 16), (2, 37, 4), (2, 179, 64), (2, 700, 64)])
def test_flash_bwd_reference_matches_jax_grad(bh, seq, d):
    """``flash_bwd_reference`` on the reference's own saved forward equals
    ``jax.grad`` through ``flash_block_with_lse`` (out and lse cotangents)
    and through ``_flash_3d`` (out only)."""
    rng = np.random.default_rng(seq + d)
    q, k, v, do = (_normal(rng, (bh, seq, d)) for _ in range(4))
    dlse = rng.normal(size=(bh, seq)).astype(np.float32)
    scale = d ** -0.5

    def with_lse(q, k, v):
        out, lse = ref_flash.flash_block_with_lse(q, k, v, scale, 128, 128)
        return jnp.sum(out * do) + jnp.sum(lse * dlse)

    def out_only(q, k, v):
        return jnp.sum(ref_flash._flash_3d(q, k, v, scale, 128, 128) * do)

    out, lse = ref_flash._flash_fwd_3d(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       scale, 128, 128)
    saved = [torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse)]
    for fn, cot in ((with_lse, dlse), (out_only, None)):
        ref = jax.grad(fn, argnums=(0, 1, 2))(q, k, v)
        ours = flash_bwd_reference(*saved, torch.from_numpy(do), scale,
                                   None if cot is None else torch.from_numpy(cot))
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_ATOL)


def test_flash_attention_gradient_matches_jax_grad():
    """Autograd through the port's ``flash_attention`` (the operator's
    registered backward, on the CPU its plain version) against ``jax.grad``
    of the reference's ``flash_attention`` in the flax layout, at 200
    patches; and ``flash_block_with_lse`` differentiated in both outputs."""
    rng = np.random.default_rng(7)
    q, k, v, do = (_normal(rng, (2, 200, 2, 8)) for _ in range(4))
    ref = jax.grad(lambda q, k, v: jnp.sum(ref_flash.flash_attention(q, k, v) * do),
                   argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = dict(_kernels.LAUNCHES)
    (flash_attention(tq, tk, tv) * torch.from_numpy(do)).sum().backward()
    assert _kernels.LAUNCHES == before  # CPU tensors never reach a kernel
    for a, b in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_ATOL)

    q3, k3, v3 = (_normal(rng, (3, 150, 8)) for _ in range(3))
    w = rng.normal(size=(3, 150)).astype(np.float32)

    def ref_loss(q, k, v):
        out, lse = ref_flash.flash_block_with_lse(q, k, v, 0.3, 128, 128)
        return jnp.sum(out * out) + jnp.sum(lse * w)

    ref = jax.grad(ref_loss, argnums=(0, 1, 2))(q3, k3, v3)
    t3 = [torch.from_numpy(a).requires_grad_() for a in (q3, k3, v3)]
    out, lse = flash_block_with_lse(*t3, 0.3)
    grads = torch.autograd.grad((out * out).sum() + (lse * torch.from_numpy(w)).sum(), t3)
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_ATOL)


def test_flash_bwd_dlse_never_touches_dv():
    rng = np.random.default_rng(3)
    q, k, v, out_cot = (torch.from_numpy(_normal(rng, (2, 40, 8))) for _ in range(4))
    out, lse = flash_fwd(q, k, v, 0.5)
    plain = flash_bwd_reference(q, k, v, out, lse, out_cot, 0.5)
    with_dlse = flash_bwd_reference(q, k, v, out, lse, out_cot, 0.5, torch.ones_like(lse))
    assert torch.equal(plain[2], with_dlse[2])
    assert not torch.equal(plain[0], with_dlse[0])


def test_flash_bwd_keeps_the_input_dtype():
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(_normal(rng, (2, 30, 8))).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = flash_fwd(q, k, v, 0.5)
    grads = flash_bwd_reference(q, k, v, out, lse, do, 0.5)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert lse.dtype == torch.float32


# Keras spellings, as configs carry them; "decay" (a learning-rate schedule)
# and "clipnorm" are dropped with a warning on both sides
OPTIMIZERS = {
    "Adam": {"lr": 0.01, "beta_1": 0.8, "beta_2": 0.99, "epsilon": 1e-6},
    "AdamW": {"lr": 0.01, "weight_decay": 0.05},
    "SGD": {"lr": 0.05, "momentum": 0.9, "nesterov": True, "decay": 0.1},
    "RMSprop": {"lr": 0.01, "rho": 0.8, "epsilon": 1e-6, "momentum": 0.5},
    "Adagrad": {"lr": 0.1, "epsilon": 1e-6, "clipnorm": 1.0},
    "Adamax": {"lr": 0.01, "beta_1": 0.85, "epsilon": 1e-6},
    "Nadam": {"lr": 0.01, "beta_2": 0.995},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    kwargs = OPTIMIZERS[name]
    rng = np.random.default_rng(len(name))
    shapes = {"a": (4, 3), "b": (3,), "c": (2, 2, 2)}
    start = {key: rng.normal(size=shape).astype(np.float32) for key, shape in shapes.items()}
    grads = [{key: rng.normal(size=shape).astype(np.float32) for key, shape in shapes.items()}
             for _ in range(20)]

    ref_opt = ref_make_optimizer(name, kwargs)
    ref_params = {key: jnp.asarray(value) for key, value in start.items()}
    state = ref_opt.init(ref_params)
    for g in grads:
        updates, state = ref_opt.update({k: jnp.asarray(v) for k, v in g.items()}, state,
                                        ref_params)
        ref_params = optax.apply_updates(ref_params, updates)

    opt = make_optimizer(name, kwargs)
    params = [torch.from_numpy(start[key].copy()) for key in shapes]
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update([torch.from_numpy(g[key]) for key in shapes], state, params)
        apply_updates(params, updates)
    for key, value in zip(shapes, params):
        np.testing.assert_allclose(value.numpy(), np.asarray(ref_params[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"{name} {key}")


def test_make_optimizer_errors_and_defaults_match_reference():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        make_optimizer("LBFGS")
    with pytest.raises(ValueError, match="Unknown optimizer"):
        ref_make_optimizer("LBFGS")
    # the default learning rate is 1e-3 on both sides: one SGD step
    params = [torch.ones(2)]
    opt = make_optimizer("sgd")
    updates, _ = opt.update([torch.ones(2)], opt.init(params), params)
    ref_opt, ref_params = ref_make_optimizer("sgd"), {"a": jnp.ones(2)}
    ref_updates, _ = ref_opt.update({"a": jnp.ones(2)}, ref_opt.init(ref_params), ref_params)
    np.testing.assert_array_equal(updates[0].numpy(), np.asarray(ref_updates["a"]))


@pytest.mark.parametrize("loss", ["mse", "mean_squared_error", "mae", "mean_absolute_error",
                                  "huber"])
def test_loss_matches_reference_with_padding_weights(loss):
    rng = np.random.default_rng(11)
    x = (2 * rng.normal(size=(8, 3))).astype(np.float32)  # |diff| on both sides of huber's 1
    y = rng.normal(size=(8, 3)).astype(np.float32)
    w = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    s = np.float32(1.5)
    ref = ref_train.make_loss_fn(lambda variables, x, **kw: x * variables["params"]["s"], loss)(
        {"s": jnp.asarray(s)}, x, y, w, None)
    ours = train.make_loss_fn(lambda p, x, g: x * p["s"], loss)(
        {"s": torch.tensor(s)}, *(torch.from_numpy(a) for a in (x, y, w)), None)
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-6)
    # the padded rows do not count: the same loss over the real rows alone
    real = train.make_loss_fn(lambda p, x, g: x * p["s"], loss)(
        {"s": torch.tensor(s)}, torch.from_numpy(x[:5]), torch.from_numpy(y[:5]),
        torch.ones(5), None)
    np.testing.assert_allclose(ours.item(), real.item(), rtol=1e-6)
    with pytest.raises(ValueError, match="Unknown loss"):
        train.make_loss_fn(lambda p, x, g: x, "hinge")


def test_pad_to_batches_matches_reference():
    X = np.arange(10, dtype=np.float32).reshape(5, 2)
    for batch in (2, 5, 8):
        for a, b in zip(train.pad_to_batches(X, X[:, :1], batch),
                        ref_train.pad_to_batches(X, X[:, :1], batch)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="empty"):
        train.pad_to_batches(X[:0], X[:0], 4)


def _ref_perms(key, epochs, n):
    """The permutations the reference's fit draws from ``key``."""
    perms = []
    for epoch_key in jax.random.split(key, epochs):
        perm_key, _ = jax.random.split(epoch_key)
        perms.append(np.asarray(jax.random.permutation(perm_key, n)))
    return perms


FIT_CASES = {
    "dense-ae": ("feedforward_symmetric", dict(n_features=5, dims=(4, 3)), 50, 16),
    "lstm-ae": ("lstm_symmetric", dict(n_features=4, dims=(5,), lookback_window=6), 40, 8),
    "patchtst-flash-P129": ("patchtst", dict(
        n_features=2, lookback_window=1040, patch_length=16, stride=8, d_model=16,
        n_heads=1, n_layers=1, attention_impl="flash"), 1047, 4),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_fn_matches_reference(case):
    """Two epochs of the reference's compiled fit and the port's loop from
    the same flax initial parameters and the same permutations. Windowed
    models: the reference trains on materialised windows, the port on start
    indices gathered per batch (as its estimator does)."""
    kind, kw, n_rows, batch = FIT_CASES[case]
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(n_rows, kw["n_features"])).astype(np.float32)
    spec = ref_factory(kind)(**kw)
    window = kw.get("lookback_window") if kind != "feedforward_symmetric" else None
    if window is None:
        X, y = rows, rows
    else:
        X = np.asarray(ref_sliding_windows(rows, window))
        y = rows[window - 1:]
    init_module = ref_factory(kind)(**{**kw, "attention_impl": "dense"}).module if (
        kind == "patchtst") else spec.module
    params = init_module.init(jax.random.PRNGKey(0), X[:1], deterministic=True)["params"]
    Xp, yp, w = ref_train.pad_to_batches(X, y, batch)
    key = jax.random.PRNGKey(1)
    ref = jax.jit(ref_train.make_fit_fn(spec.module.apply, spec.optimizer, batch_size=batch,
                                        epochs=2))(params, Xp, yp, w, key)

    port_spec = get_factory(kind)(**kw)
    module = params_from_flax(port_spec.module, jax.tree_util.tree_map(np.asarray, params))
    if window is None:
        inputs = torch.from_numpy(Xp)

        def apply(p, x, g):
            return torch.func.functional_call(module, p, (x,), {"generator": g})
    else:
        inputs = torch.from_numpy(train.pad_to_batches(np.arange(len(X)), y, batch)[0])
        row_tensor = torch.from_numpy(rows)

        def apply(p, starts, g):
            x = windowing.gather_windows(row_tensor, starts, window)
            return torch.func.functional_call(module, p, (x,), {"generator": g})

    fit = train.make_fit_fn(apply, port_spec.optimizer, loss=port_spec.loss, batch_size=batch,
                            epochs=2)
    result = fit(dict(module.named_parameters()), inputs, torch.from_numpy(yp),
                 torch.from_numpy(w), torch.Generator().manual_seed(0),
                 perms=_ref_perms(key, 2, len(Xp)))
    np.testing.assert_allclose(result.loss_history, np.asarray(ref.loss_history), rtol=1e-5)
    ours = flax_from_params(module)
    theirs = jax.tree_util.tree_map(np.asarray, ref.params)
    if kind == "patchtst":
        # the key projection's bias adds q·b to every score of a row, which
        # the softmax removes: its gradient is 0 in exact arithmetic, so
        # both sides' gradients are float32 rounding noise, and Adam turns
        # noise into steps of up to lr·(1 - b1)/sqrt(1 - b2) each, of either
        # sign. Held to that travel, and to a gradient of noise (< 1e-6)
        steps = 2 * len(Xp) // batch
        travel = 2 * steps * 1e-3 * (1 - 0.9) / np.sqrt(1 - 0.999)
        for tree in (ours, theirs):
            qkv = tree["TransformerEncoderLayer_0"]["MultiHeadSelfAttention_0"]["qkv"]
            key_bias, qkv["bias"] = qkv["bias"][1], np.delete(qkv["bias"], 1, axis=0)
            tree["key_bias"] = key_bias
        assert np.abs(ours.pop("key_bias") - theirs.pop("key_bias")).max() <= travel
        x = windowing.gather_windows(row_tensor, inputs[:batch], window)
        loss = ((module(x) - torch.from_numpy(yp[:batch])) ** 2).mean()
        grad = torch.autograd.grad(loss, module.layers[0].attn.qkv.bias)[0]
        assert grad[16:32].abs().max() < 1e-6 < grad[32:].abs().max()
    ours, theirs = (jax.tree_util.tree_leaves(t) for t in (ours, theirs))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, atol=2e-5)
    # the steps moved the parameters
    start = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, params))
    moved = jax.tree_util.tree_leaves(flax_from_params(module))
    assert max(np.abs(a - s).max() for a, s in zip(moved, start)) > 1e-4


def test_gather_windows_equals_sliding_windows():
    rows = torch.arange(60, dtype=torch.float32).reshape(20, 3)
    starts = torch.tensor([0, 7, 3, 11])
    np.testing.assert_array_equal(
        windowing.gather_windows(rows, starts, 9).numpy(),
        windowing.sliding_windows(rows, 9)[starts].numpy(),
    )
    np.testing.assert_array_equal(
        windowing.gather_windows(rows, starts, 9)[1].numpy(), rows[7:16].numpy())


def test_fit_trains_under_no_grad_and_leaves_grad_mode_alone():
    """The loop turns gradients on for its own steps only: a fit called
    inside ``no_grad`` or ``inference_mode`` trains, and the caller's mode
    is what it was."""
    from gordo_components_tpu_torch.models import DenseAutoEncoder

    X = np.random.default_rng(2).normal(size=(40, 4)).astype(np.float32)
    histories = []
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            est = DenseAutoEncoder(kind="feedforward_symmetric", dims=[3], epochs=2).to("cpu")
            est.fit(X)
            assert not torch.is_grad_enabled()
        histories.append(est.history_)
    assert torch.is_grad_enabled()
    assert histories[0] == histories[1] and histories[0][1] < histories[0][0]
