"""The plain reference against the port's PatchTST module on the same
weights, at a small size on the CPU, and its controls a step below."""

import numpy as np
import pytest
import torch

from harness import data
from reference import patchtst

SMALL = {"lookback_window": 48, "patch_length": 8, "stride": 4, "d_model": 32, "n_heads": 4,
         "n_layers": 2, "ff_dim": 64}


def port_module(tree, tags):
    from gordo_components_tpu_torch.models.convert import params_from_flax
    from gordo_components_tpu_torch.models.factories.transformer import PatchTSTModule

    module = PatchTSTModule(n_features=tags, n_features_out=tags, **SMALL)
    np_tree = data._numpy_tree(tree)
    return params_from_flax(module, np_tree).eval()


def test_reference_matches_the_port_module():
    tags = 3
    flat = data.make_weights(SMALL, 2, 11, torch.device("cpu"), torch.float32)[1]
    tree = data.tree_of(flat, SMALL)
    x = torch.randn(6, SMALL["lookback_window"], tags)
    with torch.no_grad():
        ours = patchtst.forward(tree, x, SMALL)
        theirs = port_module(tree, tags)(x)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)


def test_rounding_of_the_controls():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10 + 2 ** -11, -3.14159265, 0.0])
    tf32 = patchtst._round_tf32(x)
    assert tf32[0] == 1.0 and tf32[1] == 1.0 + 2 ** -9
    assert (tf32.view(torch.int32) & 0x1FFF).eq(0).all()
    fp8 = patchtst._round_fp8(x)
    assert torch.allclose(fp8, x, rtol=2 ** -3) and not torch.equal(fp8, x)


@pytest.mark.parametrize("mode", ["tf32", "fp8"])
def test_controls_move_the_answer(mode):
    tags = 3
    flat = data.make_weights(SMALL, 1, 5, torch.device("cpu"), torch.float32)[0]
    tree = data.tree_of(flat, SMALL)
    x = torch.randn(4, SMALL["lookback_window"], tags)
    exact = patchtst.forward(tree, x, SMALL)
    low = patchtst.forward(tree, x, SMALL, mode)
    gap = float((low - exact).abs().max() / exact.abs().max())
    assert gap > (1e-5 if mode == "tf32" else 1e-2)


def test_score_windows_and_scalers():
    tags, lookback = 2, SMALL["lookback_window"]
    rows = torch.randn(lookback + 9, tags) * 5 + 3
    flat = data.make_weights(SMALL, 1, 5, torch.device("cpu"), torch.float32)[0]
    tree = data.tree_of(flat, SMALL)
    scalers = {"x": patchtst.minmax(rows), "y": patchtst.minmax(rows),
               "e": patchtst.minmax(rows.abs())}
    whole = patchtst.score(tree, scalers, rows, SMALL, block=4)
    assert whole["model-output"].shape == (10, tags)
    torch.testing.assert_close(whole["model-input"], rows[lookback - 1:])
    scaled = rows * scalers["x"][0] + scalers["x"][1]
    assert float(scaled.min()) == pytest.approx(0.0, abs=1e-6)
    assert float(scaled.max()) == pytest.approx(1.0, abs=1e-6)
    last = patchtst.score(tree, scalers, rows[-lookback:], SMALL)
    np.testing.assert_allclose(last["model-output"].numpy(), whole["model-output"][-1:].numpy(),
                               rtol=1e-5)
