"""The benchmark's operation counts against torch's own counter over the
reference, and the attention kernel's least work from shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import data, workcount
from reference import patchtst

SMALL = {"lookback_window": 48, "patch_length": 8, "stride": 4, "d_model": 32, "n_heads": 4,
         "n_layers": 2, "ff_dim": 64}


def test_flops_per_window_matches_torch_counter():
    tags, windows = 3, 5
    flat = data.make_weights(SMALL, 1, 7, torch.device("cpu"), torch.float32)[0]
    tree = data.tree_of(flat, SMALL)
    x = torch.randn(windows, SMALL["lookback_window"], tags)
    with FlopCounterMode(display=False) as counter:
        patchtst.forward(tree, x, SMALL)
    assert counter.get_total_flops() == windows * workcount.flops_per_window(SMALL, tags)


def test_published_widths_count():
    model = {"lookback_window": 1440, "patch_length": 16, "stride": 8, "d_model": 128,
             "n_heads": 16, "n_layers": 3, "ff_dim": 256}
    per_token_layer = 8 * 128 ** 2 + 4 * 128 * 256 + 4 * 179 * 128
    flops = workcount.flops_per_window(model, 64)
    assert flops == pytest.approx(64 * 179 * 3 * per_token_layer, rel=0.01)
    assert flops == pytest.approx(12.2e9, rel=0.01)


def test_attention_least_work():
    model = {"lookback_window": 1440, "patch_length": 16, "stride": 8, "d_model": 128,
             "n_heads": 16}
    work = workcount.attention_work(model, 64, 2.0, 4)
    bh = 2 * 64 * 16
    assert work["flops"] == 4 * bh * 179 * 179 * 8
    assert work["bytes"] == bh * 179 * (4 * 8 * 4 + 4)
    fp32 = workcount.least_seconds(work, workcount.PEAKS["tf32"])
    assert fp32 == pytest.approx(max(work["flops"] / 495e12, work["bytes"] / 3.35e12))
