"""Windowing and scaling of the PyTorch port against ``gordo_components_tpu.ops``:
the same seeded numpy inputs through both, exact agreement on windows and
targets (they are gathers), float32 agreement on scaler fits."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.ops import scaling as ref_scaling  # noqa: E402
from gordo_components_tpu.ops import windowing as ref_windowing  # noqa: E402

from gordo_components_tpu_torch.ops import scaling, windowing  # noqa: E402


def _x(n=12, f=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


@pytest.mark.parametrize("n,L,la", [(10, 4, 0), (10, 4, 1), (12, 3, 2), (4, 4, 0), (5, 4, 1), (7, 1, 0)])
def test_windows_and_targets_match_reference(n, L, la):
    x = _x(n)
    ours = windowing.sliding_windows(torch.from_numpy(x), L, la).numpy()
    ref = np.asarray(ref_windowing.sliding_windows(x, L, la))
    np.testing.assert_array_equal(ours, ref)
    assert windowing.n_windows(n, L, la) == ref_windowing.n_windows(n, L, la) == len(ours)
    np.testing.assert_array_equal(
        windowing.window_output_index(n, L, la), ref_windowing.window_output_index(n, L, la)
    )
    if la == 0:
        targets = windowing.reconstruction_targets(torch.from_numpy(x), L)
        ref_t = ref_windowing.reconstruction_targets(x, L)
    else:
        targets = windowing.forecast_targets(torch.from_numpy(x), L, la)
        ref_t = ref_windowing.forecast_targets(x, L, la)
    np.testing.assert_array_equal(targets.numpy(), np.asarray(ref_t))
    # window i targets row i + L - 1 + la: the off-by-one contract
    np.testing.assert_array_equal(targets.numpy()[: len(ours)], x[L - 1 + la :][: len(ours)])
    np.testing.assert_array_equal(ours[:, -1], x[L - 1 : L - 1 + len(ours)])


def test_windowing_errors_match_reference():
    x = torch.from_numpy(_x(3))
    with pytest.raises(ValueError, match="lookback_window"):
        windowing.sliding_windows(x, 5)
    assert windowing.n_windows(2, 5) == ref_windowing.n_windows(2, 5) == 0
    for bad in [dict(lookback_window=0), dict(lookback_window=2, lookahead=-1),
                dict(lookback_window=2, lookahead=1.5)]:
        with pytest.raises(ValueError):
            windowing.n_windows(10, **bad)
        with pytest.raises(ValueError):
            ref_windowing.n_windows(10, **bad)
    with pytest.raises(ValueError, match="lookahead"):
        windowing.forecast_targets(x, 2, 0)


def test_scaler_fits_and_transforms_match_reference():
    x = _x(50, 4, seed=3) * 7 + 2
    x[:, 2] = 1.5  # a constant column: no NaN, maps to the range minimum
    pairs = [
        (scaling.fit_minmax(torch.from_numpy(x), (-1.0, 2.0)), ref_scaling.fit_minmax(x, (-1.0, 2.0))),
        (scaling.fit_standard(torch.from_numpy(x)), ref_scaling.fit_standard(x)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.scale.numpy(), np.asarray(ref.scale), rtol=1e-6)
        np.testing.assert_allclose(ours.offset.numpy(), np.asarray(ref.offset), rtol=1e-6, atol=1e-6)
        t = scaling.transform(ours, torch.from_numpy(x))
        np.testing.assert_allclose(t.numpy(), np.asarray(ref_scaling.transform(ref, x)), atol=1e-5)
        np.testing.assert_allclose(scaling.inverse_transform(ours, t).numpy(), x, atol=1e-4)
        assert np.isfinite(t.numpy()).all()
