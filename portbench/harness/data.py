"""Everything a run makes from its seed: each machine's weights (on the
device, in a few large calls), its sensor rows and its error-scaler
sample; and the artifacts the program serves, written through its own
serializer. The reference gets the same weights and rows, never what the
program derived from them."""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch


def n_patches(model: Dict) -> int:
    return (model["lookback_window"] - model["patch_length"]) // model["stride"] + 1


def param_layout(model: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float, float]]:
    """The flax-layout leaves of one machine, in a fixed order: (path,
    shape, standard deviation, mean) of the seeded draw. Dense kernels at
    1/sqrt(fan_in), biases small, LayerNorm scales near 1."""
    d, heads, ff, pl = model["d_model"], model["n_heads"], model["ff_dim"], model["patch_length"]
    hd, p = d // heads, n_patches(model)
    leaves = []

    def dense(path, shape_in, shape_out):
        fan_in = int(np.prod(shape_in))
        leaves.append((path + ("kernel",), (*shape_in, *shape_out), fan_in ** -0.5, 0.0))
        leaves.append((path + ("bias",), tuple(shape_out), 0.01, 0.0))

    def norm(path):
        leaves.append((path + ("scale",), (d,), 0.05, 1.0))
        leaves.append((path + ("bias",), (d,), 0.05, 0.0))

    dense(("Dense_0",), (pl,), (d,))
    leaves.append((("pos_embedding",), (p, d), 0.02, 0.0))
    for i in range(model["n_layers"]):
        layer = (f"TransformerEncoderLayer_{i}",)
        norm(layer + ("LayerNorm_0",))
        dense(layer + ("MultiHeadSelfAttention_0", "qkv"), (d,), (3, heads, hd))
        dense(layer + ("MultiHeadSelfAttention_0", "out"), (heads, hd), (d,))
        norm(layer + ("LayerNorm_1",))
        dense(layer + ("Dense_0",), (d,), (ff,))
        dense(layer + ("Dense_1",), (ff,), (d,))
    norm(("LayerNorm_0",))
    dense(("Dense_1",), (p * d,), (1,))
    return leaves


def make_weights(model: Dict, machines: int, seed: int, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """``(machines, n_params)`` float32 weights drawn on ``device`` from
    ``seed`` in one call and rounded to the served ``dtype``."""
    layout = param_layout(model)
    std = torch.cat([torch.full((int(np.prod(s)),), sd) for _, s, sd, _ in layout]).to(device)
    mean = torch.cat([torch.full((int(np.prod(s)),), m) for _, s, _, m in layout]).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn((machines, std.numel()), generator=gen, device=device)
    return (flat * std + mean).to(dtype).to(torch.float32)


def tree_of(flat: torch.Tensor, model: Dict) -> Dict:
    """One machine's flat weights as the nested flax-layout tree (views)."""
    tree: Dict = {}
    at = 0
    for path, shape, _, _ in param_layout(model):
        size = int(np.prod(shape))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[at:at + size].reshape(shape)
        at += size
    return tree


def sensor_rows(rng: np.random.Generator, n: int, tags: int) -> np.ndarray:
    """Plant-like rows in thousandths (int64): per-tag level and scale, a
    daily wave, noise. The value sent and scored is ``k / 1000``."""
    t = np.arange(n)[:, None]
    level = rng.uniform(-50, 150, size=tags)
    scale = rng.uniform(0.5, 20, size=tags)
    phase = rng.uniform(0, 2 * np.pi, size=tags)
    wave = np.sin(2 * np.pi * t / 1440 + phase)
    values = level + scale * (wave + 0.3 * rng.normal(size=(n, tags)))
    return np.rint(values * 1000).astype(np.int64)


def as_float(milli: np.ndarray) -> np.ndarray:
    """The float32 rows the server parses from the JSON body."""
    return (milli / 1000.0).astype(np.float32)


def machine_data(seed: int, fleet: int, tags: int, bodies_per_machine: int,
                 rows_per_body: int) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per machine: its history in thousandths, cut into
    ``bodies_per_machine`` requests of ``rows_per_body`` rows, and a sample
    of absolute residuals that fits its error scaler."""
    rng = np.random.default_rng([seed, 1])
    history, residuals = [], []
    for _ in range(fleet):
        history.append(sensor_rows(rng, bodies_per_machine * rows_per_body, tags))
        residuals.append(np.abs(rng.normal(size=(1024, tags)) * rng.uniform(0.1, 5, size=tags))
                         .astype(np.float32))
    return history, residuals


def write_artifacts(models_dir: str, names: List[str], model: Dict, precision: str,
                    weights: np.ndarray, history: List[np.ndarray],
                    residuals: List[np.ndarray]) -> None:
    """One artifact per machine through the program's serializer: the
    min-max input and target scalers fitted on the machine's history, the
    seeded weights, the error scaler fitted on its residual sample and the
    thresholds at its 99th percentile."""
    from gordo_components_tpu_torch.serializer import dump, pipeline_from_definition

    est_kwargs = {k: model[k] for k in ("lookback_window", "patch_length", "stride", "d_model",
                                         "n_heads", "n_layers", "ff_dim", "dropout",
                                         "attention_impl", "compute_dtype")}
    definition = {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": [
            "MinMaxScaler", {"PatchTSTAutoEncoder": {"kind": "patchtst", **est_kwargs}}]}},
        "transformer": "MinMaxScaler"}}}}
    for i, name in enumerate(names):
        rows = as_float(history[i])
        tags = rows.shape[1]
        pipe = pipeline_from_definition(definition)
        ttr = pipe.base_estimator
        scaler, est = (step for _, step in ttr.regressor.steps)
        scaler.fit(rows)
        ttr.transformer.fit(rows)
        est.to("cpu")
        est.set_state({"params": _numpy_tree(tree_of(torch.from_numpy(weights[i]), model)),
                       "n_features": tags, "n_features_out": tags, "history": [],
                       "fit_duration": None})
        pipe.scaler.fit(residuals[i])
        scaled = np.asarray(pipe.scaler.transform(residuals[i]))
        pipe.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
        pipe.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
        metadata = {"dataset": {"tag_list": [f"TAG-{t:03d}" for t in range(tags)]},
                    "precision": precision}
        dump(pipe, os.path.join(models_dir, name), metadata=metadata, precision=precision)


def _numpy_tree(tree: Dict) -> Dict:
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}
