"""The control of ``correct``: the plain reference put in the program's
place and computed a step below the precision the configuration states
(``config["control"]``: ``tf32`` for float32 with TF32 off, ``fp8`` for
bfloat16), over the same rows, weights and count of requests a run
compares, read against the reference at float32 by the same numbers. It
has to come out not correct."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import compare, data, traffic as traffic_mod


def readings(config: Dict, traffic: Dict, seed: int, device, mode: str = None,
             sample: int = None) -> Dict[str, float]:
    """The worst of each number over ``sample`` requests (default: as many
    as a run compares) of the mix's bodies, drawn from ``seed``."""
    from reference import patchtst

    model, tags = config["model"], config["n_tags"]
    mode = mode or config["control"]
    device = torch.device(device)
    seed = int(seed) % 2 ** 63
    n_rows = traffic_mod.rows_per_request(traffic, model["lookback_window"])
    per = traffic["bodies_per_machine"]
    history, residuals = data.machine_data(seed, traffic["fleet"], tags, per, n_rows)
    served = torch.bfloat16 if config["precision"] == "bf16" else torch.float32
    weights = data.make_weights(model, traffic["fleet"], seed, device, served)
    plan = traffic_mod.plan(traffic, seed, 1.0)
    count = sample if sample is not None else traffic["compare_sample"]
    picked = np.random.default_rng([seed, 3]).choice(len(plan["bodies"]), size=count,
                                                     replace=count > len(plan["bodies"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for b in picked.tolist():
        m, j = plan["bodies"][b], b % per
        rows = torch.from_numpy(data.as_float(history[m][j * n_rows:(j + 1) * n_rows])).to(device)
        machine_rows = torch.from_numpy(data.as_float(history[m])).to(device)
        scalers = {"x": patchtst.minmax(machine_rows), "y": patchtst.minmax(machine_rows),
                   "e": patchtst.minmax(torch.from_numpy(residuals[m]).to(device))}
        tree = data.tree_of(weights[m], model)
        with torch.no_grad():
            ref = patchtst.score(tree, scalers, rows, model, "fp32")
            low = patchtst.score(tree, scalers, rows, model, mode)
        out.append(compare.gaps({k: v.cpu().numpy() for k, v in low.items()},
                                {k: v.cpu().numpy() for k, v in ref.items()}))
    return compare.worst(out)
