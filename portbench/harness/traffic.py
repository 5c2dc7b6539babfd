"""The one traffic generator: a mix's parameters (``traffic/<name>.json``)
and a seed in, a plan out: which request bodies exist, the order they go
in, and for an open loop when each is due.

Every seed gets the same work: the same bodies, each sent equally often,
in an order drawn from the seed, and in an open loop the same arrival
times. Those are Poisson arrivals, what many machines scheduled apart add
up to, drawn once for all seeds: exponential gaps at the quantiles of
their distribution, in one fixed shuffled order. A tail below the knee is
set by the few largest bursts; drawn anew per seed, they moved the 95th
percentile from 312 to 785 ms between seeds."""

from __future__ import annotations

from typing import Dict

import numpy as np

# a closed loop's order is this long; no window gets through it
CLOSED_ORDER = 20000
# the fixed order of an open loop's gaps, the same for every seed
GAP_ORDER_SEED = 24




def rows_per_request(traffic: Dict, lookback: int) -> int:
    return lookback + traffic["windows_per_request"] - 1


def plan(traffic: Dict, seed: int, seconds: float, rate: float = None) -> Dict:
    """``{"bodies": [machine index per body], "order": [body index per
    request], "due": [seconds after the window opens, per request] (open
    loop only)}``. ``rate`` overrides an open loop's ``rate_per_s``."""
    fleet, per = traffic["fleet"], traffic["bodies_per_machine"]
    bodies = [m for m in range(fleet) for _ in range(per)]
    rng = np.random.default_rng([seed, 2])
    if traffic["loop"] == "closed":
        order = np.resize(np.arange(len(bodies)), CLOSED_ORDER)
        rng.shuffle(order)
        return {"bodies": bodies, "order": order.tolist(), "due": None}
    if traffic["loop"] != "open" or traffic["arrivals"] != "poisson":
        raise ValueError(f"unknown traffic loop {traffic['loop']!r}/{traffic.get('arrivals')!r}")
    rate = float(rate if rate is not None else traffic["rate_per_s"])
    count = max(1, int(round(rate * seconds)))
    quantiles = (np.arange(count) + 0.5) / count
    gaps = -np.log1p(-quantiles) / rate  # exponential: Poisson arrivals
    np.random.default_rng(GAP_ORDER_SEED).shuffle(gaps)
    gaps *= seconds / gaps.sum()
    due = np.cumsum(gaps) - gaps  # the first request is due as the window opens
    order = np.resize(np.arange(len(bodies)), count)
    rng.shuffle(order)
    return {"bodies": bodies, "order": order.tolist(), "due": due.tolist()}
