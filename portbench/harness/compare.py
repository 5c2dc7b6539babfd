"""The comparison that decides ``correct``: answers the timed path gave,
decoded from their npz bodies, against the plain reference over the same
rows and weights. Each number is the worst over the sampled requests."""

from __future__ import annotations

import io
import math
from typing import Dict

import numpy as np

FIELDS = ("model-input", "model-output", "tag-anomaly-scores", "total-anomaly-score")
# number -> the field it reads; input_gap is absolute (the echoed rows must
# be the rows sent), the others relative to the field's largest magnitude
NUMBERS = {"input_gap": "model-input", "output_gap": "model-output",
           "tag_score_gap": "tag-anomaly-scores", "total_score_gap": "total-anomaly-score"}


def decode(body: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(body), allow_pickle=False) as archive:
        return {name: archive[name] for name in FIELDS if name in archive.files}


def gaps(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    out = {}
    for number, field in NUMBERS.items():
        expected = np.asarray(ref[field], np.float64)
        answer = got.get(field)
        if answer is None or answer.shape != expected.shape or not np.isfinite(answer).all():
            out[number] = math.inf
            continue
        diff = float(np.abs(answer.astype(np.float64) - expected).max())
        out[number] = diff if number == "input_gap" else diff / max(
            float(np.abs(expected).max()), 1e-30)
    return out


def worst(per_request) -> Dict[str, float]:
    out = dict.fromkeys(NUMBERS, 0.0)
    for reading in per_request:
        for number, value in reading.items():
            out[number] = max(out[number], value)
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(readings[n] <= limits[n] for n in NUMBERS)
