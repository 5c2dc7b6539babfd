"""``Pipeline`` and ``TransformedTargetRegressor`` (port of
``gordo_components_tpu/models/pipeline.py:40-108, 201-265``).

State keys are the reference's: a pipeline's steps by position
(``step_i``), a target regressor's ``regressor`` and ``transformer``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


def _name_steps(
    steps: Sequence[Union[Tuple[str, Any], Any]]
) -> List[Tuple[str, Any]]:
    named: List[Tuple[str, Any]] = []
    for step in steps:
        if isinstance(step, (tuple, list)) and len(step) == 2 and isinstance(step[0], str):
            name, obj = step
        else:
            obj = step
            name = f"step_{len(named)}_{type(obj).__name__.lower()}"
        if any(name == seen for seen, _ in named):
            raise ValueError(f"Duplicate step name {name!r}")
        named.append((name, obj))
    return named


class Pipeline:
    def __init__(self, steps: Sequence[Union[Tuple[str, Any], Any]]):
        self.steps = _name_steps(steps)

    def fit(self, X, y=None, **kwargs):
        raise NotImplementedError(
            "training is not ported yet (ROADMAP.md, Queue 1: training)"
        )

    def predict(self, X) -> np.ndarray:
        for _, step in self.steps[:-1]:
            X = step.transform(X)
        return self.steps[-1][1].predict(X)

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {"steps": list(self.steps)}

    def get_state(self) -> Dict[str, Any]:
        return {
            f"step_{i}": step.get_state() if hasattr(step, "get_state") else {}
            for i, (_, step) in enumerate(self.steps)
        }

    def set_state(self, state: Dict[str, Any]) -> "Pipeline":
        for i, (_, step) in enumerate(self.steps):
            if hasattr(step, "set_state"):
                step.set_state(state.get(f"step_{i}", {}))
        return self


class TransformedTargetRegressor:
    """``regressor`` fitted on ``transformer``-scaled targets; ``predict``
    inverse-transforms back."""

    def __init__(self, regressor: Any, transformer: Optional[Any] = None):
        self.regressor = regressor
        self.transformer = transformer

    def fit(self, X, y=None, **kwargs):
        raise NotImplementedError(
            "training is not ported yet (ROADMAP.md, Queue 1: training)"
        )

    def predict(self, X) -> np.ndarray:
        pred = self.regressor.predict(X)
        if self.transformer is not None:
            pred = self.transformer.inverse_transform(pred)
        return np.asarray(pred)

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {"regressor": self.regressor, "transformer": self.transformer}

    def get_state(self) -> Dict[str, Any]:
        return {
            "regressor": (
                self.regressor.get_state() if hasattr(self.regressor, "get_state") else {}
            ),
            "transformer": (
                self.transformer.get_state()
                if hasattr(self.transformer, "get_state")
                else {}
            ),
        }

    def set_state(self, state: Dict[str, Any]) -> "TransformedTargetRegressor":
        if hasattr(self.regressor, "set_state"):
            self.regressor.set_state(state.get("regressor", {}))
        if self.transformer is not None and hasattr(self.transformer, "set_state"):
            self.transformer.set_state(state.get("transformer", {}))
        return self
