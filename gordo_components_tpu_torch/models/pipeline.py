"""``Pipeline``, ``FeatureUnion`` and ``TransformedTargetRegressor`` (port
of ``gordo_components_tpu/models/pipeline.py``), and :func:`clone_pipeline`,
the unfitted copy cross-validation fits per fold.

State keys are the reference's: a pipeline's steps by position
(``step_i``), a union's transformers by position (``transformer_i``), a
target regressor's ``regressor`` and ``transformer``. The serving engine
lifts ``Pipeline([scaler, estimator])`` only: a pipeline holding a
``FeatureUnion`` loads, fits and predicts here but is not served.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .base import GordoBase


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


class Pipeline(GordoBase):
    def __init__(self, steps: Sequence[Union[Tuple[str, Any], Any]]):
        self.steps = _name_steps(steps)

    def _transform_through(self, X, fit: bool = False, y=None):
        for _, step in self.steps[:-1]:
            if not fit:
                X = step.transform(X)
            elif hasattr(step, "fit_transform"):
                X = step.fit_transform(X, y)
            else:
                X = step.fit(X, y).transform(X)
        return X

    def fit(self, X, y=None, **kwargs) -> "Pipeline":
        """Fit each transform on the output of the one before, then the
        final estimator."""
        self.steps[-1][1].fit(self._transform_through(X, fit=True, y=y), y, **kwargs)
        return self

    def transform(self, X):
        return self.steps[-1][1].transform(self._transform_through(X))

    def predict(self, X) -> np.ndarray:
        return self.steps[-1][1].predict(self._transform_through(X))

    def score(self, X, y=None) -> float:
        return self.steps[-1][1].score(self._transform_through(X), y)

    def __getitem__(self, key):
        """A step by position or name; a slice is a pipeline of those steps."""
        if isinstance(key, slice):
            return Pipeline(self.steps[key])
        if isinstance(key, str):
            return dict(self.steps)[key]
        return self.steps[key][1]

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {"steps": list(self.steps)}

    def get_metadata(self) -> Dict[str, Any]:
        return {
            "type": "Pipeline",
            "steps": [
                {name: step.get_metadata() if hasattr(step, "get_metadata") else {}}
                for name, step in self.steps
            ],
        }

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


class FeatureUnion(GordoBase):
    """The transformers' outputs side by side along the feature axis
    (sklearn's ``FeatureUnion``), each block float32 and scaled by its
    name's ``transformer_weights`` entry (1 by default; a weight naming no
    transformer raises)."""

    def __init__(
        self,
        transformer_list: Sequence[Union[Tuple[str, Any], Any]],
        transformer_weights: Optional[Dict[str, float]] = None,
    ):
        self.transformer_list = _name_steps(transformer_list)
        self.transformer_weights = transformer_weights
        if transformer_weights:
            names = {name for name, _ in self.transformer_list}
            unknown = set(transformer_weights) - names
            if unknown:
                raise ValueError(f"transformer_weights keys {sorted(unknown)} match no "
                                 f"transformer; names are {sorted(names)}")

    def _assemble(self, name: str, block: Any) -> np.ndarray:
        block = np.asarray(block, dtype=np.float32)
        if block.ndim == 1:
            block = block[:, None]
        weight = float((self.transformer_weights or {}).get(name, 1.0))
        return block * weight

    def fit(self, X, y=None, **_kwargs) -> "FeatureUnion":
        for _, transformer in self.transformer_list:
            transformer.fit(X, y)
        return self

    def transform(self, X) -> np.ndarray:
        return np.concatenate([self._assemble(name, transformer.transform(X))
                               for name, transformer in self.transformer_list], axis=1)

    def fit_transform(self, X, y=None) -> np.ndarray:
        blocks = []
        for name, transformer in self.transformer_list:
            if hasattr(transformer, "fit_transform"):
                block = transformer.fit_transform(X, y)
            else:
                block = transformer.fit(X, y).transform(X)
            blocks.append(self._assemble(name, block))
        return np.concatenate(blocks, axis=1)

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {"transformer_list": list(self.transformer_list),
                "transformer_weights": self.transformer_weights}

    def get_metadata(self) -> Dict[str, Any]:
        return {
            "type": "FeatureUnion",
            "transformers": [
                {name: step.get_metadata() if hasattr(step, "get_metadata") else {}}
                for name, step in self.transformer_list
            ],
        }

    def get_state(self) -> Dict[str, Any]:
        return {f"transformer_{i}": step.get_state() if hasattr(step, "get_state") else {}
                for i, (_, step) in enumerate(self.transformer_list)}

    def set_state(self, state: Dict[str, Any]) -> "FeatureUnion":
        for i, (_, step) in enumerate(self.transformer_list):
            if hasattr(step, "set_state"):
                step.set_state(state.get(f"transformer_{i}", {}))
        return self


class TransformedTargetRegressor(GordoBase):
    """``regressor`` fitted on ``transformer``-scaled targets; ``predict``
    inverse-transforms back."""

    def __init__(self, regressor: Any, transformer: Optional[Any] = None):
        self.regressor = regressor
        self.transformer = transformer

    def fit(self, X, y=None, **kwargs) -> "TransformedTargetRegressor":
        """Fit the transformer on the targets (``y``, else ``X``), then the
        regressor on the transformed targets."""
        y_arr = X if y is None else y
        if self.transformer is not None:
            y_arr = self.transformer.fit_transform(y_arr)
        self.regressor.fit(X, y_arr, **kwargs)
        return self

    def predict(self, X) -> np.ndarray:
        pred = self.regressor.predict(X)
        if self.transformer is not None:
            pred = self.transformer.inverse_transform(pred)
        return np.asarray(pred)

    def score(self, X, y=None) -> float:
        """Explained variance of the predictions against the targets (``y``,
        else ``X``), tail-aligned: a windowed regressor predicts the last
        rows only."""
        from .metrics import explained_variance_score

        y_arr = np.asarray(X if y is None else y)
        pred = self.predict(X)
        return explained_variance_score(y_arr[len(y_arr) - len(pred):], pred)

    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {"regressor": self.regressor, "transformer": self.transformer}

    def get_metadata(self) -> Dict[str, Any]:
        return {
            "type": "TransformedTargetRegressor",
            "regressor": (
                self.regressor.get_metadata() if hasattr(self.regressor, "get_metadata") else {}
            ),
        }

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


def clone_pipeline(obj: Any) -> Any:
    """A deep, unfitted copy of a pipeline or estimator graph: every object
    rebuilt from its ``get_params``, nested graphs cloned too, so that
    cross-validation folds share no fitted state. An estimator's device
    (:meth:`BaseTorchEstimator.to`) carries over."""
    if isinstance(obj, Pipeline):
        return Pipeline([(name, clone_pipeline(step)) for name, step in obj.steps])
    if isinstance(obj, FeatureUnion):
        return FeatureUnion([(name, clone_pipeline(step)) for name, step in obj.transformer_list],
                            transformer_weights=copy.deepcopy(obj.transformer_weights))
    if isinstance(obj, TransformedTargetRegressor):
        return TransformedTargetRegressor(
            regressor=clone_pipeline(obj.regressor),
            transformer=None if obj.transformer is None else clone_pipeline(obj.transformer),
        )
    if hasattr(obj, "get_params"):
        params = {
            key: clone_pipeline(value) if hasattr(value, "get_params") else copy.deepcopy(value)
            for key, value in obj.get_params(deep=False).items()
        }
        clone = type(obj)(**params)
        if getattr(obj, "device", None) is not None:
            clone.to(obj.device)
        return clone
    return copy.deepcopy(obj)
