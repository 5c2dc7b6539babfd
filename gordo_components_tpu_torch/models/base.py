"""The estimator contract every model of the port satisfies: the
reference's ``GordoBase`` (``gordo_components_tpu/models/base.py``).

``GordoBase`` puts ``get_metadata()`` on top of the sklearn estimator API
(``fit``/``predict``/``get_params``/``set_params``/``score``) and a pure-state
contract (:meth:`get_state`/:meth:`set_state`): every fitted model
round-trips through a dict of numpy arrays + plain JSON config, because that
is what the serializer persists and what the serving engine stacks across
machines.
"""

from __future__ import annotations

import abc
from typing import Any, Dict


class GordoBase(abc.ABC):
    """Abstract base for all models (and the anomaly wrappers around them)."""

    @abc.abstractmethod
    def fit(self, X, y=None, **kwargs):
        """Fit to ``X`` (and ``y`` when the target tags differ from inputs)."""

    @abc.abstractmethod
    def get_metadata(self) -> Dict[str, Any]:
        """JSON-serializable description of the fitted model: kind, hyper-
        params, loss history, durations — merged into build metadata."""

    @abc.abstractmethod
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        """Constructor kwargs, sufficient to re-create this estimator
        (sklearn ``get_params`` semantics; ``clone`` compatibility)."""

    def set_params(self, **params) -> "GordoBase":
        for key, value in params.items():
            setattr(self, key, value)
        return self

    # -- pure-state persistence contract ------------------------------------
    def get_state(self) -> Dict[str, Any]:
        """Fitted state as {numpy arrays + JSON-able config}. Default: no
        fitted state (stateless transformers override nothing)."""
        return {}

    def set_state(self, state: Dict[str, Any]) -> "GordoBase":
        """Inverse of :meth:`get_state`."""
        return self


def clone_estimator(estimator):
    """Unfitted copy via ``get_params`` — sklearn.clone semantics without
    requiring sklearn introspection of ``**kwargs`` constructors."""
    return type(estimator)(**estimator.get_params(deep=False))
