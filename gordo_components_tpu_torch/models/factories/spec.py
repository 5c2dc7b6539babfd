"""What a model factory produces (port of
``gordo_components_tpu/models/factories/spec.py:96-109``)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

from torch import nn


class ModelSpec(NamedTuple):
    """The reference's ``ModelSpec`` without the optimizer (training is a
    later slice). ``input_kind`` is ``"flat"`` for ``(batch, F)`` models and
    ``"window"`` for ``(batch, L, F)`` ones; the estimator checks it
    against its own windowing."""

    module: nn.Module
    loss: str
    input_kind: str
    config: Dict[str, Any]  # JSON-able record of the resolved architecture
