"""Definition dict → live (unfitted) pipeline (port of
``gordo_components_tpu/serializer/from_definition.py``).

Class paths resolve through one explicit table and nothing else: the
reference package's paths (what its ``dump`` writes), the sklearn and
``gordo_components`` aliases its configs use, and the short names. A name
outside the table is refused — an artifact is data, and the port never
imports a name an artifact gives it.
"""

from __future__ import annotations

from typing import Any, Dict

from ..models.anomaly.diff import DiffBasedAnomalyDetector
from ..models.models import (
    DenseAutoEncoder,
    LSTMAutoEncoder,
    LSTMForecast,
    MultiStepForecast,
    PatchTSTAutoEncoder,
    PatchTSTForecast,
)
from ..models.pipeline import FeatureUnion, Pipeline, TransformedTargetRegressor
from ..models.transformers import (
    FunctionTransformer,
    InfImputer,
    MinMaxScaler,
    StandardScaler,
)

_REF = "gordo_components_tpu.models"

# the reference's class path → the port's class; the reverse of this
# table is what the port's own dump writes
CLASS_PATHS: Dict[str, type] = {
    f"{_REF}.anomaly.diff.DiffBasedAnomalyDetector": DiffBasedAnomalyDetector,
    f"{_REF}.pipeline.Pipeline": Pipeline,
    f"{_REF}.pipeline.FeatureUnion": FeatureUnion,
    f"{_REF}.pipeline.TransformedTargetRegressor": TransformedTargetRegressor,
    f"{_REF}.transformers.MinMaxScaler": MinMaxScaler,
    f"{_REF}.transformers.StandardScaler": StandardScaler,
    f"{_REF}.transformers.InfImputer": InfImputer,
    f"{_REF}.transformers.FunctionTransformer": FunctionTransformer,
    f"{_REF}.models.DenseAutoEncoder": DenseAutoEncoder,
    f"{_REF}.models.LSTMAutoEncoder": LSTMAutoEncoder,
    f"{_REF}.models.LSTMForecast": LSTMForecast,
    f"{_REF}.models.MultiStepForecast": MultiStepForecast,
    f"{_REF}.models.PatchTSTAutoEncoder": PatchTSTAutoEncoder,
    f"{_REF}.models.PatchTSTForecast": PatchTSTForecast,
}

_ALIASES: Dict[str, str] = {
    "sklearn.pipeline.Pipeline": f"{_REF}.pipeline.Pipeline",
    "sklearn.pipeline.FeatureUnion": f"{_REF}.pipeline.FeatureUnion",
    "sklearn.compose.TransformedTargetRegressor": (
        f"{_REF}.pipeline.TransformedTargetRegressor"
    ),
    "sklearn.preprocessing.MinMaxScaler": f"{_REF}.transformers.MinMaxScaler",
    "sklearn.preprocessing.data.MinMaxScaler": f"{_REF}.transformers.MinMaxScaler",
    "sklearn.preprocessing.StandardScaler": f"{_REF}.transformers.StandardScaler",
    "sklearn.preprocessing.data.StandardScaler": f"{_REF}.transformers.StandardScaler",
    "sklearn.preprocessing.FunctionTransformer": f"{_REF}.transformers.FunctionTransformer",
    "gordo_components.model.transformers.imputer.InfImputer": f"{_REF}.transformers.InfImputer",
    "gordo_components.model.models.KerasAutoEncoder": f"{_REF}.models.DenseAutoEncoder",
    "gordo_components.model.models.KerasLSTMAutoEncoder": f"{_REF}.models.LSTMAutoEncoder",
    "gordo_components.model.models.KerasLSTMForecast": f"{_REF}.models.LSTMForecast",
    "gordo_components.model.anomaly.diff.DiffBasedAnomalyDetector": (
        f"{_REF}.anomaly.diff.DiffBasedAnomalyDetector"
    ),
}
_ALIASES.update({path.rsplit(".", 1)[1]: path for path in CLASS_PATHS})
_ALIASES["KerasAutoEncoder"] = f"{_REF}.models.DenseAutoEncoder"
_ALIASES["KerasLSTMAutoEncoder"] = f"{_REF}.models.LSTMAutoEncoder"
_ALIASES["KerasLSTMForecast"] = f"{_REF}.models.LSTMForecast"


# the kwargs that hold [name, definition] pairs: a pipeline's steps, a
# union's transformers
_STEP_LISTS = ("steps", "transformer_list")


def resolve_class_path(path: str) -> type:
    try:
        return CLASS_PATHS[_ALIASES.get(path, path)]
    except KeyError:
        raise ValueError(
            f"{path!r} is not a class the port can build; known: "
            f"{sorted(CLASS_PATHS)}"
        ) from None


def _is_class_name(name: Any) -> bool:
    return isinstance(name, str) and (name in _ALIASES or name in CLASS_PATHS)


def _is_class_definition(node: Any) -> bool:
    return isinstance(node, dict) and len(node) == 1 and (
        _is_class_name(next(iter(node))) or "." in str(next(iter(node)))
    )


def _build(node: Any) -> Any:
    if _is_class_name(node):
        return resolve_class_path(node)()
    if not _is_class_definition(node):
        return node
    path, kwargs = next(iter(node.items()))
    target = resolve_class_path(path)
    if kwargs is None:
        kwargs = {}
    if not isinstance(kwargs, dict):
        raise ValueError(f"Definition for {path!r} must map to kwargs, got {type(kwargs)}")
    built = {
        key: (
            _build_steps(value)
            if key in _STEP_LISTS and isinstance(value, list)
            else _build_value(value)
        )
        for key, value in kwargs.items()
    }
    return target(**built)


def _build_steps(value: list) -> list:
    """A ``[name, definition]`` pair is a named step; anything else a bare
    step definition."""
    out = []
    for el in value:
        if (
            isinstance(el, list)
            and len(el) == 2
            and isinstance(el[0], str)
            and (_is_class_definition(el[1]) or isinstance(el[1], str))
        ):
            out.append((el[0], _build(el[1])))
        else:
            out.append(_build(el))
    return out


def _build_value(value: Any) -> Any:
    if _is_class_name(value) or _is_class_definition(value):
        return _build(value)
    if isinstance(value, list):
        return [_build_value(v) for v in value]
    if isinstance(value, dict):
        return {k: _build_value(v) for k, v in value.items()}
    return value


def pipeline_from_definition(definition: Dict[str, Any]) -> Any:
    """Materialize a definition (a ``{class.path: kwargs}`` mapping or a
    class name) into a live, unfitted graph of the port's classes."""
    built = _build(definition)
    if built is definition or isinstance(built, (str, dict)):
        raise ValueError(
            "Model definition must be a single-key {class.path: kwargs} "
            f"mapping or a class name; got: {definition!r}"
        )
    return built
