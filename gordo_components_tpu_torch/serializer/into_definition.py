"""Live pipeline → definition dict (port of
``gordo_components_tpu/serializer/into_definition.py``).

Classes are written under the reference package's class paths, so an
artifact the port dumps has the reference's format and loads in either
package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .from_definition import _STEP_LISTS, CLASS_PATHS

_PATH_OF = {cls: path for path, cls in CLASS_PATHS.items()}


def _plain(value: Any) -> Any:
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (tuple, list)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if type(value) in _PATH_OF:
        return pipeline_into_definition(value)
    raise ValueError(f"Cannot serialize {value!r} ({type(value)}) into a definition")


def pipeline_into_definition(obj: Any) -> Dict[str, Any]:
    if type(obj) not in _PATH_OF:
        raise ValueError(f"{type(obj).__name__} has no definition path")
    kwargs: Dict[str, Any] = {}
    for key, value in obj.get_params(deep=False).items():
        if key in _STEP_LISTS:
            kwargs[key] = [[name, pipeline_into_definition(step)] for name, step in value]
        else:
            kwargs[key] = _plain(value)
    return {_PATH_OF[type(obj)]: kwargs}


def into_definition_yaml(obj: Any) -> str:
    """:func:`pipeline_into_definition` as YAML text, keys in the
    definition's order (``yaml`` is imported here)."""
    try:
        import yaml
    except ImportError as exc:
        raise ImportError("into_definition_yaml needs the 'yaml' package, which is not "
                          "installed") from exc
    return yaml.safe_dump(pipeline_into_definition(obj), sort_keys=False)
