"""Config ``type`` → class, through a closed table (the port's counterpart
of ``gordo_components_tpu/utils/config.py:29-50``).

The reference imports the dotted path a config names. The port never
does: a reference config names ``gordo_components_tpu.dataset.dataset.
TimeSeriesDataset``, and importing it would load the JAX package. Each
base class hands over its table of classes and the module paths under
which configs may name them (the reference's and the port's); a bare name,
or a known module plus a name in the table, resolves to the port's class,
and anything else raises ``ValueError``, as
``serializer/from_definition.py`` does for model classes.
"""

from __future__ import annotations

from typing import Dict, Iterable, Type


def resolve_config_class(
    type_path: str,
    base_cls: Type,
    classes: Dict[str, Type],
    modules: Iterable[str],
) -> Type:
    """The port's class for ``type_path``: a bare name, or one of
    ``modules`` followed by a name."""
    if not isinstance(type_path, str) or not type_path:
        raise ValueError(f"{base_cls.__name__} type must be a non-empty string, not {type_path!r}")
    module, _, name = type_path.rpartition(".")
    modules = tuple(modules)
    if module and module not in modules:
        raise ValueError(
            f"{type_path!r} is not a {base_cls.__name__} this package resolves: a config "
            f"names a bare class or one under {', '.join(modules)}")
    resolved = classes.get(name)
    if resolved is None:
        raise ValueError(f"Unknown {base_cls.__name__} {type_path!r} "
                         f"(known: {', '.join(sorted(classes))})")
    if not (isinstance(resolved, type) and issubclass(resolved, base_cls)):
        raise ValueError(f"{type_path} is not a {base_cls.__name__}")
    return resolved
