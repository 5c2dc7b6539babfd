"""Sensor tags: a tag is a ``(name, asset)`` pair (the port's copy of
``gordo_components_tpu/dataset/sensor_tag.py:1-111``).

``normalize_sensor_tags`` accepts the spellings fleet configs use: bare
strings, ``[name, asset]`` lists, ``{"name": ..., "asset": ...}`` dicts and
``SensorTag`` instances, inferring the asset from the tag name's prefix
when none is given.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Union


class SensorTag(NamedTuple):
    name: str
    asset: Optional[str] = None

    def to_dict(self) -> Dict[str, Optional[str]]:
        return {"name": self.name, "asset": self.asset}


class SensorTagNormalizationError(ValueError):
    """Raised when a tag spec cannot be resolved into a ``SensorTag``."""


# prefix -> asset conventions, extended by ``register_tag_prefix``
TAG_PREFIX_TO_ASSET: Dict[str, str] = {
    "ASGB": "asgb",
    "GRA": "gra",
    "1901": "asgb",
    "1776": "gra",
    "1125": "kvb",
    "1138": "val",
}

_TAG_RE = re.compile(r"^([A-Za-z0-9]+)[._-]")


def register_tag_prefix(prefix: str, asset: str) -> None:
    """Extend the prefix→asset inference table (site-specific conventions)."""
    TAG_PREFIX_TO_ASSET[prefix.upper()] = asset


def _infer_asset(tag_name: str) -> Optional[str]:
    match = _TAG_RE.match(tag_name)
    if match:
        # a separator-delimited prefix is looked up exactly, never by the
        # startswith scan below ("GRADIENT.01" is not "GRA")
        return TAG_PREFIX_TO_ASSET.get(match.group(1).upper())
    # no separator (e.g. "1901TAG"): longest registered prefix at the start
    upper = tag_name.upper()
    best = None
    for prefix, asset in TAG_PREFIX_TO_ASSET.items():
        if upper.startswith(prefix) and (best is None or len(prefix) > len(best[0])):
            best = (prefix, asset)
    return best[1] if best else None


TagSpec = Union[str, List, Dict, SensorTag]


def normalize_sensor_tag(tag: TagSpec, asset: Optional[str] = None) -> SensorTag:
    """Resolve one tag spec into a ``SensorTag``.

    Accepted forms:

    - ``SensorTag`` — returned as-is
    - ``{"name": "TAG", "asset": "plant"}``
    - ``["TAG", "plant"]`` (a 2-list)
    - ``"TAG"`` — asset from the ``asset`` default or prefix inference
    """
    if isinstance(tag, SensorTag):
        return tag
    if isinstance(tag, dict):
        try:
            name = tag["name"]
        except KeyError as exc:
            raise SensorTagNormalizationError(
                f"Tag dict {tag!r} has no 'name' key"
            ) from exc
        return SensorTag(name=str(name), asset=tag.get("asset") or asset or _infer_asset(str(name)))
    if isinstance(tag, (list, tuple)):
        if len(tag) == 2:
            if tag[1] is None:
                return normalize_sensor_tag(str(tag[0]), asset)
            return SensorTag(name=str(tag[0]), asset=str(tag[1]))
        if len(tag) == 1:
            return normalize_sensor_tag(tag[0], asset)
        raise SensorTagNormalizationError(
            f"Tag list {tag!r} must have 1 or 2 elements (name[, asset])"
        )
    if isinstance(tag, str):
        return SensorTag(name=tag, asset=asset or _infer_asset(tag))
    raise SensorTagNormalizationError(f"Cannot normalize tag of type {type(tag)}: {tag!r}")


def normalize_sensor_tags(
    tag_list: List[TagSpec], asset: Optional[str] = None
) -> List[SensorTag]:
    """Normalize a heterogeneous list of tag specs into ``SensorTag`` objects."""
    return [normalize_sensor_tag(tag, asset=asset) for tag in tag_list]


def to_list_of_strings(tag_list: List[SensorTag]) -> List[str]:
    return [tag.name for tag in tag_list]
