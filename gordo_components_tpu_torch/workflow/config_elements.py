"""Fleet-config normalization (the port's copy of
``gordo_components_tpu/workflow/config_elements.py:1-156``).

The fleet YAML lists ``machines`` and a ``globals`` section of defaults;
:class:`NormalizedConfig` merges each machine's config over the globals
(the machine wins, dict-deep for dataset, metadata and evaluation) into
one fully specified :class:`Machine` per entry. A YAML string is read
through ``yaml``, imported only there; where it is missing that raises an
error naming it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union


@dataclass
class Machine:
    name: str
    model: Dict[str, Any]
    dataset: Dict[str, Any]
    metadata: Dict[str, Any] = field(default_factory=dict)
    evaluation: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if not self.name:
            raise ValueError("Machine requires a non-empty name")
        if not self.model:
            raise ValueError(f"Machine {self.name!r} has no model config "
                             "(neither per-machine nor in globals)")
        if not self.dataset:
            raise ValueError(f"Machine {self.name!r} has no dataset config")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "model": self.model,
            "dataset": self.dataset,
            "metadata": self.metadata,
            "evaluation": self.evaluation,
        }


def _merged(defaults: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Deep merge: machine wins per KEY, recursively for nested mappings —
    so a machine overriding ``dataset.data_provider.base_dir`` keeps the
    global provider ``type`` (the shape the module docstring promises; a
    shallow update would silently drop sibling keys of any nested
    override). Non-dict values (lists like tag_list included) replace
    wholesale."""
    out = dict(defaults)
    for key, value in (override or {}).items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _merged(out[key], value)
        else:
            out[key] = value
    return out


def load_yaml(text: str) -> Any:
    """``yaml.safe_load`` of ``text``, with ``yaml`` imported here alone."""
    try:
        import yaml
    except ImportError as exc:
        raise ValueError("reading a fleet config as YAML needs the 'yaml' package (PyYAML), "
                         "which is not installed; pass the config as a mapping") from exc
    return yaml.safe_load(text)


class NormalizedConfig:
    """``yaml/dict`` fleet config → normalized machines.

    Expected shape::

        project-name: my-project
        machines:
          - name: m1
            dataset: {tag_list: [...], ...}
            model: {...}           # optional if globals.model given
            metadata: {...}
            evaluation: {...}
        globals:
          model: {...}
          dataset: {resolution: 10min, ...}
          evaluation: {n_splits: 3}
    """

    def __init__(self, config: Union[str, Dict[str, Any]]):
        if isinstance(config, str):
            config = load_yaml(config)
        if not isinstance(config, dict):
            raise ValueError(f"Fleet config must be a mapping, got {type(config)}")
        crd_name = None
        # the CRD unwrap requires CRD MARKERS (kind/apiVersion), not just a
        # top-level 'spec' mapping: a plain fleet config that happens to
        # carry a 'spec' key must parse normally instead of being rejected
        # with "no spec.config mapping". A config that declares
        # kind: Gordo (or any apiVersion) and has a spec mapping is
        # unambiguously the wrapper — and a WRONG kind with a spec is
        # rejected loudly rather than misread as a flat config.
        kind = config.get("kind")
        is_crd = isinstance(config.get("spec"), dict) and (
            kind is not None or "apiVersion" in config
        )
        if kind is not None and not is_crd:
            raise ValueError(
                f"Config declares kind: {kind!r} but has no spec mapping; "
                "a CRD-shaped fleet config needs spec.config"
            )
        if is_crd and kind not in (None, "Gordo"):
            raise ValueError(
                f"Unsupported CRD kind {kind!r}; expected 'Gordo'"
            )
        if is_crd:
            # the reference's full CRD wrapper (apiVersion: equinor.com/v1,
            # kind: Gordo): machines/globals live under spec.config and the
            # project name under metadata.name — accepted verbatim so a
            # deployed gordo config ports with zero edits
            metadata = config.get("metadata")
            if metadata is not None and not isinstance(metadata, dict):
                raise ValueError(
                    "CRD-shaped fleet config has a non-mapping metadata "
                    f"({type(metadata).__name__}); expected e.g. "
                    "{name: my-project}"
                )
            crd_name = (metadata or {}).get("name")
            inner = config["spec"].get("config")
            if not isinstance(inner, dict):
                raise ValueError(
                    "CRD-shaped fleet config has no spec.config mapping"
                )
            config = inner
        self.project_name: str = (
            config.get("project-name")
            or config.get("project_name")
            or crd_name
            or "project"
        )
        raw_machines: Optional[List[Dict[str, Any]]] = config.get("machines")
        if not raw_machines:
            raise ValueError("Fleet config has no 'machines' list")
        defaults = config.get("globals", {}) or {}
        default_model = defaults.get("model", {}) or {}
        default_dataset = defaults.get("dataset", {}) or {}
        default_metadata = defaults.get("metadata", {}) or {}
        default_evaluation = defaults.get("evaluation", {}) or {}

        seen: set = set()
        self.machines: List[Machine] = []
        for entry in raw_machines:
            name = entry.get("name")
            if name in seen:
                raise ValueError(f"Duplicate machine name {name!r}")
            seen.add(name)
            self.machines.append(
                Machine(
                    name=name,
                    model=entry.get("model") or default_model,
                    dataset=_merged(default_dataset, entry.get("dataset", {})),
                    metadata=_merged(default_metadata, entry.get("metadata", {})),
                    evaluation=_merged(
                        default_evaluation, entry.get("evaluation", {})
                    ),
                )
            )
