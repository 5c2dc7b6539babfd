"""Prometheus text format (v0.0.4): rendering and a validating parser (the
port's copy of ``gordo_components_tpu/observability/exposition.py``,
without exemplars, which the port's registry does not record).

``render_prometheus`` turns a :class:`~.registry.Registry` into the text a
scraper ingests: ``# HELP`` / ``# TYPE`` comments, cumulative
``_bucket{le=...}`` + ``_sum`` + ``_count`` for histograms, escaped label
values. ``parse_prometheus_text`` is the inverse validator: a malformed
line, an unknown type or a histogram whose ``+Inf`` bucket disagrees with
its count raises ``ValueError``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

from .registry import Histogram, Registry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{(.*)\})?"                        # optional label body
    r"\s+(-?[0-9.eE+-]+|[+-]Inf|NaN)"       # value
    r"(?:\s+(-?[0-9]+))?$"                  # optional timestamp
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _escape_label(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def _fmt_labels(labelnames, values, extra: Tuple[str, str] = None) -> str:
    pairs = [f'{name}="{_escape_label(value)}"' for name, value in zip(labelnames, values)]
    if extra is not None:
        pairs.append(f'{extra[0]}="{_escape_label(extra[1])}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(registry: Registry) -> str:
    """The registry as Prometheus text exposition format v0.0.4."""
    lines: List[str] = []
    for metric in registry.metrics():
        if metric.help:
            lines.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        if isinstance(metric, Histogram):
            for values, data in sorted(metric.collect().items()):
                for le, cumulative in data["buckets"]:
                    labels = _fmt_labels(metric.labelnames, values, extra=("le", _fmt_value(le)))
                    lines.append(f"{metric.name}_bucket{labels} {cumulative}")
                labels = _fmt_labels(metric.labelnames, values)
                lines.append(f"{metric.name}_sum{labels} {_fmt_value(data['sum'])}")
                lines.append(f"{metric.name}_count{labels} {data['count']}")
        else:
            for values, value in sorted(metric.collect().items()):
                labels = _fmt_labels(metric.labelnames, values)
                lines.append(f"{metric.name}{labels} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def _unescape_label(raw: str) -> str:
    """One left-to-right scan (sequential replaces would turn a literal
    backslash followed by ``n`` into a newline)."""
    out: List[str] = []
    i = 0
    while i < len(raw):
        ch = raw[i]
        if ch == "\\" and i + 1 < len(raw):
            nxt = raw[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_label_body(body: str, lineno: int) -> Dict[str, str]:
    if not body:
        return {}
    # a trailing comma is legal; anything else must be name="value" pairs
    rest = _LABEL_RE.sub("", body).replace(",", "").strip()
    if rest:
        raise ValueError(f"line {lineno}: malformed label body {body!r}")
    return {m.group(1): _unescape_label(m.group(2)) for m in _LABEL_RE.finditer(body)}


def _parse_value(raw: str, lineno: int) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    if raw == "NaN":
        return math.nan
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"line {lineno}: unparseable value {raw!r}") from None


def _series_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def parse_prometheus_text(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Parse and validate exposition text: ``{name: [(labels, value),
    ...]}``. Raises ``ValueError`` naming the line on anything that is
    neither a well-formed comment nor a well-formed sample, on an unknown
    ``# TYPE``, and on a histogram whose ``+Inf`` bucket is not its
    ``_count``."""
    samples: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    types: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                continue  # a free-form comment
            if not _NAME_RE.match(parts[2]):
                raise ValueError(f"line {lineno}: bad metric name in comment: {parts[2]!r}")
            if parts[1] == "TYPE":
                kind = parts[3].strip() if len(parts) > 3 else ""
                if kind not in ("counter", "gauge", "histogram", "summary", "untyped"):
                    raise ValueError(f"line {lineno}: unknown metric type {kind!r}")
                types[parts[2]] = kind
            continue
        match = _SAMPLE_RE.match(line)
        if not match:
            raise ValueError(f"line {lineno}: malformed sample line {line!r}")
        name, body, raw_value = match.group(1), match.group(2), match.group(3)
        samples.setdefault(name, []).append(
            (_parse_label_body(body or "", lineno), _parse_value(raw_value, lineno))
        )
    for name, kind in types.items():
        if kind != "histogram":
            continue
        counts = {_series_key(labels): value for labels, value in samples.get(f"{name}_count", [])}
        inf_buckets = {
            _series_key({k: v for k, v in labels.items() if k != "le"}): value
            for labels, value in samples.get(f"{name}_bucket", [])
            if labels.get("le") == "+Inf"
        }
        for key, count in counts.items():
            if key not in inf_buckets:
                raise ValueError(f"histogram {name}: series {key or '(unlabeled)'} has no +Inf bucket")
            if inf_buckets[key] != count:
                raise ValueError(
                    f"histogram {name}: +Inf bucket {inf_buckets[key]} != count {count} "
                    f"for series {key or '(unlabeled)'}"
                )
    return samples
