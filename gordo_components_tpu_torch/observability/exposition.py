"""Prometheus text format (v0.0.4): rendering and a validating parser (the
port's copy of ``gordo_components_tpu/observability/exposition.py``).

``render_prometheus`` turns a :class:`~.registry.Registry` into the text a
scraper ingests: ``# HELP`` / ``# TYPE`` comments, cumulative
``_bucket{le=...}`` + ``_sum`` + ``_count`` for histograms, escaped label
values; machine-labeled families render bounded (top-K + ``other``).
``parse_prometheus_text`` is the inverse validator: a malformed line, an
unknown type or a histogram whose ``+Inf`` bucket disagrees with its count
raises ``ValueError``.

Exemplars: with ``exemplars=True`` (the server's ``?exemplars=1``) a
histogram bucket carries an OpenMetrics exemplar suffix, `` #
{trace_id="3f2a..."} 0.042 1690000000.123``, naming the request timeline
in ``/debug/requests`` behind its last traced observation. The default
render stays strict v0.0.4, whose parsers reject the suffix. The parser
validates exemplars (label grammar, the 128-character OpenMetrics label
budget, placement on histogram buckets and counters only) and raises on a
malformed one.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Tuple

from .registry import Histogram, Registry, bound_machine_cardinality

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{(.*)\})?"                        # optional label body
    r"\s+(-?[0-9.eE+-]+|[+-]Inf|NaN)"       # value
    r"(?:\s+(-?[0-9]+))?$"                  # optional timestamp
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
# exemplar suffix (OpenMetrics): `<sample> # {labels} value [timestamp]`.
# The greedy prefix makes the LAST ` # {` on the line the exemplar
# boundary, so escaped label values earlier in the line cannot split it.
_EXEMPLAR_RE = re.compile(
    r"^(?P<sample>.*\S)\s+#\s+\{(?P<labels>.*)\}"
    r"\s+(?P<value>-?[0-9.eE+-]+|[+-]Inf|NaN)"
    r"(?:\s+(?P<ts>[0-9]+(?:\.[0-9]+)?))?$"
)
# OpenMetrics: an exemplar's label names + values must fit 128 runes
_EXEMPLAR_LABEL_BUDGET = 128


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


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
    pairs = [
        f'{name}="{_escape_label(value)}"'
        for name, value in zip(labelnames, values)
    ]
    if extra is not None:
        pairs.append(f'{extra[0]}="{_escape_label(extra[1])}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_exemplar(exemplar) -> str:
    """`` # {trace_id="..."} value timestamp`` (OpenMetrics exemplar)."""
    trace_id, value, ts = exemplar
    return (
        f' # {{trace_id="{_escape_label(trace_id)}"}} '
        f"{_fmt_value(value)} {ts:.3f}"
    )


def render_prometheus(registry: Registry, exemplars: bool = False) -> str:
    """The registry as Prometheus text exposition format v0.0.4.

    ``exemplars=True`` additionally renders OpenMetrics-style exemplars
    on histogram buckets whose last traced observation is known. That is
    an OPT-IN extension (``?exemplars=1`` on the server): the classic
    Prometheus text parser selected by the v0.0.4 content type rejects
    the `` # {...}`` suffix outright, so the default scrape must stay
    strict — exemplar output is for trace debugging and
    OpenMetrics-capable ingesters."""
    lines: List[str] = []
    for metric in registry.metrics():
        if metric.help:
            lines.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        if isinstance(metric, Histogram):
            # machine-labeled families render top-K + "other", so the
            # exposition's size is bounded at any fleet size
            collected = bound_machine_cardinality(metric, metric.collect())
            for values, data in sorted(collected.items()):
                series_exemplars = data.get("exemplars") or {}
                for i, (le, cumulative) in enumerate(data["buckets"]):
                    labels = _fmt_labels(
                        metric.labelnames, values, extra=("le", _fmt_value(le))
                    )
                    suffix = ""
                    if exemplars and i in series_exemplars:
                        suffix = _fmt_exemplar(series_exemplars[i])
                    lines.append(
                        f"{metric.name}_bucket{labels} {cumulative}{suffix}"
                    )
                labels = _fmt_labels(metric.labelnames, values)
                lines.append(
                    f"{metric.name}_sum{labels} {_fmt_value(data['sum'])}"
                )
                lines.append(f"{metric.name}_count{labels} {data['count']}")
        else:
            collected = bound_machine_cardinality(metric, metric.collect())
            for values, value in sorted(collected.items()):
                labels = _fmt_labels(metric.labelnames, values)
                lines.append(f"{metric.name}{labels} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def _parse_label_body(body: str, lineno: int) -> Dict[str, str]:
    if not body:
        return {}
    labels: Dict[str, str] = {}
    # tolerate a trailing comma (the format allows it); everything else in
    # the body must be name="value" pairs — leftovers mean a malformed line
    rest = _LABEL_RE.sub("", body).replace(",", "").strip()
    if rest:
        raise ValueError(f"line {lineno}: malformed label body {body!r}")
    for match in _LABEL_RE.finditer(body):
        labels[match.group(1)] = _unescape_label(match.group(2))
    return labels


def _unescape_label(raw: str) -> str:
    """Single left-to-right scan: sequential str.replace would corrupt a
    literal backslash followed by 'n' (``\\\\n`` must decode to ``\\`` +
    ``n``, not a newline)."""
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


def _parse_exemplar(line: str, lineno: int, types: Dict[str, str]):
    """Detach and validate a trailing exemplar; returns ``(sample_part,
    exemplar_dict_or_None)``.

    A line only counts as carrying an exemplar when the exemplar suffix
    matches AND what precedes it is itself a well-formed sample — a
    quoted label value containing `` # `` is a legal plain sample, not a
    malformed exemplar. Once a line IS an exemplar, every defect in it
    (bad label grammar, over-budget label set, placement on anything but
    a histogram bucket or counter) fails loudly — a scraper would either
    reject it or silently drop the series."""
    if " # " not in line:
        return line, None
    match = _EXEMPLAR_RE.match(line)
    if match is not None:
        sample_part = match.group("sample")
        sample_match = _SAMPLE_RE.match(sample_part)
        if sample_match is not None:
            try:
                _parse_label_body(sample_match.group(2) or "", lineno)
            except ValueError:
                sample_match = None  # not a valid sample prefix after all
        if sample_match is not None:
            labels = _parse_label_body(match.group("labels"), lineno)
            if not labels:
                raise ValueError(
                    f"line {lineno}: exemplar must carry at least one label"
                )
            budget = sum(len(k) + len(v) for k, v in labels.items())
            if budget > _EXEMPLAR_LABEL_BUDGET:
                raise ValueError(
                    f"line {lineno}: exemplar label set is {budget} runes "
                    f"(OpenMetrics caps it at {_EXEMPLAR_LABEL_BUDGET})"
                )
            value = _parse_value(match.group("value"), lineno)
            ts = float(match.group("ts")) if match.group("ts") else None
            # placement: OpenMetrics allows exemplars on histogram
            # buckets and counters only — anywhere else is malformed
            name = sample_match.group(1)
            base = (
                name[: -len("_bucket")] if name.endswith("_bucket") else None
            )
            bucket_ok = base is not None and types.get(base) == "histogram"
            counter_ok = types.get(name) == "counter"
            if not (bucket_ok or counter_ok):
                raise ValueError(
                    f"line {lineno}: exemplar on {name!r}, which is "
                    "neither a histogram bucket nor a counter"
                )
            return sample_part, {
                "labels": labels, "value": value, "timestamp": ts,
            }
    # no well-formed exemplar: hand the whole line to the plain sample
    # parser (which fails loudly itself if the line is genuinely broken)
    return line, None


def parse_prometheus_text(
    text: str, return_exemplars: bool = False, return_meta: bool = False
) -> Any:
    """Parse + validate exposition text; ``{name: [(labels, value), ...]}``
    (with ``return_exemplars=True``: ``(samples, exemplars)`` where
    ``exemplars`` maps name → ``[(labels, exemplar_dict), ...]``; with
    ``return_meta=True``: ``(samples, exemplars, types, helps)``, the
    full family metadata).

    Raises ``ValueError`` (with the offending line number) on any line
    that is neither a well-formed comment nor a well-formed sample, on a
    ``# TYPE`` naming an unknown metric type, on a malformed or misplaced
    exemplar, and on a histogram whose ``+Inf`` bucket disagrees with its
    ``_count`` — the inconsistencies a real scraper rejects or silently
    mis-ingests.
    """
    samples: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    exemplars: Dict[str, List[Tuple[Dict[str, str], Dict[str, Any]]]] = {}
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                continue  # free-form comment — legal, ignored
            if not _NAME_RE.match(parts[2]):
                raise ValueError(
                    f"line {lineno}: bad metric name in comment: {parts[2]!r}"
                )
            if parts[1] == "HELP":
                helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            if parts[1] == "TYPE":
                kind = parts[3].strip() if len(parts) > 3 else ""
                if kind not in ("counter", "gauge", "histogram", "summary",
                                "untyped"):
                    raise ValueError(
                        f"line {lineno}: unknown metric type {kind!r}"
                    )
                types[parts[2]] = kind
            continue
        line, exemplar = _parse_exemplar(line, lineno, types)
        match = _SAMPLE_RE.match(line)
        if not match:
            raise ValueError(f"line {lineno}: malformed sample line {line!r}")
        name, body, raw_value = match.group(1), match.group(2), match.group(3)
        labels = _parse_label_body(body or "", lineno)
        value = _parse_value(raw_value, lineno)
        samples.setdefault(name, []).append((labels, value))
        if exemplar is not None:
            exemplars.setdefault(name, []).append((labels, exemplar))

    # histogram consistency: the +Inf bucket IS the count
    for name, kind in types.items():
        if kind != "histogram":
            continue
        counts = {  # series key (minus le) -> count value
            _series_key(labels): value
            for labels, value in samples.get(f"{name}_count", [])
        }
        inf_buckets: Dict[Any, float] = {}
        for labels, value in samples.get(f"{name}_bucket", []):
            if labels.get("le") == "+Inf":
                rest = {k: v for k, v in labels.items() if k != "le"}
                inf_buckets[_series_key(rest)] = value
        for key, count in counts.items():
            if key not in inf_buckets:
                raise ValueError(
                    f"histogram {name}: series {key or '(unlabeled)'} has "
                    "no +Inf bucket"
                )
            if inf_buckets[key] != count:
                raise ValueError(
                    f"histogram {name}: +Inf bucket {inf_buckets[key]} != "
                    f"count {count} for series {key or '(unlabeled)'}"
                )
    if return_meta:
        return samples, exemplars, types, helps
    if return_exemplars:
        return samples, exemplars
    return samples


def _series_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))
