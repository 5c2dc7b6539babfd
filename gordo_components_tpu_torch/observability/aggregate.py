"""Scrape-of-scrapes: N per-process expositions merged into one (the
port's copy of ``gordo_components_tpu/observability/aggregate.py``).

The horizontal tier puts a registry in every worker process, so an
operator (or the old watchman view) would scrape N ports
and eyeball-sum them. ``merge_expositions`` folds the fleet into ONE
exposition the router serves at ``/metrics?format=prometheus&aggregate=1``:

- **counters** sum across sources per identical label set — the fleet
  total a recording rule would have computed anyway;
- **histograms** bucket-merge: per label set, each ``le`` bucket (and
  ``_sum`` / ``_count``) sums across sources, so fleet percentiles come
  from real merged buckets, not averaged averages. The ``+Inf == count``
  invariant holds by construction because every source satisfied it;
- **gauges** (and untyped) are NOT summable (a worker's queue depth
  summed across workers is a lie about every one of them): each source's
  series keeps its value and gains a ``worker=<source>`` label, the
  documented bounded-cardinality exception;
- **exemplars** survive: per merged bucket/counter the newest-timestamped
  exemplar among the sources wins, so the aggregate still links to a
  concrete trace in SOME worker's flight recorder.

Every input is parsed by the validating parser (a worker emitting a
malformed exposition fails ITS scrape loudly instead of corrupting the
fleet view), and the merged output re-parses under the same validator
before it is returned — the aggregator can never emit what it would
itself reject.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

from .exposition import parse_prometheus_text
from .exposition import _fmt_value as _fmt_finite

WORKER_LABEL = "worker"


def _fmt_value(value: float) -> str:
    # the registry renderer never emits NaN, but a merged-in source may
    # (it is legal exposition) — and repr(nan) is not
    if isinstance(value, float) and math.isnan(value):
        return "NaN"
    return _fmt_finite(value)

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _family_of(name: str, types: Dict[str, str]) -> Tuple[str, str]:
    """``(family, suffix)`` — maps ``x_bucket``/``x_sum``/``x_count``
    back onto histogram family ``x`` when ``x`` is a declared histogram."""
    for suffix in _HIST_SUFFIXES:
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if types.get(base) == "histogram":
                return base, suffix
    return name, ""


def _labels_text(labels: Dict[str, str]) -> str:
    from .exposition import _escape_label

    if not labels:
        return ""
    pairs = [
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    ]
    return "{" + ",".join(pairs) + "}"


def _exemplar_text(exemplar: Dict[str, Any]) -> str:
    from .exposition import _escape_label

    pairs = ",".join(
        f'{k}="{_escape_label(v)}"'
        for k, v in sorted(exemplar["labels"].items())
    )
    out = f" # {{{pairs}}} {_fmt_value(exemplar['value'])}"
    if exemplar.get("timestamp") is not None:
        out += f" {exemplar['timestamp']:.3f}"
    return out


def _key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


class _Parsed:
    __slots__ = ("samples", "exemplars", "types", "helps")

    def __init__(self, text: str):
        self.samples, self.exemplars, self.types, self.helps = (
            parse_prometheus_text(text, return_meta=True)
        )


def merge_expositions(
    sources: Dict[str, str], exemplars: bool = False
) -> str:
    """Merge ``{source_label: exposition_text}`` into one exposition.

    ``source_label`` becomes the ``worker`` label value on gauge series
    (the router passes worker names plus ``"router"`` for its own
    registry). ``exemplars=False`` strips exemplar suffixes from the
    output (strict v0.0.4 for classic Prometheus parsers — mirrors the
    per-server ``&exemplars=1`` opt-in).

    Raises ``ValueError`` when any INPUT fails validation; families
    whose TYPE — or histogram bucket layout — disagrees across sources
    are skipped with a comment (one mid-upgrade worker must not take
    down the fleet scrape, and mismatched ``le`` sets cannot be summed
    per-bucket without producing non-monotone histograms). Families
    with no declared TYPE (legal v0.0.4) pass through worker-labeled.
    """
    parsed: Dict[str, _Parsed] = {
        label: _Parsed(text) for label, text in sources.items()
    }

    # family -> kind, with conflicts noted and skipped
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    conflicted: List[str] = []
    for label in sorted(parsed):
        for family, kind in parsed[label].types.items():
            if family in kinds and kinds[family] != kind:
                if family not in conflicted:
                    conflicted.append(family)
                continue
            kinds.setdefault(family, kind)
            if family not in helps and family in parsed[label].helps:
                helps[family] = parsed[label].helps[family]

    # collect every sample under its FAMILY (histogram suffixes folded)
    # family -> suffix -> series key -> merged value / per-source values
    summed: Dict[Tuple[str, str], Dict[Tuple, float]] = {}
    labeled: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    best_exemplars: Dict[Tuple[str, Tuple], Dict[str, Any]] = {}
    families_seen: Dict[str, bool] = {}
    # histogram bucket layouts per (family, series key) per source: two
    # sources exposing DIFFERENT le sets for one series (mid-rollout
    # version/knob skew) cannot be summed per-le without producing
    # non-monotone buckets — detect and skip the family loudly instead
    layouts: Dict[Tuple[str, Tuple], Dict[str, frozenset]] = {}

    for label in sorted(parsed):
        source = parsed[label]
        for name, rows in source.samples.items():
            family, suffix = _family_of(name, source.types)
            kind = kinds.get(family)
            if family in conflicted:
                continue
            families_seen[family] = True
            additive = kind in ("counter", "histogram")
            if suffix == "_bucket":
                per_series: Dict[Tuple, set] = {}
                for series_labels, _ in rows:
                    rest = {
                        k: v for k, v in series_labels.items() if k != "le"
                    }
                    per_series.setdefault(_key(rest), set()).add(
                        series_labels.get("le", "+Inf")
                    )
                for series_key, les in per_series.items():
                    layouts.setdefault((family, series_key), {})[label] = (
                        frozenset(les)
                    )
            for series_labels, value in rows:
                if additive:
                    bucket = summed.setdefault((family, suffix), {})
                    key = _key(series_labels)
                    if math.isnan(value):
                        continue  # NaN is not summable; drop the sample
                    bucket[key] = bucket.get(key, 0.0) + value
                else:
                    # gauge / untyped / summary: not summable — each
                    # source's series keeps its value via the worker
                    # label (existing worker labels win — the router's
                    # own per-worker series stay as recorded)
                    stamped = dict(series_labels)
                    stamped.setdefault(WORKER_LABEL, label)
                    labeled.setdefault(name, []).append(
                        (stamped, value)
                    )
        for name, rows in source.exemplars.items():
            family, suffix = _family_of(name, source.types)
            if family in conflicted:
                continue
            for series_labels, exemplar in rows:
                key = (name, _key(series_labels))
                held = best_exemplars.get(key)
                ts = exemplar.get("timestamp") or 0.0
                if held is None or ts >= (held.get("timestamp") or 0.0):
                    best_exemplars[key] = exemplar

    # bucket-layout disagreement per family (any series whose sources
    # expose different le sets): joins the conflicted list
    layout_conflicts = sorted({
        family
        for (family, _), per_source in layouts.items()
        if len(set(per_source.values())) > 1
    })
    for family in layout_conflicts:
        if family not in conflicted:
            conflicted.append(family)

    lines: List[str] = []
    for family in conflicted:
        reason = (
            "histogram bucket layouts disagree across sources"
            if family in layout_conflicts
            else "TYPE disagrees across sources"
        )
        lines.append(f"# aggregate: family {family} skipped — {reason}")
    for family in sorted(families_seen):
        if family in conflicted:
            continue
        kind = kinds.get(family)
        if family in helps and helps[family]:
            lines.append(f"# HELP {family} {helps[family]}")
        if kind is None:
            # untyped family (no # TYPE line — legal v0.0.4, includes a
            # summary's bare _sum/_count): worker-labeled passthrough
            for series_labels, value in sorted(
                labeled.get(family, []), key=lambda row: _key(row[0])
            ):
                lines.append(
                    f"{family}{_labels_text(series_labels)} "
                    f"{_fmt_value(value)}"
                )
            continue
        lines.append(f"# TYPE {family} {kind}")
        if kind == "histogram":
            _render_histogram(
                lines, family, summed, best_exemplars, exemplars
            )
        elif kind == "counter":
            rows = summed.get((family, ""), {})
            for key in sorted(rows):
                suffix_txt = ""
                if exemplars and (family, key) in best_exemplars:
                    suffix_txt = _exemplar_text(
                        best_exemplars[(family, key)]
                    )
                lines.append(
                    f"{family}{_labels_text(dict(key))} "
                    f"{_fmt_value(rows[key])}{suffix_txt}"
                )
        else:
            for series_labels, value in sorted(
                labeled.get(family, []),
                key=lambda row: _key(row[0]),
            ):
                lines.append(
                    f"{family}{_labels_text(series_labels)} "
                    f"{_fmt_value(value)}"
                )
    merged = "\n".join(lines) + "\n"
    # the aggregator must never emit what it would reject: re-validate
    parse_prometheus_text(merged, return_exemplars=True)
    return merged


def _render_histogram(
    lines: List[str],
    family: str,
    summed: Dict[Tuple[str, str], Dict[Tuple, float]],
    best_exemplars: Dict[Tuple[str, Tuple], Dict[str, Any]],
    exemplars: bool,
) -> None:
    buckets = summed.get((family, "_bucket"), {})
    sums = summed.get((family, "_sum"), {})
    counts = summed.get((family, "_count"), {})
    # group bucket series by their label set minus le, keep le order
    grouped: Dict[Tuple, List[Tuple[float, Tuple, str]]] = {}
    for key in buckets:
        labels = dict(key)
        le_text = labels.pop("le", "+Inf")
        le = (
            math.inf if le_text == "+Inf"
            else (-math.inf if le_text == "-Inf" else float(le_text))
        )
        grouped.setdefault(_key(labels), []).append((le, key, le_text))
    for series_key in sorted(grouped):
        for le, bucket_key, le_text in sorted(
            grouped[series_key], key=lambda row: row[0]
        ):
            labels = dict(series_key)
            labels["le"] = le_text
            suffix_txt = ""
            exemplar_key = (f"{family}_bucket", _key(labels))
            if exemplars and exemplar_key in best_exemplars:
                suffix_txt = _exemplar_text(best_exemplars[exemplar_key])
            lines.append(
                f"{family}_bucket{_labels_text(labels)} "
                f"{_fmt_value(buckets[bucket_key])}{suffix_txt}"
            )
        lines.append(
            f"{family}_sum{_labels_text(dict(series_key))} "
            f"{_fmt_value(sums.get(series_key, 0.0))}"
        )
        lines.append(
            f"{family}_count{_labels_text(dict(series_key))} "
            f"{_fmt_value(counts.get(series_key, 0.0))}"
        )


def scrape_sources(
    session: Any,
    targets: Dict[str, str],
    timeout: float = 10.0,
    exemplars: bool = True,
) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Fetch each target's exposition through ``session`` (a
    :class:`~..utils.http.Session`); ``(texts, errors)`` keyed by source
    label. A worker that is down or answers garbage lands in
    ``errors`` and is excluded — the fleet view degrades, not dies."""
    texts: Dict[str, str] = {}
    errors: Dict[str, str] = {}
    suffix = "format=prometheus" + ("&exemplars=1" if exemplars else "")
    for label, base_url in targets.items():
        try:
            response = session.get(
                f"{base_url}/metrics?{suffix}", timeout=timeout
            )
            if response.status_code != 200:
                errors[label] = f"HTTP {response.status_code}"
                continue
            # validate NOW so a malformed worker is named, not merged
            parse_prometheus_text(response.text, return_exemplars=True)
            texts[label] = response.text
        except Exception as exc:  # transport or validation
            errors[label] = f"{type(exc).__name__}: {exc}"
    return texts, errors
