"""Wire-contract checker: the port's router↔worker protocol,
machine-checked.

The HTTP surface — routes, ``X-Gordo-*`` headers, status-code semantics
— is hand-maintained in four producers/consumers at once (server,
router, client, watchman) plus every smoke tool. Nothing type-checks
HTTP: a header the router stamps and nobody reads, a route a smoke tool
calls that no server serves, a ``gordo_*`` series a smoke tool asserts
that nothing emits — all of these "work" until the one real consumer
meets the one real producer in production. So the contract has a
declared registry and a cross-reference pass.

Three rule families:

1. **headers** — every ``X-Gordo-*`` literal (and ``Retry-After``) must
   be declared in :data:`HEADERS`; across the scanned tree, a declared
   header with read evidence but NO stamp evidence is
   ``header-never-stamped``, and stamp evidence with no read anywhere is
   ``header-never-read``. Stamp vs read is classified from AST context
   (tuple/dict/subscript-store/``.add`` = stamp; ``.get``/``in``/
   subscript-load/``HTTP_X_GORDO_*`` environ key = read).
2. **routes** — every served route literal must be declared in
   :data:`ROUTES`. The port's servers declare routes in a path→endpoint
   dict (``{"/healthz": "healthz", ...}``) and in ``re.compile(r"^/...$")``
   patterns whose named groups are ``<var>`` segments (an alternation
   built from a module-level table, ``"|".join(re.escape(e) for e in
   TABLE)``, expands into one route per entry); a werkzeug
   ``Rule("<path>")`` and a ``path == "/x"`` dispatch read the same way.
   A declared route with no serve evidence anywhere is
   ``route-not-served``; a URL path fragment used in an HTTP call (or a
   base-url f-string) that aligns with NO declared route template is
   ``unserved-route-call``.
3. **series** — every ``gordo_*`` name asserted by the port's smoke
   tools (``chip_smoke.py``, ``chip_phases.py``, ``tools/torch_*.py``)
   must be emitted by a registry metric declaration somewhere in the
   package (exposition suffixes stripped, prefix assertions allowed) —
   else ``phantom-series``.

Evidence is collected per file by :func:`scan` and joined by
:func:`finalize` (the runner aggregates across the tree; the corpus
tests drive the pair directly).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .astscan import CARD_SCRIPTS, Module, dotted
from .findings import Finding

CHECKER = "wire-contracts"

# -- the declared registry ----------------------------------------------------


@dataclass(frozen=True)
class HeaderSpec:
    name: str
    doc: str           # semantics, incl. status-code interplay
    request: bool = False    # travels on requests (client/router -> worker)
    response: bool = False   # travels on responses


HEADERS: Dict[str, HeaderSpec] = {
    header.name.lower(): header
    for header in (
        HeaderSpec(
            "X-Gordo-Trace-Id",
            "request: adopt the caller's trace id; response: echo the "
            "one the request ran under",
            request=True, response=True,
        ),
        HeaderSpec(
            "X-Gordo-Deadline",
            "absolute wall-clock deadline; pre-dispatch checks answer "
            "504 once it passes",
            request=True,
        ),
        HeaderSpec(
            "X-Gordo-Worker",
            "which worker answered — placement echo for routing "
            "stickiness checks",
            response=True,
        ),
        HeaderSpec(
            "X-Gordo-Draining",
            "stamped on every response while the server drains; paired "
            "with 503 + Retry-After: 0 so clients retry NOW",
            response=True,
        ),
        HeaderSpec(
            "X-Gordo-Shard",
            "which mesh shard answered — the owner in steady state; a "
            "different shard means the spill fallback rung served a "
            "dead owner's machine",
            response=True,
        ),
        HeaderSpec(
            "X-Gordo-Timeline",
            "request: router negotiates timeline capture (stamps '1'); "
            "response: base64(JSON) encoded timeline, size-capped",
            request=True, response=True,
        ),
        HeaderSpec(
            "X-Gordo-Timeline-Truncated",
            "response over the timeline size cap — the router pulls the "
            "full timeline from /debug/requests/<id> instead",
            response=True,
        ),
        HeaderSpec(
            "X-Gordo-Tenant",
            "which principal this request scores as: the server "
            "maps it to a priority class + token-bucket quota; unknown "
            "names fold into 'default'; the router forwards it untouched",
            request=True,
        ),
        HeaderSpec(
            "Retry-After",
            "seconds to back off: admission shed / quarantine / draining "
            "503s carry it (draining floors it at 0), and quota 429s "
            "carry the bucket's refill time",
            response=True,
        ),
    )
}

_HEADER_RE = re.compile(r"^X-Gordo-[A-Za-z][A-Za-z0-9-]*$")
_ENVIRON_HEADER_RE = re.compile(r"^HTTP_X_GORDO_[A-Z0-9_]+$")


@dataclass(frozen=True)
class RouteSpec:
    path: str          # template; <var> segments are wildcards
    servers: Tuple[str, ...]   # components that serve it
    doc: str


ROUTES: Tuple[RouteSpec, ...] = (
    RouteSpec("/healthz", ("server", "router", "watchman"),
              "live/ready/degraded/draining; 503 while draining"),
    RouteSpec("/metadata", ("server",), "model metadata"),
    RouteSpec("/metrics", ("server", "router", "watchman"),
              "JSON or ?format=prometheus; router: &aggregate=1 merges "
              "workers"),
    RouteSpec("/slo", ("server", "router"),
              "burn-rate objectives + per-stage attribution"),
    RouteSpec("/telemetry", ("server", "router"),
              "warehouse window queries + traffic top-K + cost ledger; "
              "?view=export = layout-input doc; router merges workers "
              ""),
    RouteSpec("/incidents", ("server", "router"),
              "incident reports + correlator status; ?view=ledger = raw "
              "control-ledger window; router merges workers"),
    RouteSpec("/incidents/<incident_id>", ("server", "router"),
              "one durable incident report: lookback control events, "
              "metric deltas, ranked root-cause candidates"),
    RouteSpec("/models", ("server", "router"), "served machine list"),
    RouteSpec("/prefetch", ("server",),
              "POST placement hint: queue async host-cache loads "
              "for lazy machines; advisory, never blocks"),
    RouteSpec("/layout", ("server",),
              "layout-plan slice: POST pins this worker's resident "
              "set/cap/prefetch hints under a plan fingerprint (or "
              "clears them); GET echoes what was applied"),
    RouteSpec("/reload", ("server", "router"),
              "adopt a new generation; router: canary→sweep rollout, "
              "busy answers 409"),
    RouteSpec("/rollback", ("router",),
              "atomic fleet CURRENT swap then adoption"),
    RouteSpec("/router/status", ("router",), "placement + worker table"),
    RouteSpec("/autopilot", ("server", "router"),
              "controller status; reads are evaluation ticks"),
    RouteSpec("/autopilot/<action>", ("server", "router"),
              "POST enable|disable; 409 when hard-off"),
    RouteSpec("/fleet", ("router",),
              "reconciler status: committed spec revision, divergence "
              "counts, repair ring; reads are reconcile ticks"),
    RouteSpec("/fleet/<action>", ("router",),
              "GET status|diff, POST apply|rollback: journaled spec "
              "commits + read-only spec-vs-observed diff; 409 when "
              "hard-off"),
    RouteSpec("/prediction", ("server", "router"), "single-model scoring"),
    RouteSpec("/anomaly/prediction", ("server", "router"),
              "anomaly scoring; 503+Retry-After on shed/quarantine, "
              "504 past deadline, 429+Retry-After on quota"),
    RouteSpec("/tenants", ("server", "router"),
              "QoS control surface: tenant table, class limits + "
              "shed rung, raw-header heavy-hitter sketch"),
    RouteSpec("/bulk/anomaly/prediction", ("server",),
              "offline scoring surface: forced-bulk class, large "
              "windows amortized through the spill tier"),
    RouteSpec("/download-model", ("server",), "serialized model bytes"),
    RouteSpec("/debug/requests", ("server", "router"),
              "flight-recorder rings"),
    RouteSpec("/debug/requests/<trace_id>", ("server", "router"),
              "one timeline; ?format=chrome = Perfetto; stitch pull "
              "source"),
    RouteSpec("/gordo/v0/<project>/<machine>/healthz", ("server",),
              "machine-scoped healthz"),
    RouteSpec("/gordo/v0/<project>/<machine>/metadata", ("server",),
              "machine-scoped metadata"),
    RouteSpec("/gordo/v0/<project>/<machine>/prediction", ("server",),
              "machine-scoped scoring"),
    RouteSpec("/gordo/v0/<project>/<machine>/anomaly/prediction",
              ("server",), "machine-scoped anomaly scoring"),
    RouteSpec("/gordo/v0/<project>/<machine>/bulk/anomaly/prediction",
              ("server",), "machine-scoped bulk scoring"),
    RouteSpec("/gordo/v0/<project>/<machine>/download-model", ("server",),
              "machine-scoped model download"),
    RouteSpec("/gordo/v0/<project>/<machine>/<path:rest>", ("router",),
              "machine-path forward: consistent-hash placement"),
    RouteSpec("/", ("watchman",), "watchman status page"),
)

# components whose files carry wire evidence (dataset/builder HTTP — the
# influx data plane — is NOT the router↔worker protocol and is excluded)
WIRE_COMPONENTS = frozenset(
    {"server", "router", "client", "watchman", "observability",
     "resilience", "autopilot", "fleet", "cli", "tools"}
)

_HTTP_VERBS = frozenset(
    {"get", "post", "put", "delete", "head", "request", "urlopen", "open"}
)
# 'get' and 'open' collide with dict/env .get() and the builtin open():
# those two only count as HTTP calls when their receiver looks like one
_HTTP_AMBIGUOUS_VERBS = frozenset({"get", "open"})
_HTTP_RECEIVER_RE = re.compile(
    r"session|requests|client|http|urll?ib|opener|conn|pool", re.I
)
_READ_METHODS = frozenset({"get", "pop", "getlist", "get_all"})
_STAMP_METHODS = frozenset({"add", "append", "set", "setdefault"})

_SERIES_RE = re.compile(r"\bgordo_[a-z0-9_]*[a-z0-9]\b")
_EXPOSITION_SUFFIXES = ("_bucket", "_count", "_sum")
_METRIC_FACTORIES = frozenset({"counter", "gauge", "histogram"})


# components whose files DECLARE routes (path->endpoint dicts, patterns):
# elsewhere a dict keyed by paths is a client's expectation, not a server
ROUTE_TABLE_COMPONENTS = frozenset({"server", "router", "watchman"})


def component_of(relpath: str) -> str:
    if relpath.startswith("tools/") or relpath in CARD_SCRIPTS:
        return "tools"
    if relpath.startswith("tests/"):
        return "tests"
    parts = relpath.split("/")
    if parts[0] == "gordo_components_tpu_torch" and len(parts) > 1:
        return parts[1][:-3] if parts[1].endswith(".py") else parts[1]
    return parts[0]


def _is_smoke_tool(relpath: str) -> bool:
    return relpath in CARD_SCRIPTS or (
        relpath.startswith("tools/torch_") and relpath.endswith(".py")
    )


# -- evidence -----------------------------------------------------------------


@dataclass
class WireEvidence:
    """Picklable per-file evidence the runner joins across the tree."""

    relpath: str = ""
    # canonical header name -> first (line) seen, per classification
    stamps: Dict[str, int] = field(default_factory=dict)
    reads: Dict[str, int] = field(default_factory=dict)
    # registered template -> line of serve evidence (Rule/.path compare)
    serves: Dict[str, int] = field(default_factory=dict)
    # gordo_* names asserted by smoke tools: name -> line
    asserted_series: Dict[str, int] = field(default_factory=dict)
    # metric family names declared via the registry in this file
    emitted_series: Set[str] = field(default_factory=set)
    # headers travel as named constants (tracing.TRACE_HEADER,
    # DRAINING_HEADER): defs map the *_HEADER name to its canonical
    # header here; uses record (alias, 'stamp'|'read', line) and are
    # resolved cross-file at finalize
    alias_defs: Dict[str, str] = field(default_factory=dict)
    alias_uses: List[Tuple[str, str, int]] = field(default_factory=list)


def _canonical_header(raw: str) -> Optional[str]:
    if _HEADER_RE.match(raw) or raw.lower() == "retry-after":
        return raw.lower()
    if _ENVIRON_HEADER_RE.match(raw):
        parts = raw[len("HTTP_"):].split("_")
        return "-".join(part.capitalize() for part in parts).lower()
    return None


def _display_header(canonical: str) -> str:
    spec = HEADERS.get(canonical)
    if spec is not None:
        return spec.name
    return "-".join(part.capitalize() for part in canonical.split("-"))


def _parent_map(tree: ast.AST) -> Dict[int, ast.AST]:
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


def _template_segments(path: str) -> List[str]:
    return [seg for seg in path.split("/") if seg]


def _is_var(segment: str) -> bool:
    return segment.startswith("<") and segment.endswith(">")


def _fragment_matches(fragment: str, templates: List[str]) -> bool:
    """A URL fragment (constant part of an f-string or a whole path
    literal) aligns with some declared route template. An f-string
    fragment carries no anchor information, so both alignments are
    tried: prefix-aligned (``"/gordo/v0/my-project/"`` — the literal
    values fill ``<var>`` segments) and suffix-aligned
    (``"/anomaly/prediction"`` — the tail after the interpolated
    machine). ``<var>`` segments wildcard in both directions."""
    fragment = fragment.split("?", 1)[0].split("#", 1)[0]
    if fragment in ("", "/"):
        return True
    open_ended = fragment.endswith("/")
    frag_segs = _template_segments(fragment)
    for template in templates:
        temp_segs = _template_segments(template)
        if len(frag_segs) > len(temp_segs):
            continue
        head = temp_segs[: len(frag_segs)]
        if all(_is_var(t) or t == f for t, f in zip(head, frag_segs)) and (
            open_ended or len(frag_segs) == len(temp_segs)
        ):
            return True
        # suffix alignment: the fragment is the constant TAIL of an
        # f-string, so its final segment must match a LITERAL template
        # segment — ending on a <var> (notably the router's
        # <path:rest> catch-all) would let any fragment match anything
        tail = temp_segs[-len(frag_segs):]
        if (
            not open_ended
            and not _is_var(tail[-1])
            and all(_is_var(t) or t == f for t, f in zip(tail, frag_segs))
        ):
            return True
    return False


def _url_fragments(node: ast.AST) -> List[Tuple[str, int]]:
    """Constant path fragments inside a URL expression: plain string
    literals and the constant parts of f-strings; absolute URLs are
    reduced to their path component."""
    out: List[Tuple[str, int]] = []
    for sub in ast.walk(node):
        if not (isinstance(sub, ast.Constant) and isinstance(sub.value, str)):
            continue
        text = sub.value
        if text.startswith(("http://", "https://")):
            rest = text.split("://", 1)[1]
            slash = rest.find("/")
            text = rest[slash:] if slash != -1 else ""
        if text.startswith("/") and text not in ("/", ""):
            out.append((text, sub.lineno))
    return out


def _base_url_fstring(node: ast.JoinedStr) -> bool:
    """f-strings of the idiom ``f"{base_url}/healthz"`` — the URL-build
    shape the tree uses when the call site is elsewhere."""
    if not node.values or not isinstance(node.values[0], ast.FormattedValue):
        return False
    name = dotted(node.values[0].value).lower()
    return "url" in name or "base" in name


# -- per-file scan ------------------------------------------------------------


def scan(module: Module) -> Tuple[List[Finding], WireEvidence]:
    evidence = WireEvidence(relpath=module.relpath)
    findings: List[Finding] = []
    component = component_of(module.relpath)
    in_wire_scope = component in WIRE_COMPONENTS
    is_smoke_tool = _is_smoke_tool(module.relpath)
    parents = _parent_map(module.tree)
    templates = [route.path for route in ROUTES]
    known_paths = {route.path for route in ROUTES}

    # metric families declared via the registry (whole package: smoke
    # assertions may name any layer's series)
    for call in ast.walk(module.tree):
        if isinstance(call, ast.Call):
            name = dotted(call.func)
            if name and name.split(".")[-1] in _METRIC_FACTORIES:
                receiver = name.split(".")[-2].lower() if "." in name else ""
                if receiver in ("registry", "_registry") and call.args:
                    literal = call.args[0]
                    if isinstance(literal, ast.Constant) and isinstance(
                        literal.value, str
                    ):
                        evidence.emitted_series.add(literal.value)

    if is_smoke_tool:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                for name in _SERIES_RE.findall(node.value):
                    evidence.asserted_series.setdefault(name, node.lineno)

    if not in_wire_scope:
        return findings, evidence

    # header-alias definitions: NAME_HEADER = "X-Gordo-..."
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            canonical = _canonical_header(node.value.value)
            if canonical is None:
                continue
            for target in node.targets:
                if isinstance(target, ast.Name) and _is_alias_name(target.id):
                    evidence.alias_defs[target.id] = canonical

    flagged_headers: Set[str] = set()
    flagged_fragments: Set[str] = set()
    declares_routes = component in ROUTE_TABLE_COMPONENTS
    tables = _module_tables(module.tree) if declares_routes else {}
    for node in ast.walk(module.tree):
        # -- header-alias uses ----------------------------------------------
        alias: Optional[str] = None
        if isinstance(node, ast.Attribute) and _is_alias_name(node.attr):
            alias = node.attr
        elif (
            isinstance(node, ast.Name)
            and _is_alias_name(node.id)
            and isinstance(node.ctx, ast.Load)
        ):
            alias = node.id
        if alias is not None:
            role = _classify_site(node, parents)
            if role is not None:
                evidence.alias_uses.append((alias, role, node.lineno))
        # -- headers ---------------------------------------------------------
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            canonical = _canonical_header(node.value)
            if canonical is not None:
                registered = canonical in HEADERS
                if not registered and canonical not in flagged_headers:
                    flagged_headers.add(canonical)
                    findings.append(
                        Finding(
                            checker=CHECKER, code="unregistered-header",
                            file=module.relpath, line=node.lineno,
                            key=_display_header(canonical),
                            message=(
                                f"{node.value!r} is not declared in the "
                                "wire-contract registry (analysis/"
                                "wire_contracts.py HEADERS)"
                            ),
                            hint=(
                                "declare the header with its semantics, "
                                "or drop the stray literal"
                            ),
                        )
                    )
                role = _classify_header_site(node, parents)
                if role == "stamp":
                    evidence.stamps.setdefault(canonical, node.lineno)
                elif role == "read":
                    evidence.reads.setdefault(canonical, node.lineno)
        # -- routes: serve evidence ------------------------------------------
        served: List[Tuple[str, int]] = []
        if isinstance(node, ast.Call):
            callee = dotted(node.func)
            last = callee.split(".")[-1] if callee else ""
            if last == "Rule" and node.args:
                literal = node.args[0]
                if isinstance(literal, ast.Constant) and isinstance(
                    literal.value, str
                ):
                    served.append((literal.value, literal.lineno))
            if declares_routes and callee in ("re.compile", "compile") \
                    and node.args:
                text = _pattern_text(node.args[0], tables)
                if text is not None and text.startswith("^/"):
                    served.extend(
                        (path, node.lineno) for path in _regex_templates(text)
                    )
        if declares_routes and isinstance(node, ast.Dict) and node.keys \
                and all(_is_path_literal(key) for key in node.keys) and all(
                    isinstance(value, ast.Constant)
                    and isinstance(value.value, str)
                    for value in node.values):
            served.extend((key.value, key.lineno) for key in node.keys)
        for path, line in served:
            if path in known_paths:
                evidence.serves.setdefault(path, line)
            else:
                findings.append(
                    Finding(
                        checker=CHECKER, code="unregistered-route",
                        file=module.relpath, line=line,
                        key=path,
                        message=(
                            f"served route {path!r} is not "
                            "declared in the wire-contract "
                            "registry (analysis/wire_contracts.py "
                            "ROUTES)"
                        ),
                        hint="declare the route with its servers "
                             "and status semantics",
                    )
                )
            # route-path comparisons: ``request.path == "/healthz"`` /
            # membership tuples — watchman's dispatch idiom
        if isinstance(node, ast.Compare):
            names = [dotted(side) for side in [node.left] + node.comparators]
            if any(name == "path" or name.endswith(".path")
                   for name in names if name):
                for side in [node.left] + node.comparators:
                    for sub in ast.walk(side):
                        if isinstance(sub, ast.Constant) and isinstance(
                            sub.value, str
                        ) and sub.value in known_paths:
                            evidence.serves.setdefault(
                                sub.value, sub.lineno
                            )
        # -- routes: call evidence -------------------------------------------
        fragments: List[Tuple[str, int]] = []
        if isinstance(node, ast.Call):
            callee = dotted(node.func)
            last = callee.split(".")[-1] if callee else ""
            receiver = callee.rsplit(".", 1)[0] if "." in callee else ""
            if (
                last in _HTTP_VERBS
                and (node.args or node.keywords)
                and not (
                    last in _HTTP_AMBIGUOUS_VERBS
                    and not _HTTP_RECEIVER_RE.search(receiver)
                )
            ):
                # only the URL position: arg 0 (arg 1 too for
                # requests.request(method, url)) — a .post() body or a
                # .get() default is not a route
                url_args = list(
                    node.args[: 2 if last == "request" else 1]
                ) + [kw.value for kw in node.keywords if kw.arg == "url"]
                for arg in url_args:
                    fragments.extend(_url_fragments(arg))
        elif isinstance(node, ast.JoinedStr) and _base_url_fstring(node):
            fragments.extend(_url_fragments(node))
        for fragment, line in fragments:
            if fragment in flagged_fragments:
                continue
            if not _fragment_matches(fragment, templates):
                flagged_fragments.add(fragment)
                findings.append(
                    Finding(
                        checker=CHECKER, code="unserved-route-call",
                        file=module.relpath, line=line, key=fragment,
                        message=(
                            f"calls {fragment!r}, which aligns with no "
                            "declared route template — nothing serves it"
                        ),
                        hint=(
                            "fix the path, or declare the route in "
                            "analysis/wire_contracts.py ROUTES (and "
                            "serve it)"
                        ),
                    )
                )
    return findings, evidence


def _is_path_literal(node: Optional[ast.AST]) -> bool:
    return (
        isinstance(node, ast.Constant)
        and isinstance(node.value, str)
        and node.value.startswith("/")
    )


def _module_tables(tree: ast.Module) -> Dict[str, List[str]]:
    """Module-level ``NAME = {"a": ..}`` / ``("a", ..)`` tables of string
    keys/elements: the alternatives a route pattern may be built from."""
    tables: Dict[str, List[str]] = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        value = node.value
        elements = value.keys if isinstance(value, ast.Dict) else (
            value.elts if isinstance(value, (ast.Tuple, ast.List)) else None
        )
        if elements and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in elements
        ):
            tables[node.targets[0].id] = [e.value for e in elements]
    return tables


def _pattern_text(node: ast.AST, tables: Dict[str, List[str]]) -> Optional[str]:
    """The text of a route pattern expression: string constants, ``+``
    concatenation, and ``"|".join(re.escape(e) for e in TABLE)`` over a
    module-level table (its entries joined unescaped). None when the
    pattern is not statically known."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _pattern_text(node.left, tables)
        right = _pattern_text(node.right, tables)
        return None if left is None or right is None else left + right
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "join"
        and isinstance(node.func.value, ast.Constant)
        and node.func.value.value == "|"
        and len(node.args) == 1
    ):
        source = node.args[0]
        if isinstance(source, (ast.GeneratorExp, ast.ListComp)):
            source = source.generators[0].iter
        if isinstance(source, ast.Name) and source.id in tables:
            return "|".join(tables[source.id])
    return None


_GROUP_RE = re.compile(r"\(\?P<([A-Za-z_][A-Za-z0-9_]*)>")


def _regex_templates(pattern: str) -> List[str]:
    """Route templates a ``^/...$`` pattern serves: a named group of one
    segment (``[^/]+``) is ``<name>``, one of the rest (``.+``) is
    ``<path:name>``, an alternation of literals is one template per
    alternative; escaped literal characters are unescaped."""
    text = pattern[1:] if pattern.startswith("^") else pattern
    if text.endswith("$"):
        text = text[:-1]
    templates = [""]
    pos = 0
    while pos < len(text):
        match = _GROUP_RE.match(text, pos)
        if match is None:
            char = text[pos]
            if char == "\\" and pos + 1 < len(text):
                char = text[pos + 1]
                pos += 1
            templates = [t + char for t in templates]
            pos += 1
            continue
        depth, end = 1, match.end()
        while end < len(text) and depth:
            if text[end] == "\\":
                end += 2
                continue
            depth += {"(": 1, ")": -1}.get(text[end], 0)
            end += 1
        body = text[match.end():end - 1]
        name = match.group(1)
        if body == "[^/]+":
            options = [f"<{name}>"]
        elif body in (".+", ".*"):
            options = [f"<path:{name}>"]
        else:
            options = [re.sub(r"\\(.)", r"\1", alt) for alt in body.split("|")]
        templates = [t + option for t in templates for option in options]
        pos = end
    return templates


_ALIAS_NAME_RE = re.compile(r"^[A-Z][A-Z0-9_]*_HEADER$")


def _is_alias_name(name: str) -> bool:
    return bool(_ALIAS_NAME_RE.match(name))


def _classify_header_site(
    node: ast.Constant, parents: Dict[int, ast.AST]
) -> Optional[str]:
    """'stamp' / 'read' / None for a header string literal."""
    if _ENVIRON_HEADER_RE.match(node.value):
        return "read"  # WSGI environ key only exists on the read side
    return _classify_site(node, parents)


def _classify_site(
    node: ast.AST, parents: Dict[int, ast.AST]
) -> Optional[str]:
    """'stamp' / 'read' / None from the AST context of a header
    expression (string literal or *_HEADER alias reference)."""
    parent = parents.get(id(node))
    if parent is None:
        return None
    if isinstance(parent, ast.Tuple):
        # ("X-Gordo-Foo", value) response-header pair
        if len(parent.elts) >= 2 and parent.elts[0] is node:
            return "stamp"
        return None
    if isinstance(parent, ast.Dict):
        if node in parent.keys:
            return "stamp"
        return None
    if isinstance(parent, ast.Subscript):
        grand = parents.get(id(parent))
        if isinstance(parent.ctx, (ast.Store, ast.Del)) or (
            isinstance(grand, (ast.Assign, ast.AugAssign))
            and getattr(grand, "targets", [None])[0] is parent
        ):
            return "stamp"
        return "read"
    if isinstance(parent, ast.Compare):
        return "read"  # "X-Gordo-Foo" in response.headers
    if isinstance(parent, ast.Call) and node in parent.args:
        name = dotted(parent.func)
        last = name.split(".")[-1] if name else ""
        if last in _READ_METHODS and parent.args[0] is node:
            return "read"
        if last in _STAMP_METHODS and parent.args[0] is node and len(
            parent.args
        ) >= 2:
            return "stamp"
    return None


# -- cross-file finalize ------------------------------------------------------


def finalize(evidences: List[WireEvidence]) -> List[Finding]:
    findings: List[Finding] = []
    stamps: Dict[str, Tuple[str, int]] = {}
    reads: Dict[str, Tuple[str, int]] = {}
    serves: Dict[str, Tuple[str, int]] = {}
    emitted: Set[str] = set()
    asserted: List[Tuple[str, str, int]] = []
    alias_map: Dict[str, str] = {}
    for evidence in evidences:
        alias_map.update(evidence.alias_defs)
    for evidence in evidences:
        for header, line in evidence.stamps.items():
            stamps.setdefault(header, (evidence.relpath, line))
        for header, line in evidence.reads.items():
            reads.setdefault(header, (evidence.relpath, line))
        for alias, role, line in evidence.alias_uses:
            canonical = alias_map.get(alias)
            if canonical is None:
                continue
            target = stamps if role == "stamp" else reads
            target.setdefault(canonical, (evidence.relpath, line))
        for path, line in evidence.serves.items():
            serves.setdefault(path, (evidence.relpath, line))
        emitted |= evidence.emitted_series
        for name, line in evidence.asserted_series.items():
            asserted.append((name, evidence.relpath, line))

    for canonical, spec in sorted(HEADERS.items()):
        read_site = reads.get(canonical)
        stamp_site = stamps.get(canonical)
        if read_site is not None and stamp_site is None:
            findings.append(
                Finding(
                    checker=CHECKER, code="header-never-stamped",
                    file=read_site[0], line=read_site[1], key=spec.name,
                    message=(
                        f"{spec.name} is read here but NOTHING stamps it "
                        "anywhere in the tree — the consumer always sees "
                        "the default"
                    ),
                    hint="stamp it on the producing side, or delete the "
                         "dead read + registry entry",
                )
            )
        if stamp_site is not None and read_site is None:
            findings.append(
                Finding(
                    checker=CHECKER, code="header-never-read",
                    file=stamp_site[0], line=stamp_site[1], key=spec.name,
                    message=(
                        f"{spec.name} is stamped here but NOTHING reads "
                        "it anywhere in the tree — bytes on the wire "
                        "with no consumer"
                    ),
                    hint="read it where the contract says, or delete the "
                         "stamp + registry entry",
                )
            )

    for route in ROUTES:
        if route.path not in serves:
            findings.append(
                Finding(
                    checker=CHECKER, code="route-not-served",
                    file="gordo_components_tpu_torch/analysis/wire_contracts.py",
                    line=1, key=route.path,
                    message=(
                        f"declared route {route.path!r} has no serve "
                        f"evidence in any of {'/'.join(route.servers)} — "
                        "the registry drifted from the URL maps"
                    ),
                    hint="serve it (a route table, pattern or path "
                         "dispatch) or delete the registry entry",
                )
            )

    stripped: Set[str] = set(emitted)
    for name in emitted:
        for suffix in ("_total",):
            if name.endswith(suffix):
                stripped.add(name[: -len(suffix)])
    for name, relpath, line in sorted(asserted):
        base = name
        for suffix in _EXPOSITION_SUFFIXES:
            if base.endswith(suffix):
                base = base[: -len(suffix)]
                break
        if base in emitted or base in stripped:
            continue
        if any(family.startswith(base + "_") for family in emitted):
            continue  # prefix assertion ("gordo_resilience_...")
        findings.append(
            Finding(
                checker=CHECKER, code="phantom-series",
                file=relpath, line=line, key=name,
                message=(
                    f"smoke tool asserts series {name!r} but no registry "
                    "metric declaration emits it — the assertion can "
                    "only ever fail (or silently match nothing)"
                ),
                hint="fix the series name, or declare the metric it "
                     "expects",
            )
        )
    return findings
