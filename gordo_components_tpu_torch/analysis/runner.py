"""The port's lint entry point (``python -m
gordo_components_tpu_torch.analysis``, the CLI's ``lint``): run every
checker over the port's tree, apply the port's baseline, print
``file:line severity checker message`` findings.

Pure stdlib and import-light on purpose — the gate must run in seconds,
on a host with no torch. Exit status: 0 = clean (no non-baselined
findings), 1 = findings, 2 = usage error.

The scanned tree is the port's: ``gordo_components_tpu_torch/``, its
tests (``tests/test_torch_*.py`` and the Influx double they share,
``tests/influx_double.py``), its tools (``tools/torch_*.py``) and its
card scripts (``chip_smoke.py``, ``chip_phases.py``). The corpus of
seeded-bad snippets under ``tests/lint_corpus/`` is fed to the checkers
by the tests, never scanned as part of the tree.

Two-phase shape so the scan parallelizes: per-file checkers run in a
:func:`_scan_one` worker (``--jobs N`` fans files over processes; the
default ``--jobs 1`` stays in-process and deterministic), returning
findings + the cross-file EVIDENCE (knob mentions, wire-contract
producer/consumer sites, fault-seam references). The aggregate half —
wire finalize, fault finalize, stale knobs, README knob table — joins
the evidence single-threaded. Per-checker wall time is accumulated
either way and reported in the summary line (``--format json`` for CI).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from . import (
    exception_hygiene,
    fault_coverage,
    guarded_state,
    knob_registry,
    knobs,
    lock_discipline,
    metrics_conventions,
    span_seam,
    wire_contracts,
)
from .astscan import CARD_SCRIPTS, parse_module
from .findings import Baseline, Finding

PACKAGE = "gordo_components_tpu_torch"
_PKG = PACKAGE + "/"
_TOOLS = ("tools/torch_",)

# checker -> repo-relative path prefixes it runs over
SCOPES: Dict[str, Tuple[str, ...]] = {
    "lock-discipline": (_PKG,),
    "guarded-state": (_PKG,),
    "span-seam": (
        _PKG + "server/",
        _PKG + "client/",
        _PKG + "router/",
        _PKG + "watchman/",
    ),
    "metrics-conventions": (_PKG, *_TOOLS, *CARD_SCRIPTS),
    "knob-registry": (_PKG, *_TOOLS, "tests/", *CARD_SCRIPTS),
    # tests legitimately swallow in teardown helpers; the hygiene rule
    # covers the shipped tree
    "exception-hygiene": (_PKG, *_TOOLS),
    "wire-contracts": (_PKG, *_TOOLS, *CARD_SCRIPTS),
    "fault-coverage": (_PKG, *_TOOLS, "tests/", *CARD_SCRIPTS),
}

# the port's own markers in README.md's port section (the reference's
# table has markers of its own, which these must not contain)
KNOB_TABLE_BEGIN = (
    "<!-- torch-knob-table:begin (generated: python -m "
    "gordo_components_tpu_torch.analysis --write-knob-table) -->"
)
KNOB_TABLE_END = "<!-- torch-knob-table:end -->"
# README.md's port section: the only prose that counts as a mention of
# a port knob (the reference's own sections and table name every
# reference knob)
PORT_SECTION = "## The PyTorch/H100 port"

BASELINE_RELPATH = PACKAGE + "/analysis/lint_baseline.json"


def repo_root(start: Optional[str] = None) -> str:
    """The checkout root: the directory holding gordo_components_tpu_torch/."""
    here = os.path.abspath(start or os.path.dirname(__file__))
    probe = here
    while True:
        if os.path.isdir(os.path.join(probe, PACKAGE)):
            return probe
        parent = os.path.dirname(probe)
        if parent == probe:
            return os.path.abspath(start or os.getcwd())
        probe = parent


def _is_port_file(relpath: str) -> bool:
    """The port's tree outside its package: its tests, the Influx double
    they share, its tools and the card scripts."""
    name = relpath.rsplit("/", 1)[-1]
    if relpath.startswith("tests/"):
        return relpath.count("/") == 1 and (
            name.startswith("test_torch_") or name == "influx_double.py"
        )
    if relpath.startswith("tools/"):
        return relpath.count("/") == 1 and relpath.startswith(_TOOLS)
    return relpath in CARD_SCRIPTS


def _iter_files(root: str) -> List[str]:
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(root, PACKAGE)):
        dirnames[:] = sorted(
            d for d in dirnames
            # _build: kernel libraries; a lint_corpus would hold
            # seeded-BAD snippets the tests feed the checkers directly
            if d not in ("__pycache__", "_build", "lint_corpus")
        )
        for filename in sorted(filenames):
            if filename.endswith(".py"):
                out.append(os.path.join(dirpath, filename))
    for prefix in ("tests", "tools"):
        base = os.path.join(root, prefix)
        if not os.path.isdir(base):
            continue
        for filename in sorted(os.listdir(base)):
            if filename.endswith(".py") and _is_port_file(f"{prefix}/{filename}"):
                out.append(os.path.join(base, filename))
    for single in CARD_SCRIPTS:
        path = os.path.join(root, single)
        if os.path.exists(path):
            out.append(path)
    return out


def _in_scope(relpath: str, checker: str) -> bool:
    return relpath.startswith(SCOPES[checker]) or relpath in SCOPES[checker]


def _check_knob_table(root: str) -> List[Finding]:
    """README's knob table must equal the generated one."""
    readme = os.path.join(root, "README.md")
    try:
        with open(readme, "r", encoding="utf-8") as handle:
            text = handle.read()
    except OSError:
        return []
    begin = text.find(KNOB_TABLE_BEGIN)
    end = text.find(KNOB_TABLE_END)
    if begin == -1 or end == -1:
        return [
            Finding(
                checker="knob-registry", code="readme-table-missing",
                file="README.md", line=1, key="knob-table",
                message=(
                    "README.md has no generated port knob-table block "
                    f"({KNOB_TABLE_BEGIN} ... {KNOB_TABLE_END})"
                ),
                hint="run: python -m gordo_components_tpu_torch.analysis "
                     "--write-knob-table",
            )
        ]
    current = text[begin + len(KNOB_TABLE_BEGIN):end].strip()
    expected = knobs.render_markdown_table().strip()
    if current != expected:
        line = text[:begin].count("\n") + 1
        return [
            Finding(
                checker="knob-registry", code="readme-table-drift",
                file="README.md", line=line, key="knob-table",
                message=(
                    "README's port knob table differs from the registry "
                    "in analysis/knobs.py — docs drifted"
                ),
                hint="run: python -m gordo_components_tpu_torch.analysis "
                     "--write-knob-table",
            )
        ]
    return []


def _port_section(root: str) -> str:
    """README.md's port section: from its heading to the next
    second-level heading."""
    try:
        with open(os.path.join(root, "README.md"), "r",
                  encoding="utf-8") as handle:
            text = handle.read()
    except OSError:
        return ""
    start = text.find(PORT_SECTION)
    if start == -1:
        return ""
    end = text.find("\n## ", start + len(PORT_SECTION))
    return text[start:] if end == -1 else text[start:end]


def write_knob_table(root: str) -> bool:
    """Rewrite README's generated knob-table block in place."""
    readme = os.path.join(root, "README.md")
    with open(readme, "r", encoding="utf-8") as handle:
        text = handle.read()
    begin = text.find(KNOB_TABLE_BEGIN)
    end = text.find(KNOB_TABLE_END)
    if begin == -1 or end == -1:
        return False
    rendered = (
        text[: begin + len(KNOB_TABLE_BEGIN)]
        + "\n"
        + knobs.render_markdown_table()
        + "\n"
        + text[end:]
    )
    with open(readme, "w", encoding="utf-8") as handle:
        handle.write(rendered)
    return True


# -- per-file scan (the parallelizable half) ----------------------------------

# (checker name, check callable) for the simple per-file checkers
_PER_FILE = (
    ("lock-discipline", lock_discipline.check),
    ("guarded-state", guarded_state.check),
    ("span-seam", span_seam.check),
    ("metrics-conventions", metrics_conventions.check),
    ("exception-hygiene", exception_hygiene.check),
)


def _scan_one(job: Tuple[str, str]) -> Dict[str, Any]:
    """Worker: parse one file, run every in-scope per-file checker, and
    collect the cross-file evidence. Returns only picklable data so
    ``--jobs N`` can fan it across processes."""
    path, relpath = job
    result: Dict[str, Any] = {
        "findings": [], "knob_mentions": set(), "wire": None,
        "fault": None, "timings": {},
    }
    module = parse_module(path, relpath)
    if module is None:
        result["findings"].append(
            Finding(
                checker="lint", code="unparseable", file=relpath,
                line=1, key=relpath,
                message="file does not parse; checkers skipped it",
            )
        )
        return result
    timings: Dict[str, float] = result["timings"]
    for checker, check in _PER_FILE:
        if _in_scope(relpath, checker):
            started = time.perf_counter()
            result["findings"].extend(check(module))
            timings[checker] = (
                timings.get(checker, 0.0) + time.perf_counter() - started
            )
    if _in_scope(relpath, "knob-registry") and (
        relpath != _PKG + "analysis/knobs.py"
    ):
        # knobs.py itself is the registry: its literals would make
        # every registered knob count as "mentioned" (circular
        # staleness) and can never be unregistered
        started = time.perf_counter()
        result["findings"].extend(knob_registry.check(module))
        result["knob_mentions"] = knob_registry.collect_mentions(module)
        timings["knob-registry"] = (
            timings.get("knob-registry", 0.0)
            + time.perf_counter() - started
        )
    if _in_scope(relpath, "wire-contracts") and not relpath.startswith(
        _PKG + "analysis/"
    ):
        # the registry module's own docstrings/specs are not evidence
        started = time.perf_counter()
        wire_findings, wire_evidence = wire_contracts.scan(module)
        result["findings"].extend(wire_findings)
        result["wire"] = wire_evidence
        timings["wire-contracts"] = (
            timings.get("wire-contracts", 0.0)
            + time.perf_counter() - started
        )
    if _in_scope(relpath, "fault-coverage") and not relpath.startswith(
        _PKG + "analysis/"
    ):
        started = time.perf_counter()
        result["fault"] = fault_coverage.scan(module)
        timings["fault-coverage"] = (
            timings.get("fault-coverage", 0.0)
            + time.perf_counter() - started
        )
    return result


def run_lint(
    root: Optional[str] = None,
    jobs: int = 1,
    timings: Optional[Dict[str, float]] = None,
) -> List[Finding]:
    root = root or repo_root()
    if timings is None:
        timings = {}
    job_list = [
        (path, os.path.relpath(path, root).replace(os.sep, "/"))
        for path in _iter_files(root)
    ]
    if jobs == 0:
        jobs = os.cpu_count() or 1
    if jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # spawn, not fork: run_lint is also called in-process by the
        # test suite, whose libraries have already spun up worker
        # threads — forking a multithreaded process can deadlock in the
        # child. The analysis package imports in ~0.3s, so spawn stays
        # cheap.
        with ProcessPoolExecutor(
            max_workers=jobs,
            mp_context=multiprocessing.get_context("spawn"),
        ) as pool:
            results = list(pool.map(_scan_one, job_list, chunksize=8))
    else:
        results = [_scan_one(job) for job in job_list]

    findings: List[Finding] = []
    mentions = set()
    wire_evidence = []
    fault_evidence = []
    for result in results:
        findings.extend(result["findings"])
        mentions |= result["knob_mentions"]
        if result["wire"] is not None:
            wire_evidence.append(result["wire"])
        if result["fault"] is not None:
            fault_evidence.append(result["fault"])
        for checker, spent in result["timings"].items():
            timings[checker] = timings.get(checker, 0.0) + spent

    started = time.perf_counter()
    findings.extend(wire_contracts.finalize(wire_evidence))
    timings["wire-contracts"] = (
        timings.get("wire-contracts", 0.0) + time.perf_counter() - started
    )
    started = time.perf_counter()
    findings.extend(fault_coverage.finalize(fault_evidence))
    timings["fault-coverage"] = (
        timings.get("fault-coverage", 0.0) + time.perf_counter() - started
    )

    started = time.perf_counter()
    # registered-but-unmentioned knobs. README PROSE of the port's
    # section counts as a mention, but the generated knob-table block
    # must NOT: it always contains every registered knob (it is
    # rendered FROM the registry), so counting it would make the stale
    # check circular and dead knobs would live forever. The rest of the
    # README documents the reference, whose table names every
    # reference knob: counting it would mask every dead port knob.
    readme_text = _port_section(root)
    begin = readme_text.find(KNOB_TABLE_BEGIN)
    end = readme_text.find(KNOB_TABLE_END)
    if begin != -1 and end != -1:
        readme_text = readme_text[:begin] + readme_text[end:]
    # word-bounded: prose naming GORDO_COMPILE_CACHE_STORE must not
    # also count as a mention of its prefix GORDO_COMPILE_CACHE
    readme_mentions = set(knob_registry._KNOB_RE.findall(readme_text))
    findings.extend(
        knob_registry.stale_knobs(set(mentions) | readme_mentions)
    )
    findings.extend(_check_knob_table(root))
    timings["knob-registry"] = (
        timings.get("knob-registry", 0.0) + time.perf_counter() - started
    )
    return findings


def _render_timings(timings: Dict[str, float]) -> str:
    return ", ".join(
        f"{checker} {spent:.2f}s"
        for checker, spent in sorted(
            timings.items(), key=lambda item: -item[1]
        )
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gordo_components_tpu_torch.analysis",
        description=(
            "The port's invariant linter: lock discipline, guarded "
            "state, span seams, wire contracts, fault-seam coverage, "
            "exception hygiene, metric conventions, knob registry, "
            "over gordo_components_tpu_torch/ and its tests, tools and "
            "card scripts."
        ),
    )
    parser.add_argument("--root", default=None,
                        help="checkout root (default: auto-detect)")
    parser.add_argument("--baseline", default=None,
                        help="baseline path (default: <root>/"
                             f"{BASELINE_RELPATH})")
    parser.add_argument("--jobs", type=int, default=1, metavar="N",
                        help="parallel per-file scan processes "
                             "(0 = one per CPU; default 1, in-process)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text",
                        help="output format (json: one object with "
                             "findings/baselined/timings, CI-friendly)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="grandfather every current finding into the "
                             "baseline (reasons start as TODO — fill them "
                             "in; a TODO-stubbed entry is itself reported "
                             "as baseline[unjustified-keep] until a real "
                             "reason lands)")
    parser.add_argument("--write-knob-table", action="store_true",
                        help="regenerate the knob table of README.md's "
                             "port section from analysis/knobs.py and exit")
    parser.add_argument("--show-baselined", action="store_true",
                        help="also print findings the baseline suppresses")
    args = parser.parse_args(argv)

    root = os.path.abspath(args.root) if args.root else repo_root()
    if args.write_knob_table:
        if not write_knob_table(root):
            print("README.md has no port knob-table markers", file=sys.stderr)
            return 2
        print("README.md port knob table regenerated")
        return 0

    started = time.perf_counter()
    timings: Dict[str, float] = {}
    findings = run_lint(root, jobs=args.jobs, timings=timings)
    baseline_path = args.baseline or os.path.join(root, BASELINE_RELPATH)
    baseline = Baseline.load(baseline_path)

    if args.write_baseline:
        # rebuild from CURRENT findings: existing reasons survive, new
        # findings start as TODO, and entries whose violation is gone
        # are pruned — a freshly written baseline always gates clean
        baseline.entries = {
            finding.ident: baseline.entries.get(
                finding.ident, "TODO: justify"
            )
            for finding in findings
        }
        baseline.save(baseline_path)
        print(f"baseline written: {len(baseline.entries)} entr(ies) in "
              f"{baseline_path}")
        return 0

    fresh, suppressed = baseline.split(findings)
    fresh.sort(key=lambda f: (f.file, f.line, f.checker, f.code))
    elapsed = time.perf_counter() - started

    if args.format == "json":
        def _as_dict(finding: Finding) -> Dict[str, Any]:
            return {
                "file": finding.file, "line": finding.line,
                "severity": finding.severity, "checker": finding.checker,
                "code": finding.code, "key": finding.key,
                "message": finding.message, "hint": finding.hint,
                "ident": finding.ident,
            }

        print(json.dumps(
            {
                "findings": [_as_dict(f) for f in fresh],
                "baselined": [
                    dict(_as_dict(f),
                         reason=baseline.entries.get(f.ident, ""))
                    for f in suppressed
                ],
                "timings": {
                    checker: round(spent, 4)
                    for checker, spent in sorted(timings.items())
                },
                "elapsed": round(elapsed, 4),
                "clean": not fresh,
            },
            indent=2,
        ))
        return 1 if fresh else 0

    for finding in fresh:
        print(finding.render())
    if args.show_baselined and suppressed:
        print(f"-- {len(suppressed)} baselined finding(s):")
        for finding in suppressed:
            print(f"   {finding.render()}  "
                  f"[baseline: {baseline.entries.get(finding.ident, '')}]")
    print(
        f"lint: {len(fresh)} finding(s), {len(suppressed)} baselined, "
        f"{elapsed:.2f}s [{_render_timings(timings)}]"
    )
    return 1 if fresh else 0
