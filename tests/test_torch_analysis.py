"""The port's invariant linter (``gordo_components_tpu_torch.analysis``)
against the reference's (``gordo_components_tpu.analysis``).

Checkers: every per-file and aggregate checker of both packages runs over
the reference's seeded-bad corpus (``tests/lint_corpus/*.py``, scanned
under the pretend paths ``tests/test_lint.py`` uses), with the reference's
declaration tables and vocabulary swapped into the port's modules, and the
findings (checker, code, line, key, severity) come out equal: the logic is
the reference's. The port's own declarations are held apart: its
blocking-call vocabulary on a torch-spelled twin of the blocking corpus
(``tests/lint_corpus/torch/``), its route forms, its scope, its knob
registry and README table; and its tree lints clean, in one process and
in two."""

import ast
import json
import os
import subprocess
import sys

import pytest

from gordo_components_tpu.analysis import (
    exception_hygiene as ref_exception_hygiene,
    fault_coverage as ref_fault_coverage,
    guarded_state as ref_guarded_state,
    knob_registry as ref_knob_registry,
    lock_discipline as ref_lock_discipline,
    metrics_conventions as ref_metrics_conventions,
    span_seam as ref_span_seam,
    wire_contracts as ref_wire_contracts,
)
from gordo_components_tpu.analysis.astscan import parse_module as ref_parse_module
from gordo_components_tpu_torch.analysis import (
    exception_hygiene,
    fault_coverage,
    guarded_state,
    knob_registry,
    knobs,
    lock_discipline,
    locks,
    metrics_conventions,
    runner,
    span_seam,
    wire_contracts,
)
from gordo_components_tpu_torch.analysis.astscan import parse_module
from gordo_components_tpu_torch.analysis.findings import Baseline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tests", "lint_corpus")
TORCH_CORPUS = os.path.join(CORPUS, "torch")

ENGINE = "gordo_components_tpu/server/engine.py"
# corpus file -> the pretend paths tests/test_lint.py scans it under
CORPUS_PATHS = {
    "lock_inversion.py": (ENGINE,),
    "blocking_under_lock.py": (ENGINE,),
    "unbound_seam.py": (ENGINE,),
    "unguarded_mutation.py": (ENGINE,),
    "bad_metric_name.py": ("gordo_components_tpu/x.py",),
    "counterless_swallow.py": ("gordo_components_tpu/x.py",),
    "unregistered_knob.py": ("tests/x.py",),
    "orphan_wire.py": ("gordo_components_tpu/server/wire_bad.py",),
    "fault_seams.py": (
        "gordo_components_tpu/resilience/faults.py",
        "gordo_components_tpu/server/x.py",
        "tests/x.py",
    ),
}

PER_FILE = {
    "lock-discipline": (lock_discipline.check, ref_lock_discipline.check),
    "guarded-state": (guarded_state.check, ref_guarded_state.check),
    "span-seam": (span_seam.check, ref_span_seam.check),
    "metrics-conventions": (metrics_conventions.check, ref_metrics_conventions.check),
    "exception-hygiene": (exception_hygiene.check, ref_exception_hygiene.check),
    "knob-registry": (knob_registry.check, ref_knob_registry.check),
}


@pytest.fixture
def reference_tables(monkeypatch):
    """The reference's declarations, vocabulary and scope in the port's
    checker modules: what is left to compare is the checkers' logic."""
    from gordo_components_tpu.analysis import knobs as ref_knobs
    from gordo_components_tpu.analysis import locks as ref_locks

    for module in (lock_discipline, guarded_state):
        monkeypatch.setattr(module, "LOCK_ATTRS", ref_locks.LOCK_ATTRS)
    monkeypatch.setattr(lock_discipline, "LOCK_RANKS", ref_locks.LOCK_RANKS)
    monkeypatch.setattr(lock_discipline, "HOT_LOCKS", ref_locks.HOT_LOCKS)
    monkeypatch.setattr(lock_discipline, "_blocking_reason",
                        ref_lock_discipline._blocking_reason)
    monkeypatch.setattr(guarded_state, "GUARDED_FIELDS", ref_locks.GUARDED_FIELDS)
    for name in ("COMPONENTS", "ALLOWED_LABELS", "HIST_UNITS"):
        monkeypatch.setattr(metrics_conventions, name,
                            getattr(ref_metrics_conventions, name))
    monkeypatch.setattr(knob_registry, "KNOBS", ref_knobs.KNOBS)
    for name in ("HEADERS", "ROUTES", "WIRE_COMPONENTS", "component_of"):
        monkeypatch.setattr(wire_contracts, name, getattr(ref_wire_contracts, name))
    monkeypatch.setattr(
        wire_contracts, "_is_smoke_tool",
        lambda relpath: relpath.startswith("tools/") and relpath.endswith(
            ("_smoke.py", "scrape_metrics.py")))
    monkeypatch.setattr(fault_coverage, "FAULTS_RELPATH", ref_fault_coverage.FAULTS_RELPATH)


def _rows(findings):
    return sorted((f.checker, f.code, f.line, f.key, f.severity) for f in findings)


def _modules(filename):
    path = os.path.join(CORPUS, filename)
    pairs = [(parse_module(path, rel), ref_parse_module(path, rel))
             for rel in CORPUS_PATHS[filename]]
    assert all(port is not None and ref is not None for port, ref in pairs)
    return pairs


@pytest.mark.parametrize("checker", sorted(PER_FILE))
@pytest.mark.parametrize("filename", sorted(CORPUS_PATHS))
def test_a_per_file_checker_finds_what_the_reference_finds(reference_tables, filename, checker):
    port_check, ref_check = PER_FILE[checker]
    for port_module, ref_module in _modules(filename):
        assert _rows(port_check(port_module)) == _rows(ref_check(ref_module))


@pytest.mark.parametrize("filename", sorted(CORPUS_PATHS))
def test_the_wire_contract_finds_what_the_reference_finds(reference_tables, filename):
    port_scans = [wire_contracts.scan(port) for port, _ in _modules(filename)]
    ref_scans = [ref_wire_contracts.scan(ref) for _, ref in _modules(filename)]
    assert _rows(f for found, _ in port_scans for f in found) == _rows(
        f for found, _ in ref_scans for f in found)
    assert _rows(wire_contracts.finalize([ev for _, ev in port_scans])) == _rows(
        ref_wire_contracts.finalize([ev for _, ev in ref_scans]))


@pytest.mark.parametrize("filename", sorted(CORPUS_PATHS))
def test_fault_coverage_finds_what_the_reference_finds(reference_tables, filename):
    pairs = _modules(filename)
    port = fault_coverage.finalize([fault_coverage.scan(p) for p, _ in pairs])
    ref = ref_fault_coverage.finalize([ref_fault_coverage.scan(r) for _, r in pairs])
    assert _rows(port) == _rows(ref)


def test_the_corpus_parity_is_not_vacuous(reference_tables):
    """Each corpus file makes its intended checker report something, so
    the equalities above compare findings, not two empty lists."""
    counts = {}
    for filename in CORPUS_PATHS:
        for port_module, _ in _modules(filename):
            for checker, (check, _) in PER_FILE.items():
                counts[checker] = counts.get(checker, 0) + len(check(port_module))
    assert all(counts[checker] > 0 for checker in PER_FILE), counts


# -- the port's vocabulary: the torch-spelled twin of the blocking corpus ----------


def _shape(key):
    """How many parts a finding's key has: a blocking key is the lock, the
    scope and the call, plus the helper a call one level down went through."""
    return key.count(":")


def test_the_torch_twin_is_caught_like_the_reference_corpus():
    port = lock_discipline.check(parse_module(
        os.path.join(TORCH_CORPUS, "blocking_under_lock.py"),
        "gordo_components_tpu_torch/server/engine.py"))
    ref = ref_lock_discipline.check(ref_parse_module(
        os.path.join(CORPUS, "blocking_under_lock.py"), ENGINE))
    assert {f.code for f in port} == {f.code for f in ref}
    assert {(f.code, _shape(f.key)) for f in port} == {(f.code, _shape(f.key)) for f in ref}
    blocking = {f.key.split(":")[1]: f for f in port if f.code == "blocking-under-lock"}
    assert {f.key.split(":")[0] for f in blocking.values()} == {"engine.template"}
    assert set(blocking) == {
        "fetch_under_lock", "event_under_lock", "item_under_lock", "resolve_under_lock",
        "nvcc_under_lock", "sleep_under_lock", "join_via_helper",
        "http_as_context_manager", "pool_under_lock",
    }
    # the reference's scopes, spelled in torch, are caught in the same places
    ref_scopes = {f.key.split(":")[1] for f in ref if f.code == "blocking-under-lock"}
    assert ref_scopes <= set(blocking)
    assert "device completion" in blocking["fetch_under_lock"].message
    assert "kernel library" in blocking["resolve_under_lock"].message
    assert "nvcc" in blocking["nvcc_under_lock"].message
    assert "network I/O" in blocking["pool_under_lock"].message
    # a host array's tolist and the reasoned escape are not findings; the
    # empty escape is
    assert not any("numpy_is_not_a_device" in f.key or "good_reason" in f.key for f in port)
    assert [f.key.split(":")[0] for f in port if f.code == "empty-escape-reason"] == [
        "empty_reason"]


def _call(source):
    return ast.parse(source).body[0].value


@pytest.mark.parametrize("source, blocks", [
    ("torch.cuda.synchronize()", "device completion"),
    ("self._done.synchronize()", "device completion"),
    ("stream.synchronize()", "device completion"),
    ("loss.item()", "device completion"),
    ("out.cpu()", "device completion"),
    ("out.detach().tolist()", "device completion"),
    ("torch.arange(3).tolist()", "device completion"),
    ("np.asarray(x).tolist()", None),
    ("values.tolist()", None),
    ("np.float32(1.5).item()", None),
    ("_kernels.resolve(names, store)", "kernel library"),
    ("_kernels.fill_store(names, store)", "kernel library"),
    ("_library(name)", "kernel library"),
    ("path.resolve()", None),
    ("subprocess.run([_nvcc(), '--version'])", "nvcc"),
    ("subprocess.Popen(['nvcc', '-o', out, src])", "nvcc"),
    ("subprocess.run(['ls'])", None),
    ("time.sleep(0.1)", "sleeps"),
    ("thread.join()", "joins"),
    ("', '.join(parts)", None),
    ("self._session.post(url)", "network I/O"),
    ("http.get(url)", "network I/O"),
    ("conn.getresponse()", "network I/O"),
    ("urllib.request.urlopen(url)", "network I/O"),
    ("headers.get('accept')", None),
    ("jax.device_get(x)", None),
])
def test_the_blocking_vocabulary_is_pytorchs(source, blocks):
    why = lock_discipline._blocking_reason(_call(source))
    if blocks is None:
        assert why is None, why
    else:
        assert why is not None and blocks in why, why


# -- the port's route forms ----------------------------------------------------------


_ROUTE_TABLE = '''
import re

_ENDPOINTS = {"healthz": "healthz", "anomaly/prediction": "anomaly"}
_ROOT = {"/healthz": "healthz", "/models": "models", "/frobnicate": "frob"}
_MACHINE = re.compile(
    r"^/gordo/v0/(?P<project>[^/]+)/(?P<machine>[^/]+)/(?P<endpoint>"
    + "|".join(re.escape(e) for e in _ENDPOINTS)
    + ")$"
)
_FORWARD = re.compile(r"^/gordo/v0/(?P<project>[^/]+)/(?P<machine>[^/]+)/(?P<rest>.+)$")
_DEBUG = re.compile(r"^/debug/requests/(?P<trace_id>[^/]+)$")
_NOT_A_ROUTE = re.compile(r"[a-z]+")


def dispatch(path):
    if path == "/metrics":
        return "metrics"
'''


def _route_scan(tmp_path, relpath):
    source = tmp_path / "routes.py"
    source.write_text(_ROUTE_TABLE)
    return wire_contracts.scan(parse_module(str(source), relpath))


def test_route_tables_and_patterns_are_serve_evidence(tmp_path):
    findings, evidence = _route_scan(tmp_path, "gordo_components_tpu_torch/server/routes.py")
    assert set(evidence.serves) == {
        "/healthz", "/models", "/metrics", "/debug/requests/<trace_id>",
        "/gordo/v0/<project>/<machine>/healthz",
        "/gordo/v0/<project>/<machine>/anomaly/prediction",
        "/gordo/v0/<project>/<machine>/<path:rest>",
    }
    assert [(f.code, f.key) for f in findings] == [("unregistered-route", "/frobnicate")]


def test_a_path_dict_outside_the_servers_is_no_route_table(tmp_path):
    findings, evidence = _route_scan(tmp_path, "gordo_components_tpu_torch/client/routes.py")
    assert set(evidence.serves) == {"/metrics"}  # the path == dispatch only
    assert not findings


@pytest.mark.parametrize("pattern, templates", [
    (r"^/incidents/(?P<incident_id>[^/]+)$", ["/incidents/<incident_id>"]),
    (r"^/fleet/(?P<action>[^/]+)$", ["/fleet/<action>"]),
    (r"^/a/(?P<rest>.+)$", ["/a/<path:rest>"]),
    (r"^/m/(?P<endpoint>healthz|anomaly/prediction)$", ["/m/healthz", "/m/anomaly/prediction"]),
    (r"^/x\-y/(?P<e>a|b)$", ["/x-y/a", "/x-y/b"]),
])
def test_a_route_pattern_reads_as_templates(pattern, templates):
    assert wire_contracts._regex_templates(pattern) == templates




# -- scope, baseline, knobs ------------------------------------------------------------


def test_the_port_lints_its_own_tree_only():
    files = {os.path.relpath(p, ROOT).replace(os.sep, "/") for p in runner._iter_files(ROOT)}
    assert "chip_smoke.py" in files and "chip_phases.py" in files
    assert "tests/influx_double.py" in files
    assert "gordo_components_tpu_torch/server/engine.py" in files
    assert "tests/test_torch_analysis.py" in files
    assert "tools/torch_slice_profile.py" in files
    assert not [f for f in files if f.startswith(("gordo_components_tpu/", "tests/lint_corpus"))]
    assert "tests/test_lint.py" not in files and "tools/scrape_metrics.py" not in files
    assert runner.repo_root(os.path.join(ROOT, "gordo_components_tpu_torch", "server")) == ROOT


@pytest.fixture(scope="module")
def tree_findings():
    timings = {}
    findings = runner.run_lint(ROOT, jobs=1, timings=timings)
    return findings, timings


def test_the_port_tree_is_lint_clean(tree_findings):
    findings, timings = tree_findings
    baseline = Baseline.load(os.path.join(ROOT, runner.BASELINE_RELPATH))
    fresh, suppressed = baseline.split(findings)
    assert not fresh, "\n" + "\n".join(f.render() for f in fresh)
    assert len(suppressed) == len(baseline.entries)
    for checker in ("lock-discipline", "guarded-state", "wire-contracts", "fault-coverage",
                    "exception-hygiene", "span-seam", "metrics-conventions",
                    "knob-registry"):
        assert checker in timings, sorted(timings)


def test_every_declared_route_is_served_by_the_port(tree_findings):
    """The port's route tables serve each route the registry declares, and
    the registry declares each route they serve."""
    assert not [f for f in tree_findings[0]
                if f.code in ("route-not-served", "unregistered-route")]


def test_two_processes_find_what_one_finds(tree_findings):
    parallel = runner.run_lint(ROOT, jobs=2)
    assert sorted(f.ident for f in parallel) == sorted(f.ident for f in tree_findings[0])


def test_every_baseline_entry_has_a_reason():
    with open(os.path.join(ROOT, runner.BASELINE_RELPATH)) as fh:
        entries = json.load(fh)["findings"]
    assert entries
    for entry in entries:
        reason = entry["reason"].strip()
        assert reason and not reason.upper().startswith("TODO"), entry
        assert entry["id"].split(":")[1].startswith(
            ("gordo_components_tpu_torch/", "chip_smoke.py", "chip_phases.py", "tools/torch_",
             "tests/test_torch_")), entry


def test_the_readme_port_table_is_the_registrys():
    with open(os.path.join(ROOT, "README.md"), encoding="utf-8") as fh:
        text = fh.read()
    begin = text.index(runner.KNOB_TABLE_BEGIN) + len(runner.KNOB_TABLE_BEGIN)
    end = text.index(runner.KNOB_TABLE_END)
    assert text[begin:end].strip() == knobs.render_markdown_table().strip()
    assert begin > text.index(runner.PORT_SECTION)
    # the reference's markers are not the port's
    from gordo_components_tpu.analysis import runner as ref_runner

    for marker in (ref_runner.KNOB_TABLE_BEGIN, ref_runner.KNOB_TABLE_END):
        assert marker not in runner.KNOB_TABLE_BEGIN + runner.KNOB_TABLE_END


def _port_mentions():
    names = set()
    for path in runner._iter_files(ROOT):
        rel = os.path.relpath(path, ROOT).replace(os.sep, "/")
        if rel.startswith("gordo_components_tpu_torch/") and rel != (
                "gordo_components_tpu_torch/analysis/knobs.py"):
            names |= knob_registry.collect_mentions(parse_module(path, rel))
    return names


def test_the_registry_is_the_knobs_the_port_reads():
    from gordo_components_tpu.analysis import knobs as ref_knobs

    assert set(knobs.KNOBS) == _port_mentions()
    for name, knob in knobs.KNOBS.items():
        ref = ref_knobs.KNOBS[name]
        assert (knob.name, knob.parser) == (ref.name, ref.parser)


def test_a_dead_port_knob_is_stale_whatever_the_readme_says(monkeypatch):
    """Neither the port's generated table nor the reference's sections of
    the README keep a knob alive: only the port's code and its section's
    prose do."""
    fake = "GORDO_TEST_" + "ONLY_FAKE_KNOB"
    monkeypatch.setitem(knobs.KNOBS, fake, knobs.Knob(
        name=fake, default="0", parser="bool", doc="corpus-only", component="test"))
    dead_elsewhere = "GORDO_" + "FORCED_CPU"  # named in the README's reference part
    ref_knob = knobs.Knob(name=dead_elsewhere, default="1", parser="bool", doc="-",
                          component="engine")
    monkeypatch.setitem(knobs.KNOBS, dead_elsewhere, ref_knob)
    stale = {f.key for f in runner.run_lint(ROOT) if f.code == "stale-knob"}
    assert {fake, dead_elsewhere} <= stale


def test_the_table_lives_in_the_port_section(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text(f"# x\n\n{runner.PORT_SECTION} (`x`)\n\nprose GORDO_SLO\n\n"
                      f"{runner.KNOB_TABLE_BEGIN}\nold\n{runner.KNOB_TABLE_END}\n\n## Next\n"
                      "the next section's prose\n")
    assert runner.write_knob_table(str(tmp_path))
    section = runner._port_section(str(tmp_path))
    assert knobs.render_markdown_table() in section and "\nold\n" not in section
    assert "prose GORDO_SLO" in section and "next section" not in section
    assert runner._check_knob_table(str(tmp_path)) == []


def test_the_analyzer_needs_nothing_but_the_standard_library():
    """The card's host has no jax, pandas or requests; the lint imports
    none of them, nor torch or numpy."""
    script = (
        "import sys\n"
        "for name in ('torch', 'numpy', 'jax', 'pandas', 'requests', 'gordo_components_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from gordo_components_tpu_torch.analysis.runner import main\n"
        "sys.exit(main(['--format', 'json']))\n"
    )
    result = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                            text=True, timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert result.returncode == 0, result.stderr + result.stdout
    report = json.loads(result.stdout)
    assert report["clean"] is True and report["findings"] == []
    assert set(report["timings"]) >= {"lock-discipline", "wire-contracts", "knob-registry"}


def test_the_cli_lint_verb_is_the_analyzer(capsys, tmp_path):
    from gordo_components_tpu_torch.cli import cli

    assert cli.main(["lint", "--format", "json", "--show-baselined"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["clean"] is True
    assert len(report["baselined"]) == len(Baseline.load(
        os.path.join(ROOT, runner.BASELINE_RELPATH)).entries)
    # with no baseline the keeps are findings
    assert cli.main(["lint", "--baseline", str(tmp_path / "none.json")]) == 1


def test_every_declared_lock_has_a_rank_and_every_hot_lock_is_declared():
    assert set(locks.HOT_LOCKS) <= set(locks.LOCK_RANKS)
    assert set(locks.LOCK_ATTRS.values()) <= set(locks.LOCK_RANKS)
    assert set(locks.GUARDED_FIELDS.values()) <= set(locks.LOCK_RANKS)
    assert len(set(locks.LOCK_RANKS.values())) == len(locks.LOCK_RANKS)
    from gordo_components_tpu.analysis import locks as ref_locks

    shared = set(locks.LOCK_RANKS) & set(ref_locks.LOCK_RANKS)
    assert shared and all(locks.LOCK_RANKS[n] == ref_locks.LOCK_RANKS[n] for n in shared)
