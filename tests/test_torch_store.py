"""The port's model store against the JAX package's, on the CPU: atomic
commits, generations (commit, prune, pin, rollback past a corrupted
generation), the fleet index, the build journal, the disk registry, and
roots committed by one package read, verified and rolled back by the
other. Manifests are compared byte for byte; everything else exactly."""

import json
import os

import pytest

from gordo_components_tpu.store import atomic as ref_atomic
from gordo_components_tpu.store import errors as ref_errors
from gordo_components_tpu.store import generations as ref_generations
from gordo_components_tpu.store import journal as ref_journal
from gordo_components_tpu.store import manifest as ref_manifest
from gordo_components_tpu.utils import disk_registry as ref_registry

from gordo_components_tpu_torch.observability.registry import REGISTRY
from gordo_components_tpu_torch.store import atomic, errors, generations, journal, manifest
from gordo_components_tpu_torch.utils import disk_registry

ERRORS = ("StoreError", "ManifestMissing", "ArtifactIncomplete", "ArtifactCorrupt")


def _write(directory, files):
    os.makedirs(directory, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(directory, name), "wb") as fh:
            fh.write(data)


def _writer(files):
    return lambda staging: _write(staging, files)


def _flip_byte(path):
    with open(path, "r+b") as fh:
        data = bytearray(fh.read())
        data[0] ^= 0xFF
        fh.seek(0)
        fh.write(bytes(data))


@pytest.mark.parametrize("name", ERRORS)
def test_store_error_hierarchy_is_the_references(name):
    ours, ref = getattr(errors, name), getattr(ref_errors, name)
    assert [c.__name__ for c in ours.__mro__] == [c.__name__ for c in ref.__mro__]
    assert ours.__doc__ == ref.__doc__
    assert issubclass(ours, RuntimeError) and not issubclass(ours, ValueError)
    # the old import path names the same class
    assert getattr(manifest, name) is ours


def test_render_manifest_is_byte_equal(tmp_path):
    _write(tmp_path / "a", {"state.npz": b"\x00" * 1000, "definition.json": b"{}",
                            "z.txt": "ünï".encode()})
    ours = manifest.manifest_for_dir(str(tmp_path / "a"))
    assert ours == ref_manifest.manifest_for_dir(str(tmp_path / "a"))
    assert manifest.render_manifest(ours) == ref_manifest.render_manifest(ours)
    manifest.write_manifest(str(tmp_path / "a"))
    with open(tmp_path / "a" / manifest.MANIFEST_FILE, "rb") as fh:
        assert fh.read() == ref_manifest.render_manifest(ours)


def test_verify_artifact_typed_errors_and_shallow_check(tmp_path):
    root = str(tmp_path / "a")
    _write(root, {"f": b"abc"})
    with pytest.raises(errors.ManifestMissing):
        manifest.verify_artifact(root)
    manifest.write_manifest(root)
    assert manifest.read_manifest(root)["files"]["f"]["size"] == 3
    _flip_byte(os.path.join(root, "f"))
    manifest.verify_artifact(root, deep=False)  # sizes agree: a structural pass
    before = REGISTRY.counter("gordo_store_verify_failures_total", labels=("error",)).collect()
    with pytest.raises(errors.ArtifactCorrupt, match="SHA-256"):
        manifest.verify_artifact(root)
    after = REGISTRY.counter("gordo_store_verify_failures_total", labels=("error",)).collect()
    assert after[("ArtifactCorrupt",)] == before.get(("ArtifactCorrupt",), 0) + 1
    os.remove(os.path.join(root, "f"))
    with pytest.raises(errors.ArtifactIncomplete):
        manifest.verify_artifact(root, deep=False)
    with open(os.path.join(root, manifest.MANIFEST_FILE), "w") as fh:
        fh.write('{"format_version": 2, "files": {}}')
    with pytest.raises(errors.ArtifactCorrupt, match="format_version"):
        manifest.read_manifest(root)


def test_write_manifest_checks_a_precomputed_payload(tmp_path):
    root = str(tmp_path / "a")
    _write(root, {"f": b"abc"})
    payload = manifest.manifest_for_dir(root)
    _write(root, {"g": b"x"})
    with pytest.raises(errors.ArtifactIncomplete, match="precomputed"):
        manifest.write_manifest(root, payload=payload)


def test_fsync_knob(monkeypatch):
    for value, expected in (("0", False), ("off", False), ("1", True), ("", True)):
        monkeypatch.setenv("GORDO_STORE_FSYNC", value)
        assert manifest.fsync_enabled() is expected is ref_manifest.fsync_enabled()


def test_atomic_commit_publishes_whole_or_nothing(tmp_path):
    dest = str(tmp_path / "art")
    with atomic.atomic_commit(dest) as staging:
        _write(staging, {"a": b"1"})
        assert os.path.basename(staging).startswith(atomic.STAGING_PREFIX)
    assert sorted(os.listdir(dest)) == ["MANIFEST.json", "a"]
    ref_manifest.verify_artifact(dest)
    with pytest.raises(RuntimeError, match="boom"):
        with atomic.atomic_commit(dest) as staging:
            _write(staging, {"b": b"2"})
            raise RuntimeError("boom")
    assert sorted(os.listdir(tmp_path)) == ["art"]  # no staging left, dest untouched
    assert sorted(os.listdir(dest)) == ["MANIFEST.json", "a"]
    with atomic.atomic_commit(dest) as staging:  # replaces an existing artifact
        _write(staging, {"c": b"3"})
    assert sorted(os.listdir(dest)) == ["MANIFEST.json", "c"]
    assert sorted(os.listdir(tmp_path)) == ["art"]


def test_sweep_leftovers_removes_staging_and_restores_orphaned_trash(tmp_path):
    _write(tmp_path / ".staging-x.1234", {"a": b"1"})
    _write(tmp_path / ".trash-gone.abcd", {"a": b"only copy"})
    _write(tmp_path / ".trash-kept.abcd", {"a": b"old"})
    _write(tmp_path / "kept", {"a": b"new"})
    swept = atomic.sweep_leftovers(str(tmp_path))
    assert sorted(swept) == [".staging-x.1234", ".trash-gone.abcd (restored as gone)",
                             ".trash-kept.abcd"]
    assert sorted(os.listdir(tmp_path)) == ["gone", "kept"]
    with open(tmp_path / "gone" / "a", "rb") as fh:
        assert fh.read() == b"only copy"


def test_atomic_write_file(tmp_path):
    path = str(tmp_path / "CURRENT")
    atomic.atomic_write_file(path, "gen-0001\n")
    atomic.atomic_write_file(path, "gen-0002\n")
    assert open(path).read() == "gen-0002\n"
    assert os.listdir(tmp_path) == ["CURRENT"]


def test_generations_commit_prune_and_pin(tmp_path, monkeypatch):
    root = str(tmp_path / "m")
    paths = [generations.commit_generation(root, _writer({"v": str(i).encode()}), keep=2)
             for i in range(4)]
    assert [os.path.basename(p) for p in paths] == [f"gen-000{i}" for i in range(1, 5)]
    assert generations.list_generations(root) == ["gen-0003", "gen-0004"]
    assert generations.current_generation(root) == "gen-0004"
    assert generations.resolve_artifact_dir(root) == paths[-1]
    assert generations.pin_generation(root, "gen-0003") == "gen-0003"
    assert generations.current_generation(root) == "gen-0003"
    generations.commit_generation(root, _writer({"v": b"5"}), keep=1)  # never below 2
    assert generations.list_generations(root) == ["gen-0004", "gen-0005"]
    assert generations.current_generation(root) == "gen-0005"
    with pytest.raises(errors.ArtifactIncomplete, match="no such generation"):
        generations.pin_generation(root, "gen-0001")
    with pytest.raises(errors.ArtifactIncomplete, match="not a generation"):
        generations.pin_generation(root, "latest")
    monkeypatch.setenv("GORDO_STORE_KEEP_GENERATIONS", "4")
    for i in range(4):
        generations.commit_generation(root, _writer({"v": b"x"}))
    assert len(generations.list_generations(root)) == 4


def test_generation_names_sort_numerically(tmp_path):
    for name in ("gen-9999", "gen-10000", "gen-0002"):
        os.makedirs(tmp_path / name)
    assert generations.list_generations(str(tmp_path)) == ["gen-0002", "gen-9999", "gen-10000"]
    assert generations.next_generation_name(str(tmp_path)) == "gen-10001"
    assert generations.next_generation_name(str(tmp_path / "none")) == "gen-0001"


def test_rollback_skips_an_unverifiable_generation(tmp_path):
    root = str(tmp_path / "m")
    for i in range(3):
        generations.commit_generation(root, _writer({"v": f"v{i}".encode()}), keep=5)
    _flip_byte(os.path.join(root, "gen-0002", "v"))
    restored = generations.rollback_generation(root)
    assert restored == os.path.join(root, "gen-0001")
    assert generations.current_generation(root) == "gen-0001"
    with pytest.raises(errors.StoreError, match="no previous generation"):
        generations.rollback_generation(root)
    # a garbage pointer: every generation is a candidate, the newest that verifies wins
    with open(os.path.join(root, generations.CURRENT_FILE), "w") as fh:
        fh.write("garbage")
    assert generations.rollback_generation(root) == os.path.join(root, "gen-0003")
    with pytest.raises(errors.StoreError, match="not a generation root"):
        generations.rollback_generation(str(tmp_path))


def test_resolve_artifact_dir_refuses_a_pointer_that_is_not_a_generation(tmp_path):
    """A ``CURRENT`` naming an existing directory that is not ``gen-NNNN``
    is torn in the reference; the port's first copy followed it."""
    root = str(tmp_path / "m")
    generations.commit_generation(root, _writer({"v": b"1"}))
    os.makedirs(os.path.join(root, "other"))
    with open(os.path.join(root, generations.CURRENT_FILE), "w") as fh:
        fh.write("other\n")
    for resolve in (generations.resolve_artifact_dir, ref_generations.resolve_artifact_dir):
        with pytest.raises(RuntimeError, match="not a generation name"):
            resolve(root)
    assert generations.resolve_artifact_dir(str(tmp_path)) == str(tmp_path)  # flat


def test_artifact_status_and_fleet_index(tmp_path):
    models = str(tmp_path)
    generations.commit_generation(os.path.join(models, "a"), _writer({"v": b"1"}))
    _write(os.path.join(models, "flat"), {"definition.json": b"{}"})
    _write(os.path.join(models, ".hidden"), {"definition.json": b"{}"})
    _write(os.path.join(models, "junk"), {"x": b""})
    index = generations.build_fleet_index(models)
    assert index == ref_generations.build_fleet_index(models)
    assert index == {"a": {"path": "a", "generation": "gen-0001"},
                     "flat": {"path": "flat", "generation": None}}
    path = generations.write_fleet_index(models, {**index, "a": {**index["a"],
                                                                 "precision": "int8"}})
    assert generations.read_fleet_index(models) == ref_generations.read_fleet_index(models)
    assert generations.read_fleet_index(models)["a"]["precision"] == "int8"
    with open(path, "w") as fh:
        json.dump({"format_version": 9, "machines": {}}, fh)
    assert generations.read_fleet_index(models) is None
    status = generations.artifact_status(os.path.join(models, "a"))
    assert status == ref_generations.artifact_status(os.path.join(models, "a"))
    assert status["verified"] and status["generation"] == "gen-0001"
    flat = generations.artifact_status(os.path.join(models, "flat"))
    assert flat == ref_generations.artifact_status(os.path.join(models, "flat"))
    assert flat["error"].startswith("ManifestMissing")
    assert generations.is_artifact_dir(os.path.join(models, "flat"))
    assert not generations.is_artifact_dir(os.path.join(models, "junk"))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_roots_cross_between_the_packages(tmp_path, writer):
    """A root committed by one package is read, verified and rolled back by
    the other: the same manifest bytes, CURRENT and generation names."""
    commit, other, verify = ((generations, ref_generations, ref_manifest.verify_artifact)
                             if writer == "port" else
                             (ref_generations, generations, manifest.verify_artifact))
    root = str(tmp_path / "m")
    for i in range(3):
        commit.commit_generation(root, _writer({"state.npz": bytes([i]) * 64,
                                                "metadata.json": b"{}"}))
    assert other.list_generations(root) == ["gen-0001", "gen-0002", "gen-0003"]
    assert other.current_generation(root) == "gen-0003"
    for gen in other.list_generations(root):
        verify(os.path.join(root, gen))
    assert other.artifact_status(root)["verified"]
    _flip_byte(os.path.join(root, "gen-0002", "state.npz"))
    assert other.rollback_generation(root) == os.path.join(root, "gen-0001")
    assert commit.current_generation(root) == "gen-0001"
    with open(os.path.join(root, "gen-0001", "MANIFEST.json"), "rb") as fh:
        assert fh.read() == manifest.render_manifest(
            ref_manifest.manifest_for_dir(os.path.join(root, "gen-0001")))


def test_journal_replay_with_a_torn_line_and_siblings(tmp_path):
    out = str(tmp_path)
    j0 = journal.BuildJournal(journal.journal_path(out))
    j1 = journal.BuildJournal(journal.journal_path(out, 1))
    assert j1.path.endswith("build_journal.jsonl.p1")
    j0.record("m-1", journal.EVENT_STARTED, cache_key="k1")
    j0.record("m-1", journal.EVENT_COMMITTED, model_dir="d1")
    j0.record("m-2", journal.EVENT_STARTED)
    j1.record("m-3", journal.EVENT_FAILED, error="boom")
    with open(j0.path, "a") as fh:
        fh.write('{"machine": "m-2", "event": "comm')  # the append a crash cut
    states = journal.replay(out)
    assert states == ref_journal.replay(out)
    assert {m: r["event"] for m, r in states.items()} == {
        "m-1": "committed", "m-2": "started", "m-3": "failed"}
    assert journal.summarize(states) == ref_journal.summarize(states) == {
        "started": 1, "committed": 1, "failed": 1}
    assert journal.replay(str(tmp_path / "nothing")) == {}


def test_disk_registry(tmp_path):
    reg = str(tmp_path / "reg")
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    disk_registry.write_key(reg, "abc123", model_dir)
    assert disk_registry.get_value(reg, "abc123") == model_dir
    assert ref_registry.get_value(reg, "abc123") == model_dir
    ref_registry.write_key(reg, "def456", str(tmp_path / "gone"))
    assert disk_registry.get_value(reg, "def456") is None  # dangling
    assert disk_registry.get_value(reg, "nothing") is None
    assert disk_registry.delete_key(reg, "abc123") and not disk_registry.delete_key(reg, "abc123")
    with pytest.raises(ValueError, match="filename"):
        disk_registry.write_key(reg, "../escape", model_dir)
    assert sorted(os.listdir(reg)) == ["def456.md5"]


def test_port_atomic_commit_keeps_the_reference_layout(tmp_path):
    """Staging and trash names are the reference's, so either package's
    sweep cleans the other's debris."""
    assert atomic.STAGING_PREFIX == ref_atomic.STAGING_PREFIX
    _write(tmp_path / f"{atomic.STAGING_PREFIX}x.1", {"a": b""})
    assert ref_atomic.sweep_leftovers(str(tmp_path)) == [f"{atomic.STAGING_PREFIX}x.1"]
