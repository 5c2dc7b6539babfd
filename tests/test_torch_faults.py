"""The port's fault injection (``gordo_components_tpu_torch.resilience.
faults``), its ``store-commit`` seam and the ``FlakyDataProvider``, against
the JAX package, on the CPU.

- the grammar: good specs parse to the reference's rules, field by field,
  and bad specs raise ``ValueError`` on both sides;
- ``inject`` raises ``FaultInjected`` (a ``RuntimeError``) or sleeps, for a
  matching point and target only; ``damage_artifact`` and ``tear_tail``
  leave the same bytes as the reference's on copies of one file;
- the ``store-commit`` seam of the port's atomic commit: an ``error`` fault
  aborts the commit and leaves the staging dir as a kill would, a
  ``bitflip`` commits an artifact whose manifest no longer verifies;
- ``FlakyDataProvider`` resolves from a config naming the reference's
  class, fails as the reference's does (after ``fail_after`` series, for
  ``fail_times`` calls) and otherwise yields its inner provider's series.
"""

import os
import time
from datetime import datetime, timezone

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.dataset.data_provider.providers import (  # noqa: E402
    FlakyDataProvider as RefFlakyDataProvider,
)
from gordo_components_tpu.dataset.sensor_tag import SensorTag as RefSensorTag  # noqa: E402
from gordo_components_tpu.resilience import faults as ref_faults  # noqa: E402

from gordo_components_tpu_torch.dataset.data_provider import (  # noqa: E402
    FlakyDataProvider,
    GordoBaseDataProvider,
    RandomDataProvider,
)
from gordo_components_tpu_torch.dataset.sensor_tag import SensorTag  # noqa: E402
from gordo_components_tpu_torch.resilience import faults  # noqa: E402
from gordo_components_tpu_torch.store.atomic import STAGING_PREFIX  # noqa: E402
from gordo_components_tpu_torch.store.errors import StoreError  # noqa: E402
from gordo_components_tpu_torch.store.generations import commit_generation  # noqa: E402
from gordo_components_tpu_torch.store.manifest import verify_artifact  # noqa: E402


@pytest.fixture
def ref_rules():
    """Install rules in the reference's module for one call; its state is
    restored after."""
    saved = (list(ref_faults._rules), ref_faults._configured)

    def install(spec):
        ref_faults._rules[:] = ref_faults.parse_spec(spec)
        ref_faults._configured = True

    yield install
    ref_faults._rules[:], ref_faults._configured = saved


@pytest.fixture(autouse=True)
def _no_faults():
    """Each test starts and ends with no rule and the env read pending."""
    faults._rules[:] = []
    faults._configured = False
    yield
    faults._rules[:] = []
    faults._configured = False


GOOD_SPECS = [
    "",
    "data-fetch:m1:error",
    "store-commit:*:bitflip:state.npz",
    "engine-dispatch:mach-slow:latency:0.2;model-load:mach-dead:error",
    " probe:*:latency ; spec-commit:fleet:torn-write ;",
    "reconcile-apply:x:corrupt",
    "store-commit:m:error:disk gone: really",  # the param keeps its colons
    "no-such-point:x:error",  # unknown points parse and never fire
]
BAD_SPECS = [
    "data-fetch:m1",
    "data-fetch",
    "store-commit:m:explode",
    "probe:*:latency:soon",
    "a:b:error;c:d",
]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_good_specs_parse_as_the_reference(spec):
    def fields(rules):
        return [(r.point, r.target, r.kind, r.param) for r in rules]

    assert fields(faults.parse_spec(spec)) == fields(ref_faults.parse_spec(spec))
    assert faults.POINTS == ref_faults.POINTS
    assert faults.KINDS == ref_faults.KINDS


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_as_the_reference(spec):
    with pytest.raises(ValueError):
        ref_faults.parse_spec(spec)
    with pytest.raises(ValueError):
        faults.parse_spec(spec)
    with pytest.raises(ValueError):
        faults.configure(spec)


def test_inject_fires_for_its_point_and_target_only():
    assert not faults.active()
    faults.configure("data-fetch:m1:error:boom;data-fetch:slow:latency:0.05")
    assert faults.active()
    with pytest.raises(faults.FaultInjected, match="boom") as info:
        faults.inject("data-fetch", "m1")
    assert isinstance(info.value, RuntimeError)
    faults.inject("data-fetch", "m2")
    faults.inject("store-commit", "m1")
    started = time.perf_counter()
    faults.inject("data-fetch", "slow")
    assert time.perf_counter() - started >= 0.04
    faults.configure("store-commit:*:error")
    with pytest.raises(faults.FaultInjected, match="store-commit"):
        faults.inject("store-commit", None)
    faults.clear()
    assert not faults.active()
    faults.inject("store-commit", "m1")


def test_env_spec_is_read_lazily_and_a_bad_one_injects_nothing(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "data-fetch:m:error")
    with pytest.raises(faults.FaultInjected):
        faults.inject("data-fetch", "m")
    faults._configured = False
    monkeypatch.setenv(faults.ENV_VAR, "data-fetch:m")
    faults.inject("data-fetch", "m")
    assert not faults.active()


@pytest.mark.parametrize("kind", ["truncate", "bitflip"])
def test_damage_artifact_leaves_the_reference_bytes(tmp_path, kind, ref_rules):
    payload = bytes(range(256)) * 7
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for d in (ours, theirs):
        d.mkdir()
        (d / "state.npz").write_bytes(payload)
        (d / "other.bin").write_bytes(payload)
    spec = f"store-commit:m:{kind}"
    faults.configure(spec)
    faults.damage_artifact("store-commit", "m", str(ours))
    faults.damage_artifact("store-commit", "other", str(ours))  # no match: untouched
    ref_rules(spec)
    ref_faults.damage_artifact("store-commit", "m", str(theirs))
    assert (ours / "state.npz").read_bytes() == (theirs / "state.npz").read_bytes() != payload
    assert (ours / "other.bin").read_bytes() == payload


def test_tear_tail_leaves_the_reference_bytes(tmp_path, ref_rules):
    text = '{"a": 1}\n{"b": 22222222}\n'
    ours, theirs = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    ours.write_text(text)
    theirs.write_text(text)
    faults.configure("spec-commit:j:torn-write")
    faults.tear_tail("spec-commit", "j", str(ours))
    ref_rules("spec-commit:j:torn-write")
    ref_faults.tear_tail("spec-commit", "j", str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.read_text().startswith('{"a": 1}\n{"b"') and len(ours.read_text()) < len(text)


def _write(staging):
    with open(os.path.join(staging, "state.npz"), "wb") as fh:
        fh.write(os.urandom(4096))
    with open(os.path.join(staging, "metadata.json"), "w") as fh:
        fh.write("{}")


def test_store_commit_error_aborts_like_a_kill(tmp_path):
    root = tmp_path / "machine"
    faults.configure("store-commit:mach:error")
    commit_generation(str(tmp_path / "other"), _write, name="other")  # no match
    with pytest.raises(faults.FaultInjected):
        commit_generation(str(root), _write, name="mach")
    assert not (root / "gen-0001").exists() and not (root / "CURRENT").exists()
    leftovers = [e for e in os.listdir(root) if e.startswith(STAGING_PREFIX)]
    assert len(leftovers) == 1  # the staging dir stays, as after a crash
    faults.clear()
    gen = commit_generation(str(root), _write, name="mach")
    verify_artifact(gen)


@pytest.mark.parametrize("kind", ["bitflip", "truncate"])
def test_store_commit_damage_commits_a_torn_artifact(tmp_path, kind):
    faults.configure(f"store-commit:mach:{kind}")
    gen = commit_generation(str(tmp_path / "machine"), _write, name="mach")
    with pytest.raises(StoreError):
        verify_artifact(gen)


def _series_values(provider, tags, tag_cls):
    start = datetime(2023, 1, 1, tzinfo=timezone.utc)
    end = datetime(2023, 1, 2, tzinfo=timezone.utc)
    return list(provider.load_series(start, end, [tag_cls(t, None) for t in tags]))


def test_flaky_provider_fails_as_the_reference():
    tags = ["a", "b", "c"]
    config = {"type": "gordo_components_tpu.dataset.data_provider.providers.FlakyDataProvider",
              "fail_after": 1, "fail_times": 2, "min_size": 20, "max_size": 30, "seed": 4}
    ours = GordoBaseDataProvider.from_dict(config)
    assert isinstance(ours, FlakyDataProvider)
    assert isinstance(ours.provider, RandomDataProvider)
    ref_kwargs = {k: v for k, v in config.items() if k != "type"}
    theirs = RefFlakyDataProvider(**ref_kwargs)
    for _ in range(2):
        with pytest.raises(IOError, match="after 1 series"):
            _series_values(ours, tags, SensorTag)
        with pytest.raises(IOError, match="after 1 series"):
            _series_values(theirs, tags, RefSensorTag)
    mine = _series_values(ours, tags, SensorTag)
    ref = _series_values(theirs, tags, RefSensorTag)
    assert [name for name, _, _ in mine] == [s.name for s in ref] == tags
    for (_, stamps, values), series in zip(mine, ref):
        np.testing.assert_array_equal(stamps, series.index.asi8)
        np.testing.assert_array_equal(values, series.values)
    again = GordoBaseDataProvider.from_dict(ours.to_dict())
    assert again.to_dict() == ours.to_dict()
