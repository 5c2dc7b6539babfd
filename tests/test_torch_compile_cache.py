"""The port's compile cache (``gordo_components_tpu_torch/compile_cache``)
against the reference's, on the CPU.

Where a kernel library would be built, a stub ``nvcc`` on ``PATH`` writes a
file of its own (its source's hash and flags) and logs its invocation; the
stub loader reads that file back instead of ``dlopen``-ing it, and the
probe checks what it read. So the store's whole path runs here: keys and
names rendered as the reference's, ``resolve_store``'s precedence, entries
that the reference's ``verify_artifact`` accepts, the outcomes miss, hit,
stale, invalid and the self-heal, ``write_error`` on a root that cannot be
written, an fp32 → bf16 flip that misses cleanly, ``purge --stale`` and
the two packages' roots kept apart, the raise without ``nvcc`` on a cold
store and a warm store serving without it, two processes racing on one
empty store, the engine's libraries per rung, the export, and the ``cache``
CLI's JSON keys held against the reference's.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.compile_cache import fingerprint as ref_fp  # noqa: E402
from gordo_components_tpu.compile_cache import store as ref_store  # noqa: E402
from gordo_components_tpu.store import manifest as ref_manifest  # noqa: E402

from gordo_components_tpu_torch.compile_cache import fingerprint as fp  # noqa: E402
from gordo_components_tpu_torch.compile_cache import store as cc_store  # noqa: E402
from gordo_components_tpu_torch.compile_cache.store import (  # noqa: E402
    CompileCacheStore,
    resolve_store,
)
from gordo_components_tpu_torch.ops import _kernels  # noqa: E402
from gordo_components_tpu_torch.store.manifest import write_manifest  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F32, BF16 = "flash_fwd_f32", "flash_fwd_bf16"

STUB_NVCC = """\
#!{python}
import hashlib, os, sys, time
if "--version" in sys.argv:
    print("Cuda compilation tools, release 0.0, V0.0.0 (stub)")
    sys.exit(0)
args = sys.argv[1:]
out = args[args.index("-o") + 1]
src = args[-1]
with open(os.environ["STUB_NVCC_LOG"], "a") as fh:
    fh.write(os.path.basename(src) + "\\n")
time.sleep(float(os.environ.get("STUB_NVCC_SLEEP", "0")))
flags = [a for i, a in enumerate(args[:-1]) if a != "-o" and args[i - 1] != "-o"]
with open(src, "rb") as fh:
    digest = hashlib.sha256(fh.read()).hexdigest()
with open(out, "wb") as fh:
    fh.write(("stub-library:" + digest + ":" + " ".join(flags)).encode())
"""


class StubLib:
    """What the stub loader returns: the bytes it read at load."""

    def __init__(self, path):
        with open(path, "rb") as fh:
            self.data = fh.read()
        if not self.data.startswith(b"stub-library:"):
            raise OSError(f"{path}: not a library")


def _stub_probe(name, lib):
    flags = " ".join(_kernels.nvcc_flags())
    if not lib.data.endswith(flags.encode()):
        raise RuntimeError(f"{name}: built with other flags")


@pytest.fixture
def toolchain(tmp_path, monkeypatch):
    """A stub nvcc first on PATH (its invocations logged), the stub loader
    and probe, and a fresh process-wide library table."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STUB_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    log.write_text("")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.setenv("STUB_NVCC_LOG", str(log))
    monkeypatch.delenv("CUDA_KERNEL_DEBUG", raising=False)
    monkeypatch.delenv(cc_store.STORE_ENV, raising=False)
    monkeypatch.setattr(_kernels, "_LIBS", {})
    monkeypatch.setattr(_kernels, "_LIB_FILES", {})
    monkeypatch.setattr(_kernels, "_load_library", lambda path, name: StubLib(path))
    monkeypatch.setattr(_kernels, "_probe_library", _stub_probe)

    class Toolchain:
        def compiled(self):
            return log.read_text().split()

        def new_process(self):
            """What a fresh process sees: no library loaded."""
            _kernels._LIBS.clear()
            _kernels._LIB_FILES.clear()

        def hide_nvcc(self):
            monkeypatch.setenv("PATH", os.pathsep.join(
                p for p in os.environ["PATH"].split(os.pathsep) if p != str(bin_dir)))
            monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    return Toolchain()


def _entry(store, name):
    return store.path_of(_kernels.library_key(name))


# -- keys and names -----------------------------------------------------------

KEYS = [
    {"program": {"kind": "kernel-library", "library": F32, "precision": "f32"},
     "backend": {"torch": "2.5.1", "cuda": "12.4", "debug": False}},
    {"b": [3, 2, {"z": None, "a": 1.5}], "a": "é"},
    {"nested": {"tuple": (1, 2), "path": Path("/x")}},
    {},
]


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
def test_canonical_and_entry_name_render_as_the_references(key):
    assert fp.canonical(key) == ref_fp.canonical(key)
    assert fp.entry_name(key) == ref_fp.entry_name(key)
    assert fp.entry_name(key).startswith("cc-") and len(fp.entry_name(key)) == 35


def test_backend_fingerprint_needs_no_card_and_names_the_build(monkeypatch):
    monkeypatch.delenv("CUDA_KERNEL_DEBUG", raising=False)
    backend = fp.backend_fingerprint()
    assert backend == {"torch": torch.__version__, "cuda": torch.version.cuda,
                       "machine": __import__("platform").machine(), "arch": "sm_90a",
                       "debug": False}
    monkeypatch.setenv("CUDA_KERNEL_DEBUG", "1")
    assert fp.backend_fingerprint()["debug"] is True
    key = _kernels.library_key(F32)
    assert key["precision"] == "f32" and key["flags"][-1] == "-DCUDA_KERNEL_DEBUG"
    assert "nvcc" not in json.dumps(fp.full_key(key))


# -- where the store lives ----------------------------------------------------

CASES = [  # (explicit, env, models_root)
    (None, None, None),
    (None, None, "models"),
    ("explicit", None, "models"),
    (None, "from-env", "models"),
    ("explicit", "from-env", "models"),
    ("off", None, "models"),
    (None, "off", "models"),
    ("off", "from-env", None),
    ("explicit", "off", None),
    (None, "", "models"),
]


@pytest.mark.parametrize("explicit,env,models_root", CASES)
def test_resolve_store_follows_the_references_precedence(tmp_path, monkeypatch, explicit, env,
                                                         models_root):
    monkeypatch.chdir(tmp_path)
    if env is None:
        monkeypatch.delenv(cc_store.STORE_ENV, raising=False)
    else:
        monkeypatch.setenv(cc_store.STORE_ENV, env)
    ours = resolve_store(explicit, models_root)
    theirs = ref_store.resolve_store(explicit, models_root)
    if theirs is None:
        assert ours is None
    elif explicit is None and not env:
        # the models-root default: the port's subdirectory of the reference's
        assert ours.root == os.path.join(theirs.root, "torch-cuda")
    else:
        assert ours.root == theirs.root


# -- the outcomes ---------------------------------------------------------------

def test_miss_then_hit_with_no_nvcc_run(toolchain, tmp_path):
    store = CompileCacheStore(str(tmp_path / "store"))
    assert _kernels.resolve([F32], store) == {F32: "miss"}
    assert toolchain.compiled() == ["flash_fwd_f32.cu"]
    assert store.counters == {"hit": 0, "miss": 1, "stale": 0, "invalid": 0, "write": 1,
                              "write_error": 0}
    # the same process asks again: the library is loaded, nothing is looked up
    assert _kernels.resolve([F32], store) == {F32: "loaded"}
    toolchain.new_process()
    again = CompileCacheStore(store.root)
    assert _kernels.resolve([F32], again) == {F32: "hit"}
    assert toolchain.compiled() == ["flash_fwd_f32.cu"]
    assert again.counters["hit"] == 1 and again.counters["write"] == 0
    # what was loaded is a private copy of the entry's bytes, never the entry
    ident = _kernels._identity(F32)
    loaded_from = _kernels._LIB_FILES[ident][0]
    assert not loaded_from.startswith(store.root)
    with open(os.path.join(_entry(store, F32), cc_store.LIBRARY_FILE), "rb") as fh:
        assert _kernels._LIBS[ident].data == fh.read()


def test_an_entry_is_what_the_references_manifest_verifies(toolchain, tmp_path):
    store = CompileCacheStore(str(tmp_path / "store"))
    _kernels.resolve([F32], store)
    entry = _entry(store, F32)
    assert sorted(os.listdir(entry)) == ["KEY.json", "MANIFEST.json", "META.json", "library.so"]
    payload = ref_manifest.verify_artifact(entry, deep=True)
    assert sorted(payload["files"]) == ["KEY.json", "META.json", "library.so"]
    with open(os.path.join(entry, "KEY.json")) as fh:
        assert fh.read().strip() == fp.canonical(fp.full_key(_kernels.library_key(F32)))
    with open(os.path.join(entry, "META.json")) as fh:
        meta = json.load(fh)
    assert meta["nvcc"].endswith("(stub)") and meta["compile_seconds"] > 0
    assert os.path.basename(entry) == ref_fp.entry_name(fp.full_key(_kernels.library_key(F32)))


def _flip_a_bit(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x01
    open(path, "wb").write(bytes(data))


def test_a_flipped_bit_reads_invalid_and_the_store_heals(toolchain, tmp_path):
    store = CompileCacheStore(str(tmp_path / "store"))
    _kernels.resolve([F32, BF16], store)
    _flip_a_bit(os.path.join(_entry(store, F32), cc_store.LIBRARY_FILE))
    toolchain.new_process()
    second = CompileCacheStore(store.root)
    assert _kernels.resolve([F32, BF16], second) == {F32: "invalid", BF16: "hit"}
    assert toolchain.compiled().count("flash_fwd_f32.cu") == 2
    assert second.counters["write"] == 1
    ref_manifest.verify_artifact(_entry(store, F32), deep=True)
    toolchain.new_process()
    third = CompileCacheStore(store.root)
    assert _kernels.resolve([F32, BF16], third) == {F32: "hit", BF16: "hit"}
    assert len(toolchain.compiled()) == 3


def test_a_rewritten_key_reads_stale_and_a_failed_probe_invalid(toolchain, tmp_path,
                                                                monkeypatch):
    store = CompileCacheStore(str(tmp_path / "store"))
    _kernels.resolve([F32], store)
    entry = _entry(store, F32)
    key_file = os.path.join(entry, "KEY.json")
    key = json.loads(open(key_file).read())
    key["backend"]["torch"] = "0.0-elsewhere"
    open(key_file, "w").write(fp.canonical(key) + "\n")
    write_manifest(entry, fsync=False)  # verifies, but holds another key
    toolchain.new_process()
    second = CompileCacheStore(store.root)
    assert _kernels.resolve([F32], second) == {F32: "stale"}
    assert second.counters["write"] == 1
    toolchain.new_process()

    def failing(name, lib):
        raise RuntimeError("probe disagrees")

    monkeypatch.setattr(_kernels, "_probe_library", failing)
    third = CompileCacheStore(store.root)
    assert _kernels.resolve([F32], third) == {F32: "invalid"}
    assert toolchain.compiled() == ["flash_fwd_f32.cu"] * 3


def test_a_root_that_cannot_be_written_counts_write_error_and_still_loads(toolchain,
                                                                          tmp_path):
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    store = CompileCacheStore(str(blocker / "store"))
    assert _kernels.resolve([F32], store) == {F32: "miss"}
    assert store.counters["write_error"] == 1 and store.counters["write"] == 0
    assert isinstance(_kernels._LIBS[_kernels._identity(F32)], StubLib)
    assert _kernels._LIB_FILES[_kernels._identity(F32)][0].startswith(cc_store.private_dir())


def test_an_fp32_to_bf16_flip_is_a_clean_miss_never_a_stale_hit(toolchain, tmp_path):
    store = CompileCacheStore(str(tmp_path / "store"))
    assert _kernels.resolve([F32], store) == {F32: "miss"}
    assert _kernels.resolve([BF16], store) == {BF16: "miss"}
    assert store.counters["stale"] == 0 and store.counters["hit"] == 0
    assert _entry(store, F32) != _entry(store, BF16)
    assert {r["precision"] for r in store.entries()} == {"f32", "bf16"}


def test_a_debug_build_is_a_new_entry_never_a_stale_hit(toolchain, tmp_path, monkeypatch):
    store = CompileCacheStore(str(tmp_path / "store"))
    _kernels.resolve([F32], store)
    monkeypatch.setenv("CUDA_KERNEL_DEBUG", "1")
    toolchain.new_process()
    debug = CompileCacheStore(store.root)
    assert _kernels.resolve([F32], debug) == {F32: "miss"}
    assert debug.counters["stale"] == 0
    assert len(os.listdir(store.root)) == 2


def test_purge_stale_removes_the_damaged_and_the_other_backends_entries_only(
        toolchain, tmp_path, monkeypatch):
    """Current entries stay; a damaged one and a debug build's go. The
    reference's entries beside the port's subdirectory survive the port's
    purge, and the port's survive the reference's."""
    models = tmp_path / "models"
    store = resolve_store(None, str(models))
    _kernels.resolve([F32, BF16], store)
    monkeypatch.setenv("CUDA_KERNEL_DEBUG", "1")
    toolchain.new_process()
    _kernels.resolve([F32], store)
    monkeypatch.delenv("CUDA_KERNEL_DEBUG")
    debug_entry = [r["name"] for r in store.entries() if r["backend"]["debug"]]
    _flip_a_bit(os.path.join(_entry(store, BF16), cc_store.LIBRARY_FILE))
    reference_entry = models / ".compile-cache" / "cc-0123456789abcdef0123456789abcdef"
    reference_entry.mkdir(parents=True)
    (reference_entry / "KEY.json").write_text('{"program": {}, "backend": {}}\n')

    listed = {r["name"]: r for r in store.entries()}
    assert listed[os.path.basename(_entry(store, F32))]["current"] is True
    assert listed[os.path.basename(_entry(store, BF16))]["verified"] is False
    assert listed[debug_entry[0]]["current"] is False
    removed = store.purge(stale_only=True)
    assert sorted(removed) == sorted([os.path.basename(_entry(store, BF16)), *debug_entry])
    assert [r["name"] for r in store.entries()] == [os.path.basename(_entry(store, F32))]
    assert reference_entry.is_dir()
    # the reference's purge walks its own root only: the port's subdirectory
    # is not a cc-* directory there
    ref_root = ref_store.CompileCacheStore(str(models / ".compile-cache"))
    ref_root.purge(stale_only=False)
    assert not reference_entry.exists()
    assert [r["name"] for r in store.entries()] == [os.path.basename(_entry(store, F32))]
    assert store.purge() == [os.path.basename(_entry(store, F32))]


def test_without_nvcc_a_cold_store_raises_naming_both_and_a_warm_one_serves(toolchain,
                                                                            tmp_path):
    warm = CompileCacheStore(str(tmp_path / "warm"))
    _kernels.resolve([F32], warm)
    toolchain.new_process()
    toolchain.hide_nvcc()
    cold = CompileCacheStore(str(tmp_path / "cold"))
    with pytest.raises(RuntimeError, match=r"nvcc not found.*compile cache at .*cold.*"
                                           r"flash_fwd_f32 \(miss\)"):
        _kernels.resolve([F32], cold)
    with pytest.raises(RuntimeError, match="nvcc not found.*no compile cache"):
        _kernels.resolve([F32], None)
    again = CompileCacheStore(warm.root)
    assert _kernels.resolve([F32], again) == {F32: "hit"}
    assert toolchain.compiled() == ["flash_fwd_f32.cu"]


def test_the_first_launch_inside_use_store_resolves_through_it(toolchain, tmp_path):
    store = CompileCacheStore(str(tmp_path / "store"))
    with _kernels.use_store(store):
        with _kernels.use_store(None):  # None changes nothing
            assert isinstance(_kernels._library(F32), StubLib)
    assert store.counters["miss"] == 1 and store.counters["write"] == 1
    assert _kernels._ACTIVE_STORE == []


def test_a_second_store_is_told_and_receives_a_copy_of_a_loaded_library(toolchain,
                                                                         tmp_path):
    first = CompileCacheStore(str(tmp_path / "first"))
    second = CompileCacheStore(str(tmp_path / "second"))
    assert _kernels.resolve([F32], first) == {F32: "miss"}
    assert _kernels.resolve([F32], second) == {F32: "loaded"}
    assert second.counters["write"] == 1
    with open(os.path.join(_entry(first, F32), cc_store.LIBRARY_FILE), "rb") as a, \
            open(os.path.join(_entry(second, F32), cc_store.LIBRARY_FILE), "rb") as b:
        assert a.read() == b.read()
    assert _kernels.fill_store([F32, BF16], second) == {F32: "present", BF16: "built"}


RACER = textwrap.dedent("""
    import json, sys
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.compile_cache import CompileCacheStore
    class Lib:
        def __init__(self, path):
            self.data = open(path, "rb").read()
    _kernels._load_library = lambda path, name: Lib(path)
    _kernels._probe_library = lambda name, lib: None
    store = CompileCacheStore(sys.argv[1])
    outcome = _kernels.resolve(["flash_fwd_f32"], store)
    print(json.dumps({"outcome": outcome, "counters": store.counters}))
""")


def test_two_processes_booting_over_one_empty_store_both_load_and_the_last_writer_wins(
        toolchain, tmp_path):
    root = str(tmp_path / "shared")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "STUB_NVCC_SLEEP": "1.0"}
    procs = [subprocess.Popen([sys.executable, "-c", RACER, root], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    results = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert [r["outcome"] for r in results] == [{F32: "miss"}] * 2
    assert toolchain.compiled() == ["flash_fwd_f32.cu"] * 2
    writes = sum(r["counters"]["write"] + r["counters"]["write_error"] for r in results)
    assert writes == 2 and sum(r["counters"]["write"] for r in results) >= 1
    store = CompileCacheStore(root)
    assert [r["verified"] for r in store.entries()] == [True]
    assert not [n for n in os.listdir(root) if not n.startswith("cc-")]
    third = subprocess.run([sys.executable, "-c", RACER, root], env=env, capture_output=True,
                           text=True, timeout=120)
    assert json.loads(third.stdout.strip().splitlines()[-1])["outcome"] == {F32: "hit"}


# -- the libraries a module launches --------------------------------------------

def _patchtst(lookback, compute_dtype="float32", attention_impl="flash"):
    from gordo_components_tpu_torch.models.factories.transformer import PatchTSTModule

    return PatchTSTModule(n_features=2, n_features_out=2, lookback_window=lookback,
                          patch_length=2, stride=1, d_model=8, n_heads=1, n_layers=1,
                          ff_dim=8, compute_dtype=compute_dtype, attention_impl=attention_impl)


@pytest.mark.parametrize("lookback,dtype,impl,forward,backward", [
    (130, "float32", "flash", [F32], [F32, "flash_bwd_f32"]),
    (130, "bfloat16", "flash", [BF16], ["flash_bwd_bf16", BF16]),
    (129, "float32", "flash", [], []),  # 128 patches: one tile, dense attention
    (130, "float32", "dense", [], []),
])
def test_libraries_for_follows_the_attention_rule(lookback, dtype, impl, forward, backward):
    module = _patchtst(lookback, dtype, impl)
    assert _kernels.libraries_for(module) == forward
    assert _kernels.libraries_for(module, backward=True) == sorted(backward)
    assert _kernels.libraries_for(torch.nn.Sequential(torch.nn.Linear(2, 2))) == []


def test_the_libraries_a_cpu_forward_calls_are_the_ones_resolved(monkeypatch):
    """The static rule agrees with what the forward does: on the CPU the
    operator's plain version runs, and each call is recorded by dtype."""
    from gordo_components_tpu_torch.ops import flash_attention

    for dtype, name in (("float32", F32), ("bfloat16", BF16)):
        calls = []
        real = flash_attention.flash_fwd
        monkeypatch.setattr(flash_attention, "flash_fwd",
                            lambda q, *a, real=real: calls.append(q.dtype) or real(q, *a))
        module = _patchtst(130, dtype)
        with torch.no_grad():
            module(torch.zeros(1, 130, 2))
        assert [_kernels._KERNEL_FOR_DTYPE[d] for d in set(calls)] == [name]
        assert _kernels.libraries_for(module) == [name]


# -- the engine, the export and the cache CLI -----------------------------------

def _detector(estimator, **kwargs):
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {estimator: {
            **kwargs, "epochs": 1, "batch_size": 16}}]}},
        "transformer": "MinMaxScaler"}}}}


SLICE = dict(lookback_window=130, patch_length=2, stride=1, d_model=8, n_heads=1, n_layers=1,
             ff_dim=8, attention_impl="flash")
TREE = {  # name -> (config, tags)
    "slice-f32": (_detector("PatchTSTAutoEncoder", **SLICE), 2),
    "slice-bf16": (_detector("PatchTSTAutoEncoder", **SLICE, compute_dtype="bfloat16"), 2),
    "dense": (_detector("DenseAutoEncoder", kind="feedforward_hourglass"), 4),
}


@pytest.fixture(scope="module")
def models_tree(tmp_path_factory):
    from gordo_components_tpu_torch.builder.build_model import _build_from_rows
    from gordo_components_tpu_torch.serializer import dump

    root = tmp_path_factory.mktemp("tree") / "models"
    for seed, (name, (config, tags)) in enumerate(TREE.items()):
        X = (np.random.default_rng(seed).normal(size=(160, tags)) * 2 + 4).astype(np.float32)
        model, _ = _build_from_rows(name, config, X, device="cpu",
                                    evaluation_config={"cv_mode": "build_only"})
        dump(model, str(root / name),
             metadata={"dataset": {"tag_list": [f"t{i}" for i in range(tags)]}})
    return root


def _engine(root, names, precisions=None, store=None):
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine

    return ServingEngine({n: load(str(root / n), device="cpu") for n in names},
                         precisions=precisions, device="cpu", compile_cache=store)


@pytest.mark.parametrize("names,precisions,expected", [
    (["slice-f32"], None, [F32]),
    (["slice-bf16"], None, [BF16]),
    (["slice-f32"], {"slice-f32": "int8"}, [F32]),  # int8 dequantizes to an fp32 forward
    (["slice-f32", "slice-bf16", "dense"], None, [BF16, F32]),
    (["dense"], None, []),
])
def test_the_engine_resolves_the_libraries_its_buckets_launch(models_tree, names, precisions,
                                                               expected):
    engine = _engine(models_tree, names, precisions)
    try:
        assert engine.required_libraries() == expected
        # on the CPU no kernel launches: the warm-up resolves nothing
        engine.warmup()
        assert engine.kernel_libraries == {}
        stats = engine.stats()
        assert stats["compile_cache"] is None and stats["kernel_libraries"] == {}
    finally:
        engine.close()


def test_engine_stats_carry_the_stores_counters(models_tree, tmp_path):
    store = CompileCacheStore(str(tmp_path / "store"))
    store.counters["hit"] = 2
    engine = _engine(models_tree, ["dense"], store=store)
    try:
        assert engine.stats()["compile_cache"] == {"hit": 2, "miss": 0, "stale": 0,
                                                   "invalid": 0, "write": 0, "write_error": 0}
    finally:
        engine.close()


def test_a_cpu_server_defaults_its_store_under_the_models_root_and_writes_nothing(
        models_tree, tmp_path, monkeypatch):
    from gordo_components_tpu_torch.observability import ledger
    from gordo_components_tpu_torch.server.server import ModelServer

    monkeypatch.setenv("GORDO_TELEMETRY", "0")
    monkeypatch.setenv("GORDO_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.delenv(cc_store.STORE_ENV, raising=False)
    monkeypatch.delenv("GORDO_LAZY_BOOT", raising=False)
    monkeypatch.setattr(ledger, "LEDGER", ledger.ControlLedger())
    server = ModelServer(str(models_tree), device="cpu")
    try:
        assert server.compile_cache.root == str(models_tree / ".compile-cache" / "torch-cuda")
        assert server.engine.compile_cache is server.compile_cache
        assert not (models_tree / ".compile-cache").exists()
    finally:
        server.close()
    off = ModelServer(str(models_tree), device="cpu", compile_cache_store="off")
    try:
        assert off.compile_cache is None and off.engine.stats()["compile_cache"] is None
    finally:
        off.close()


def test_the_export_fills_a_store_on_a_host_without_a_card(models_tree, toolchain, tmp_path):
    from gordo_components_tpu_torch.compile_cache import export_serving_cache

    dirs = {name: str(models_tree / name) for name in TREE}
    dirs["broken"] = str(tmp_path / "missing")
    root = str(tmp_path / "store")
    summary = export_serving_cache(dirs, root)
    assert summary["machines"] == 3 and summary["buckets"] == 3
    assert list(summary["skipped"]) == ["broken"]
    assert summary["cache"]["write"] == 2 and summary["cache_root"] == root
    assert sorted(toolchain.compiled()) == ["flash_fwd_bf16.cu", "flash_fwd_f32.cu"]
    again = export_serving_cache(dirs, root)
    assert again["cache"]["write"] == 0 and len(toolchain.compiled()) == 2
    # a boot over the filled store builds nothing
    toolchain.new_process()
    toolchain.hide_nvcc()
    assert _kernels.resolve([F32, BF16], CompileCacheStore(root)) == {F32: "hit", BF16: "hit"}
    assert export_serving_cache({"broken": dirs["broken"]}, root) == {
        "buckets": 0, "machines": 0, "skipped": {"broken": summary["skipped"]["broken"]}}


UNION = {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
    "regressor": {"Pipeline": {"steps": [
        {"FeatureUnion": {"transformer_list": ["MinMaxScaler", "StandardScaler"]}},
        {"PatchTSTAutoEncoder": {**SLICE, "epochs": 1, "batch_size": 16}}]}},
    "transformer": "MinMaxScaler"}}}}


@pytest.fixture(scope="module")
def union_tree(tmp_path_factory):
    """A PatchTST machine behind a ``FeatureUnion``, which the engine
    cannot lift: the server's host path scores it, its estimator on the
    engine's device, where its forward launches the fp32 library."""
    from gordo_components_tpu_torch.builder.build_model import _build_from_rows
    from gordo_components_tpu_torch.serializer import dump

    root = tmp_path_factory.mktemp("union") / "models"
    X = (np.random.default_rng(11).normal(size=(160, 2)) * 2 + 4).astype(np.float32)
    model, _ = _build_from_rows("union", UNION, X, device="cpu",
                                evaluation_config={"cv_mode": "build_only"})
    dump(model, str(root / "union"), metadata={"dataset": {"tag_list": ["t0", "t1"]}})
    return root


def test_a_host_path_machines_library_is_exported_and_resolved_with_no_nvcc(
        union_tree, toolchain, tmp_path, monkeypatch):
    """The export puts the host-path machine's library into the store, and
    a boot over that store with no nvcc resolves it there: eagerly at the
    warm-up, lazily at its first load. The engines are built on the CPU and
    then told they are on the card, which only their resolution reads (no
    bucket runs; the lazy machine's estimator is placed by a stand-in)."""
    from gordo_components_tpu_torch.compile_cache import export_serving_cache
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.serializer.persistence import estimators
    from gordo_components_tpu_torch.server.engine import ServingEngine

    root = str(tmp_path / "store")
    summary = export_serving_cache({"union": str(union_tree / "union")}, root)
    assert (summary["buckets"], summary["machines"], summary["skipped"]) == (0, 1, {})
    assert summary["cache"]["write"] == 1 and toolchain.compiled() == ["flash_fwd_f32.cu"]
    toolchain.hide_nvcc()

    toolchain.new_process()
    model = load(str(union_tree / "union"), device="cpu")
    engine = ServingEngine({"union": model}, device="cpu", compile_cache=CompileCacheStore(root))
    try:
        assert list(engine.skipped) == ["union"] and engine.required_libraries() == [F32]
        engine.device = torch.device("cuda")
        assert engine.warmup() == 0 and engine.kernel_libraries == {F32: "hit"}
    finally:
        engine.close()

    toolchain.new_process()
    lazy_model = load(str(union_tree / "union"), device="cpu")
    for est in estimators(lazy_model):
        monkeypatch.setattr(est, "to", lambda device: None)
    engine = ServingEngine({}, lazy={"union": lambda: {"model": lazy_model}}, device="cpu",
                           compile_cache=CompileCacheStore(root))
    try:
        engine.device = torch.device("cuda")
        assert engine.kernel_libraries == {}
        assert engine.spill_bundle("union")["skip"]
        assert engine.kernel_libraries == {F32: "hit"}
        assert engine.host_path_machines() == {"union": engine.spill_bundle("union")["skip"]}
    finally:
        engine.close()
    assert toolchain.compiled() == ["flash_fwd_f32.cu"]


def _port_cli(capsys, *argv):
    from gordo_components_tpu_torch.cli.cli import main

    capsys.readouterr()
    code = main(list(argv))
    return code, capsys.readouterr().out


def test_the_cache_clis_json_keys_are_the_references(models_tree, toolchain, tmp_path,
                                                     capsys, monkeypatch):
    from click.testing import CliRunner

    from gordo_components_tpu.cli.cli import gordo

    monkeypatch.setenv("GORDO_LEDGER_DIR", str(tmp_path / "ledger"))
    dense_tree = tmp_path / "dense-tree"
    dense_tree.mkdir()
    os.symlink(models_tree / "dense", dense_tree / "dense")
    ref_root, port_root = str(tmp_path / "ref-store"), str(tmp_path / "port-store")
    runner = CliRunner()

    def reference(*argv):
        result = runner.invoke(gordo, list(argv), catch_exceptions=False)
        assert result.exit_code == 0, result.output
        return json.loads(result.output[result.output.index("{"):])

    theirs_warm = reference("cache", "warm", "--models-dir", str(dense_tree), "--store",
                            ref_root)
    code, out = _port_cli(capsys, "cache", "warm", "--models-dir", str(models_tree),
                          "--store", port_root)
    ours_warm = json.loads(out)
    assert code == 0 and set(ours_warm) == set(theirs_warm)
    assert set(ours_warm["cache"]) == set(theirs_warm["cache"])
    theirs_list = reference("cache", "list", "--store", ref_root)
    code, out = _port_cli(capsys, "cache", "list", "--store", port_root)
    ours_list = json.loads(out)
    assert code == 0 and set(ours_list) == set(theirs_list) == {"root", "backend", "entries"}
    assert theirs_list["entries"] and len(ours_list["entries"]) == 2
    for ours, theirs in zip(ours_list["entries"], theirs_list["entries"] * 2):
        assert set(ours) == set(theirs)
        assert ours["current"] and ours["verified"]
    theirs_purge = reference("cache", "purge", "--store", ref_root, "--stale")
    code, out = _port_cli(capsys, "cache", "purge", "--store", port_root, "--stale")
    ours_purge = json.loads(out)
    assert code == 0 and set(ours_purge) == set(theirs_purge) == {"root", "removed"}
    assert ours_purge["removed"] == []
    code, out = _port_cli(capsys, "cache", "purge", "--store", port_root)
    assert sorted(json.loads(out)["removed"]) == sorted(r["name"] for r in ours_list["entries"])
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _port_cli(capsys, "cache", "warm", "--models-dir", str(empty))[0] == 2


def _fleet_config(tmp_path, names):
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps({"machines": [
        {"name": name, "model": TREE[name][0],
         "dataset": {"type": "RandomDataset", "train_start_date": "2023-01-01T00:00:00+00:00",
                     "train_end_date": "2023-01-02T00:00:00+00:00", "tag_list": ["t0", "t1"]}}
        for name in names]}))
    return str(path)


@pytest.mark.parametrize("flags,built_store,exported", [
    ([], "default", True),
    (["--no-serving-cache"], "default", False),
    (["--compile-cache-dir", "off"], None, True),
    (["--compile-cache-dir", "{tmp}/build-store"], "{tmp}/build-store", True),
])
def test_fleet_build_fits_through_its_store_and_exports_the_serving_libraries(
        models_tree, toolchain, tmp_path, capsys, monkeypatch, flags, built_store, exported):
    """The fit resolves its libraries through ``--compile-cache-dir`` (by
    default the store a server over the output defaults to) and, unless
    ``--no-serving-cache``, the export puts the serving libraries there
    after the commits (the training itself is stood in for here)."""
    import gordo_components_tpu_torch.parallel as parallel

    out = tmp_path / "out"
    seen = {}

    def fake_build_fleet(machines, output_dir, **kwargs):
        seen["store"] = kwargs["compile_cache_store"]
        return {m.name: str(models_tree / m.name) for m in machines}

    monkeypatch.delenv("GORDO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(parallel, "build_fleet", fake_build_fleet)
    flags = [flag.format(tmp=tmp_path) for flag in flags]
    code, printed = _port_cli(capsys, "fleet-build", "--machine-config",
                              _fleet_config(tmp_path, ["slice-f32", "dense"]), "--output-dir",
                              str(out), *flags, "--device", "cpu")
    assert code == 0 and set(json.loads(printed)) == {"slice-f32", "dense"}
    default = str(out / ".compile-cache" / "torch-cuda")
    expected = default if built_store == "default" else (
        built_store and built_store.format(tmp=tmp_path))
    assert (seen["store"].root if seen["store"] is not None else None) == expected
    served = CompileCacheStore(default).entries()
    assert [r["program"]["library"] for r in served] == ([F32] if exported else [])
    assert toolchain.compiled() == (["flash_fwd_f32.cu"] if exported else [])


def test_build_fits_through_its_store(toolchain, tmp_path, capsys, monkeypatch):
    import gordo_components_tpu_torch.builder as builder

    seen = []

    def fake_provide(name, model_config, data_config, output_dir, **kwargs):
        seen.append(kwargs["compile_cache_store"])
        return output_dir

    monkeypatch.setattr(builder, "provide_saved_model", fake_provide)
    monkeypatch.delenv("GORDO_COMPILE_CACHE", raising=False)
    base = ["build", "m", "--model-config", json.dumps(TREE["dense"][0]), "--data-config",
            "{}", "--output-dir", str(tmp_path / "m"), "--device", "cpu"]
    assert _port_cli(capsys, *base)[0] == 0
    assert _port_cli(capsys, *base, "--compile-cache-dir", "off")[0] == 0
    monkeypatch.setenv("GORDO_COMPILE_CACHE", str(tmp_path / "env-store"))
    assert _port_cli(capsys, *base)[0] == 0
    assert [s.root if s else None for s in seen] == [
        str(tmp_path / "m" / ".compile-cache" / "torch-cuda"), None, str(tmp_path / "env-store")]


def test_without_a_store_the_build_directory_serves_as_before(toolchain, tmp_path, monkeypatch):
    """No store: the library is built into the build directory (``built``)
    and a later process loads it from there (``cached``), no nvcc run."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "_build"))
    assert _kernels.resolve([F32], None) == {F32: "built"}
    assert os.path.exists(_kernels.library_path(F32))
    toolchain.new_process()
    assert _kernels.resolve([F32, F32], None) == {F32: "cached"}
    assert _kernels.resolve([F32], None) == {F32: "loaded"}
    assert toolchain.compiled() == ["flash_fwd_f32.cu"]
    assert _kernels._LIB_FILES[_kernels._identity(F32)][0] == _kernels.library_path(F32)
