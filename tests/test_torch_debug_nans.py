"""The port's numeric sanitizer against the reference's ``jax_debug_nans``.

``gordo --debug-nans`` turns on ``jax_debug_nans`` in the reference: a
NaN made by any operation raises ``FloatingPointError``. The port's
counterpart (``utils/backend.py``'s ``NanSanitizer`` under ``nan_guard``,
switched by ``set_debug_nans``, ``--debug-nans`` or ``GORDO_DEBUG_NANS``)
checks every operator's output. The reference runs as its own tests run
it: ``jax.config.update("jax_debug_nans", True)`` and back, the Pallas
kernel in interpret mode; the port runs its plain versions on the CPU.

- (a) clean machines (a PatchTST slice machine whose 129 patches take the
  flash operator, a dense and an LSTM zoo machine, each with a constant
  tag) score and fit 2 steps under the flag: the port's bytes equal its
  unflagged bytes exactly (tolerance 0) and neither package raises;
- (b) a NaN weight, a NaN input row and a NaN born only in a backward
  raise ``FloatingPointError`` from predict and fit in both packages; a
  server answers the NaN-weight machine 503 (quarantined) in both, on the
  engine and on the host path;
- (c) an ``inf`` in one q entry of a flash call makes a NaN (``inf - inf``
  in the softmax): the port raises at ``gordo::flash_fwd``, the reference
  fails inside ``pallas_call``.
"""

import json
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from werkzeug.test import Client  # noqa: E402

from gordo_components_tpu.models.train import make_fit_fn as ref_make_fit_fn  # noqa: E402
from gordo_components_tpu.ops import flash_attention as ref_flash  # noqa: E402
from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402
from gordo_components_tpu.serializer import pipeline_from_definition as ref_from_definition  # noqa: E402
from gordo_components_tpu.server import build_app  # noqa: E402

from gordo_components_tpu_torch.cli import cli  # noqa: E402
from gordo_components_tpu_torch.models.factories.spec import adam  # noqa: E402
from gordo_components_tpu_torch.models.train import make_fit_fn  # noqa: E402
from gordo_components_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_reference  # noqa: E402
from gordo_components_tpu_torch.serializer import load, pipeline_from_definition  # noqa: E402
from gordo_components_tpu_torch.serializer.persistence import estimators  # noqa: E402
from gordo_components_tpu_torch.server.engine import ServingEngine  # noqa: E402
from gordo_components_tpu_torch.utils import backend, debug_flags  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAGS = [f"tag-{i}" for i in range(3)]
CONSTANT = 1  # this tag holds one value: its scalers' ranges are 0
SLICE = dict(lookback_window=1040, patch_length=16, stride=8, d_model=4, n_heads=1, n_layers=1,
             ff_dim=8, attention_impl="flash")  # (1040 - 16) / 8 + 1 = 129 patches: flash
MACHINES = {  # name -> (estimator, kwargs, rows for 2 steps of batch 2 (slice) or 16)
    "slice": ("PatchTSTAutoEncoder", dict(SLICE, epochs=1, batch_size=2), 1040 + 3),
    "dense": ("DenseAutoEncoder", dict(kind="feedforward_hourglass", epochs=1, batch_size=16),
              32),
    "lstm": ("LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[6], lookback_window=8,
                                     epochs=1, batch_size=16), 8 + 31),
}
SCORE_ROWS = {"slice": 1040 + 1, "dense": 24, "lstm": 8 + 15}


def _detector(estimator, kwargs, scalers=("MinMaxScaler",)):
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": [*scalers, {estimator: kwargs}]}},
        "transformer": "MinMaxScaler",
    }}}}


def _rows(n, seed=0):
    X = (np.random.default_rng(seed).normal(size=(n, len(TAGS))) * 3 + 5).astype(np.float32)
    X[:, CONSTANT] = 1.5
    return X


@pytest.fixture
def ref_flag():
    """The reference's flag, set as its CLI sets it at a process's start,
    before any program is compiled: jax's caches are cleared first (a
    program compiled earlier in this process can skip the check)."""
    jax.clear_caches()
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.fixture
def port_flag():
    backend.set_debug_nans(True)
    try:
        yield
    finally:
        backend.set_debug_nans(False)


def _ref_fit(name, X, scalers=("MinMaxScaler",)):
    """The reference detector, fitted, with its error scaler and thresholds
    on the training residuals (as tests/test_torch_serving.py does)."""
    estimator, kwargs, _ = MACHINES[name]
    model = ref_from_definition(_detector(estimator, kwargs, scalers))
    model.fit(X, X)
    pred = model.predict(X)
    residual = np.abs(X[len(X) - len(pred):] - pred)
    model.scaler.fit(residual)
    scaled = model.scaler.transform(residual)
    model.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
    model.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    return model


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Each machine fitted (2 steps) and scored by the reference under its
    flag, which raises nothing for these clean machines, and dumped;
    ``nan-weight`` is the dense machine with one NaN in its first
    kernel."""
    root = tmp_path_factory.mktemp("debug-nans")
    jax.config.update("jax_debug_nans", True)
    try:
        models = {name: _ref_fit(name, _rows(rows)) for name, (_, _, rows) in MACHINES.items()}
    finally:
        jax.config.update("jax_debug_nans", False)
    for name, model in models.items():
        ref_dump(model, str(root / name), metadata={"dataset": {"tag_list": TAGS}})
    est = models["dense"].base_estimator.regressor.steps[-1][1]
    leaves, tree = jax.tree_util.tree_flatten(est.params_)
    leaves = [np.array(leaf) for leaf in leaves]
    leaves[0].flat[0] = np.nan
    est.params_ = jax.tree_util.tree_unflatten(tree, leaves)
    ref_dump(models["dense"], str(root / "nan-weight"), metadata={"dataset": {"tag_list": TAGS}})
    return root


# -- the switch ----------------------------------------------------------------


@pytest.mark.parametrize("argv, env, expected", [
    (["--debug-nans"], None, True),
    (["--no-debug-nans"], None, False),
    ([], "1", True),
    ([], "0", False),
    (["--no-debug-nans"], "1", False),
    ([], None, False),
])
def test_cli_sets_and_clears_the_flag(argv, env, expected, tmp_path, monkeypatch):
    """``--debug-nans/--no-debug-nans`` and ``GORDO_DEBUG_NANS`` set the
    process flag as the reference's root option does (tests/test_cli.py's
    ``test_debug_nans_flag``); the flag is reset after the test."""
    if env is None:
        monkeypatch.delenv("GORDO_DEBUG_NANS", raising=False)
    else:
        monkeypatch.setenv("GORDO_DEBUG_NANS", env)
    backend.set_debug_nans(not expected)
    try:
        cli.main([*argv, "rollback", "--list", str(tmp_path)])
        assert backend.debug_nans_enabled() is expected
    finally:
        backend.set_debug_nans(False)


def test_cli_refuses_a_bad_environment_value(monkeypatch, tmp_path):
    monkeypatch.setenv("GORDO_DEBUG_NANS", "maybe")
    with pytest.raises(SystemExit) as exc:
        cli.main(["rollback", "--list", str(tmp_path)])
    assert exc.value.code == 2
    assert not backend.debug_nans_enabled()


def test_a_process_starts_with_the_environment_and_imports_no_torch_for_it():
    """A child with ``GORDO_DEBUG_NANS=1`` (a router's worker, a rank) has
    the flag on from its start; the switch itself imports no torch (a
    router's process never does)."""
    code = ("import sys\n"
            "from gordo_components_tpu_torch.utils import debug_flags\n"
            "assert 'torch' not in sys.modules\n"
            "print(debug_flags.debug_nans_enabled())\n")
    env = {**os.environ, "GORDO_DEBUG_NANS": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "True"
    assert debug_flags.parse_flag("on") is True and debug_flags.parse_flag(" ") is None


def test_the_guard_is_off_without_the_flag_and_checks_every_op_with_it(port_flag):
    backend.set_debug_nans(False)
    with backend.nan_guard():
        assert torch.isnan(torch.zeros(2) / torch.zeros(2)).all()
    backend.set_debug_nans(True)
    with backend.nan_guard():
        assert torch.isinf(torch.ones(2) / torch.zeros(2)).all()  # NaN only, as jax_debug_nans
        with pytest.raises(FloatingPointError, match=r"invalid value \(nan\) encountered in "
                                                     r"aten::div\.Tensor"):
            torch.zeros(2) / torch.zeros(2)
    assert torch.isnan(torch.zeros(2) / torch.zeros(2)).all()  # outside the guard


# -- (a) clean machines ----------------------------------------------------------


def _port_estimator(model):
    (est,) = list(estimators(model))
    return est


def _port_scores(model, name, X):
    engine = ServingEngine({name: model}, device="cpu")
    try:
        result = engine.anomaly(name, X)
    finally:
        engine.close()
    frame = model.anomaly(X)  # the host path
    return [*result, frame.values]


def _port_fit(name, X):
    estimator, kwargs, _ = MACHINES[name]
    model = pipeline_from_definition(_detector(estimator, kwargs))
    est = _port_estimator(model).to("cpu")
    est.fit(X, X)
    flat = jax.tree_util.tree_leaves(est.params_)
    return [np.asarray(leaf) for leaf in flat] + [np.asarray(est.history_)]


@pytest.mark.parametrize("name", list(MACHINES))
def test_a_clean_machine_gives_the_unflagged_bytes(name, artifacts, ref_flag):
    """Scoring (the engine and the host path) and a 2-step fit under the
    flag give the port's unflagged bytes exactly (the reference's fit and
    scoring under its flag ran in ``artifacts``)."""
    X = _rows(SCORE_ROWS[name], seed=1)
    model = load(str(artifacts / name), device="cpu")
    fit_rows = _rows(MACHINES[name][2])
    plain = _port_scores(model, name, X), _port_fit(name, fit_rows)
    backend.set_debug_nans(True)
    try:
        flagged = _port_scores(model, name, X), _port_fit(name, fit_rows)
    finally:
        backend.set_debug_nans(False)
    for got, want in zip(flagged, plain):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    assert np.isfinite(flagged[0][3]).all()


def _ref_load(path):
    from gordo_components_tpu.serializer import load as ref_load

    return ref_load(str(path))


# -- (b) NaN weights, inputs, backwards ----------------------------------------------


def test_a_nan_weight_raises_from_predict_in_both(artifacts, ref_flag, port_flag):
    X = _rows(SCORE_ROWS["dense"], seed=1)
    with pytest.raises(FloatingPointError, match="invalid value"):
        _ref_load(artifacts / "nan-weight").predict(X)
    model = load(str(artifacts / "nan-weight"), device="cpu")
    with pytest.raises(FloatingPointError, match=r"invalid value \(nan\) encountered in aten::"):
        model.predict(X)
    engine = ServingEngine({"nan-weight": model}, device="cpu")
    try:
        with pytest.raises(FloatingPointError):
            engine.anomaly("nan-weight", X)
    finally:
        engine.close()
    backend.set_debug_nans(False)
    assert np.isnan(model.predict(X)).all()  # without the flag: NaN scores, no raise


@pytest.mark.parametrize("name", ["dense", "lstm"])
def test_a_nan_input_row_raises_from_predict_and_fit_in_both(name, artifacts, ref_flag,
                                                            port_flag):
    X = _rows(MACHINES[name][2], seed=1)
    X[5, 1] = np.nan
    estimator, kwargs, _ = MACHINES[name]
    with pytest.raises(FloatingPointError):
        _ref_load(artifacts / name).predict(X)
    with pytest.raises(FloatingPointError):
        ref_from_definition(_detector(estimator, kwargs)).fit(X, X)
    with pytest.raises(FloatingPointError):
        load(str(artifacts / name), device="cpu").predict(X)
    model = pipeline_from_definition(_detector(estimator, kwargs))
    _port_estimator(model).to("cpu")
    with pytest.raises(FloatingPointError):
        model.fit(X, X)


def test_a_nan_born_in_a_backward_raises_from_fit_in_both(ref_flag, port_flag):
    """``sqrt(square(x @ v))`` with ``v = 0`` is 0 forward; its backward is
    ``g / 0 = inf`` through the sqrt, then ``inf * 0`` through the square:
    a NaN no forward op makes. Both training loops raise."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(8, 3)).astype(np.float32)
    w0 = rng.normal(size=(3, 3)).astype(np.float32)
    v0 = np.zeros((3, 1), np.float32)
    ones = np.ones(8, np.float32)

    def ref_apply(variables, x, deterministic=True, rngs=None):
        p = variables["params"]
        return x @ p["w"] + jax.numpy.sqrt(jax.numpy.square(x @ p["v"]))

    import optax

    ref_fit = ref_make_fit_fn(ref_apply, optax.adam(1e-3), batch_size=4, epochs=1)
    with pytest.raises(FloatingPointError):
        ref_fit({"w": w0, "v": v0}, *(jax.numpy.asarray(a) for a in (X, X, ones)),
                jax.random.PRNGKey(0))

    def apply(p, x, generator):
        return x @ p["w"] + torch.sqrt(torch.square(x @ p["v"]))

    fit = make_fit_fn(apply, adam(1e-3), batch_size=4, epochs=1)
    params = {"w": torch.tensor(w0, requires_grad=True), "v": torch.tensor(v0, requires_grad=True)}
    with torch.no_grad():
        assert torch.isfinite(apply(params, torch.tensor(X), None)).all()
    with pytest.raises(FloatingPointError, match=r"encountered in aten::(mul|pow)"):
        fit(params, torch.tensor(X), torch.tensor(X), torch.tensor(ones),
            torch.Generator().manual_seed(0))


def _server_root(artifacts, tmp_path):
    """A models dir of a clean machine, the NaN-weight machine on the
    engine, and the same weights behind a 3-step pipeline the engine
    cannot lift (the host path, where the reference's flag reaches)."""
    root = tmp_path / "models"
    root.mkdir()
    for name in ("dense", "nan-weight"):
        os.symlink(artifacts / name, root / name)
    estimator, kwargs, rows = MACHINES["dense"]
    X = _rows(rows)
    model = _ref_fit("dense", X, scalers=("MinMaxScaler", "StandardScaler"))
    est = model.base_estimator.regressor.steps[-1][1]
    leaves, tree = jax.tree_util.tree_flatten(est.params_)
    leaves = [np.array(leaf) for leaf in leaves]
    leaves[0].flat[0] = np.nan
    est.params_ = jax.tree_util.tree_unflatten(tree, leaves)
    ref_dump(model, str(root / "nan-host"), metadata={"dataset": {"tag_list": TAGS}})
    return root


def _ask(base, name, X):
    body = json.dumps({"X": X.tolist()}).encode()
    req = urllib.request.Request(f"{base}/gordo/v0/project/{name}/anomaly/prediction",
                                 data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def test_a_server_answers_the_nan_machine_as_the_reference_does(artifacts, tmp_path,
                                                                monkeypatch):
    """Under the flag both servers quarantine a machine whose scoring
    raises (503), on the engine and on the host path, and answer a clean
    machine 200. The reference runs with its compile-cache store off and
    its flag set before any program compiles, as at a process's start (a
    program compiled earlier in the process can skip the check). The port
    runs as ``run-server`` with ``GORDO_DEBUG_NANS=1`` in its environment,
    as a fleet tier's worker would."""
    monkeypatch.setenv("GORDO_LEDGER_DIR", str(tmp_path / "ref-ledger"))
    monkeypatch.setenv("GORDO_TELEMETRY_DIR", str(tmp_path / "ref-telemetry"))
    root = _server_root(artifacts, tmp_path)
    X = _rows(SCORE_ROWS["dense"], seed=1)
    jax.clear_caches()  # the reference's flag is set at its process's start
    jax.config.update("jax_debug_nans", True)
    try:
        app = build_app({n: str(root / n) for n in sorted(os.listdir(root))},
                        project="project", models_root=str(root), compile_cache_store="off")
        theirs = {}
        for name in ("nan-host", "nan-weight", "dense"):
            resp = Client(app).post(f"/gordo/v0/project/{name}/anomaly/prediction",
                                    json={"X": X.tolist()})
            theirs[name] = (resp.status_code, resp.get_data())
        app.engine.close()
    finally:
        jax.config.update("jax_debug_nans", False)
    assert {name: status for name, (status, _) in theirs.items()} == {
        "dense": 200, "nan-weight": 503, "nan-host": 503}
    assert b"FloatingPointError" in theirs["nan-weight"][1]

    env = {**os.environ, "GORDO_DEBUG_NANS": "1", "GORDO_LEDGER_DIR": str(tmp_path / "ledger"),
           "GORDO_TELEMETRY_DIR": str(tmp_path / "telemetry"), "JAX_PLATFORMS": "cpu"}
    log = open(tmp_path / "server.log", "w+")
    proc = subprocess.Popen([sys.executable, "-m", "gordo_components_tpu_torch.cli", "run-server",
                             "--models-dir", str(root), "--host", "127.0.0.1", "--port", "0",
                             "--device", "cpu"], cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        base = None
        deadline = time.monotonic() + 180
        while base is None and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.2)
            log.seek(0)
            for line in log.read().splitlines():
                if " on http://" in line:
                    base = line.split(" on ", 1)[1].split()[0].rstrip(".")
        assert base, open(tmp_path / "server.log").read()[-3000:]
        ours = {name: _ask(base, name, X) for name in ("dense", "nan-weight", "nan-host")}
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        log.close()
    assert {name: status for name, (status, _) in ours.items()} == {
        name: status for name, (status, _) in theirs.items()}
    for name in ("nan-weight", "nan-host"):
        assert b"quarantined: FloatingPointError: invalid value (nan)" in ours[name][1]
    log_text = open(tmp_path / "server.log").read()
    assert "debug nans enabled" in log_text
    assert "invalid value (nan) encountered in" in log_text


def test_the_collector_thread_runs_under_the_flag(artifacts, port_flag, monkeypatch):
    """A dispatch fetched on the bucket's collector thread runs its fetch
    under the sanitizer: a NaN made there fails the request's waiter with
    ``FloatingPointError``."""
    model = load(str(artifacts / "dense"), device="cpu")
    engine = ServingEngine({"dense": model}, device="cpu")
    (bucket,) = engine._buckets
    seen = []
    real_host = bucket._host

    def host(outputs):
        stack = torch.utils._python_dispatch._get_current_dispatch_mode_stack()
        seen.append((threading.current_thread().name,
                     any(isinstance(mode, backend.NanSanitizer) for mode in stack)))
        torch.zeros(1) / torch.zeros(1)  # a NaN made in the fetch stage (and its retry)
        return real_host(outputs)

    monkeypatch.setattr(bucket, "_host", host)
    monkeypatch.setattr(bucket, "_should_pipeline", lambda: True)
    try:
        with pytest.raises(FloatingPointError, match="aten::div"):
            engine.anomaly("dense", _rows(SCORE_ROWS["dense"], seed=1))
    finally:
        engine.close()
    assert seen and set(seen) == {("gordo-bucket-collector", True)}


# -- (c) an inf in q ---------------------------------------------------------------


def test_an_inf_in_q_raises_at_the_attention_op_in_both(ref_flag, port_flag):
    """One ``inf`` in q and no NaN in the inputs: the online softmax's
    ``inf - inf`` makes the NaN. The port raises naming ``gordo::flash_fwd``
    (its CPU implementation is the plain version, which marks the same rows
    NaN without the flag). The reference's de-optimized re-run of
    ``pallas_call`` (interpret mode) re-enters its own jit without end in
    jax 0.9.0, so it fails inside ``pallas_call`` with ``RecursionError``
    before its ``FloatingPointError`` (the recursion limit is lowered to
    reach that end quickly)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 7, 8)).astype(np.float32) for _ in range(3))
    q[0, 1, 2] = np.inf
    with pytest.raises(FloatingPointError, match=r"encountered in gordo::flash_fwd"), \
            backend.nan_guard():
        flash_fwd(*(torch.tensor(a) for a in (q, k, v)), 0.35)
    backend.set_debug_nans(False)
    out, _ = flash_fwd(*(torch.tensor(a) for a in (q, k, v)), 0.35)
    plain, _ = flash_fwd_reference(*(torch.tensor(a) for a in (q, k, v)), 0.35)
    assert torch.equal(torch.isnan(out).any(-1), torch.isnan(plain).any(-1))
    assert torch.isnan(out).any(-1).tolist() == [[False, True] + [False] * 5, [False] * 7]
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(400)
    try:
        ref_flash._flash_fwd_3d(q, k, v, 0.35, 128, 128)
    except RecursionError as exc:
        frames = [frame.name for frame in traceback.extract_tb(exc.__traceback__)]
    else:
        frames = []
    finally:
        sys.setrecursionlimit(limit)
    assert "_pallas_call_impl" in frames
