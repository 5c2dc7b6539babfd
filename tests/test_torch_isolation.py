"""The PyTorch port stands alone: no module of ``gordo_components_tpu_torch``,
and not ``chip_smoke.py`` or the Influx double it loads
(``tests/influx_double.py``), imports jax, flax, optax, orbax, sklearn,
pandas, click, requests, werkzeug, aiohttp, influxdb or the JAX package (the
card's machine has none of them); ``yaml``, ``pyarrow`` and ``azure`` are
imported only inside the function that needs them, which names the package
when it is missing; and
every entry point runs on CUDA unless ``device="cpu"`` is passed — without
a card it raises instead of quietly running on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "gordo_components_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gordo_components_tpu", "sklearn",
             "pandas", "click", "requests", "werkzeug", "aiohttp", "influxdb")
# packages the card's machine may lack: imported lazily, where they are needed
LAZY_ONLY = ("yaml", "pyarrow", "azure", "jinja2")


def _sources():
    tools = [ROOT / "tools" / name for name in ("torch_slice_profile.py", "flash_kernel_sweep.py")]
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_phases.py",
                                          ROOT / "tests" / "influx_double.py", *tools]


def test_the_walk_covers_the_lint_and_the_model_contract():
    walked = {p.relative_to(PORT).as_posix() for p in _sources() if PORT in p.parents}
    assert {"analysis/runner.py", "analysis/lockcheck.py", "analysis/locks.py",
            "models/base.py", "models/anomaly/base.py", "parallel/distributed.py",
            "parallel/shard_plan.py"} <= walked


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def _module_level_imports(tree):
    """Import statements that run when the module is imported: everything
    but the bodies of functions."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_yaml_and_pyarrow_are_imported_only_lazily(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in _module_level_imports(tree):
        names = ([alias.name for alias in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if node.level == 0 else [])
        for name in names:
            assert name.split(".")[0] not in LAZY_ONLY, f"{path}:{node.lineno} imports {name}"


def _import_everything(blocked, extra=""):
    """Import every module of the port in a fresh interpreter in which
    importing any of ``blocked`` fails, then run ``extra``."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
        if p.name != "__main__.py"
    )
    script = (
        "import sys\n"
        f"for name in {tuple(blocked)!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for module in {modules!r}:\n"
        "    importlib.import_module(module)\n"
        + extra +
        "print('ok')\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip().splitlines()[-1] == "ok"


def test_package_imports_with_jax_blocked():
    _import_everything(FORBIDDEN)


def test_package_imports_with_pandas_pyarrow_yaml_and_click_blocked(tmp_path):
    """What the card's machine lacks: every module imports without it, a
    JSON config still loads, and the places that need yaml, pyarrow, jinja2
    or the Azure SDK raise naming the package (a parquet request body is a
    415)."""
    (tmp_path / "map.yaml").write_text("m: int8\n")
    (tmp_path / "T.parquet").write_bytes(b"")
    extra = f"""
import pytest
from gordo_components_tpu_torch.cli import cli
from gordo_components_tpu_torch import precision
from gordo_components_tpu_torch.dataset.data_provider.providers import _read_parquet
assert cli._load_config('{{"a": 1}}', "X") == {{"a": 1}}
assert precision.parse_precision_map("m=int8") == {{"m": "int8"}}
with pytest.raises(ValueError, match="'yaml'"):
    cli._load_config("a: 1", "X")
with pytest.raises(ImportError, match="'yaml'"):
    precision.parse_precision_map({str(tmp_path / "map.yaml")!r})
with pytest.raises(ImportError, match="'pyarrow'"):
    _read_parquet({str(tmp_path / "T.parquet")!r}, False)
import numpy as np
from gordo_components_tpu_torch.client import Client
from gordo_components_tpu_torch.dataset.data_provider import DataLakeProvider
from gordo_components_tpu_torch.dataset.sensor_tag import SensorTag
from gordo_components_tpu_torch.models.transformers import MinMaxScaler
from gordo_components_tpu_torch.serializer import into_definition_yaml
from gordo_components_tpu_torch.server.server import HTTPError, _parse_parquet
with pytest.raises(ImportError, match="'yaml'"):
    into_definition_yaml(MinMaxScaler())
with pytest.raises(HTTPError, match="'pyarrow'") as refused:
    _parse_parquet(b"PAR1", ["a"])
assert refused.value.status == 415
with pytest.raises(ImportError, match="'pyarrow'"):
    Client("http://127.0.0.1:1").predict_frame("m", np.zeros((1, 1)), columns=["a"])
with pytest.raises(RuntimeError, match="azure-datalake-store"):
    DataLakeProvider(storename="s", interactive=True).can_handle_tag(SensorTag("t", "a"))
from gordo_components_tpu_torch.workflow import generate_argo_workflow
from gordo_components_tpu_torch.workflow.workflow_generator import validate_generated
with pytest.raises(ImportError, match="'jinja2'"):
    generate_argo_workflow({{"machines": [{{"name": "m", "dataset": {{"x": 1}},
                                           "model": {{"m": {{}}}}}}]}})
with pytest.raises(ImportError, match="'yaml'"):
    validate_generated("kind: Job")
"""
    _import_everything(FORBIDDEN + ("pyarrow", "yaml", "azure", "jinja2"), extra)


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import ModelServer
    from gordo_components_tpu_torch.utils.backend import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    from gordo_components_tpu_torch.cli import cli
    from gordo_components_tpu_torch.server.server import make_server

    from gordo_components_tpu_torch.parallel import global_fleet_devices

    for entry in (lambda: load(str(tmp_path)), lambda: ServingEngine({}),
                  lambda: ModelServer(str(tmp_path)), lambda: make_server(str(tmp_path), port=0),
                  lambda: cli.main(["run-server", "--models-dir", str(tmp_path), "--port", "0"]),
                  global_fleet_devices):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    # an estimator given weights without a device: set_state, then predict
    from gordo_components_tpu_torch.models import DenseAutoEncoder
    from gordo_components_tpu_torch.models.register import get_factory

    module = get_factory("feedforward_symmetric")(n_features=3, dims=(2,)).module
    params = {f"Dense_{i}": {"kernel": layer.weight.detach().numpy().T,
                             "bias": layer.bias.detach().numpy()}
              for i, layer in enumerate(module.layers)}
    state = {"params": params, "n_features": 3, "n_features_out": 3}
    est = DenseAutoEncoder(kind="feedforward_symmetric", dims=[2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.set_state(state)
    est.to("cpu").set_state(state)
    est.device = None  # weights loaded, no device asked for
    with pytest.raises(RuntimeError, match="device='cpu'"):
        est.predict(np.zeros((2, 3), np.float32))


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card here: chip_smoke.py exits non-zero and prints no result line."""
    result = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout


def test_fleet_yaml_is_read_lazily_and_names_yaml_when_missing():
    """Without yaml a fleet config given as a mapping or JSON still
    normalizes; one given as YAML text raises naming the package."""
    extra = """
import pytest
from gordo_components_tpu_torch.workflow import NormalizedConfig
config = {"machines": [{"name": "m", "model": {"X": {}}, "dataset": {"tag_list": ["t"]}}]}
assert NormalizedConfig(config).machines[0].name == "m"
with pytest.raises(ValueError, match="'yaml'"):
    NormalizedConfig("machines: []")
"""
    _import_everything(FORBIDDEN + ("pyarrow", "yaml"), extra)


def test_fleet_entry_points_need_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    from gordo_components_tpu_torch.parallel import (
        FleetMachineConfig,
        MachineBatch,
        build_fleet,
        fleet_devices,
        train_fleet_arrays,
    )
    from gordo_components_tpu_torch.cli import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet_devices()
    assert fleet_devices("cpu") == [torch.device("cpu")]
    machine = FleetMachineConfig(name="m", model_config={}, data_config={})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_fleet([machine], str(tmp_path))
    batch = MachineBatch(np.zeros((1, 4, 2)), np.zeros((1, 4, 2)), np.ones((1, 4)), [0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_fleet_arrays(None, batch)
    fleet_file = tmp_path / "fleet.json"
    fleet_file.write_text('{"machines": [{"name": "m", "model": {"DenseAutoEncoder": {}}, '
                          '"dataset": {"tag_list": ["t"]}}]}')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["fleet-build", "--machine-config", str(fleet_file), "--output-dir",
                  str(tmp_path / "out")])


def test_the_walk_covers_the_compile_cache_and_chip_smoke():
    """The compile cache's modules and ``chip_smoke.py`` are among the
    sources the checks above walk (``chip_smoke.py`` among them for jax,
    pandas, requests and werkzeug)."""
    walked = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert {f"gordo_components_tpu_torch/compile_cache/{name}.py"
            for name in ("__init__", "fingerprint", "store", "export")} <= walked
    assert "chip_smoke.py" in walked
    assert {"jax", "pandas", "requests", "werkzeug"} <= set(FORBIDDEN)
