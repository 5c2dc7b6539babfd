"""The PyTorch port stands alone: no module of ``gordo_components_tpu_torch``,
and not ``chip_smoke.py``, imports jax, flax, optax, sklearn, pandas or the
JAX package; and every entry point runs on CUDA unless ``device="cpu"`` is
passed — without a card it raises instead of quietly running on the CPU."""

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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gordo_components_tpu", "sklearn", "pandas")


def _sources():
    tools = [ROOT / "tools" / name for name in ("torch_slice_profile.py", "flash_kernel_sweep.py")]
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", *tools]


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


def test_package_imports_with_jax_blocked():
    """Import every module of the port in a fresh interpreter in which
    importing any forbidden name fails."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
        if p.name != "__main__.py"
    )
    script = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for module in {modules!r}:\n"
        "    importlib.import_module(module)\n"
        "print('ok')\n"
    )
    result = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"


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
    for entry in (lambda: load(str(tmp_path)), lambda: ServingEngine({}),
                  lambda: ModelServer(str(tmp_path))):
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
