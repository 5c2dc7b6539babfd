"""Phase 17's pure helpers in ``chip_smoke.py`` (warm boot), on the CPU.

The phase counts ``nvcc`` invocations through a wrapper first on ``PATH``
that logs its arguments and runs the real compiler; here the wrapper runs
a stub compiler and the log is read back as the phase reads it. The
forward libraries a warm-up resolves per set of compute dtypes agree with
what the engine's rule (``_kernels.libraries_for``) gives a module of
that dtype. The environment without ``nvcc`` finds none, through the
port's own lookup. A store entry is found by its key, and a flipped bit
fails the manifest's check. The fleet config's machines take the flash
kernel (more than 128 patches), and the phase runs with the store off for
the phases before it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

from gordo_components_tpu_torch.compile_cache import CompileCacheStore  # noqa: E402
from gordo_components_tpu_torch.compile_cache import store as cc_store  # noqa: E402
from gordo_components_tpu_torch.models.factories.transformer import PatchTSTModule  # noqa: E402
from gordo_components_tpu_torch.ops import _kernels  # noqa: E402
from gordo_components_tpu_torch.store.errors import StoreError  # noqa: E402
from gordo_components_tpu_torch.store.manifest import verify_artifact  # noqa: E402

STUB = """#!{python}
import sys
if "--version" in sys.argv:
    print("stub release 0.0")
    sys.exit(0)
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "wb").write(b"stub:" + " ".join(sys.argv[1:-3]).encode())
"""


@pytest.mark.parametrize("dtypes,expected", [
    (["float32"], ["flash_fwd_f32"]),
    (["bfloat16"], ["flash_fwd_bf16"]),
    (["float32", "bfloat16"], ["flash_fwd_bf16", "flash_fwd_f32"]),
    (["int8", "float32"], ["flash_fwd_f32"]),
    ([], []),
])
def test_expected_forward_libraries(dtypes, expected):
    assert chip_smoke.expected_forward_libraries(dtypes) == expected


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_phases_machines_resolve_what_the_engines_rule_gives(dtype):
    module = PatchTSTModule(n_features=2, n_features_out=2,
                            lookback_window=chip_smoke.LOOKBACK, compute_dtype=dtype,
                            attention_impl="flash", **{**chip_smoke.SLICE, "d_model": 16,
                                                       "n_heads": 2, "ff_dim": 16})
    assert _kernels.libraries_for(module) == chip_smoke.expected_forward_libraries([dtype])
    assert [d for d, _ in chip_smoke.WB_MACHINES.values()] == ["float32", "bfloat16"]


def test_the_fleet_machines_take_the_flash_kernel():
    kwargs = {k: v for k, v in chip_smoke.WB_FLEET_SLICE.items()
              if k not in ("kind", "batch_size", "epochs")}
    module = PatchTSTModule(n_features=chip_smoke.WB_FLEET_TAGS,
                            n_features_out=chip_smoke.WB_FLEET_TAGS, **kwargs)
    assert module.n_patches == 129
    assert _kernels.libraries_for(module, backward=True) == ["flash_bwd_f32", "flash_fwd_f32"]
    assert chip_smoke.WB_FLEET_ROWS - chip_smoke.WB_FLEET_SLICE["lookback_window"] + 1 == 64
    config = chip_smoke.wb_fleet_config()
    assert [m["name"] for m in config["machines"]] == list(chip_smoke.WB_FLEET)
    assert len({json.dumps(m["dataset"]) for m in config["machines"]}) == 2


def test_the_wrapper_logs_each_compile_and_runs_the_real_compiler(tmp_path):
    real = tmp_path / "real-nvcc"
    real.write_text(STUB.format(python=sys.executable))
    real.chmod(0o755)
    log = tmp_path / "nvcc.log"
    wrapper = chip_smoke.write_nvcc_wrapper(str(tmp_path / "bin"), str(real), str(log))
    assert os.path.basename(wrapper) == "nvcc" and os.access(wrapper, os.X_OK)
    for source in ("flash_fwd_f32.cu", "flash_fwd_bf16.cu"):
        out = tmp_path / f"{source}.so"
        subprocess.run([wrapper, "-O3", "-shared", "-o", str(out), f"/src/{source}"], check=True)
        assert out.read_bytes() == b"stub:-O3 -shared"
    subprocess.run([wrapper, "--version"], check=True, capture_output=True)
    assert chip_smoke.nvcc_compiled(str(log)) == ["flash_fwd_f32.cu", "flash_fwd_bf16.cu"]
    assert len(log.read_text().splitlines()) == 3  # the version query is logged, not counted
    assert chip_smoke.nvcc_compiled(str(tmp_path / "absent.log")) == []


def test_env_without_nvcc_hides_every_compiler(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    chip_smoke.write_nvcc_wrapper(str(bin_dir), "/bin/false", str(tmp_path / "log"))
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    (cuda / "nvcc").write_text("")
    env = {"PATH": os.pathsep.join([str(bin_dir), str(cuda), "/usr/bin"]),
           "CUDA_HOME": str(tmp_path / "cuda"), "OTHER": "kept"}
    bare = chip_smoke.env_without_nvcc(env, str(tmp_path / "empty"))
    assert bare["PATH"].split(os.pathsep) == [p for p in ["/usr/bin"]
                                               if not os.path.exists(os.path.join(p, "nvcc"))]
    assert bare["OTHER"] == "kept" and os.path.isdir(bare["CUDA_HOME"])
    monkeypatch.setenv("PATH", env["PATH"])
    monkeypatch.setenv("CUDA_HOME", env["CUDA_HOME"])
    assert _kernels._nvcc() == str(bin_dir / "nvcc")
    monkeypatch.setenv("PATH", bare["PATH"])
    monkeypatch.setenv("CUDA_HOME", bare["CUDA_HOME"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels._nvcc()


def test_store_entry_finds_an_entry_by_its_key_and_a_flipped_bit_fails_it(tmp_path,
                                                                          monkeypatch):
    monkeypatch.delenv("CUDA_KERNEL_DEBUG", raising=False)
    store = CompileCacheStore(str(tmp_path / "store"))
    library = tmp_path / "lib.so"
    library.write_bytes(bytes(range(256)) * 8)
    for name in ("flash_fwd_f32", "flash_fwd_bf16"):
        assert store.put(_kernels.library_key(name), str(library))
    monkeypatch.setenv("CUDA_KERNEL_DEBUG", "1")
    assert store.put(_kernels.library_key("flash_fwd_f32"), str(library))
    monkeypatch.delenv("CUDA_KERNEL_DEBUG")
    f32 = chip_smoke.store_entry(store.root, "flash_fwd_f32")
    debug = chip_smoke.store_entry(store.root, "flash_fwd_f32", debug=True)
    assert f32 == store.path_of(_kernels.library_key("flash_fwd_f32")) and debug != f32
    verify_artifact(f32, deep=True)
    chip_smoke.flip_a_bit(os.path.join(f32, cc_store.LIBRARY_FILE))
    assert os.path.getsize(os.path.join(f32, cc_store.LIBRARY_FILE)) == 2048
    with pytest.raises(StoreError, match="SHA-256"):
        verify_artifact(f32, deep=True)
    with pytest.raises(SystemExit):
        chip_smoke.store_entry(store.root, "flash_bwd_f32")


def test_the_earlier_phases_run_with_the_store_off():
    from gordo_components_tpu_torch.compile_cache import resolve_store

    assert chip_smoke.WB_OFF == {"GORDO_COMPILE_CACHE_STORE": "off",
                                 "GORDO_COMPILE_CACHE": "off"}
    saved = {key: os.environ.get(key) for key in chip_smoke.WB_OFF}
    os.environ.update(chip_smoke.WB_OFF)
    try:
        assert resolve_store(None, "/models") is None
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
