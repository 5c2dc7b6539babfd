"""Nothing the benchmark runs imports JAX or the JAX package, compared by
each module's whole top-level name (the port's own name begins with the
JAX package's); the reference imports nothing of the port; the load
generator runs on the standard library alone."""

import ast
import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT
from harness.bench import FOREIGN, foreign_modules

PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def top_modules(body, *flags):
    code = PROBE.format(bench=BENCH, root=ROOT, body=body)
    out = subprocess.run([sys.executable, *flags, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, env={**os.environ, "USE_FLAX": "0"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_name_comparison():
    assert foreign_modules(["gordo_components_tpu_torch.server", "jaxtyping", "flaxen",
                            "numpy"]) == []
    assert foreign_modules(["jax.numpy", "gordo_components_tpu.ops", "flax"]) == [
        "flax", "gordo_components_tpu", "jax"]


def test_harness_and_program_load_no_jax():
    loaded = top_modules("import harness.bench, harness.control, harness.trace\n"
                         "import gordo_components_tpu_torch.server.server\n"
                         "import gordo_components_tpu_torch.serializer")
    assert not loaded & set(FOREIGN), loaded & set(FOREIGN)
    assert "gordo_components_tpu_torch" in loaded


def test_reference_imports_nothing_of_the_program():
    loaded = top_modules("import reference.patchtst")
    assert not loaded & {*FOREIGN, "gordo_components_tpu_torch"}


def test_load_generator_is_standard_library_alone():
    loaded = top_modules("import runpy\nrunpy.run_path({!r}, run_name='probe')".format(
        os.path.join(BENCH, "harness", "loadgen.py")), "-I", "-S")
    assert not loaded & {"numpy", "torch", *FOREIGN, "gordo_components_tpu_torch"}


def test_no_source_names_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(BENCH):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for module in names:
                    assert module.split(".")[0] not in FOREIGN, (name, module)
