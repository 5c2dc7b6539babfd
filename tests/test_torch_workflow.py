"""The port's workflow generator and ``cli workflow generate`` against the
JAX package's, on the configs of ``tests/test_workflow.py``.

Every manifest, parsed with ``yaml.safe_load_all``, equals the
reference's after the two stated substitutions: a container runs
``python -m gordo_components_tpu_torch.cli`` where the reference's runs
``gordo_components_tpu.cli``, and a limit requests ``nvidia.com/gpu``
where the reference's requests ``google.com/tpu``, with the same count.
The Argo workflow (default and a parallelism of 7) and the fleet Job (one
host, three hosts, a custom slice timeout and deadline) are held for
each config; ``validate_generated`` and the generator's two
``ValueError``s as the reference's; the CLI with every option, with
``--output-file``, with values its ranges refuse and with a config the
generator rejects: exit code, stdout and the written file as the
reference's click command gives them.
"""

import copy

import pytest
import yaml
from click.testing import CliRunner

from gordo_components_tpu.cli.cli import gordo as ref_cli
from gordo_components_tpu.workflow import generate_argo_workflow as ref_argo
from gordo_components_tpu.workflow import generate_tpu_job as ref_job
from gordo_components_tpu.workflow.workflow_generator import (
    validate_generated as ref_validate,
)
from test_workflow import FLEET_YAML

from gordo_components_tpu_torch.cli.cli import main as port_main
from gordo_components_tpu_torch.workflow import generate_argo_workflow, generate_tpu_job
from gordo_components_tpu_torch.workflow.workflow_generator import validate_generated

REF_COMMAND = "gordo_components_tpu.cli"
PORT_COMMAND = "gordo_components_tpu_torch.cli"

CRD = {
    "apiVersion": "equinor.com/v1",
    "kind": "Gordo",
    "metadata": {"name": "crd-project"},
    "spec": {"config": yaml.safe_load(FLEET_YAML)},
}
DEEP_MERGE = {
    "machines": [
        {
            "name": "m1",
            "model": {"Pipeline": {"steps": ["MinMaxScaler"]}},
            "dataset": {"tag_list": ["a"], "data_provider": {"base_dir": "/other/lake"}},
        }
    ],
    "globals": {
        "dataset": {
            "resolution": "10min",
            "data_provider": {"type": "NcsReader", "base_dir": "/lake"},
        }
    },
}
CONFIGS = {"fleet-yaml": FLEET_YAML, "crd": CRD, "deep-merge": DEEP_MERGE}
BAD_CONFIGS = [{"project-name": "x"}, {"machines": [{"name": "a", "dataset": {"x": 1}}]}]


def _substituted(node):
    """The reference's parsed manifest with the port's two differences."""
    if isinstance(node, dict):
        return {("nvidia.com/gpu" if key == "google.com/tpu" else key): _substituted(value)
                for key, value in node.items()}
    if isinstance(node, list):
        return [_substituted(item) for item in node]
    return PORT_COMMAND if node == REF_COMMAND else node


def _parsed(manifest):
    return [document for document in yaml.safe_load_all(manifest) if document is not None]


def _assert_same(ours, ref):
    theirs = _parsed(ref)
    assert _parsed(ours) == [_substituted(document) for document in theirs]
    # the substitutions are the only differences, and each applies
    flat = yaml.safe_dump_all(theirs)
    assert REF_COMMAND in flat and PORT_COMMAND not in flat


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("kwargs", [{}, {"parallelism": 7, "image": "img:1",
                                         "output_dir": "/o", "register_dir": "/r"}],
                         ids=["defaults", "options"])
def test_argo_workflow_matches_reference(name, kwargs):
    config = CONFIGS[name]
    ours = generate_argo_workflow(copy.deepcopy(config), **kwargs)
    ref = ref_argo(copy.deepcopy(config), **kwargs)
    validate_generated(ours)
    _assert_same(ours, ref)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("kwargs", [{}, {"hosts": 3}, {"hosts": 3, "tpu_chips": 8,
                                                       "slice_timeout_s": 300,
                                                       "active_deadline_s": 7200,
                                                       "image": "img:2"}],
                         ids=["one-host", "three-hosts", "three-hosts-options"])
def test_fleet_job_matches_reference(name, kwargs):
    config = CONFIGS[name]
    ours = generate_tpu_job(copy.deepcopy(config), **kwargs)
    ref = ref_job(copy.deepcopy(config), **kwargs)
    validate_generated(ours)
    _assert_same(ours, ref)
    limits = [container["resources"]["limits"] for document in _parsed(ours)
              if document["kind"] in ("Job", "Deployment")
              for container in document["spec"]["template"]["spec"]["containers"]]
    assert limits == [{"nvidia.com/gpu": kwargs.get("tpu_chips", 16)}, {"nvidia.com/gpu": 1}]


def test_errors_match_reference():
    for generate in (generate_tpu_job, ref_job):
        with pytest.raises(ValueError, match="hosts"):
            generate(FLEET_YAML, hosts=0)
        with pytest.raises(ValueError, match="active_deadline_s"):
            generate(FLEET_YAML, active_deadline_s=0)
    for validate in (validate_generated, ref_validate):
        validate("---\nkind: Job\n---\n")
        with pytest.raises(ValueError, match="kind"):
            validate("apiVersion: v1\nmetadata: {}\n")
    for bad in BAD_CONFIGS:
        for generate in (generate_argo_workflow, ref_argo, generate_tpu_job, ref_job):
            with pytest.raises(ValueError):
                generate(copy.deepcopy(bad))


def _run_both(args, tmp_path, capsys):
    """(exit code, stdout) of the port's command and of the reference's
    click command, each with its own ``--output-file`` target."""
    def with_out(tag):
        return [str(tmp_path / f"{tag}.yaml") if arg == "OUT" else arg for arg in args]

    try:
        port_rc = port_main(["workflow", "generate", *with_out("port")])
    except SystemExit as exc:
        port_rc = exc.code
    port_out = capsys.readouterr().out
    result = CliRunner().invoke(ref_cli, ["workflow", "generate", *with_out("ref")])
    return (port_rc, port_out), (result.exit_code, result.stdout)


@pytest.mark.parametrize("options", [
    [],
    ["--image", "img:3", "--parallelism", "4"],
    ["--output-file", "OUT", "--image", "img:3", "--parallelism", "4"],
    ["--tpu"],
    ["--tpu", "--tpu-chips", "8", "--tpu-hosts", "3", "--slice-timeout-s", "0",
     "--active-deadline-s", "7200", "--image", "img:4"],
    ["--tpu", "--tpu-hosts", "2", "--output-file", "OUT"],
], ids=["argo", "argo-options", "argo-file", "job", "job-every-option", "job-file"])
def test_cli_matches_reference(options, tmp_path, capsys):
    config = tmp_path / "fleet.yaml"
    config.write_text(FLEET_YAML)
    (port_rc, port_out), (ref_rc, ref_out) = _run_both(
        ["--machine-config", str(config), *options], tmp_path, capsys)
    assert port_rc == ref_rc == 0, ref_out
    if "OUT" in options:
        assert port_out == f"{tmp_path / 'port.yaml'}\n"
        assert ref_out == f"{tmp_path / 'ref.yaml'}\n"
        _assert_same((tmp_path / "port.yaml").read_text(), (tmp_path / "ref.yaml").read_text())
    else:
        _assert_same(port_out, ref_out)


@pytest.mark.parametrize("options,code", [
    (["--tpu", "--tpu-hosts", "0"], 64),
    (["--tpu", "--active-deadline-s", "0"], 2),
    (["--tpu", "--slice-timeout-s", "-1"], 2),
    (["--parallelism", "many"], 2),
], ids=["hosts-0", "deadline-0", "timeout-negative", "parallelism-not-int"])
def test_cli_refusals_match_reference(options, code, tmp_path, capsys):
    config = tmp_path / "fleet.yaml"
    config.write_text(FLEET_YAML)
    (port_rc, port_out), (ref_rc, _) = _run_both(
        ["--machine-config", str(config), *options], tmp_path, capsys)
    assert port_rc == ref_rc == code
    assert port_out == ""


@pytest.mark.parametrize("bad", BAD_CONFIGS, ids=["no-machines", "no-model"])
def test_cli_bad_config_exits_config(bad, tmp_path, capsys):
    config = tmp_path / "bad.yaml"
    config.write_text(yaml.safe_dump(bad))
    (port_rc, port_out), (ref_rc, _) = _run_both(
        ["--machine-config", str(config), "--output-file", "OUT"], tmp_path, capsys)
    assert port_rc == ref_rc == 64
    assert port_out == ""
    assert not (tmp_path / "port.yaml").exists() and not (tmp_path / "ref.yaml").exists()
