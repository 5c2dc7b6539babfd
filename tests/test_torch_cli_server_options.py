"""Two serving options of the reference's CLI in the port:
``run-fleet-server --megabatch/--no-megabatch`` and ``run-server
--fill-window-us``.

- ``run-fleet-server`` forwards ``--megabatch``/``--no-megabatch`` to every
  worker's command line, as the reference's forwards it (the same
  ``worker_args``), and the worker's own parser reads it back;
- ``run-server --fill-window-us N`` gives the served engine a fill window
  of N µs, overriding ``GORDO_FILL_WINDOW_US`` (which is the default when
  the option is absent);
- a value that is no integer, in the option or in the variable, exits 2
  in both packages.

No worker process or listener starts: the router's tier assembly and the
server's ``make_server`` are replaced by recorders that stop the command.
The served machine is a dense detector fitted and dumped by the JAX
package.
"""

import os
import sys

import pytest
from click.testing import CliRunner

torch = pytest.importorskip("torch")

from gordo_components_tpu.cli.cli import gordo as ref_cli  # noqa: E402
from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402

from gordo_components_tpu_torch import router  # noqa: E402
from gordo_components_tpu_torch.cli import cli  # noqa: E402
from gordo_components_tpu_torch.server import server  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_server_seams import TAGS, _fit  # noqa: E402


class _Stop(Exception):
    pass


def _port_rc(argv):
    try:
        return cli.main(argv)
    except SystemExit as exc:
        return exc.code


def _worker_argvs(monkeypatch, tmp_path, flags):
    """Each worker's command line as the port's ``run-fleet-server``
    would spawn it with ``flags``."""
    argvs = []

    def assemble(specs, factory, **kwargs):
        argvs.extend(factory(spec).argv for spec in specs)
        raise _Stop

    monkeypatch.setattr(router, "assemble_fleet", assemble)
    with pytest.raises(_Stop):
        cli.main(["run-fleet-server", "--models-dir", str(tmp_path), "--workers", "2",
                  "--device", "cpu", *flags])
    return argvs


def _reference_worker_args(monkeypatch, tmp_path, flags):
    import gordo_components_tpu.router as ref_router

    seen = {}

    def serve(models_dir, **kwargs):
        seen.update(kwargs)

    monkeypatch.setattr(ref_router, "run_fleet_server", serve)
    result = CliRunner().invoke(ref_cli, ["run-fleet-server", "--models-dir", str(tmp_path),
                                          *flags])
    assert result.exit_code == 0, result.output
    return list(seen["worker_args"])


@pytest.mark.parametrize("flags,megabatch", [(["--megabatch"], True),
                                             (["--no-megabatch"], False), ([], None)],
                         ids=["on", "off", "unset"])
def test_fleet_server_forwards_megabatch_to_every_worker(monkeypatch, tmp_path, flags,
                                                         megabatch):
    argvs = _worker_argvs(monkeypatch, tmp_path, flags)
    assert len(argvs) == 2
    ref_args = _reference_worker_args(monkeypatch, tmp_path, flags)
    assert ref_args == flags
    for argv in argvs:
        run_server = argv.index("run-server")
        assert argv[run_server + 1:][-len(flags) - 2:] == [*flags, "--device", "cpu"]
        parsed = cli.parser().parse_args(argv[run_server:])
        assert parsed.megabatch is megabatch


def test_fleet_server_help_offers_megabatch(capsys):
    assert _port_rc(["run-fleet-server", "--help"]) == 0
    text = capsys.readouterr().out
    assert "--megabatch" in text and "Not offered" not in text


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    ref_dump(_fit(0), str(root / "dense"), metadata={"dataset": {"tag_list": TAGS}})
    return root


def _served_fill_window(monkeypatch, tmp_path, flags):
    """The fill window of the engine that ``run-server`` builds over
    ``tmp_path``."""
    seen = {}

    def make(target, host, port, device=None, **options):
        app = server.ModelServer(target, device="cpu", **options)
        seen["fill_window_us"] = app.engine.fill_window_us
        app.close()
        raise _Stop

    monkeypatch.setattr(server, "make_server", make)
    monkeypatch.setenv("GORDO_MEGABATCH", "1")
    with pytest.raises(_Stop):
        cli.main(["run-server", "--models-dir", str(tmp_path), "--port", "0", "--device",
                  "cpu", *flags])
    return seen["fill_window_us"]


def test_fill_window_option_sets_the_engines_window(monkeypatch, models_dir):
    monkeypatch.setenv("GORDO_FILL_WINDOW_US", "777")
    assert _served_fill_window(monkeypatch, models_dir, []) == 777
    assert _served_fill_window(monkeypatch, models_dir, ["--fill-window-us", "1234"]) == 1234
    assert _served_fill_window(monkeypatch, models_dir, ["--fill-window-us", "0"]) == 0


@pytest.mark.parametrize("where", ["option", "variable"])
def test_a_bad_fill_window_exits_as_the_reference(monkeypatch, tmp_path, where):
    flags = ["--fill-window-us", "soon"] if where == "option" else []
    if where == "variable":
        monkeypatch.setenv("GORDO_FILL_WINDOW_US", "soon")
    port_rc = _port_rc(["run-server", "--models-dir", str(tmp_path), "--device", "cpu",
                        *flags])
    ref_rc = CliRunner().invoke(ref_cli, ["run-server", "--models-dir", str(tmp_path),
                                          *flags]).exit_code
    assert port_rc == ref_rc == 2
