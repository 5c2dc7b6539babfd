"""The port's fleet build as several ranks of one ``torch.distributed``
(gloo) group on the CPU, against the same build as one rank and against
the JAX package's ``build_fleet``.

This file is also the rank process: ``python tests/test_torch_multirank_
build.py --rank R --world W --port P --mode MODE ...`` joins the group on
``127.0.0.1:P``, installs the mode's hooks (they live only here) and runs
``cli fleet-build --device cpu``; it prints its marker lines and exits with
the command's code. Every spawn has its own timeout, kills its whole
process group on timeout, and is retried once when the coordinator's port
was taken before rank 0 bound it.

- ``initialize_multihost``: a no-op without a coordinator or torchrun's
  environment; a named coordinator that cannot be joined raises; a bare
  ``--process-id`` is a usage error; ``--n-devices 2`` on one device is a
  config error;
- a machine's seed is prefix-stable in the slice's padded machine count,
  and the ranks' spans tile a slice;
- 2 and 4 ranks build every machine bit for bit as one rank does (the
  same arrays in the artifacts, the same predictions), machines of
  different row counts included, and ranks whose block is all padding;
  each rank writes its own manifest and journal, and the manifests
  partition the fleet by contiguous spans;
- with the reference's draws injected (its initial parameters and
  permutations for each machine's reference key), 2 ranks predict within
  ``PREDICT_RTOL`` of the JAX package's ``build_fleet`` of the same fleet;
- the slice checkpointer: a kill right after the first slice's checkpoint
  lands is restored on the re-run ("Restored slice checkpoint", nothing
  trained for that slice, no checkpoint left), with 1 rank and with 2; an
  unreadable checkpoint warns and retrains with 1 rank and raises (and is
  removed) with 2; zero-size leaves round-trip, and a checkpoint restores
  the subset of its machines a rank asks for;
- resume: a machine isolated by a failed fetch is retried alone, its
  resolved slice mate neither fetched nor trained, and comes out as in a
  build that never failed;
- the watchdog: both ranks wedged at slice 1 exit ``[75, 75]`` with its
  CRITICAL line; a rank that dies leaves its peer exiting positive, never
  64 or 66, within the drill's limit; the re-runs complete the fleet;
- the rendezvous timeout bounds no collective: a rank whose block is
  padding waits out its peer's training past it; ranks that disagree on
  which machines are resolved exit 75 before training;
- two ranks filling one empty kernel-library store at once leave one
  whole entry;
- ``fleet_flops_accounting``: its trip counts equal the reference's,
  doubling epochs doubles its train steps, the flash formulas count
  4·BH·S²·D forward and 10·BH·S²·D backward, and a dense step counts its
  products by hand.
"""

import argparse
import importlib
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the reference's PREDICT_RTOL of tests/test_torch_fleet_build.py: float32
# both sides, the same draws, products summed in other orders
PREDICT_RTOL = 1e-5
SLICE = 2  # machines per slice: 5 machines make slices of 2, 2 and 1
N_SPLITS = 2
SPAWN_TIMEOUT_S = 150.0
# the "slow" ranks' rendezvous timeout, and what rank 0's training outlasts it by
SLOW_RENDEZVOUS_S = 5
SLOW_TRAIN_S = SLOW_RENDEZVOUS_S + 4


def _data(tags, seed, days):
    return {
        "type": "TimeSeriesDataset",
        "train_start_date": "2023-01-01T00:00:00+00:00",
        "train_end_date": f"2023-01-{1 + days:02d}T00:00:00+00:00",
        "tag_list": [f"TAG-{i}" for i in range(tags)],
        "data_provider": {"type": "RandomDataProvider", "min_size": 150 * days,
                          "max_size": 200 * days, "seed": seed},
    }


DENSE = {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
    "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {"DenseAutoEncoder": {
        "kind": "feedforward_hourglass", "batch_size": 64, "epochs": 1}}]}},
    "transformer": "MinMaxScaler"}}}}


def _machines(n=5):
    """One dense bucket; machines alternate 1 and 2 days of rows, so a
    slice's machines have different row counts."""
    return [dict(name=f"mr-{i}", model_config=DENSE, data_config=_data(3, 40 + i, 1 + i % 2))
            for i in range(n)]


def _fleet_file(path, machines):
    with open(path, "w") as fh:
        json.dump({"machines": [{"name": m["name"], "model": m["model_config"],
                                 "dataset": m["data_config"]} for m in machines]}, fh)
    return str(path)


# --------------------------------------------------------------------------
# the rank process
# --------------------------------------------------------------------------

def _reference_draws_hook(builder, fleet, seed, eff):
    """Train with the reference's draws: each machine's key is located in
    the port's ``machine_seeds`` (bucket 0; slice and position searched),
    and its initial parameters and permutations are those the reference's
    program draws from ``split(fold_in(fold_in(PRNGKey(seed), 0), s), eff)``
    at that position. Padding machines keep the port's own draws."""
    import copy

    import jax
    import jax.numpy as jnp
    import torch

    from gordo_components_tpu.models.analysis import analyze_model as ref_analyze
    from gordo_components_tpu.parallel.build_fleet import _spec_for as ref_spec_for
    from gordo_components_tpu.serializer import pipeline_from_definition as ref_definition
    from gordo_components_tpu_torch.models.convert import params_from_flax

    real_train = builder.train_fleet_arrays
    ref_spec = ref_spec_for(ref_analyze(ref_definition(DENSE)), 3, 3, N_SPLITS)

    def locate(key):
        for s in range(8):
            for i in range(SLICE):
                if int(builder.machine_seeds(seed, 0, s, i + 1)[i]) == key:
                    return s, i
        return None

    def ref_perms(key, n):
        perms = []
        for epoch_key in jax.random.split(key, ref_spec.epochs):
            perm_key, _ = jax.random.split(epoch_key)
            perms.append(np.asarray(jax.random.permutation(perm_key, n)))
        return perms

    def train(spec, batch, device=None, **kwargs):
        n_rows = batch.X.shape[1]
        padded = -(-n_rows // spec.batch_size) * spec.batch_size
        own = fleet.initial_params(spec.module, batch.keys)
        params0, perms = {n: v.clone() for n, v in own.items()}, []
        for m, key in enumerate(np.asarray(batch.keys).tolist()):
            where = locate(key)
            if where is None:  # a padding machine: zero weight, any draw
                perms.append([[np.arange(padded)] * spec.epochs] * (N_SPLITS + 1))
                continue
            s, i = where
            ref_key = jax.random.split(jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(seed), 0), s), eff[s])[i]
            split = jax.random.split(ref_key, N_SPLITS + 2)
            tree = ref_spec.module.init(split[0], jnp.zeros((1, 3), jnp.float32),
                                        deterministic=True)["params"]
            module = params_from_flax(copy.deepcopy(spec.module),
                                      jax.tree_util.tree_map(np.asarray, tree))
            for name, p in module.named_parameters():
                params0[name][m] = p.detach()
            perms.append([ref_perms(split[2 + j], padded) for j in range(N_SPLITS)]
                         + [ref_perms(split[1], padded)])
        return real_train(spec, batch, device=device, params0=params0, perms=perms, **kwargs)

    builder.train_fleet_arrays = train
    return torch


def _child(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--mode", default="build")
    parser.add_argument("--config", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--eff", default=None, help="reference slice sizes, comma separated")
    parser.add_argument("--cached", default=None, help="an artifact rank 1's registry holds")
    args = parser.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    builder = importlib.import_module("gordo_components_tpu_torch.parallel.build_fleet")
    from gordo_components_tpu_torch.parallel import distributed, fleet

    if args.world > 1:
        distributed.initialize_multihost(
            f"127.0.0.1:{args.port}", args.world, args.rank,
            timeout_s=SLOW_RENDEZVOUS_S if args.mode == "slow" else 60)
    if args.mode == "store":
        _store_child(args)
        return
    if args.mode == "draws":
        _reference_draws_hook(builder, fleet, 0, [int(v) for v in args.eff.split(",")])
    trains = []
    real_train = builder.train_fleet_arrays
    slices_started = []

    def counting_train(spec, batch, *a, **k):
        trains.append(len(batch.keys))
        if args.mode == "slow" and slices_started[-1] == "bucket 0 slice 2":
            # rank 0 trains the last slice's one machine past the
            # rendezvous timeout while rank 1, whose block is padding,
            # waits for it in the slice's collectives
            time.sleep(SLOW_TRAIN_S)
            print("trained-past-the-rendezvous-timeout", flush=True)
        return real_train(spec, batch, *a, **k)

    builder.train_fleet_arrays = counting_train

    if args.mode == "crash-after-checkpoint":
        real_save = builder._SliceCheckpointer.save_async

        def save_then_die(self, key, result, positions):
            real_save(self, key, result, positions)
            self._wait()  # the file has landed
            print("crashed-after-checkpoint", flush=True)
            os._exit(17)

        builder._SliceCheckpointer.save_async = save_then_die
    if args.mode == "disagree" and args.rank == 1:
        # rank 1's registry holds the first machine, rank 0's nothing
        asked = []

        def get_value(register_dir, key):
            asked.append(key)
            return args.cached if len(asked) == 1 else None

        builder.disk_registry.get_value = get_value
    if args.mode in ("hang", "asym", "slow"):
        real_start = builder._SliceWatchdog.start

        def start(self, where):
            real_start(self, where)
            slices_started.append(where)
            if args.mode == "hang" and where == "bucket 0 slice 1":
                print("wedged-in-slice", flush=True)
                time.sleep(3600)
            elif args.mode == "asym" and where == "bucket 0 slice 2" and args.rank == 1:
                print("peer-died-asymmetrically", flush=True)
                os._exit(17)

        builder._SliceWatchdog.start = start

    from gordo_components_tpu_torch.cli import cli

    command = ["--log-level", "INFO", "fleet-build", "--machine-config", args.config,
               "--output-dir", args.out, "--device", "cpu", "--n-splits", str(N_SPLITS),
               "--slice-size", str(SLICE), "--no-serving-cache", "--compile-cache-dir", "off"]
    if args.world > 1:
        command += ["--coordinator-address", f"127.0.0.1:{args.port}", "--num-processes",
                    str(args.world), "--process-id", str(args.rank)]
    if args.mode == "disagree":
        command += ["--model-register-dir", os.path.join(args.out, "registry")]
    code = cli.main(command)
    print(f"trains@{args.rank}: {json.dumps(trains)}", flush=True)
    logging.shutdown()
    sys.stderr.flush()
    os._exit(code)


STORE_ROUNDS = 5


def _store_key(round_):
    return {"kernel": "flash_fwd_f32", "test": "two ranks", "round": round_}


def _store_child(args):
    """Both ranks commit the same entry of one empty store at once (a
    barrier starts them together), one fresh key a round: as two ranks
    that both missed, built and write back."""
    from gordo_components_tpu_torch.compile_cache.store import CompileCacheStore
    from gordo_components_tpu_torch.parallel import distributed

    library = os.path.join(args.out, f"lib-{args.rank}.so")
    with open(library, "wb") as fh:
        fh.write(bytes([7]) * 65536)  # both ranks built the same bytes
    store = CompileCacheStore(os.path.join(args.out, "store"))
    written = []
    for round_ in range(STORE_ROUNDS):
        distributed.barrier()
        written.append(int(store.put(_store_key(round_), library, compile_seconds=1.0)))
        distributed.barrier()
    print(f"store@{args.rank}: {json.dumps(written)}", flush=True)
    os._exit(0)


# --------------------------------------------------------------------------
# the parent: spawning ranks
# --------------------------------------------------------------------------

def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn(world, mode, out, config=None, env=None, eff=None, timeout=SPAWN_TIMEOUT_S,
           cached=None):
    """``world`` rank processes of this file → (exit codes, outputs), in
    rank order. A timeout kills every rank's process group; a port taken
    before rank 0 bound it is retried once on a fresh port."""
    base_env = {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu",
                "OMP_NUM_THREADS": "1", **(env or {})}
    for attempt in range(2):
        port = _free_port()
        procs = []
        for rank in range(world):
            argv = [sys.executable, os.path.abspath(__file__), "--rank", str(rank), "--world",
                    str(world), "--port", str(port), "--mode", mode, "--out", str(out)]
            if config:
                argv += ["--config", str(config)]
            if eff:
                argv += ["--eff", ",".join(map(str, eff))]
            if cached:
                argv += ["--cached", str(cached)]
            procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True, env=base_env,
                                          start_new_session=True))
        deadline = time.monotonic() + timeout
        outputs = []
        for proc in procs:
            try:
                outputs.append(proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                for other in procs:
                    try:
                        os.killpg(other.pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                outputs.append(proc.communicate()[0] + "\n[killed at the spawn's timeout]")
        codes = [proc.wait() for proc in procs]
        raced = any("EADDRINUSE" in o or "address already in use" in o.lower() for o in outputs)
        if not (raced and attempt == 0):
            return codes, outputs
    return codes, outputs


def _built(outputs):
    return [json.loads(o.split(f"trains@{r}: ", 1)[1].splitlines()[0])
            for r, o in enumerate(outputs)]


def _single_rank_build(machines, out, draws_eff=None):
    """The same fleet as one rank, in this process, on one thread as the
    ranks run (a CPU product's last bits depend on its thread count)."""
    import torch

    builder = importlib.import_module("gordo_components_tpu_torch.parallel.build_fleet")
    from gordo_components_tpu_torch.parallel import FleetMachineConfig, fleet

    threads = torch.get_num_threads()
    real_train = builder.train_fleet_arrays
    torch.set_num_threads(1)
    try:
        if draws_eff is not None:
            _reference_draws_hook(builder, fleet, 0, draws_eff)
        return builder.build_fleet([FleetMachineConfig(**m) for m in machines], str(out),
                                   device="cpu", n_splits=N_SPLITS, slice_size=SLICE)
    finally:
        builder.train_fleet_arrays = real_train
        torch.set_num_threads(threads)


ROWS = np.random.default_rng(5).normal(size=(40, 3)).astype(np.float32)


def _assert_same_machines(root_a, root_b, names):
    """Bit for bit: the artifacts' arrays, the detector's metadata and the
    predictions on fixed rows."""
    from gordo_components_tpu_torch.serializer import load, load_metadata
    from gordo_components_tpu_torch.store.generations import resolve_artifact_dir

    for name in names:
        a, b = os.path.join(root_a, name), os.path.join(root_b, name)
        meta_a = load_metadata(a)["model"]["model_builder_metadata"]
        meta_b = load_metadata(b)["model"]["model_builder_metadata"]
        assert meta_a == meta_b, name
        with np.load(os.path.join(resolve_artifact_dir(a), "state.npz")) as sa, \
                np.load(os.path.join(resolve_artifact_dir(b), "state.npz")) as sb:
            assert sorted(sa.files) == sorted(sb.files)
            for key in sa.files:
                np.testing.assert_array_equal(sa[key], sb[key], err_msg=f"{name} {key}")
        np.testing.assert_array_equal(load(a, device="cpu").predict(ROWS),
                                      load(b, device="cpu").predict(ROWS), err_msg=name)


def _manifests(out, world):
    files = ["fleet_manifest.json"] + [f"fleet_manifest.p{r}.json" for r in range(1, world)]
    result = []
    for name in files:
        with open(os.path.join(out, name)) as fh:
            result.append(json.load(fh))
    return result


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The fleet built as one rank with the port's own draws."""
    out = tmp_path_factory.mktemp("one-rank")
    return str(out), _single_rank_build(_machines(), out)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

def test_initialize_multihost_no_op_bad_coordinator_and_cli_usage(tmp_path, monkeypatch):
    import torch

    from gordo_components_tpu_torch.cli import cli
    from gordo_components_tpu_torch.parallel import distributed

    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    distributed.initialize_multihost()
    assert not torch.distributed.is_initialized()
    assert distributed.global_fleet_devices("cpu") == (torch.device("cpu"), 1, 0)
    with pytest.raises(ValueError, match="--process-id"):
        distributed.initialize_multihost("127.0.0.1:1", 2)
    started = time.monotonic()
    # rank 1 of a coordinator nobody listens on: a named coordinator that
    # cannot be joined raises, it never falls back to one process
    with pytest.raises(RuntimeError):
        distributed.initialize_multihost(f"127.0.0.1:{_free_port()}", 2, 1, timeout_s=2)
    assert time.monotonic() - started < 30
    assert not torch.distributed.is_initialized()

    config = _fleet_file(tmp_path / "fleet.json", _machines(1))
    base = ["fleet-build", "--machine-config", config, "--output-dir", str(tmp_path / "o"),
            "--device", "cpu"]
    assert cli.main(base + ["--process-id", "1"]) == cli.EXIT_USAGE
    assert cli.main(base + ["--n-devices", "2"]) == cli.EXIT_CONFIG
    assert not (tmp_path / "o").exists()
    help_text = cli.parser()._subparsers._group_actions[0].choices["fleet-build"].format_help()
    for flag in ("--coordinator-address", "--num-processes", "--process-id", "--n-devices"):
        assert flag in help_text
    assert "Not offered yet" not in help_text


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_keys_are_prefix_stable_and_spans_partition_a_slice(world):
    """A machine's seed does not depend on the padded machine count (so not
    on the world size), and the ranks' spans tile the padded slice."""
    builder = importlib.import_module("gordo_components_tpu_torch.parallel.build_fleet")
    from gordo_components_tpu_torch.parallel import pad_to_multiple

    n_padded = pad_to_multiple(5, world)
    keys = builder.machine_seeds(7, 1, 2, n_padded)
    np.testing.assert_array_equal(keys[:5], builder.machine_seeds(7, 1, 2, 5))
    spans = [builder._local_machine_span(n_padded, world, r) for r in range(world)]
    assert [lo for lo, _ in spans] == [hi - n_padded // world for _, hi in spans]
    assert spans[0][0] == 0 and spans[-1][1] == n_padded
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    with pytest.raises(ValueError, match="divide"):
        builder._local_machine_span(5, 2, 0)


def test_four_ranks_build_every_machine_as_one_rank_does(tmp_path, one_rank):
    root, single = one_rank
    out = tmp_path / "four"
    config = _fleet_file(tmp_path / "fleet.json", _machines())
    codes, outputs = _spawn(4, "build", out, config)
    assert codes == [0, 0, 0, 0], "\n".join(outputs)
    # 5 machines in slices of 2, 2, 1, each padded to 4: ranks 0 and 1 own
    # one machine of the first two slices, rank 0 the last; 2 and 3 none
    assert _built(outputs) == [[1, 1, 1], [1, 1], [], []]
    _assert_same_machines(root, str(out), sorted(single))
    manifests = _manifests(str(out), 4)
    owned = [sorted(m["machines"]) for m in manifests]
    assert owned == [["mr-0", "mr-2", "mr-4"], ["mr-1", "mr-3"], [], []]
    for rank, manifest in enumerate(manifests):
        assert manifest["journal"] == {"resumed": 0, "torn": 0, "rebuilt": len(owned[rank])}
        for name, entry in manifest["machines"].items():
            assert entry["status"] == "completed"
    from gordo_components_tpu_torch.store import journal as store_journal

    assert os.path.isfile(store_journal.journal_path(str(out), 1))
    assert not os.path.exists(store_journal.journal_path(str(out), 2))  # nothing to record
    states = store_journal.replay(str(out))
    assert {n: r["event"] for n, r in states.items()} == dict.fromkeys(single, "committed")
    assert not os.listdir(out / ".slice_checkpoints") if (out / ".slice_checkpoints").exists() \
        else True


def test_two_ranks_equal_one_rank_and_the_reference(tmp_path):
    """With the reference's draws in every build: 2 ranks equal 1 rank bit
    for bit, and the JAX package's build within PREDICT_RTOL; the ranks'
    manifests partition the fleet by contiguous spans of each slice."""
    from gordo_components_tpu.parallel import FleetMachineConfig as RefMachine
    from gordo_components_tpu.serializer import load as ref_load
    from gordo_components_tpu_torch.serializer import load

    ref_builder = importlib.import_module("gordo_components_tpu.parallel.build_fleet")
    machines = _machines()
    eff = [2, 2, 1]  # the reference's slices (one process, no padding)
    single = _single_rank_build(machines, tmp_path / "one", draws_eff=eff)
    config = _fleet_file(tmp_path / "fleet.json", machines)
    codes, outputs = _spawn(2, "draws", tmp_path / "two", config, eff=eff)
    assert codes == [0, 0], "\n".join(outputs)
    assert _built(outputs) == [[1, 1, 1], [1, 1]]
    _assert_same_machines(str(tmp_path / "one"), str(tmp_path / "two"), sorted(single))
    manifests = _manifests(str(tmp_path / "two"), 2)
    assert [sorted(m["machines"]) for m in manifests] == [["mr-0", "mr-2", "mr-4"],
                                                          ["mr-1", "mr-3"]]
    assert manifests[1]["journal"]["rebuilt"] == 2

    ref_builder.build_fleet([RefMachine(**m) for m in machines], str(tmp_path / "ref"),
                            n_splits=N_SPLITS, slice_size=SLICE)
    for m in machines:
        ours = load(str(tmp_path / "two" / m["name"]), device="cpu").predict(ROWS)
        theirs = np.asarray(ref_load(str(tmp_path / "ref" / m["name"])).predict(ROWS))
        np.testing.assert_allclose(ours, theirs, atol=PREDICT_RTOL * np.abs(theirs).max(),
                                   rtol=0, err_msg=m["name"])


def test_checkpoint_restores_after_a_kill_one_rank(tmp_path, monkeypatch, caplog):
    """A kill after the first slice's checkpoint lands, before any
    artifact: the re-run restores that slice, trains only the others and
    leaves no checkpoint; then an unreadable checkpoint warns and
    retrains."""
    builder = importlib.import_module("gordo_components_tpu_torch.parallel.build_fleet")
    machines = _machines(4)
    out = tmp_path / "fleet"
    real_commit = builder.commit_generation

    def dying_commit(*args, **kwargs):
        raise RuntimeError("killed before artifacts")

    monkeypatch.setattr(builder, "commit_generation", dying_commit)
    with pytest.raises(RuntimeError, match="killed before artifacts"):
        _single_rank_build(machines, out)
    checkpoints = os.listdir(out / ".slice_checkpoints")
    assert len(checkpoints) == 1
    assert os.listdir(out / ".slice_checkpoints" / checkpoints[0]) == ["rank0-of1.npz"]
    monkeypatch.setattr(builder, "commit_generation", real_commit)

    trains = []
    real_train = builder.train_fleet_arrays
    monkeypatch.setattr(builder, "train_fleet_arrays",
                        lambda spec, batch, **k: trains.append(1) or real_train(spec, batch, **k))
    caplog.set_level(logging.INFO, logger=builder.__name__)
    built = _single_rank_build(machines, out)
    assert sorted(built) == [m["name"] for m in machines]
    assert len(trains) == 1  # slice 0 restored, slice 1 trained
    assert "Restored slice checkpoint" in caplog.text
    assert not (out / ".slice_checkpoints").exists()

    # the restored slice equals a build that never stopped
    fresh = tmp_path / "fresh"
    _single_rank_build(machines, fresh)
    _assert_same_machines(str(fresh), str(out), [m["name"] for m in machines])

    # an unreadable checkpoint, one rank: a warning, then a retrain
    again = tmp_path / "again"
    monkeypatch.setattr(builder, "commit_generation", dying_commit)
    with pytest.raises(RuntimeError):
        _single_rank_build(machines[:2], again)
    monkeypatch.setattr(builder, "commit_generation", real_commit)
    (slice_dir,) = (again / ".slice_checkpoints").iterdir()
    (slice_dir / "rank0-of1.npz").write_bytes(b"not a zip")
    trains.clear()
    caplog.clear()
    _single_rank_build(machines[:2], again)
    assert len(trains) == 1 and "unreadable" in caplog.text
    _single_rank_build(machines[:2], tmp_path / "fresh-two")
    _assert_same_machines(str(tmp_path / "fresh-two"), str(again),
                          [m["name"] for m in machines[:2]])


def test_checkpoint_zero_size_leaves_and_an_unreadable_one_with_two_ranks(tmp_path,
                                                                            monkeypatch):
    import torch

    builder = importlib.import_module("gordo_components_tpu_torch.parallel.build_fleet")
    from gordo_components_tpu_torch.ops.scaling import ScalerParams
    from gordo_components_tpu_torch.parallel import distributed
    from gordo_components_tpu_torch.parallel.fleet import MachineResult

    rng = np.random.default_rng(0)
    scaler = ScalerParams(scale=rng.normal(size=(2, 3)).astype(np.float32),
                          offset=rng.normal(size=(2, 3)).astype(np.float32))
    result = MachineResult(
        params={"layers.0.weight": rng.normal(size=(2, 4, 3)).astype(np.float32)},
        input_scaler=scaler, target_scaler=scaler, error_scaler=scaler,
        loss_history=rng.normal(size=(2, 3)).astype(np.float32),
        cv_scores=np.zeros((2, 0, 4), np.float32),  # CV off
        tag_thresholds=rng.normal(size=(2, 3)).astype(np.float32),
        total_threshold=rng.normal(size=(2,)).astype(np.float32))
    one = builder._SliceCheckpointer(str(tmp_path / "one"))
    one.save_async("k", result, [0, 2])  # the block's machines 0 and 2
    one._wait()  # the file has landed (finalize waits so)
    restored = one.try_restore("k", [0, 2])
    assert restored.cv_scores.shape == (2, 0, 4) and restored.cv_scores.dtype == np.float32
    for a, b in zip(builder._result_arrays(result).items(),
                    builder._result_arrays(restored).items()):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
    # a subset restores its own rows, in the order asked; a machine the
    # checkpoint lacks (isolated when it was written) means a retrain
    second = builder._result_arrays(one.try_restore("k", [2]))
    for name, value in builder._result_arrays(result).items():
        np.testing.assert_array_equal(second[name], value[1:], err_msg=name)
    assert one.try_restore("k", [0, 1]) is None
    assert one.try_restore("k", []) is None
    one.finalize("k")
    assert not os.path.exists(one.path("k"))
    one.close()
    assert not (tmp_path / "one" / ".slice_checkpoints").exists()

    # rank 1 of 2 (its peer stubbed as agreeing that the checkpoint exists)
    monkeypatch.setattr(distributed, "allgather_ints", lambda values: np.asarray([values] * 2))
    two = builder._SliceCheckpointer(str(tmp_path / "two"), world=2, rank=1)
    two.save_async("k", result, [0, 1])
    two._wait()
    path = os.path.join(two.path("k"), "rank1-of2.npz")
    assert os.path.isfile(path) and not [f for f in os.listdir(two.path("k"))
                                         if f.endswith(".tmp")]
    with open(path, "r+b") as fh:
        fh.truncate(100)
    with pytest.raises(distributed.RankFailure, match="unreadable"):
        two.try_restore("k", [0, 1])
    assert not os.path.exists(path)  # the re-run votes to retrain
    assert torch.distributed.is_initialized() is False


def test_two_ranks_restore_a_checkpointed_slice_after_a_kill(tmp_path, one_rank):
    root, single = one_rank
    out = tmp_path / "fleet"
    config = _fleet_file(tmp_path / "fleet.json", _machines())
    codes, outputs = _spawn(2, "crash-after-checkpoint", out, config)
    assert codes == [17, 17], "\n".join(outputs)
    assert all("crashed-after-checkpoint" in o for o in outputs)
    (slice_dir,) = (out / ".slice_checkpoints").iterdir()
    assert sorted(os.listdir(slice_dir)) == ["rank0-of2.npz", "rank1-of2.npz"]
    assert not any(n.startswith("mr-") for n in os.listdir(out))

    codes, outputs = _spawn(2, "build", out, config)
    assert codes == [0, 0], "\n".join(outputs)
    assert all("Restored slice checkpoint" in o for o in outputs)
    assert _built(outputs) == [[1, 1], [1]]  # slice 0 restored by both
    assert not (out / ".slice_checkpoints").exists()
    _assert_same_machines(root, str(out), sorted(single))


def test_watchdog_ends_wedged_and_orphaned_ranks_and_the_reruns_complete(tmp_path, one_rank):
    root, single = one_rank
    out = tmp_path / "fleet"
    config = _fleet_file(tmp_path / "fleet.json", _machines())
    timeout_s = 20.0  # a slice takes well under a second; the rest allows for a loaded host
    started = time.monotonic()
    codes, outputs = _spawn(2, "hang", out, config, env={"GORDO_SLICE_TIMEOUT_S": str(timeout_s)})
    assert codes == [75, 75], "\n".join(outputs)
    for output in outputs:
        assert "wedged-in-slice" in output
        assert "Fleet slice watchdog" in output and "exiting 75" in output
    assert time.monotonic() - started < SPAWN_TIMEOUT_S
    assert {"mr-0", "mr-1"} <= set(os.listdir(out))  # slice 0 landed

    # the re-run skips slice 0 (resolved), builds slice 1 as it was, and a
    # rank dies at slice 2: its peer ends retryably
    started = time.monotonic()
    codes, outputs = _spawn(2, "asym", out, config, env={"GORDO_SLICE_TIMEOUT_S": "30"},
                            timeout=90)
    assert codes[1] == 17 and "peer-died-asymmetrically" in outputs[1], "\n".join(outputs)
    assert codes[0] > 0 and codes[0] not in (64, 66), "\n".join(outputs)
    assert time.monotonic() - started < 90
    assert {"mr-2", "mr-3"} <= set(os.listdir(out))

    codes, outputs = _spawn(2, "build", out, config, env={"GORDO_SLICE_TIMEOUT_S": "120"})
    assert codes == [0, 0], "\n".join(outputs)
    with open(out / "fleet_manifest.json") as fh:
        assert json.load(fh)["journal"]["resumed"] == 4
    _assert_same_machines(root, str(out), sorted(single))


def test_a_partly_resolved_slice_trains_only_its_pending_machine(tmp_path, monkeypatch,
                                                                   one_rank):
    """A machine isolated by a failed fetch is retried alone on the re-run:
    its resolved slice mate is neither fetched nor trained (its row count
    comes from its metadata), and the retried machine comes out as in a
    build that never failed (its own key, the slice's row axis)."""
    root, single = one_rank
    builder = importlib.import_module("gordo_components_tpu_torch.parallel.build_fleet")
    out = tmp_path / "fleet"
    real_fetch = builder._fetch_machine_data
    fetched, trains, failing = [], [], {"mr-1"}

    def fetch(item, retries, backoff):
        fetched.append(item["machine"].name)
        if item["machine"].name in failing:
            return "ConnectionError: source down"
        return real_fetch(item, retries, backoff)

    real_train = builder.train_fleet_arrays
    monkeypatch.setattr(builder, "_fetch_machine_data", fetch)
    monkeypatch.setattr(builder, "train_fleet_arrays", lambda spec, batch, **k: trains.append(
        len(batch.keys)) or real_train(spec, batch, **k))
    assert sorted(_single_rank_build(_machines(), out)) == ["mr-0", "mr-2", "mr-3", "mr-4"]
    assert trains == [1, 2, 1]  # mr-1 left out of slice 0's stack

    failing.clear()
    fetched.clear()
    trains.clear()
    assert sorted(_single_rank_build(_machines(), out)) == sorted(single)
    assert fetched == ["mr-1"] and trains == [1]
    with open(out / "fleet_manifest.json") as fh:
        assert json.load(fh)["journal"] == {"resumed": 4, "torn": 0, "rebuilt": 1}
    _assert_same_machines(root, str(out), ["mr-1", "mr-2", "mr-3", "mr-4"])


def test_a_rank_idle_in_a_collective_outlasts_the_rendezvous_timeout(tmp_path, one_rank):
    """The rendezvous timeout does not bound the build's collectives: rank
    1, whose block of the last slice is padding, waits in that slice's
    collectives while rank 0 trains past the timeout, and both finish."""
    root, single = one_rank
    out = tmp_path / "slow"
    config = _fleet_file(tmp_path / "fleet.json", _machines())
    codes, outputs = _spawn(2, "slow", out, config)
    assert codes == [0, 0], "\n".join(outputs)
    assert "trained-past-the-rendezvous-timeout" in outputs[0]
    assert _built(outputs) == [[1, 1, 1], [1, 1]]
    _assert_same_machines(root, str(out), sorted(single))


def test_ranks_that_disagree_on_what_is_resolved_fail_retryably(tmp_path, one_rank):
    """Rank 1's registry resolves a machine rank 0's does not: the plan's
    digest differs, and both ranks exit 75 before any slice trains."""
    root, single = one_rank
    out = tmp_path / "disagree"
    config = _fleet_file(tmp_path / "fleet.json", _machines())
    codes, outputs = _spawn(2, "disagree", out, config, cached=os.path.join(root, "mr-0"))
    assert codes == [75, 75], "\n".join(outputs)
    assert all("disagree on the build plan" in o for o in outputs), "\n".join(outputs)
    assert _built(outputs) == [[], []]


def test_two_ranks_fill_one_empty_kernel_library_store(tmp_path):
    """The store commits through a staging directory and a rename: of two
    ranks writing one entry at once, at least one lands it, a loser counts
    a ``write_error`` and leaves nothing behind, and every entry is whole."""
    from gordo_components_tpu_torch.compile_cache.store import CompileCacheStore
    from gordo_components_tpu_torch.store.atomic import STAGING_PREFIX

    codes, outputs = _spawn(2, "store", tmp_path)
    assert codes == [0, 0], "\n".join(outputs)
    written = [json.loads(o.split(f"store@{r}: ", 1)[1].splitlines()[0])
               for r, o in enumerate(outputs)]
    assert all(a + b >= 1 for a, b in zip(*written)), written
    store = CompileCacheStore(str(tmp_path / "store"))
    entries = store.entries()
    assert sorted(e["program"]["round"] for e in entries) == list(range(STORE_ROUNDS))
    assert all(e["verified"] for e in entries)
    for round_ in range(STORE_ROUNDS):
        assert store.holds(_store_key(round_), deep=True)
    assert not [n for n in os.listdir(tmp_path / "store") if n.startswith(STAGING_PREFIX)]


def _dense_spec(epochs=4):
    builder = importlib.import_module("gordo_components_tpu_torch.parallel.build_fleet")
    from gordo_components_tpu_torch.models.analysis import analyze_model
    from gordo_components_tpu_torch.serializer import pipeline_from_definition

    sys.path.insert(0, ROOT)
    import bench

    cfg = bench._configs(full=False, epochs=epochs, machines=2)["dense_ae_10tag"]
    return cfg, builder._spec_for(analyze_model(pipeline_from_definition(cfg["model"])), 10, 10,
                                  N_SPLITS)


def test_fleet_flops_accounting_trip_counts_match_the_reference():
    from gordo_components_tpu.parallel.build_fleet import _analyze_model, _spec_for
    from gordo_components_tpu.parallel.fleet import fleet_flops_accounting as ref_accounting
    from gordo_components_tpu.serializer import pipeline_from_definition as ref_definition
    from gordo_components_tpu_torch.parallel import fleet_flops_accounting

    cfg, spec = _dense_spec()
    ref_spec = _spec_for(_analyze_model(ref_definition(cfg["model"])), 10, 10, n_splits=N_SPLITS)
    ours, theirs = fleet_flops_accounting(spec, 2, 128, 10, 10), ref_accounting(ref_spec, 2, 128,
                                                                                10, 10)
    assert theirs is not None and ours is not None
    for key in ("train_steps", "predict_chunks"):
        assert ours[key] == theirs[key]
    assert ours["train_steps"] == 3 * spec.epochs * (128 // spec.batch_size)
    doubled = fleet_flops_accounting(spec._replace(epochs=2 * spec.epochs), 2, 128, 10, 10)
    assert doubled["train_steps"] == 2 * ours["train_steps"]
    assert doubled["total_flops"] > ours["total_flops"]

    # the dense step by hand: per machine and layer, 2·B·in·out forward,
    # as much again for the weight's gradient, and for the input's gradient
    # on every layer but the first (the batch needs none)
    layers = [p.shape for n, p in spec.module.named_parameters() if n.endswith("weight")]
    B, M = spec.batch_size, 2
    products = [2 * B * out_f * in_f for out_f, in_f in layers]
    assert ours["predict_chunk_flops"] == M * sum(products)
    assert ours["train_step_flops"] == M * (2 * sum(products) + sum(products[1:]))
    assert ours["total_flops"] == (ours["train_step_flops"] * ours["train_steps"]
                                   + ours["predict_chunk_flops"] * ours["predict_chunks"])


def test_flash_flop_formulas_on_the_custom_ops():
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from gordo_components_tpu_torch.ops.flash_attention import flash_fwd

    bh, s, d = 6, 150, 16
    q, k, v = (torch.randn(bh, s, d, requires_grad=True) for _ in range(3))
    with FlopCounterMode(display=False) as counter:
        out, _ = flash_fwd(q, k, v, 0.25)
    assert counter.get_total_flops() == 4 * bh * s * s * d
    with FlopCounterMode(display=False) as counter:
        torch.autograd.grad(out.sum(), (q, k, v))
    assert counter.get_total_flops() == 10 * bh * s * s * d
    meta = torch.empty(bh, s, d, device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        flash_fwd(meta, meta, meta, 0.25)
    assert counter.get_total_flops() == 4 * bh * s * s * d


if __name__ == "__main__":
    _child(sys.argv[1:])
