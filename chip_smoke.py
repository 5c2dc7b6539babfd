#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases; any failure exits non-zero before the result line:

1. environment: torch/CUDA versions, the card's name and power limit, and
   a build of every CUDA kernel from ``gordo_components_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. each kernel (the fp32 one of ``csrc/flash_fwd_f32.cu`` and the bf16 one
   of ``csrc/flash_fwd_bf16.cu``) against its plain PyTorch version on the
   card, at the slice shape and the edge shapes of ``CHECK_SHAPES``, the
   fp32 one also at the training step's and the fleet build's shapes
   (``FWD_F32_PATH_SHAPES``, phase 12's chunks among them; each plain
   version runs over BH slices); then,
   at the slice shape, its time, the plain version's time and one PyTorch
   library call's time as a yardstick: SDPA on the 4-D view with its fused
   backend forced and named (timed only; the port never calls it). The
   backward (``csrc/flash_bwd_f32.cu`` and ``csrc/flash_bwd_bf16.cu``)
   against ``flash_bwd_reference`` at ``CHECK_SHAPES``, the training shape
   (16384, 179, 64), the fleet build's stacked step (32768, 179, 64) and
   ``LONG_SHAPES`` (the walk past the resident
   length), with and without an lse cotangent (max |Δ| of dq, dk, dv each
   against ``bwd_atol``), two launches at the training shape bit-identical;
   then its time, the plain version's, the
   library backward's (``torch.autograd.grad`` of that SDPA call, the
   backward alone) and its bound, at the slice shape, the fleet build's
   stacked step (32768, 179, 64) and the training shape;
3. the main path: a full-width long-window PatchTST anomaly machine
   (d_model 512, 8 heads, 3 layers, 64 tags, lookback 1440 = 179 patches,
   random weights from a seed in the flax layout, scalers fitted on seeded
   data, float32) is dumped as an artifact, served by the port's HTTP
   server on the card, and asked a few ``POST /anomaly/prediction``
   requests, one at a time. The launch counts are zeroed just before and
   read just after; every dispatch (one per lone request) must launch the
   fp32 kernel once per layer, and every response must match the same
   artifact scored by the port with ``device="cpu"`` (its plain path) over
   its first and last ``CPU_PLAIN_WINDOWS // 2`` windows (each window
   scores alone; so do phases 14 and 15);
3b. the bf16 path: the same machine built with ``compute_dtype="bfloat16"``
   answers one W = 16 request; it must launch the bf16 kernel once per
   layer and the fp32 kernel never, and match the same artifact scored on
   the card with dense attention in bf16;
4. the zoo: the reference's dense and LSTM machines at the widths of its own
   configs (``ZOO``: the dense AE of ``bench.py``'s ``dense_ae_10tag``, the
   ``feedforward_model`` defaults at 100 tags, the LSTM AE of
   ``lstm_ae_50tag``, the LSTM forecast of ``lstm_forecast_100tag``, the
   ``lstm_model`` defaults at 50 tags, that LSTM AE again with
   ``compute_dtype="bfloat16"``, and a joint ``MultiStepForecast``), random
   weights from a seed in the flax layout, dumped by the port into one
   models directory and served by one HTTP server on the card. Each machine
   answers requests of 144 and 1008 rows (a day and a week at 10-minute
   resolution), each matching the same artifact scored on the CPU plain
   path (bf16: at the same dtype, within ``BF16_SERVE_RTOL``), and no
   request launches a flash kernel; the joint forecaster is listed as
   skipped in ``/healthz`` and answers 503. One dense machine is scored at
   the engine's ``bf16`` rung against the CPU at that rung, and one
   1008-row request of ``lstm-ae-50tag`` and of ``dense-ae-default`` is
   traced under ``torch.profiler`` (device time by kernel, launches);
5. the fleet (``FLEETS``): 100 dense machines at 10 tags, 32 LSTM AEs at
   50 tags and 4 full-width PatchTST machines (the slice machine with other
   seeds), dumped into one models directory and served by one HTTP server
   through the stacked engine, which must hold one copy of the weights on
   the card (every machine's own weights on the host, device memory within
   ``HELD_SLACK`` of the stacked trees); each fleet's concurrent clients, spread over
   its machines, send FLEET_ROUNDS timed rounds of requests (req/s, p50,
   p99). Every dense and LSTM response must match the CPU plain path within
   SERVE_RTOL; every PatchTST response the same request served alone on the
   card within FUSED_RTOL, and one of them the CPU within SERVE_RTOL. Every
   fleet must fuse (fusion ratio above 1) with no fused-path repair, and
   the fp32 flash kernel must launch once per layer per PatchTST dispatch
   (at BH = k·8192), fewer times than once per layer per request. One fused
   dispatch per fleet is traced under ``torch.profiler`` (kernels, idle
   share). Then the dense fleet's rounds run again with the clients asking
   for the npz wire format (``Accept: application/x-gordo-npz``), every
   response against the CPU, req/s, p50 and p99 printed beside JSON's;
6. the int8 rung (``phase_int8``): the slice machine, ``dense-ae-default``,
   ``lstm-ae-50tag`` and a four-machine PatchTST fleet, each written by the
   port's ``write_artifact_files(..., precision="int8")`` (its metadata pins
   int8, ``quant_int8.npz`` beside ``state.npz``) and served by one HTTP
   server. The stacked weights must be int8 on the card; lone requests (W =
   1 and 16; 1008 rows), a concurrent W = 16 round over the fleet and one
   fused dispatch of 4 must each match the same artifact at int8 on the CPU
   plain path within SERVE_RTOL (a PatchTST answer at its first and last
   ``CPU_PLAIN_WINDOWS // 2`` windows, as phase 3) and the same weights
   served at f32 on the
   card within ``precision.error_budget("int8")`` (normalized total-score
   parity); fp32 flash launches = 3 × PatchTST dispatches. Printed: stacked
   bytes at int8 and f32, device memory held after boot, one int8 and one
   f32 W = 16 request under ``torch.profiler``, the dequantize pass alone;
7. the serving surface (``phase_surface``): one server with f32, bf16 and
   int8 machines and a bare (non-detector) dense pipeline: ``/models``,
   ``/metadata``, ``/healthz`` (fleet and per machine), ``/prediction`` (the
   bare machine and a detector), ``/anomaly/prediction`` of the bare machine
   (422), npz == JSON in float32, the trace id echoed, Prometheus
   ``/metrics`` parsed and counting the requests made, a spent
   ``X-Gordo-Deadline`` (504, no dispatch), a scoring fault (quarantine,
   503, named by ``/healthz``, the others serving, probe recovery after the
   cooldown), ``POST /reload`` (a rewritten, an added and a removed machine)
   while clients keep scoring, and a server under ``GORDO_MAX_INFLIGHT=1``,
   ``GORDO_MAX_QUEUE=0`` shedding 8 concurrent clients with 503 +
   ``Retry-After`` while every 200 is right;
8. training (``phase_train``): the slice machine's regressor (scalers, then
   ``PatchTSTAutoEncoder.fit``, float32, flash attention) trained on the
   card for one epoch over ``TRAIN_ROWS`` seeded rows, 8 Adam steps of 32
   windows; the launch counts are zeroed just before and read just after:
   3 fp32 forward and 3 fp32 backward launches per step, nothing else. The
   same fit with dense attention (same initial parameters, same
   permutation) must give the same loss history and W = 16 predictions
   within ``TRAIN_RTOL``. Printed: wall per step, peak device memory, one
   step under ``torch.profiler`` (device busy, GEMMs, flash forward and
   backward, idle share) and the optimizer update alone. The trained
   machine is dumped, served over HTTP and one W = 16 response held to the
   model's own ``predict`` within ``SERVE_RTOL``. Then the bf16 path
   (``phase_train_bf16``): the same fit at ``compute_dtype="bfloat16"``,
   3 bf16 forward and backward launches per step, its loss within
   ``BF16_SERVE_RTOL`` of the same fit with dense attention in bf16;
9. builds from data configs, every one a ``TimeSeriesDataset`` of
   ``RandomDataProvider`` series at 10 minutes: ``dense-ae-default`` and
   ``lstm-ae-50tag`` through the port's ``build_model`` on the card
   (``phase_build``: 2016 joined rows, ``cross_validate`` over 3 folds,
   then ``fit``), dumped with the build metadata (the reference's keys and
   phases checked), served by one HTTP server, each 1008-row response
   against the CPU plain path, no flash launch; then ``phase_cli_build``:
   ``python -m gordo_components_tpu_torch.cli build`` of the full-width
   slice machine (64 tags, ``TRAIN_ROWS`` joined rows, ``build_only``: 8
   Adam steps, 3 fp32 forward and backward launches each) into a
   generation root with a registry; the same command again must be a cache
   hit (no launch, no new generation; it runs beside the next build),
   ``--precision int8`` must commit ``gen-0002`` with the int8 sidecar
   under another key, ``rollback`` must restore ``gen-0001`` and
   ``rollback --list`` (beside the served request below) report it, and the port's
   server on the models directory must serve the machine from its root,
   a W = 16 response within SERVE_RTOL of the CPU plain path. Printed: each
   build's wall by phase, the joined rows, the build's peak device memory,
   the cache hit's wall, the commit's wall, the generation's bytes, and
   the flash launches;
10. the fleet build (``phase_fleet_build``): ``python -m
   gordo_components_tpu_torch.cli fleet-build`` of one fleet config
   (``FLEET_BUILD``: 100 dense AEs at 10 tags, 864 rows, 3 folds in one
   stack of 400 fits; 32 LSTM AEs at 50 tags, 432 rows, 2 folds; the slice
   machine twice, ``TRAIN_ROWS`` rows, 1 fold, ``cv_parallel`` false, so
   two sequential stacks of two) in a fresh process: 134 machines
   committed with registry keys and journal records, the PatchTST bucket
   through the fp32 flash kernels once per layer per step for both
   machines (``fleet_flash_launches``); the same command again, beside
   the stacking check below, resolves every machine cached with no launch;
   the port's server on the output
   root answers two machines of each bucket within SERVE_RTOL of each
   one's own predict on the card; one of the PatchTST machines (phase 19
   holds both) fitted alone at M = 1 from the same initial parameters and
   permutations matches the stacked build (losses within TRAIN_RTOL,
   thresholds within ``FLEET_THRESHOLD_RTOL``). Printed: the process wall, machines per
   hour, each bucket's slice wall, the peak device memory, the launches,
   the generations, the cache hit's wall;
11. the request seams (``phase_seams``): one server on 24 ``dense_ae_10tag``
   machines and 2 full-width PatchTST machines, under
   ``GORDO_TENANTS=ops:interactive;batch:bulk;metered:standard:5:5``, with
   a ``model-load`` error fault on one dense machine (quarantined at boot,
   the fleet serving) and a 50 ms ``engine-dispatch`` latency fault on
   another. The traffic of ``SEAMS_TRAFFIC`` (8 ``batch`` clients on
   ``/bulk/anomaly/prediction``, an ``ops`` client on dense machines, one
   on the PatchTST machines, a ``metered`` burst of 20) runs with the flight
   recorder holding every request, then the identical request list with
   the recorder off, then each distinct request alone with the recorder
   off and on. Checked: every response equal to the CPU plain path within
   SERVE_RTOL; recorder on and off give the same bytes wherever a request
   dispatches alone (every PatchTST request, the serial replay) and, for a
   dense request fused with other batch mates in the two runs, agree within
   FUSED_RTOL; every
   answered trace in ``/debug/requests``; a PatchTST timeline holds
   ``SEAMS_STAGES``, admission + score + encode within its wall, and
   dispatch + device_execute + fetch at least 3 x phase 2's
   ``flash_fwd_f32`` ms, device_execute + fetch alone in the median;
   ``?format=chrome`` parses; the ``gordo_stage_seconds`` exemplars of the
   run name recorded traces; ``metered`` alone gets 429 + ``Retry-After``;
   a fused dispatch of both PatchTST machines under ``torch.profiler``,
   profiled ``SEAMS_PROFILES`` times with the recorder on and as often off
   (interleaved), launches 3 ``flash_fwd_f32`` each time and has the same
   kernels and synchronizes on and off, each the most any one profile of
   its setting saw (a profile that lost a record is named); the slow
   machine's ``dispatch`` stage is at least 50 ms; the ledger directory
   holds the fault plan and the quarantine, each valid. Printed with the
   card's name and power limit: req/s, p50 and p99 per class, the median
   stage breakdown of a dense and a PatchTST request, recorder on against
   off;
12. the bulk client (``phase_client``): the in-repo InfluxDB 1.x double
   (``tests/influx_double.py``, loaded by path, its points indexed by tag so
   that a query scans one tag's points) filled through the port's
   ``MinimalInfluxClient`` with seeded one-minute series of ``N_TAGS`` tags
   for each of ``CLIENT_MACHINES``, each machine in a measurement of its own,
   ``CLIENT_CHUNKS`` x (LOOKBACK + CLIENT_WINDOWS - 1) rows; both slice
   machines built by ``python -m gordo_components_tpu_torch.cli build`` from
   an ``InfluxDataProvider`` data config, each process started once its
   machine's points are written (the next machine's written while the
   build before runs, the two builds then overlapping; 8 Adam steps each
   through the fp32 flash kernels); served by the port's server
   in this process and scored by the port's ``Client`` (parallelism
   ``CLIENT_PARALLELISM``, one ``max_interval`` per chunk, the Influx and
   CSV forwarders). Checked: every chunk answers, scores its last
   ``CLIENT_WINDOWS`` rows (the reference's tail alignment) at their
   timestamps, and equals the same rows POSTed alone as npz within
   FUSED_RTOL; each chunk's timeline holds ``data_fetch`` and dispatch +
   device_execute + fetch at least 3 x phase 2's ``flash_fwd_f32`` time at
   its dispatch's BH; the forwarded points read back from the double; ``cli
   client predict`` in a subprocess prints the same row counts and writes a
   CSV per machine; ``GET /download-model`` loads (``serializer.loads``) and,
   lifted on the card, scores a chunk within SERVE_RTOL of the served one; a
   parquet body equals the npz answer where pyarrow is installed (else a
   415); fp32 flash launches = 3 x PatchTST dispatches in the serving
   window. Printed with the card: the builds' walls, per chunk wall,
   ``data_fetch`` and device ms, the client's wall and rows per second, the
   forwarders' walls;
13. the control loops (``phase_control``): one server on 16
   ``dense_ae_10tag`` machines and 2 full-width PatchTST machines, with the
   knobs of ``CONTROL_ENV`` (a 100 ms latency objective on fast and slow
   windows of 2 and 30 s, the autopilot on with a 1 s cooldown, the
   warehouse ticking each second under a 128 KiB budget, 4 machines per
   metric family); 5 lone requests; a skewed dense stage (machine i about
   ``CONTROL_SKEW``/(i+1) requests, ``CONTROL_CLIENTS`` clients); a burn of
   both PatchTST machines asked together, an ``engine-dispatch`` latency
   fault over its first half; a light dense recovery with the autopilot
   disabled; the 5 lone requests again; ``/metrics`` scraped every 0.5 s
   meanwhile. Checked: the fast window crosses in the burn and only there,
   once per edge, each edge an ``slo``/``breach`` ledger event, the budget
   attributed to a device-side stage; the burn's incident report is on disk,
   the fault plan ranked above any autopilot decision, ``/incidents/<id>``
   and ``cli incidents show`` return it; the autopilot applied a decision
   (``dispatch_depth`` down on ``burn_device`` or ``shed`` up on
   ``sustained_burn``) that the engine or the gate reports, and none once
   disabled; ``cli autopilot status|enable|disable`` exit 0; the lone
   responses equal to the bit before and after; the traffic sketch's counts
   what was sent, in the skew's order, the scrape keeping the 4 most
   requested machines of a family that ranks them in reverse, the export
   valid, ``cli telemetry traffic|costs|export`` exit 0 and the f32 rung's
   ``device_bytes`` the stacked trees; the warehouse under its budget and a
   second server on the same models dir reloading its history; fp32 flash
   launches = 3 x PatchTST dispatches (the second server's warm-up
   included). Printed with the card: each stage's requests and latency, the
   skewed dense stage on fresh servers with the loops off and on (req/s,
   p50, p99);
14. the fleet tier (``phase_tier``): 24 ``dense_ae_10tag`` machines
   (``TIER_DENSE``, the first a generation root), the slice machine twice
   in fp32 and once in bf16, in one models root; a PatchTST request holds
   ``TIER_WINDOWS`` = 16 windows, so its flash forwards run at BH 8192, the
   slice shape that phase 2 holds. Tier A: the port's
   ``assemble_fleet`` in this process over 2 ``SubprocessWorker``s, each the
   port's ``run-server --worker-id i`` on the card through CLI_RUNNER (a
   launch record per process), replicas 2, probes every 0.5 s, the router
   on a ``ThreadingHTTPServer`` here; the workers run an ``engine-dispatch``
   latency fault of ``TIER_SLOW_S`` on ``TIER_SLOW``. Checked: every
   machine's answer carries ``X-Gordo-Worker`` of its placed worker and
   equals the same request posted straight to that worker, byte for byte,
   and the CPU plain path (fp32 within SERVE_RTOL, bf16 within
   BF16_SERVE_RTOL; a PatchTST answer over its first and last
   ``CPU_PLAIN_WINDOWS // 2`` windows); a dense machine driven past ``TIER_HOT_RPS`` is
   promoted hot and answered by both workers; a routed PatchTST trace on the
   router holds ``route`` with the worker's lane (``device_execute``,
   ``fetch``) inside it, and a stitch merged; the aggregate ``/metrics``'s
   scoring counters equal the workers' sum (plus the router's own),
   ``/telemetry`` merges both workers, ``/slo`` answers on all three; a
   new generation of ``TIER_RELOAD`` committed through the store is
   adopted by ``POST /reload`` (canary, then sweep) and undone by ``POST
   /rollback``, each answer against the CPU; a worker SIGTERMed while
   ``TIER_SLOW``'s request is in flight answers ``/healthz`` 503
   ``draining``, its request 200, and is respawned in its slot, while the
   elastic seam boots a third worker beside it; a worker SIGKILLed is
   ejected and respawned; the third worker answers its share and retires
   ring first; 4 paced dense clients see no
   non-200 through drain, crash, reload and the elastic seam; ``run-watchman``
   over the router reports all 27 machines healthy, then, under a ``probe``
   fault, that one machine unhealthy with the fault's message; every worker
   process that exited by SIGTERM launched ``flash_fwd_f32`` and
   ``flash_fwd_bf16`` 3 times per fp32 and bf16 PatchTST dispatch of its
   engines (read off its ``/metrics`` before each reload and its exit).
   Tier B: ``python -m gordo_components_tpu_torch.cli run-fleet-server
   --workers 2``, started beside Tier A's boot and checked before Tier A's
   first check, boots and answers 10 requests; its workers hold the card's
   device files open and the router none (nor maps libcuda; ``nvidia-smi
   --query-compute-apps=pid`` is printed and, where its pids are this
   namespace's, must list the workers and not the router); SIGTERM exits 0
   with no worker left. Printed with the card: the router's overhead
   (``TIER_OVERHEAD`` alternating pairs of routed and direct requests, dense
   and PatchTST: each side's p50, p99 and max, and the pairs' median
   difference with a 95 % bootstrap interval), worker boot, drain,
   eject and respawn-to-ready seconds, the reload's and rollback's walls.

15. the spill tier and the host path (``phase_spill``): one models root of
   ``SPILL_DENSE`` (64 ``dense_ae_10tag`` machines), the slice machine three
   times in fp32 (``SPILL_RELOAD`` a generation root), once in bf16, a
   ``dense_ae_10tag`` machine at int8 and the slice machine behind a
   MinMaxScaler and a StandardScaler (``SPILL_HOST``, which the engine
   cannot lift), with a ``FLEET_INDEX.json`` from the port's
   ``write_fleet_index``. The port's server boots it lazily
   (``GORDO_BOOT_EAGER=4``, a ``GORDO_HOST_CACHE_MB`` that holds two fp32
   PatchTST bundles but not three, sized from the bundle bytes the engine
   reports) and, beside it, eagerly. Checked: after boot the lazy server
   holds at least the lazy machines' stacked bytes less on the card; every
   lazy machine's first answer (a miss) and second (a hit) equal the eager
   server's lone answer byte for byte (npz), and the CPU plain path within
   SERVE_RTOL (bf16: BF16_SERVE_RTOL) over its first and last
   ``CPU_PLAIN_WINDOWS // 2`` windows; ``SPILL_SCHEDULE`` over the fp32
   PatchTST machines moves the host cache's hit, miss, store and evict
   counts as ``spill_lru_prediction`` says; ``POST /prefetch`` queues an
   untouched machine and names an unknown one, whose first request is then
   a hit, and a machine-scoped ``/healthz`` of another moves no counter;
   the host-path machine answers 200 on both servers, its estimator on the
   card, equal to its CPU pipeline within SERVE_RTOL over the same windows;
   a new generation of
   ``SPILL_RELOAD`` is listed ``refreshed`` by ``POST /reload`` on both
   servers, and its next request is a miss answering what the eager
   server, reloaded, answers, byte for byte, and not the old answer;
   ``flash_fwd_f32`` launched 3 times per fp32 PatchTST dispatch, stacked
   or spilled, and per host-path forward, ``flash_fwd_bf16`` 3 times per
   bf16 dispatch. Printed with the card: both boots' walls and device
   bytes, the miss, hit and eager request walls by rung, a bundle's
   host-to-device copy against a plain pinned ``copy_`` of 256 MiB, the
   prefetch loads' walls, the host path's walls against the eager fp32
   PatchTST request's.
16. fleet control (``phase_fleet_control``): one models root of 16
   ``dense_ae_10tag`` machines, the slice machine ``FC_SLICE`` with two
   generations of other seeds (``CURRENT`` on the newer), an eager fp32
   slice machine and two lazy ones, fp32 and bf16 (in the fleet index, out
   of ``GORDO_BOOT_EAGER``), under a host cache of two bundles, served by
   ``cli run-fleet-server --workers 2`` as a process (``FLEET_RUNNER``
   records each worker process's launches). ``/fleet`` is enabled with no
   spec and an empty diff. ``cli fleet apply`` of a spec pinning the older
   generation converges (``/metrics`` scraped until ``/fleet/diff`` is
   empty): ``CURRENT`` on disk and both workers' ``/healthz`` name it, the
   journal shows ``generation`` then ``adoption`` (worker-0, the canary,
   first), and a W = 16 request through the router equals an in-process
   eager server on the card over that generation's artifact byte for byte
   (npz), and not the newer one's. Skewed traffic (``FC_HOT`` hot, the lazy
   machines warm, ``FC_PACED`` paced throughout) feeds ``cli layout plan
   --cap 1 --parity-budget 0``, ``explain`` and ``apply``: after convergence
   each worker's ``/healthz`` ``layout`` and ``GET /layout`` carry the
   plan's fingerprint and pins, the router's ring weights are the plan's,
   each worker's host cache loads the hinted lazy machines it did not hold,
   and each hinted machine's next W = 16 request is a host-cache hit with
   no store read, equal to the eager server's answer byte for byte (and a
   second one, whose wall is a warm scorer's). ``cli
   fleet rollback`` clears the fingerprints and the weights; the paced
   clients saw no non-200. At SIGTERM every worker process's
   ``flash_fwd_f32`` launches are 3 per fp32 PatchTST dispatch, stacked or
   spilled, its ``flash_fwd_bf16`` 3 per bf16 one. Printed with the card:
   each step's convergence seconds, the longest scrape (a reload) and the
   rollback's wall, a hit's wall.
17. warm boot (``phase_warm_boot``): the other phases run with the
   kernel-library store off (``WB_OFF``), as they did before it; this
   phase serves a models tree of the full-width slice machine at fp32 and
   at bf16 by fresh ``cli run-server`` processes over the store the tree
   defaults to (``<models>/.compile-cache/torch-cuda``), ``nvcc`` reached
   through a wrapper first on ``PATH`` that logs each invocation. The cold
   boot compiles exactly the two forward libraries (2 misses, 2 writes); the
   warm boot, with no ``nvcc`` to be found (``PATH`` without one,
   ``CUDA_HOME`` empty, so it can run none), reads 2 hits and answers W =
   16 requests bit for bit as the cold boot did, and its ``/telemetry``
   compile block holds both entries with fp32 and bf16 build seconds,
   which the layout export's rungs carry; a flipped bit in the fp32
   entry's library (a boot beside the warm one, over hard links of the
   models and a copy of the store, with its own ``nvcc`` log) reads
   invalid, is rebuilt (one ``nvcc``) and written back, and the answers
   keep their bits; under ``CUDA_KERNEL_DEBUG=1`` the boot's own
   resolution (``_kernels.resolve``, in this process) makes 2 new entries,
   never a stale hit; ``cli cache list`` marks the entries
   ``current``/``verified``, ``cli cache purge --stale`` removes a damaged
   bf16 entry and the debug ones and leaves the current fp32 entry and a
   reference-format ``cc-*`` entry beside the port's subdirectory; ``cli
   fleet-build`` of two narrow PatchTST machines (129 patches), run beside
   the cold, warm and flipped boots with a log of its own, compiles the
   fp32 forward and backward for its fit and nothing for its serving
   export, and a boot over its output (beside the debug build and the
   cache verbs) compiles nothing and reads a hit.
   Printed with the card: every boot's wall from its start to a 200 on
   ``/healthz``, the ``nvcc`` counts, the compile block, the fleet build's
   wall. Its launches are every process's, recorded at exit.
18. lint and lock witness (``phase_lock_witness``, in a thread beside
   phase 16 once its fleet is up): the port's lint
   (``gordo_components_tpu_torch.analysis``, stdlib only) over this
   checkout on the card's host, which has no jax, pandas or ``requests``:
   0 fresh findings; the baselined count and each checker's seconds are
   printed. It runs in a thread beside the witness: a child process (``LW_CHILD``) with ``GORDO_LOCKCHECK=1``
   in its environment before the port is imported builds an in-process
   ``ModelServer`` on the card over a lazily booted tree: 8
   ``dense_ae_10tag`` machines, the full-width slice machine at fp32 (phase
   3's artifact) and at bf16, eager, and two lazy fp32 slice machines
   behind a host cache that holds one bundle (so they evict each other),
   with the kernel-library store under the tree empty at the start (the
   boot's warm-up resolves the forward libraries through the kernel
   loader's and the store's locks). 8 client threads score for
   ``LW_SECONDS``; meanwhile one ``POST /prefetch``, one ``POST /reload``
   (a dense machine rebuilt in place: a new engine, warmed under the
   reload lock), and reads of ``/slo``, ``/telemetry`` and ``/autopilot``.
   The child prints one JSON line: the witness's ``violations()`` and
   ``report()`` (both must be empty), its ``observed_edges()``, the flash
   launches per dtype against the PatchTST dispatches of every engine the
   child ran (3 each), the answers by status (no non-200), the host
   cache's evictions and prefetches. Phase 3's W = 16 request, asked again
   of the child, answers within ``FUSED_RTOL`` of phase 3's answer.
   Printed with the card: the edges that involve ``kernels.*``,
   ``compile_cache.*``, ``engine.template`` and ``engine.spill``, which
   only the card takes.
19. the multi-rank fleet build (``phase_multirank``): ``FLEET_BUILD``'s
   three buckets with their own kwargs at 16 dense, 4 LSTM and 2
   full-width PatchTST machines (``MR_COUNTS``), ``--slice-size 8`` (dense
   trains in two slices; of two ranks each owns one PatchTST machine), this
   process holding nothing on the card, every build's allocator on
   expandable segments. (b) first: two rank processes (CLI_RUNNER, a record
   each) of one gloo group on a free loopback port (once more on a fresh
   port when rank 0 could not bind it) into root B: both exit 0, their
   manifests (``fleet_manifest.json``, ``fleet_manifest.p1.json``)
   partition the fleet into the contiguous blocks of each slice that
   ``mr_owners`` computes, and each rank's fp32 flash forward and backward
   launches are ``fleet_flash_launches(rows)`` for its one PatchTST
   machine. Then (c) two ranks into root C under ``GORDO_SLICE_TIMEOUT_S``
   at ``MR_WATCHDOG_FACTOR`` x the worst healthy span the watchdog guards
   in B (each rank logs at DEBUG the plan's agreement and each slice's fit,
   artifacts and checkpoint; at least ``MR_WATCHDOG_FLOOR_S``), each
   rank's first machine of dense slice 1 fetched ``MR_HOLD_S`` late (a
   ``data-fetch`` latency fault, inside the budget): once both ranks' journals show their share of
   dense slice 0 committed, rank 1 is SIGSTOPped, rank 0 must exit 75 with
   the watchdog's line within the budget plus ``MR_GRACE_S``, then rank 1
   is SIGKILLed. Then (a) one ``cli fleet-build`` process into root A,
   alone on the card (its PatchTST slice stacks both slice machines, about
   all the card holds beside this process): its launches the same; every
   machine of B equals A's, its predictions (fixed rows, on the card) and
   thresholds within ``FLEET_THRESHOLD_RTOL`` and its loss history within
   ``TRAIN_RTOL`` (for the PatchTST machines, one alone per rank against
   the stack of both: phase 10's ``stacking_check``, for both). Last, both
   ranks again on C exit 0, their journals count every machine committed
   before as ``resumed``, every machine equals A's, and
   ``.slice_checkpoints`` is gone. Printed with the card: each process's
   wall, peak device memory and launches, the machines per hour of A and
   of the pair, B's slice walls, the drill's timings.
20. the fleet-sharded serving mesh (``phase_mesh``, in a thread beside
   phase 19's wedge drill, whose ranks sit mostly idle): one models root of the
   full-width slice machine in fp32 and in bf16 and four
   ``dense_ae_10tag`` machines (hard links of phase 14's artifacts,
   renamed ``MESH_SLICE``/``MESH_DENSE`` so that each of the two shards
   owns one slice machine and two dense ones), served by ``cli
   run-fleet-server --workers 2 --mesh-shards 2`` as a process
   (``FLEET_RUNNER`` records each worker process's launches); meanwhile an
   in-process single-host server over the same root answers each machine
   once (npz). Checked: the router holds no device file and maps neither
   libcuda nor libtorch, each worker holds the card's; each worker's
   ``/healthz`` ``mesh`` block is shard i of 2 owning
   ``plan.owned(...)`` (its ``machines``, and its
   ``gordo_mesh_shard_machines``); every machine's answer through the
   router carries ``X-Gordo-Shard`` and ``X-Gordo-Worker`` of its plan's
   owner and equals the single-host answer byte for byte, and each
   worker's ``gordo_mesh_requests_total{path="owned"}`` counts its
   machines' requests; the bf16 slice machine asked of the other shard
   straight (a miss, then a hit) and, with the owner of the fp32 one
   SIGKILLed, the fp32 one through the router (a miss, then a hit) are
   answered by the other shard, byte for byte the single-host answer (the
   tolerance phase 15 holds a spilled answer to: none), its
   ``path="fallback"`` count +2 and ``mesh_fallback`` in its timeline;
   the owner, respawned, answers again; every worker process's
   ``flash_fwd_f32`` launches are 3 per fp32 slice dispatch, stacked or
   spilled, its ``flash_fwd_bf16`` 3 per bf16 one. Printed with the card:
   the boot, the owner's way back, the single-host, owned and fallback
   (miss, hit) walls per rung, the dispatches and launches.
21. the host-sharded capacity mode and the partial residency tier
   (``phase_shard``, in the side process after 14, 15 and 17, whose
   artifacts it hard-links: ``SHARD_SOURCES``, the fp32 and the bf16 slice
   machine, 12 ``dense_ae_10tag`` machines and the int8 one, renamed). (a)
   ``cli cache warm --shard-fleet`` fills the store under the tree (both
   forward libraries written, in this process: copies of the libraries
   the earlier phases loaded); then a fresh ``cli run-server
   --shard-fleet`` process (CLI_RUNNER records its launches) with no
   ``nvcc`` on its PATH boots on store hits alone, while an in-process
   single-host server over the same artifacts answers each machine once
   (npz). Checked: ``/metrics`` ``shard_mesh_devices`` 1, megabatching
   off, the store's counts all hits; each machine asked 3 times with the
   same rows (cold, cold and promote, hot), every answer byte for byte the
   single-host one (the tolerance of phases 15 and 20: none);
   ``gordo_engine_requests_total{path}`` moved by 2 cold and 1 hot per
   machine, less the bucket's first machine's warm-up hit (``SHARD_BUCKETS``
   machines answer cold once and hot twice, as in the reference), and
   ``gordo_engine_hot_cache_events_total{promote}`` by the machines; a
   ``POST /reload`` with ``SHARD_ADDED`` joined keeps shard mode and the
   new machine answers the single-host bytes; the process's forward
   launches are 3 per fp32 and per bf16 slice dispatch. (b) in this process,
   ``ServingEngine(megabatch_residency=4)`` over the 12 dense machines and
   the fp32 slice machine: machines promote on their second hit, never
   more than 4 resident, a fifth kept out by the freshness guard; a resident
   machine's lone answer and a fused resident batch of 4 equal the cold
   path's bits for the same batch (its lone answers within FUSED_RTOL);
   ``apply_tuning(megabatch_residency=8)`` answers 8 (``residency_resize``
   +1); ``pin_residency`` seeds a pinned machine, whose next cold hit
   promotes it; the slice machine (a full bucket) answers the single-host
   bytes, 3 fp32 launches per dispatch. Printed with the card: the store's
   warm, the boot, the reload, the cold, cold and hot walls of a W = 16
   slice request beside the single-host one, each promotion's wall.
22. ring attention (``phase_ring``, in this process once the side is done,
   before phase 10): two ranks of one gloo group (this script with
   ``--ring-rank R``, a ``file://`` rendezvous) time-slice the card, each
   K/V hop staged through host memory. (a) ``ring_attention`` at the slice
   machine's widths and W = 16 with 180 patches (``RING_LOOKBACK`` 1448;
   the slice's 179 are prime), ``(1024, 180, 8, 64)``, 90 patches a rank:
   ``ring_flash`` and ``ring`` in fp32 and ``ring_flash`` in bf16, the
   output and dq, dk, dv of Σout² against the single-process
   ``flash_attention`` of the whole sequence (its autograd) and the plain
   version (dense attention in fp32), within ``RING_ATOL`` in fp32 and
   ``bf16_atol`` (output) or BF16_ULPS units of the largest grad in bf16;
   both ranks return
   the same output; each ``ring_flash`` call launches its dtype's forward
   kernel twice and its backward kernel twice per rank, ``ring`` none; a
   K/V hop alone is timed. (b) the full-width slice machine at
   ``ring_flash`` (lookback 1448) fitted for two Adam steps of one batch of
   8 windows on both ranks (the ring group set for the fit), 2 forward and
   2 backward launches per layer per step, the ranks' losses equal, and
   within TRAIN_RTOL of the same fit at ``flash`` in this process. (c) the
   slice machine (179 patches) built at ``ring_flash`` and at ``flash``
   from one seed, scored W = 16 by one ``ServingEngine`` here (one rank:
   one hop): the answers within SERVE_RTOL, 3 fp32 launches per dispatch.
   Printed with the card: each rank's join, wall, peak memory, hop walls,
   each call's forward and backward walls and errors, the fits' walls and
   losses, the engine's walls.
23. the numeric sanitizer (``phase_debug_nans``, in this process after
   phase 8b): ``--debug-nans``'s check of every operator's output. The slice
   machine of phase 3 with one NaN in its patch embedding (``dn_nan_weight``)
   raises ``FloatingPointError`` naming the op from the engine's scoring and
   from an Adam step; ``sqrt(square(x @ v))`` at ``v = 0`` raises from its
   backward, on autograd's device thread, where a hook sees the sanitizer;
   an ``inf`` in one q entry raises at ``gordo::flash_fwd`` in fp32 and bf16,
   and without the flag each kernel marks NaN the rows its plain version
   marks; ``run-server`` with ``GORDO_DEBUG_NANS=1`` (a process, beside the
   checks) answers the clean machine 200 and the NaN one 503 (quarantined),
   as the CPU test holds. Then, under the flag, a W = 16 fp32 answer and a
   bf16 one (phases 3 and 3b's artifacts) and one fp32 Adam step of batch
   32 give the unflagged bytes through the kernels (3 launches an answer,
   3 + 3 the step). Printed with the card: each unit's wall with and
   without the flag, the ops named.

Every phase prints its wall (``phase wall``), and the script its total.
The script runs in 1200 s at most, build included, and aims at 1000: for
that, work that would wait runs beside other work, every check kept
(phases 9b, 14, 17, 18 beside 16, 20 beside 19's drill; PERF.md §5 lists
each cut). After phase 2, phases 11, 13, 14, 15, 17 and 21 run in a second
process of this script (``--side``, ``SIDE_PHASES``) beside phases 3-9b,
23, 12 and 16 in this one, in order 3-8b, 23, 9, 9b, 12, 16 (18 beside
it); phases 10 and 19 (20 beside its drill), which need about all of the
card, run once both are done, after phase 22. The side's stdout follows this process's
phases. A thread
samples the card's memory in use (every process on it), and its peak
during each phase is printed before the script's wall; each phase's start
goes to stderr, and every thread's stack too after ``DUMP_STACKS_S``.
This process's allocator runs on expandable segments, so that
it gives the card back before phase 19's builds.

The line before last is ``nvidia-smi``'s name and power limit; the one
before that the kernels' JSON record; the last line is the result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import Counter

import numpy as np

SEED = 0
N_TAGS = 64
LOOKBACK = 1440  # one day at 1-minute resolution
SLICE = dict(patch_length=16, stride=8, d_model=512, n_heads=8, n_layers=3, ff_dim=1024)
# windows per request (each scored again on the CPU plain path, ~12 s at W =
# 16 on the card's host, so every window count is asked once)
WINDOWS = (1, 16, 64)
# phases 3, 14 and 15 hold this many windows of a PatchTST answer, half from
# each end, against the CPU plain path: each window scores alone, and the
# whole answers took 188 s of the script on the CPU (PR 15)
CPU_PLAIN_WINDOWS = 4
# card peaks (NVIDIA H100 SXM data sheet, dense): fp32 outside the tensor
# cores, bf16 on the tensor cores, and device memory bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
FP32_ATOL = 2e-5  # summation order only (the reference's kernel-vs-dense bound)
BF16_ATOL = 2e-2  # compared in bf16: one rounding of outputs near 1
# bf16 outputs are also held to BF16_ULPS units in the last place of the
# largest |plain| output (see bf16_atol): the plain version computes in fp32
# from the same bf16 inputs and rounds once; the kernel rounds P to bf16
# (2^-9 relative, ~1e-4 absolute on an output) and rounds once, so the two
# differ by about one ulp. A key dropped or doubled in P·V alone moves an
# output by about |v| / S, ~1e-2 at S = 179, which BF16_ATOL lets through.
BF16_ULPS = 4
LSE_ATOL = 1e-4  # lse is float32 on both sides from the same inputs
# the flash backward in float32, kernel vs plain version on the same saved
# forward: float32 on both sides, the products summed in other orders and
# exp on the MUFU unit (~2 ulp); relative to the largest grad, since a
# grad sums S products of O(1) terms. A dropped key or a wrong mask is O(1)
FP32_BWD_RTOL = 2e-5
# served scores, GPU vs CPU plain path, relative to the array's magnitude:
# float32 on both sides, GEMMs and the online softmax sum in other orders
# (1e-6 .. 1e-5 relative); a wrong mask or layout is an O(1) error
SERVE_RTOL = 1e-4
# bf16 served scores, flash kernel vs dense attention, both on the card in
# bf16: the dense path rounds its logits and softmax weights to bf16 (2^-9
# relative each, ~1e-2 absolute on a logit of a few units), the kernel
# keeps fp32 scores and rounds only P; three layers carry that into the
# scores, ~1e-2 relative. A wrong mask, layout or transpose is O(1).
BF16_SERVE_RTOL = 5e-2


FAILED_WITH = []  # fail()'s messages in this process: the side reports the last


def fail(message: str) -> None:
    FAILED_WITH.append(message)
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def bf16_atol(ref) -> float:
    """The bf16 output tolerance against the plain output ``ref``:
    BF16_ULPS units in the last place of its largest magnitude (bf16 keeps
    8 significant bits), never more than BF16_ATOL."""
    top = ref.float().abs().max().item()
    return min(BF16_ATOL, BF16_ULPS * math.ldexp(1.0, math.frexp(top)[1] - 8))


def bwd_atol(ref) -> float:
    """The flash backward's tolerance against its plain version on the same
    saved forward: float32 grads within FP32_BWD_RTOL of the largest |plain|
    grad (at least of 1); bfloat16 grads within :func:`bf16_atol`, and never
    below FP32_BWD_RTOL: a grad that cancels to ~0 (one key: dP = delta)
    is float32 rounding noise on both sides, which bf16 keeps."""
    import torch

    if ref.dtype == torch.bfloat16:
        return max(bf16_atol(ref), FP32_BWD_RTOL)
    return FP32_BWD_RTOL * max(1.0, ref.abs().max().item())


def timed_ms(fn, iters: int = 10) -> float:
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(bh: int, seq: int, d: int, dtype) -> dict:
    """Least time for the flash forward on these inputs: q, k, v read once,
    out and lse written once; 4·BH·S²·D operations (two products)."""
    import torch

    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * bh * seq * d * elem + bh * seq * 4
    flops = 4 * bh * seq * seq * d
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")] * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "gflop": flops / 1e9,
        "gbytes": nbytes / 1e9,
    }


def library_view(t3, heads: int = SLICE["n_heads"]):
    """The ``(W·tags, H, S, D)`` view of a ``(BH, S, D)`` tensor: the port
    flattens ``(..., H, S, D)`` with the heads innermost, so this is the same
    memory. PyTorch's fused attention backends take only 4-D inputs; on 3-D
    inputs ``scaled_dot_product_attention`` runs its math backend, which
    materialises the score matrix."""
    bh, seq, d = t3.shape
    return t3.view(bh // heads, heads, seq, d)


def library_backend(dtype) -> str:
    """The fused backend that is the yardstick: FlashAttention-2 in bf16, the
    memory-efficient kernel in fp32 (FlashAttention takes no fp32)."""
    return "FLASH_ATTENTION" if str(dtype) == "torch.bfloat16" else "EFFICIENT_ATTENTION"


def time_library(torch, F, q, k, v, scale: float):
    """One PyTorch call computing the same function, as a yardstick only (the
    port never calls it): SDPA on the 4-D view with its fused backend forced.
    If that backend refuses the inputs the phase fails: the math backend is
    never what gets timed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    name = library_backend(q.dtype)
    q4, k4, v4 = (library_view(t) for t in (q, k, v))
    try:
        with sdpa_kernel(getattr(SDPBackend, name)):
            ms = timed_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
    except RuntimeError as exc:
        fail(f"SDPA backend {name} refused {tuple(q4.shape)} {q4.dtype}: {exc}")
    return name, ms


def phase_environment():
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    from gordo_components_tpu_torch.ops import _kernels

    seconds = _kernels.build_all()
    print(f"kernels built in {seconds:.1f} s: {sorted(_kernels.SOURCES)}")
    return card


SLICE_SHAPE = (16 * N_TAGS * SLICE["n_heads"], (LOOKBACK - 16) // 8 + 1, 64)
# every kernel is held against its plain version at these shapes, in both
# dtypes: the slice shape, S = 64 / 65 (one tile and one past it), S = 256,
# S = 300 at D = 128 (the q-block split and the two-half head), and D = 12
# (the bf16 kernel's plain-load path, where TMA's 16-byte stride rule fails).
# The last three have BH far above the blocks the card holds at once (132
# SMs, a few blocks each), so every persistent block walks several work
# items, as at the slice shape, in every instantiation: fp32 at D <= 32
# and D = 128, bf16's two-half head and its plain-load path.
# a fused dispatch of the four-machine PatchTST fleet at W = 16 (phase 5)
FUSED_SHAPE = (4 * SLICE_SHAPE[0], *SLICE_SHAPE[1:])
CHECK_SHAPES = [SLICE_SHAPE, FUSED_SHAPE, (12, 129, 16), (3, 37, 8), (4, 64, 64), (4, 65, 64),
                (4, 256, 64), (5, 300, 128), (2, 37, 12),
                (4096, 65, 32), (2048, 300, 128), (1024, 129, 12)]
KERNELS = {  # kernel name -> (dtype, source)
    "flash_fwd_f32": ("float32", "gordo_components_tpu_torch/csrc/flash_fwd_f32.cu"),
    "flash_fwd_bf16": ("bfloat16", "gordo_components_tpu_torch/csrc/flash_fwd_bf16.cu"),
    "flash_bwd_f32": ("float32", "gordo_components_tpu_torch/csrc/flash_bwd_f32.cu"),
    "flash_bwd_bf16": ("bfloat16", "gordo_components_tpu_torch/csrc/flash_bwd_bf16.cu"),
}
FWD_KERNELS = ("flash_fwd_f32", "flash_fwd_bf16")
BWD_KERNELS = ("flash_bwd_f32", "flash_bwd_bf16")
REPLACES = {  # the TPU kernel each replaces
    **dict.fromkeys(FWD_KERNELS, "gordo_components_tpu/ops/flash_attention.py:157"),
    **dict.fromkeys(BWD_KERNELS, "gordo_components_tpu/ops/flash_attention.py:187-229"),
}
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)
# the backward at the training step's shape (batch 32 x 64 tags x 8 heads)
TRAIN_SHAPE = (32 * N_TAGS * SLICE["n_heads"], SLICE_SHAPE[1], SLICE_SHAPE[2])
# the fleet build's PatchTST step (phase 10): two machines stacked, BH = 2 x 16384
# (the same shape as FUSED_SHAPE)
FLEET_TRAIN_SHAPE = (2 * TRAIN_SHAPE[0], *TRAIN_SHAPE[1:])
# the fleet build's PatchTST predict chunks (phase 10): 128 windows (four
# batches of 32) per machine, the two machines stacked, and one machine
# alone (the M = 1 fits that phase 10 holds the stack to)
FLEET_PREDICT_SHAPE = (2 * 128 * N_TAGS * SLICE["n_heads"], *TRAIN_SHAPE[1:])
ALONE_PREDICT_SHAPE = (FLEET_PREDICT_SHAPE[0] // 2, *TRAIN_SHAPE[1:])
# phase 12's client chunks: CLIENT_WINDOWS windows a chunk, up to
# CLIENT_PARALLELISM chunks of the two machines in one fused dispatch
CLIENT_WINDOWS = 32
CLIENT_PARALLELISM = 4
CLIENT_SHAPES = [(k * CLIENT_WINDOWS * N_TAGS * SLICE["n_heads"], *SLICE_SHAPE[1:])
                 for k in range(1, CLIENT_PARALLELISM + 1)]
# the fp32 forward is also held at its training and fleet shapes: a step of
# one machine (phases 8, 9 and the M = 1 fits), of the stacked two and the
# predict chunks, and at the client's chunks; bf16 runs at none of them
FWD_F32_PATH_SHAPES = list(dict.fromkeys([TRAIN_SHAPE, FLEET_TRAIN_SHAPE, ALONE_PREDICT_SHAPE,
                                          FLEET_PREDICT_SHAPE, *CLIENT_SHAPES]))
# the plain versions run over BH slices of this many sequences, so that their
# float32 S x S matrices stay near 2 GiB each at S = 179 (sequences are
# independent: the slices compute the same numbers)
PLAIN_BH = 16384
# sequences past what a backward block holds at once (192 rows at D <= 64,
# 64 above in fp32; three key tiles at D <= 64, two above in bf16): the
# block walks them in chunks, summing across chunks in memory only it writes
LONG_SHAPES = [(64, 700, 64), (64, 700, 128)]


def plain_in_slices(torch, fn, *tensors) -> tuple:
    """``fn`` over PLAIN_BH slices of the ``(BH, ...)`` tensors (None passes
    through), its outputs concatenated along BH."""
    bh = tensors[0].shape[0]
    parts = [fn(*(None if t is None else t[i:i + PLAIN_BH] for t in tensors))
             for i in range(0, bh, PLAIN_BH)]
    return tuple(torch.cat(p) for p in zip(*parts))


def phase_kernels(torch, device) -> dict:
    """Each flash kernel against flash_fwd_reference on the card, then its
    time beside the plain version's and the library yardstick's."""
    import torch.nn.functional as F

    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_fwd_reference,
    )

    gen = torch.Generator(device=device).manual_seed(SEED)

    def qkv(shape, dtype):
        return [(0.5 * torch.randn(shape, generator=gen, device=device)).to(dtype)
                for _ in range(3)]

    def check(name, launch, shape, dtype):
        q, k, v = qkv(shape, dtype)
        scale = shape[-1] ** -0.5
        out, lse = launch(q, k, v, scale)
        ref_out, ref_lse = plain_in_slices(
            torch, lambda *t: flash_fwd_reference(*t, scale), q, k, v)
        torch.cuda.synchronize()
        atol = FP32_ATOL if dtype == torch.float32 else bf16_atol(ref_out)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        print(f"{name} {tuple(shape)}: max|out-plain| {err:.3g} (atol {atol:.3g}), "
              f"max|lse-plain| {lse_err:.3g} (atol {LSE_ATOL})")
        if not (err <= atol and lse_err <= LSE_ATOL):
            fail(f"{name} disagrees with its plain version at {shape}")
        return err

    record = {}
    for name in FWD_KERNELS:
        dtype = getattr(torch, KERNELS[name][0])
        shapes = CHECK_SHAPES + (FWD_F32_PATH_SHAPES if name == "flash_fwd_f32" else [])
        errs = [check(name, _kernels.flash_fwd_cuda, shape, dtype)
                for shape in dict.fromkeys(shapes)]
        record[name] = {"max_abs_err": max(errs)}
        torch.cuda.empty_cache()
    # the bf16 kernel's first build-up step (one warpgroup, one stage)
    for shape in (SLICE_SHAPE, (5, 300, 128)):
        check("flash_fwd_bf16 single-stage step", _kernels.flash_fwd_bf16_single_stage,
              shape, torch.bfloat16)
    # the public entry with small blocks: (B, S, H, D) layout into the kernel
    q, k, v = qkv((1, 37, 3, 8), torch.float32)
    before = _kernels.LAUNCHES["flash_fwd_f32"]
    out = flash_attention(q, k, v, block_q=8, block_k=8)
    ref = flash_attention(*(t.cpu() for t in (q, k, v)), block_q=8, block_k=8)
    err = (out.cpu() - ref).abs().max().item()
    print(f"flash_attention (1, 37, 3, 8) blocks 8: max|cuda-cpu| {err:.3g}")
    if err > FP32_ATOL or _kernels.LAUNCHES["flash_fwd_f32"] != before + 1:
        fail("flash_attention on the card did not match the CPU path through the kernel")

    # times at the slice shape, in turns: kernel, plain, library, kernel
    for name in FWD_KERNELS:
        dtype = getattr(torch, KERNELS[name][0])
        q, k, v = qkv(SLICE_SHAPE, dtype)
        scale = SLICE_SHAPE[-1] ** -0.5
        ms_first = timed_ms(lambda: _kernels.flash_fwd_cuda(q, k, v, scale))
        plain_ms = timed_ms(lambda: flash_fwd_reference(q, k, v, scale), iters=3)
        library, library_ms = time_library(torch, F, q, k, v, scale)
        ms_second = timed_ms(lambda: _kernels.flash_fwd_cuda(q, k, v, scale))
        ms = (ms_first + ms_second) / 2
        bound = attention_bound(*SLICE_SHAPE, dtype)
        print(f"{name} {SLICE_SHAPE}: kernel {ms:.4f} ms ({ms_first:.4f}, {ms_second:.4f}), "
              f"plain {plain_ms:.4f} ms, sdpa {library} {library_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: {bound['gflop']:.1f} GFLOP, "
              f"{bound['gbytes']:.3f} GB); achieved {bound['gflop'] / ms:.1f} TFLOP/s, "
              f"{bound['gbytes'] / ms:.3f} TB/s, {100 * bound['bound_ms'] / ms:.1f} % of bound")
        record[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, library=library,
                            shape_ms={SLICE_SHAPE[0]: ms}, **bound)
        del q, k, v
        # the fused dispatch and fleet step; the fp32 predict chunks, with the
        # library beside them (the plain version would need ~70 GiB there),
        # and the client's chunks (phase 12 reads these times)
        for shape in dict.fromkeys([FUSED_SHAPE] + ([ALONE_PREDICT_SHAPE, FLEET_PREDICT_SHAPE,
                                                     *CLIENT_SHAPES]
                                                    if name == "flash_fwd_f32" else [])):
            q, k, v = qkv(shape, dtype)
            shape_ms = timed_ms(lambda: _kernels.flash_fwd_cuda(q, k, v, scale))
            record[name]["shape_ms"][shape[0]] = shape_ms
            library_text = ""
            if shape in (ALONE_PREDICT_SHAPE, FLEET_PREDICT_SHAPE):
                library, shape_library_ms = time_library(torch, F, q, k, v, scale)
                library_text = f", sdpa {library} {shape_library_ms:.4f} ms"
            shape_bound = attention_bound(*shape, dtype)
            print(f"{name} {shape}: kernel {shape_ms:.4f} ms{library_text}, bound "
                  f"{shape_bound['bound_ms']:.4f} ms ({shape_bound['bound_by']}), "
                  f"{100 * shape_bound['bound_ms'] / shape_ms:.1f} % of bound")
            del q, k, v
            torch.cuda.empty_cache()
    record.update(phase_kernels_bwd(torch, device))
    return record


def bwd_bound(bh: int, seq: int, d: int, dtype, dlse: bool = False) -> dict:
    """Least time for the flash backward on these inputs: q, k, v, out, dout
    and lse (and dlse) read once, dq, dk, dv written once; 10·BH·S²·D
    operations (five S x S x D products) at the peak rate of the inputs'
    type."""
    import torch

    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = 8 * bh * seq * d * elem + (2 if dlse else 1) * bh * seq * 4
    flops = 10 * bh * seq * seq * d
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")] * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "gflop": flops / 1e9,
        "gbytes": nbytes / 1e9,
    }


def time_library_bwd(torch, F, q, k, v, do, scale: float):
    """The library yardstick of the backward: ``torch.autograd.grad`` of SDPA
    on the 4-D view with its fused backend forced, the backward alone timed
    (the forward's graph is kept and differentiated again each time)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    name = library_backend(q.dtype)
    q4, k4, v4 = (library_view(t).detach().requires_grad_() for t in (q, k, v))
    try:
        with sdpa_kernel(getattr(SDPBackend, name)):
            out = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            ms = timed_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), library_view(do),
                                                      retain_graph=True))
    except RuntimeError as exc:
        fail(f"SDPA backend {name} refused the backward at {tuple(q4.shape)} {q4.dtype}: {exc}")
    return name, ms


def phase_kernels_bwd(torch, device) -> dict:
    """The flash backward (csrc/flash_bwd_f32.cu, csrc/flash_bwd_bf16.cu)
    against flash_bwd_reference on the card, from the plain forward's saved
    out and lse, at CHECK_SHAPES, the training and fleet step shapes and
    LONG_SHAPES (the plain version over PLAIN_BH slices), with
    and without an lse cotangent, in both dtypes; two launches at the
    training shape bit-identical (no atomics, a fixed order of sums); then
    its time beside the plain version's, the library backward's and the
    bound, at the slice and the training shapes."""
    import torch.nn.functional as F

    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.ops.flash_attention import (
        flash_bwd_reference,
        flash_fwd_reference,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 11)

    def inputs(shape, dtype):
        q, k, v, do = [(0.5 * torch.randn(shape, generator=gen, device=device)).to(dtype)
                       for _ in range(4)]
        out, lse = plain_in_slices(
            torch, lambda *t: flash_fwd_reference(*t, shape[-1] ** -0.5), q, k, v)
        return q, k, v, out, lse, do

    record = {}
    for name in BWD_KERNELS:
        dtype = getattr(torch, KERNELS[name][0])
        worst = 0.0
        for shape in dict.fromkeys(CHECK_SHAPES + [TRAIN_SHAPE, FLEET_TRAIN_SHAPE] + LONG_SHAPES):
            q, k, v, out, lse, do = inputs(shape, dtype)
            scale = shape[-1] ** -0.5
            for dlse in (None, torch.randn(shape[:2], generator=gen, device=device)):
                grads = _kernels.flash_bwd_cuda(q, k, v, out, lse, do, scale, dlse)
                plain = plain_in_slices(
                    torch, lambda *t: flash_bwd_reference(*t[:6], scale, t[6]),
                    q, k, v, out, lse, do, dlse)
                torch.cuda.synchronize()
                errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, plain)]
                atols = [bwd_atol(r) for r in plain]
                print(f"{name} {tuple(shape)} {'dlse' if dlse is not None else 'no dlse'}: "
                      f"max|d{{q,k,v}}-plain| {', '.join(f'{e:.3g}' for e in errs)} "
                      f"(atol {', '.join(f'{a:.3g}' for a in atols)})")
                if any(e > a for e, a in zip(errs, atols)):
                    fail(f"{name} disagrees with its plain version at {shape}")
                worst = max(worst, *errs)
                del grads, plain
            del q, k, v, out, lse, do
        torch.cuda.empty_cache()
        q, k, v, out, lse, do = inputs(TRAIN_SHAPE, dtype)
        dlse = torch.randn(TRAIN_SHAPE[:2], generator=gen, device=device)
        scale = TRAIN_SHAPE[-1] ** -0.5
        first = _kernels.flash_bwd_cuda(q, k, v, out, lse, do, scale, dlse)
        second = _kernels.flash_bwd_cuda(q, k, v, out, lse, do, scale, dlse)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        print(f"{name} {TRAIN_SHAPE}: two launches bit-identical: {same}")
        if not same:
            fail(f"{name} gives different grads from run to run at {TRAIN_SHAPE}")
        del q, k, v, out, lse, do, dlse, first, second
        torch.cuda.empty_cache()
        record[name] = {"max_abs_err": worst}
        # times, in turns: kernel, plain, library, kernel; the training shape
        # last (its numbers are the kernels line's), the fleet step's before it
        for shape in (SLICE_SHAPE, FLEET_TRAIN_SHAPE, TRAIN_SHAPE):
            q, k, v, out, lse, do = inputs(shape, dtype)
            scale = shape[-1] ** -0.5
            ms_first = timed_ms(lambda: _kernels.flash_bwd_cuda(q, k, v, out, lse, do, scale))
            plain_ms = timed_ms(lambda: flash_bwd_reference(q, k, v, out, lse, do, scale), iters=3)
            library, library_ms = time_library_bwd(torch, F, q, k, v, do, scale)
            ms_second = timed_ms(lambda: _kernels.flash_bwd_cuda(q, k, v, out, lse, do, scale))
            ms = (ms_first + ms_second) / 2
            bound = bwd_bound(*shape, dtype)
            print(f"{name} {shape}: kernel {ms:.4f} ms ({ms_first:.4f}, {ms_second:.4f}), "
                  f"plain {plain_ms:.4f} ms, sdpa backward {library} {library_ms:.4f} ms, "
                  f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
                  f"{bound['gflop']:.1f} GFLOP, {bound['gbytes']:.3f} GB); achieved "
                  f"{bound['gflop'] / ms:.1f} TFLOP/s, {100 * bound['bound_ms'] / ms:.1f} % of bound")
            record[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, library=library,
                                **bound, shape=list(shape))
            del q, k, v, out, lse, do
            torch.cuda.empty_cache()
    return record


def slice_weights(rng: np.random.Generator) -> dict:
    """Random PatchTST weights in the flax layout (what ``state.npz``
    holds under ``…/params``): Dense kernels ``(in, out)`` at 1/sqrt(fan_in)."""
    d, h, ff, pl = SLICE["d_model"], SLICE["n_heads"], SLICE["ff_dim"], SLICE["patch_length"]
    n_patches = (LOOKBACK - pl) // SLICE["stride"] + 1

    def dense(shape_in, shape_out):
        fan_in = int(np.prod(shape_in))
        return {
            "kernel": (rng.normal(size=(*shape_in, *shape_out)) / np.sqrt(fan_in)).astype(np.float32),
            "bias": (0.01 * rng.normal(size=shape_out)).astype(np.float32),
        }

    def norm():
        return {"scale": (1 + 0.05 * rng.normal(size=d)).astype(np.float32),
                "bias": (0.05 * rng.normal(size=d)).astype(np.float32)}

    tree = {
        "Dense_0": dense((pl,), (d,)),
        "pos_embedding": (0.02 * rng.normal(size=(n_patches, d))).astype(np.float32),
    }
    for i in range(SLICE["n_layers"]):
        tree[f"TransformerEncoderLayer_{i}"] = {
            "LayerNorm_0": norm(),
            "MultiHeadSelfAttention_0": {
                "qkv": dense((d,), (3, h, d // h)),
                "out": dense((h, d // h), (d,)),
            },
            "LayerNorm_1": norm(),
            "Dense_0": dense((d,), (ff,)),
            "Dense_1": dense((ff,), (d,)),
        }
    tree["LayerNorm_0"] = norm()
    tree["Dense_1"] = dense((n_patches * d,), (1,))
    return tree


def sensor_rows(rng: np.random.Generator, n: int, tags: int = N_TAGS) -> np.ndarray:
    """Seeded plant-like signals: per-tag level and scale, slow drift, noise."""
    t = np.arange(n)[:, None]
    level = rng.uniform(-50, 150, size=tags)
    scale = rng.uniform(0.5, 20, size=tags)
    phase = rng.uniform(0, 2 * np.pi, size=tags)
    wave = np.sin(2 * np.pi * t / 720 + phase)
    return (level + scale * (wave + 0.3 * rng.normal(size=(n, tags)))).astype(np.float32)


def build_artifact(dest: str, device, compute_dtype: str = "float32", seed: int = SEED,
                   precision: str = None, scalers: tuple = ("MinMaxScaler",),
                   attention_impl: str = "flash") -> list:
    """The slice machine with seeded weights and scalers, dumped by the port
    (at ``precision``: its metadata pins the rung, and at int8
    ``write_artifact_files`` writes the quantized sidecar). ``scalers``: the
    input transformers before the estimator, each fitted on the one
    before's output."""
    from gordo_components_tpu_torch.serializer import dump, pipeline_from_definition

    rng = np.random.default_rng(seed)
    definition = {
        "DiffBasedAnomalyDetector": {
            "base_estimator": {
                "TransformedTargetRegressor": {
                    "regressor": {
                        "Pipeline": {
                            "steps": [
                                *scalers,
                                {"PatchTSTAutoEncoder": {
                                    "kind": "patchtst", "lookback_window": LOOKBACK,
                                    "attention_impl": attention_impl,
                                    "compute_dtype": compute_dtype,
                                    **SLICE,
                                }},
                            ]
                        }
                    },
                    "transformer": "MinMaxScaler",
                }
            }
        }
    }
    model = pipeline_from_definition(definition)
    ttr = model.base_estimator
    *transformers, est = (step for _, step in ttr.regressor.steps)
    train = sensor_rows(rng, 4 * LOOKBACK)
    rows_in = train
    for transformer in transformers:
        transformer.fit(rows_in)
        rows_in = transformer.transform(rows_in)
    ttr.transformer.fit(train)
    est.to(device)
    est.set_state({"params": slice_weights(rng), "n_features": N_TAGS,
                   "n_features_out": N_TAGS, "history": [], "fit_duration": None})
    # the error scaler and thresholds on residuals of the tail of the data
    tail = train[-(LOOKBACK + 127):]
    pred = model.predict(tail)
    residual = np.abs(tail[len(tail) - len(pred):] - pred)
    model.scaler.fit(residual)
    scaled = model.scaler.transform(residual)
    model.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
    model.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    tags = [f"TAG-{i:03d}" for i in range(N_TAGS)]
    dump(model, dest, metadata=artifact_metadata(tags, precision), precision=precision)
    return tags


def artifact_metadata(tags: list, precision: str = None) -> dict:
    metadata = {"dataset": {"tag_list": tags}}
    if precision is not None:
        metadata["precision"] = precision
    return metadata


def post(url: str, X: np.ndarray) -> tuple:
    """POST ``{"X": rows}``; returns (HTTP status, payload, wall ms)."""
    return post_body(url, json.dumps({"X": X.tolist()}).encode())


def http(method: str, url: str, body: bytes = None, headers: dict = None) -> tuple:
    """One HTTP request; returns (status, response headers, body bytes,
    wall ms)."""
    req = urllib.request.Request(url, data=body, method=method, headers={
        "Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, reply, raw = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        status, reply, raw = exc.code, dict(exc.headers), exc.read()
    return status, reply, raw, (time.perf_counter() - t0) * 1e3


def decode(reply: dict, raw: bytes) -> dict:
    """A scoring response's payload, from JSON or from the npz wire format
    (its arrays then numpy arrays)."""
    from gordo_components_tpu_torch import wire

    if wire.content_type_of(reply.get("Content-Type")) == wire.NPZ_CONTENT_TYPE:
        return wire.payload_from_npz(raw)
    return json.loads(raw)


def post_body(url: str, body: bytes, npz: bool = False) -> tuple:
    """POST an encoded JSON body, asking for the npz wire format if ``npz``;
    returns (HTTP status, payload, wall ms)."""
    from gordo_components_tpu_torch import wire

    headers = {"Accept": wire.NPZ_CONTENT_TYPE} if npz else None
    status, reply, raw, ms = http("POST", url, body, headers)
    return status, decode(reply, raw), ms


def serve(artifact: str, device, windows, rng) -> list:
    """POST one request of each window count to the port's HTTP server on
    the card, one at a time. The launch counts are zeroed just before the
    first request and read after each; returns (X, payload, launches by
    kernel, engine dispatches) per request."""
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.server.server import make_server

    httpd = make_server(artifact, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           f"/gordo/v0/project/{os.path.basename(artifact)}/anomaly/prediction")
    engine = httpd.model_server.engine
    results = []
    try:
        _kernels.reset_launches()
        for w in windows:
            X = sensor_rows(rng, LOOKBACK + w - 1)
            before = dict(_kernels.LAUNCHES)
            dispatches = engine.stats()["dispatches"]
            status, payload, ms = post(url, X)
            launches = {n: _kernels.LAUNCHES[n] - before[n] for n in KERNELS}
            dispatches = engine.stats()["dispatches"] - dispatches
            print(f"POST W={w} ({len(X)} rows): HTTP {status}, {ms:.1f} ms, "
                  f"{dispatches} dispatch(es), launches {launches}")
            if status != 200:
                fail(f"HTTP {status} for W={w}")
            results.append((X, payload, launches, dispatches))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return results


def cpu_plain_parts(X: np.ndarray) -> list:
    """The row blocks of a request that the CPU plain path scores: those of
    its first and of its last ``CPU_PLAIN_WINDOWS // 2`` windows (a request
    of no more windows, or a dense one shorter than a lookback, whole).
    Each window scores alone, so they answer the answer's first and last
    rows (:func:`end_rows`)."""
    half = CPU_PLAIN_WINDOWS // 2
    if len(X) < LOOKBACK or len(X) - LOOKBACK + 1 <= CPU_PLAIN_WINDOWS:
        return [X]
    return [X[:LOOKBACK + half - 1], X[len(X) - (LOOKBACK + half - 1):]]


def cpu_plain_answer(score, X: np.ndarray) -> dict:
    """``score(rows)`` (a dict of arrays, a row per window) over each of
    :func:`cpu_plain_parts`, joined along the rows."""
    parts = [score(rows) for rows in cpu_plain_parts(X)]
    return {field: np.concatenate([np.asarray(part[field]) for part in parts])
            for field in parts[0]}


def end_rows(data: dict, rows: int) -> dict:
    """An answer's four score arrays at the ``rows`` rows that
    :func:`cpu_plain_answer` scored: the first ``rows // 2`` and the last
    ``rows - rows // 2`` (every row where ``rows`` is the answer's)."""
    head = rows // 2

    def ends(array):
        array = np.asarray(array)
        return np.concatenate([array[:head], array[len(array) - (rows - head):]])

    return {field: ends(data[field]) for field in (
        "model-input", "model-output", "tag-anomaly-scores", "total-anomaly-score")}


def compare_arrays(label: str, w: int, data: dict, plain: dict, rtol: float,
                   tags: int = N_TAGS) -> float:
    """The four score arrays (``w`` rows of ``tags``) against another
    scoring of the same rows: shapes, finiteness, and the worst difference
    relative to each array's magnitude."""
    expected = {"model-input": (w, tags), "model-output": (w, tags),
                "tag-anomaly-scores": (w, tags), "total-anomaly-score": (w,)}
    worst = 0.0
    for field, shape in expected.items():
        got = np.asarray(data[field], np.float64)
        if got.shape != shape or not np.isfinite(got).all():
            fail(f"{label} W={w}: {field} has shape {got.shape} (want {shape}) or non-finite values")
        ref = plain[field].astype(np.float64)
        rel = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
        worst = max(worst, rel)
        if rel > rtol:
            fail(f"{label} W={w}: {field} differs by {rel:.3g} (relative, limit {rtol})")
    return worst


def compare_scores(label: str, w: int, payload: dict, plain: dict, rtol: float,
                   tags: int = N_TAGS) -> float:
    """A response's score arrays against ``plain`` (:func:`compare_arrays`),
    and its thresholds."""
    worst = compare_arrays(label, w, payload["data"], plain, rtol, tags)
    if len(payload["tag-thresholds"]) != tags:
        fail("thresholds missing from the response")
    return worst


# phase 3's answers by window count: (rows, the answer's data), which
# phase 18 asks again of a server under the lock witness
SERVED = {}


def phase_serve(torch, device, tmp: str) -> dict:
    """The main path in float32: the slice machine served over HTTP; each
    dispatch (one per lone request) launches the fp32 kernel once per layer,
    and each response matches the CPU plain path."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine

    artifact = os.path.join(tmp, "turbine-long-window")
    started = time.perf_counter()
    build_artifact(artifact, device)
    print(f"artifact written in {time.perf_counter() - started:.1f} s: {sorted(os.listdir(artifact))}")
    results = serve(artifact, device, WINDOWS, np.random.default_rng(SEED + 1))
    SERVED.update({w: (X, payload["data"]) for w, (X, payload, _, _) in zip(WINDOWS, results)})
    per_request = [r[2]["flash_fwd_f32"] for r in results]
    if any(r[3] != 1 for r in results) or any(n != SLICE["n_layers"] for n in per_request) or any(
            r[2][n] for r in results for n in ("flash_fwd_bf16", *BWD_KERNELS)):
        fail(f"fp32 kernel launches per request {per_request} in dispatches "
             f"{[r[3] for r in results]}: expected one dispatch of {SLICE['n_layers']} "
             "launches each and no bf16 launch")

    cpu_engine = ServingEngine({"m": load(artifact, device="cpu")}, device="cpu")
    for w, (X, payload, _, _) in zip(WINDOWS, results):
        # each window scores alone, so the first and last rows of an answer
        # are the answers to the rows that make those windows
        started = time.perf_counter()
        plain = cpu_plain_answer(
            lambda rows: dict(zip(wire.SCORE_FIELDS, cpu_engine.anomaly("m", rows))), X)
        cpu_s = time.perf_counter() - started
        depth = len(plain["model-output"])
        worst = compare_arrays("fp32", depth, end_rows(payload["data"], depth), plain,
                               SERVE_RTOL)
        if len(payload["tag-thresholds"]) != N_TAGS or \
                np.asarray(payload["data"]["model-output"]).shape != (w, N_TAGS):
            fail(f"fp32 W={w}: thresholds or model-output shape wrong")
        print(f"W={w}: card vs CPU plain path over {depth} windows from both ends, worst "
              f"relative difference {worst:.3g} (limit {SERVE_RTOL}); CPU scoring took "
              f"{cpu_s:.1f} s")
    return {n: sum(r[2][n] for r in results) for n in KERNELS}


def phase_serve_bf16(torch, device, tmp: str) -> dict:
    """The bf16 path: the same slice machine built with compute_dtype
    bfloat16, one W = 16 request over HTTP; it launches the bf16 kernel once
    per layer (and the fp32 kernel never) and matches the same artifact
    scored on the card with dense attention in bf16."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.models.factories.transformer import MultiHeadSelfAttention
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine

    artifact = os.path.join(tmp, "turbine-long-window-bf16")
    build_artifact(artifact, device, compute_dtype="bfloat16")
    w = 16
    [(X, payload, launches, _)] = serve(artifact, device, (w,), np.random.default_rng(SEED + 3))
    if launches != {**NO_LAUNCHES, "flash_fwd_bf16": SLICE["n_layers"]}:
        fail(f"bf16 request launched {launches}, expected {SLICE['n_layers']} bf16 launches only")
    dense = load(artifact, device=device)
    est = dense.base_estimator.regressor.steps[-1][1]
    for module in est.module_.modules():
        if isinstance(module, MultiHeadSelfAttention):
            module.attention_impl = "dense"
    plain = dict(zip(wire.SCORE_FIELDS,
                     ServingEngine({"m": dense}, device=device).anomaly("m", X)))
    worst = compare_scores("bf16", w, payload, plain, BF16_SERVE_RTOL)
    print(f"bf16 W={w}: flash kernel vs dense attention on the card, worst relative "
          f"difference {worst:.3g} (limit {BF16_SERVE_RTOL})")
    return launches


# phase 4: the reference's model zoo at the widths of its own configs.
# name -> (estimator, estimator kwargs, tags); bench.py:122-173 for the
# 10/50/100-tag machines, the factory defaults for the other two
ZOO = {
    "dense-ae-10tag": ("DenseAutoEncoder", dict(kind="feedforward_hourglass"), 10),
    "dense-ae-default": ("DenseAutoEncoder", dict(kind="feedforward_model"), 100),
    "lstm-ae-50tag": ("LSTMAutoEncoder", dict(
        kind="lstm_symmetric", dims=[32], lookback_window=24), 50),
    "lstm-forecast-100tag": ("LSTMForecast", dict(
        kind="lstm_symmetric", dims=[32], lookback_window=24, horizon=3), 100),
    "lstm-model-default": ("LSTMAutoEncoder", dict(kind="lstm_model", lookback_window=24), 50),
    "lstm-ae-50tag-bf16": ("LSTMAutoEncoder", dict(
        kind="lstm_symmetric", dims=[32], lookback_window=24, compute_dtype="bfloat16"), 50),
    "multi-step-forecast": ("MultiStepForecast", dict(
        kind="lstm_symmetric", dims=[32], lookback_window=24, horizon=3), 50),
}
ZOO_ROWS = (144, 1008, 144, 1008)  # a day and a week at 10-minute resolution, twice


def zoo_weights(config: dict, rng: np.random.Generator) -> dict:
    """Random weights in the flax layout of a dense or LSTM factory's
    ``config``: Dense kernels ``(in, out)`` at 1/sqrt(fan_in); LSTM cells
    ``OptimizedLSTMCell_i/{ii,if,ig,io}`` (input kernels, no bias) and
    ``{hi,hf,hg,ho}`` (recurrent kernels with bias), head ``Dense_0``."""

    def kernel(n_in, n_out):
        return (rng.normal(size=(n_in, n_out)) / np.sqrt(n_in)).astype(np.float32)

    def dense(n_in, n_out):
        return {"kernel": kernel(n_in, n_out),
                "bias": (0.01 * rng.normal(size=n_out)).astype(np.float32)}

    if "units" in config:
        widths = [config["n_features"], *config["units"]]
        tree = {}
        for i, (n_in, units) in enumerate(zip(widths[:-1], widths[1:])):
            cell = {}
            for gate in "ifgo":
                cell[f"i{gate}"] = {"kernel": kernel(n_in, units)}
                cell[f"h{gate}"] = dense(units, units)
            tree[f"OptimizedLSTMCell_{i}"] = cell
        tree["Dense_0"] = dense(widths[-1], config["n_features_out"])
        return tree
    dims = [config["n_features"], *config["encoding_dim"], *config["decoding_dim"],
            config["n_features_out"]]
    return {f"Dense_{i}": dense(n_in, n_out)
            for i, (n_in, n_out) in enumerate(zip(dims[:-1], dims[1:]))}


def build_zoo_artifact(dest: str, estimator: str, kwargs: dict, tags: int, device,
                       rng: np.random.Generator, precision: str = None) -> None:
    """A DiffBasedAnomalyDetector / TransformedTargetRegressor / MinMaxScaler
    pipeline around ``estimator`` (as bench.py builds them), scalers fitted
    on seeded rows, seeded weights, the error scaler and thresholds on the
    residuals of the training tail (not for a joint forecaster, which emits
    horizon x F values per window), dumped by the port."""
    from gordo_components_tpu_torch.serializer import dump, pipeline_from_definition

    model = pipeline_from_definition({"DiffBasedAnomalyDetector": {"base_estimator": {
        "TransformedTargetRegressor": {
            "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {estimator: kwargs}]}},
            "transformer": "MinMaxScaler",
        }}}})
    ttr = model.base_estimator
    scaler, est = (step for _, step in ttr.regressor.steps)
    train = sensor_rows(rng, 2016, tags)
    scaler.fit(train)
    ttr.transformer.fit(train)
    config = est._make_spec(tags, tags).config  # the joint forecaster's head is widened
    est.to(device).set_state({"params": zoo_weights(config, rng), "n_features": tags,
                              "n_features_out": tags})
    if not getattr(est, "joint_horizon", False):
        tail = train[-1008:]
        pred = model.predict(tail)
        residual = np.abs(tail[len(tail) - len(pred):] - pred)
        model.scaler.fit(residual)
        scaled = model.scaler.transform(residual)
        model.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
        model.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    dump(model, dest, precision=precision, metadata=artifact_metadata(
        [f"TAG-{i:03d}" for i in range(tags)], precision))


def kernel_label(key: str) -> str:
    """A profiler kernel name made short and readable: the kernel's own name
    and, for PyTorch's elementwise kernels, the functor it applies."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    name = key.split("<", 1)[0].split("(", 1)[0].split("::")[-1]
    if name in ("Kernel", "Kernel2") and "<" in key:  # CUTLASS's wrapper: name its GEMM
        name = key.split("<", 1)[1].split(">", 1)[0].split(",", 1)[0].split("::")[-1].split("<")[0]
    ops = re.findall(r"\w*Functor\w*|\w+_kernel_cuda", key)
    return f"{name}[{ops[-1]}]" if ops else name[:80]


def profile_request(torch, engine, name: str, X: np.ndarray) -> dict:
    """One warm request under torch.profiler: device time summed by kernel,
    the kernels launched and the device's idle share of the traced wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.anomaly(name, X)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.anomaly(name, X)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    events = [evt for evt in prof.key_averages()
              if evt.device_type == DeviceType.CUDA and evt.self_device_time_total]
    kernels = [evt for evt in events if not evt.key.startswith(("Memcpy", "Memset"))]
    busy_ms = sum(evt.self_device_time_total for evt in events) / 1e3
    by_kernel = sorted(((kernel_label(evt.key), evt.self_device_time_total / 1e3, evt.count)
                        for evt in kernels), key=lambda row: -row[1])
    host_launches = sum(evt.count for evt in prof.key_averages()
                        if evt.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    return {"machine": name, "rows": len(X), "traced_ms": traced_ms,
            "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / traced_ms,
            "kernel_launches": sum(evt.count for evt in kernels),
            "host_launch_calls": host_launches,
            "device_ms_by_kernel": [{"kernel": k, "ms": ms, "launches": n}
                                    for k, ms, n in by_kernel[:8]]}


def phase_zoo(torch, device, tmp: str) -> None:
    """The dense and LSTM machines served by one HTTP server on the card,
    each request against the CPU plain path and launching no flash kernel;
    the joint forecaster skipped with a 503; one dense machine at the bf16
    rung; two requests traced."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import make_server

    models_dir = os.path.join(tmp, "zoo")
    rng = np.random.default_rng(SEED + 4)
    started = time.perf_counter()
    for name, (estimator, kwargs, tags) in ZOO.items():
        build_zoo_artifact(os.path.join(models_dir, name), estimator, kwargs, tags, device, rng)
    print(f"zoo: {len(ZOO)} artifacts written in {time.perf_counter() - started:.1f} s")

    httpd = make_server(models_dir, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    requests = []  # (machine, X, status, payload, ms)
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            skipped = json.loads(resp.read())["skipped"]
        if sorted(skipped) != ["multi-step-forecast"]:
            fail(f"zoo: /healthz skipped {sorted(skipped)}, expected the joint forecaster only")
        print(f"zoo: /healthz skips multi-step-forecast: {skipped['multi-step-forecast']}")
        _kernels.reset_launches()
        for name, (_, _, tags) in ZOO.items():
            url = f"{base}/gordo/v0/project/{name}/anomaly/prediction"
            for rows in ZOO_ROWS:
                X = sensor_rows(rng, rows, tags)
                status, payload, ms = post(url, X)
                print(f"zoo POST {name} {rows} rows: HTTP {status}, {ms:.2f} ms")
                requests.append((name, X, status, payload, ms))
        launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
        engine = httpd.model_server.engine
        traces = [profile_request(torch, engine, name, sensor_rows(rng, 1008, ZOO[name][2]))
                  for name in ("lstm-ae-50tag", "dense-ae-default")]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if any(launches.values()):
        fail(f"zoo requests launched flash kernels: {launches}")
    print(f"zoo: flash launches over {len(requests)} requests: {launches}")

    cpu_engines = {}
    for name, X, status, payload, ms in requests:
        if name == "multi-step-forecast":
            if status != 503:
                fail(f"zoo: the joint forecaster answered HTTP {status}, expected 503")
            continue
        if status != 200:
            fail(f"zoo: {name} answered HTTP {status}: {payload}")
        if name not in cpu_engines:
            cpu_engines[name] = ServingEngine(
                {name: load(os.path.join(models_dir, name), device="cpu")}, device="cpu")
        plain = dict(zip(wire.SCORE_FIELDS, cpu_engines[name].anomaly(name, X)))
        rtol = BF16_SERVE_RTOL if name.endswith("bf16") else SERVE_RTOL
        rows = len(plain["total-anomaly-score"])
        worst = compare_scores(f"zoo {name}", rows, payload, plain, rtol, tags=X.shape[1])
        print(f"zoo {name} {len(X)} rows ({rows} scored): card vs CPU plain path, worst "
              f"relative difference {worst:.3g} (limit {rtol})")

    # the engine's bf16 rung: bf16 weights and inputs, float32 architecture
    name, tags = "dense-ae-default", ZOO["dense-ae-default"][2]
    X = sensor_rows(rng, 1008, tags)
    artifact = os.path.join(models_dir, name)
    scored = [dict(zip(wire.SCORE_FIELDS, ServingEngine(
        {name: load(artifact, device=where)}, precisions={name: "bf16"}, device=where,
    ).anomaly(name, X))) for where in (device, "cpu")]
    worst = compare_arrays(f"zoo {name} bf16 rung", len(X), scored[0], scored[1],
                           BF16_SERVE_RTOL, tags=tags)
    print(f"zoo {name} at the bf16 rung, 1008 rows: card vs CPU at the same rung, worst "
          f"relative difference {worst:.3g} (limit {BF16_SERVE_RTOL})")
    for trace in traces:
        print(f"zoo profile: {json.dumps(trace)}")


# phase 5: fleets of one architecture each, all served by one HTTP server.
# name -> (machines, estimator, estimator kwargs, tags, rows per request,
# client threads, requests per thread in each round). Widths: the dense
# machine of bench_serving.py:248-307 at its 10 tags, the LSTM AE of
# bench.py's lstm_ae_50tag at its 32 machines, the slice machine.
FLEETS = {
    "dense": (100, "DenseAutoEncoder", dict(kind="feedforward_hourglass"), 10, 144, 12, 10),
    "lstm": (32, "LSTMAutoEncoder", dict(
        kind="lstm_symmetric", dims=[32], lookback_window=24), 50, 144, 8, 8),
    "patchtst": (4, "PatchTSTAutoEncoder", None, N_TAGS, LOOKBACK + 15, 4, 2),
}
FLEET_ROUNDS = 2  # cut from 3 to keep the script within its time limit
# a fused PatchTST dispatch against the same request served alone on the
# card: float32 both, the same kernels, but batched GEMMs (k machines in one
# cuBLAS call) sum in another order than single ones (~1e-7 relative per
# product); a request scored with another machine's weights or rows is O(1)
FUSED_RTOL = 1e-5
# device memory the fleet server may hold past its stacked trees: the warmup
# left 0.9 MiB on an H100, and a second copy of one full-width PatchTST
# machine (3 layers of 2.1 M float32 weights) would add about 24 MiB
HELD_SLACK = 8 * 2**20


def build_fleet(models_dir: str, device) -> dict:
    """Every fleet's artifacts under ``models_dir``, distinct seeded weights
    per machine; returns {fleet: [machine names]}."""
    names = {}
    for f, (fleet, (count, estimator, kwargs, tags, *_)) in enumerate(FLEETS.items()):
        names[fleet] = [f"{fleet}-{i:03d}" for i in range(count)]
        for i, name in enumerate(names[fleet]):
            dest, seed = os.path.join(models_dir, name), SEED + 1000 * (f + 1) + i
            if fleet == "patchtst":
                build_artifact(dest, device, seed=seed)
            else:
                build_zoo_artifact(dest, estimator, kwargs, tags, device,
                                   np.random.default_rng(seed))
    return names


def drive_fleet(base: str, fleet: str, names: list, rng, npz: bool = False) -> tuple:
    """FLEET_ROUNDS timed rounds of concurrent clients spread over the
    fleet's machines (client t's i-th request goes to machine t + i·threads,
    shifted each round). The bodies are encoded before a round, and the
    clients start it together; with ``npz`` they ask for the npz wire
    format. Returns ([(machine, X, payload)], round records)."""
    _, _, _, tags, rows, threads, per_thread = FLEETS[fleet]
    responses, rounds = [], []
    for r in range(FLEET_ROUNDS):
        plan = [[(names[(t + i * threads + r * threads * per_thread) % len(names)],
                  sensor_rows(rng, rows, tags)) for i in range(per_thread)]
                for t in range(threads)]
        bodies = [[json.dumps({"X": X.tolist()}).encode() for _, X in per_client]
                  for per_client in plan]
        out = [[] for _ in range(threads)]
        errors = []
        start = threading.Barrier(threads + 1)

        def client(t):
            try:
                start.wait(timeout=60)
                for (name, X), body in zip(plan[t], bodies[t]):
                    status, payload, ms = post_body(
                        f"{base}/gordo/v0/project/{name}/anomaly/prediction", body, npz)
                    if status != 200:
                        raise RuntimeError(f"{name}: HTTP {status}: {payload}")
                    out[t].append((name, X, payload, ms))
            except Exception as exc:  # noqa: BLE001 - reported below, fails the phase
                errors.append(exc)

        workers = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
        for w in workers:
            w.start()
        start.wait(timeout=60)
        started = time.perf_counter()
        for w in workers:
            w.join(timeout=600)
        wall = time.perf_counter() - started
        if errors or any(w.is_alive() for w in workers):
            fail(f"fleet {fleet} round {r}: {errors[:3] or 'a client did not finish'}")
        done = [entry for per_client in out for entry in per_client]
        lat = np.asarray([entry[3] for entry in done])
        rounds.append({"round": r, "wire": "npz" if npz else "json",
                       "requests": len(done), "wall_s": wall,
                       "req_per_s": len(done) / wall, "p50_ms": float(np.percentile(lat, 50)),
                       "p99_ms": float(np.percentile(lat, 99))})
        print(f"fleet {fleet} round {r}: {json.dumps(rounds[-1])}")
        responses += [entry[:3] for entry in done]
    return responses, rounds


def bucket_counts(engine, name: str) -> dict:
    bucket, _ = engine._by_name[name]
    return {"dispatches": bucket.dispatch_count, "requests": bucket.request_count,
            "fallback_cold": bucket.fallback_cold_count,
            "retry_isolated": bucket.retry_isolated_count}


def profile_fused(torch, engine, names: list, Xs: list) -> dict:
    """One fused dispatch of ``len(names)`` requests for distinct machines,
    under torch.profiler: kernels launched and the device's idle share of
    the traced wall (dispatch to results on the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gordo_components_tpu_torch.server.engine import _Item

    bucket, _ = engine._by_name[names[0]]

    def dispatch():
        items = []
        for name, X in zip(names, Xs):
            x, m_valid = engine._prepare(bucket, X)
            items.append(_Item(engine._by_name[name][1], x, m_valid))
        bucket._dispatch(items[0].x.shape[0], items, defer=False)
        for it in items:
            if not it.done.wait(600) or it.error is not None:
                fail(f"fused profile dispatch failed: {it.error}")

    before = bucket.dispatch_count
    dispatch()  # warm at this batch size
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dispatch()
        traced_ms = (time.perf_counter() - t0) * 1e3
    if bucket.dispatch_count != before + 2 or bucket.max_batch_seen < len(names):
        fail("the profiled requests did not share one dispatch")
    events = [evt for evt in prof.key_averages()
              if evt.device_type == DeviceType.CUDA and evt.self_device_time_total]
    kernels = [evt for evt in events if not evt.key.startswith(("Memcpy", "Memset"))]
    busy_ms = sum(evt.self_device_time_total for evt in events) / 1e3
    return {"machines": len(names), "traced_ms": traced_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / traced_ms,
            "kernel_launches": sum(evt.count for evt in kernels)}


def phase_fleet(torch, device, tmp: str) -> dict:
    """The stacked engine's fleets: 100 dense, 32 LSTM and 4 full-width
    PatchTST machines dumped into one directory and served by one HTTP
    server; each fleet's concurrent clients in FLEET_ROUNDS timed rounds.
    Dense and LSTM responses against the CPU plain path; PatchTST responses
    against the same request served alone on the card, one against the
    CPU; fused dispatches (fusion ratio > 1) in every fleet, no fused-path
    repair, and the fp32 flash kernel launched once per layer per PatchTST
    dispatch. Returns the phase's flash launches."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.models.analysis import analyze_model
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import make_server

    models_dir = os.path.join(tmp, "fleet")
    started = time.perf_counter()
    names = build_fleet(models_dir, device)
    print(f"fleet: {sum(map(len, names.values()))} artifacts written in "
          f"{time.perf_counter() - started:.1f} s")
    started = time.perf_counter()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    httpd = make_server(models_dir, port=0, device=device)
    held = torch.cuda.memory_allocated() - allocated
    stacked = sum(b.stacked_nbytes() for b in httpd.model_server.engine._buckets)
    print(f"fleet: server loaded, stacked and warmed up in {time.perf_counter() - started:.1f} s; "
          f"device memory held {held / 2**20:.1f} MiB, stacked trees {stacked / 2**20:.1f} MiB")
    # one copy of the weights: every loaded machine's own weights stay on the
    # host, and the card holds the stacked trees plus what the warmup left
    on_card = [name for name, machine in httpd.model_server.machines.items()
               if any(t.is_cuda for t in analyze_model(
                   machine.model).estimator.module_.state_dict().values())]
    if on_card or held > stacked + HELD_SLACK:
        httpd.server_close()
        fail(f"fleet: the server holds {held} bytes on the card for {stacked} stacked bytes; "
             f"machines with weights on the card: {on_card[:5]}")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    engine = httpd.model_server.engine
    rng = np.random.default_rng(SEED + 5)
    results, launches = {}, {}
    try:
        stats = engine.stats()
        if stats["buckets"] != len(FLEETS) or stats["machines"] != sum(map(len, names.values())):
            fail(f"fleet: {stats['machines']} machines in {stats['buckets']} buckets")
        for fleet, fleet_names in names.items():
            before = bucket_counts(engine, fleet_names[0])
            _kernels.reset_launches()
            responses, rounds = drive_fleet(base, fleet, fleet_names, rng)
            engine.quiesce()
            if fleet == "patchtst":
                launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
            after = bucket_counts(engine, fleet_names[0])
            delta = {key: after[key] - before[key] for key in after}
            k = FLEETS[fleet][5]
            Xs = [sensor_rows(rng, FLEETS[fleet][4], FLEETS[fleet][3]) for _ in range(k)]
            trace = profile_fused(torch, engine, fleet_names[:k], Xs)
            results[fleet] = {"responses": responses, "rounds": rounds, "counts": delta,
                              "trace": trace}
        # the dense fleet again, its clients asking for the npz wire format
        npz_responses, npz_rounds = drive_fleet(base, "dense", names["dense"], rng, npz=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    for fleet, result in results.items():
        delta = result["counts"]
        ratio = delta["requests"] / delta["dispatches"] if delta["dispatches"] else 0
        summary = {"fleet": fleet, "machines": len(names[fleet]), "counts": delta,
                   "fusion_ratio": ratio, "rounds": result["rounds"],
                   "fused_dispatch_trace": result["trace"]}
        print(f"fleet summary: {json.dumps(summary)}")
        if delta["fallback_cold"] or delta["retry_isolated"]:
            fail(f"fleet {fleet}: fused-path repairs counted: {delta}")
        if not ratio > 1:
            fail(f"fleet {fleet}: fusion ratio {ratio} ({delta['dispatches']} dispatches)")
        if delta["requests"] != len(result["responses"]):
            fail(f"fleet {fleet}: {delta['requests']} requests scored for "
                 f"{len(result['responses'])} responses")

    # dense and LSTM responses against the CPU plain path
    cpu = ServingEngine({name: load(os.path.join(models_dir, name), device="cpu")
                         for fleet in ("dense", "lstm") for name in names[fleet]}, device="cpu")
    results["dense-npz"] = {"responses": npz_responses}
    for fleet in ("dense", "lstm", "dense-npz"):
        worst = 0.0
        for name, X, payload in results[fleet]["responses"]:
            plain = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, X)))
            rows = len(plain["total-anomaly-score"])
            worst = max(worst, compare_scores(f"fleet {fleet} {name}", rows, payload, plain,
                                              SERVE_RTOL, tags=X.shape[1]))
        print(f"fleet {fleet}: {len(results[fleet]['responses'])} responses vs the CPU plain "
              f"path, worst relative difference {worst:.3g} (limit {SERVE_RTOL})")
    cpu.close()
    json_rounds = results["dense"]["rounds"]
    print("fleet dense, JSON vs npz wire format: " + json.dumps({
        wire_format: {key: [r[key] for r in rounds] for key in ("req_per_s", "p50_ms", "p99_ms")}
        for wire_format, rounds in (("json", json_rounds), ("npz", npz_rounds))}))

    # PatchTST: every response against the same request alone on the card
    responses = results["patchtst"]["responses"]
    dispatches = results["patchtst"]["counts"]["dispatches"]
    if not (launches["flash_fwd_f32"] == SLICE["n_layers"] * dispatches
            < SLICE["n_layers"] * len(responses)) or launches["flash_fwd_bf16"] or any(
                launches[n] for n in BWD_KERNELS):
        fail(f"fleet patchtst: flash launches {launches} for {dispatches} dispatches of "
             f"{len(responses)} requests")
    print(f"fleet patchtst: flash launches {launches} = {SLICE['n_layers']} x {dispatches} "
          f"dispatches for {len(responses)} requests")
    worst = 0.0
    for name, X, payload in responses:
        alone = dict(zip(wire.SCORE_FIELDS, engine.anomaly(name, X)))
        worst = max(worst, compare_scores(f"fleet patchtst {name}", len(alone["model-output"]),
                                          payload, alone, FUSED_RTOL, tags=X.shape[1]))
    print(f"fleet patchtst: {len(responses)} fused responses vs the same request alone on the "
          f"card, worst relative difference {worst:.3g} (limit {FUSED_RTOL})")
    name, X, payload = responses[0]
    cpu = ServingEngine({name: load(os.path.join(models_dir, name), device="cpu")}, device="cpu")
    plain = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, X)))
    worst = compare_scores(f"fleet patchtst {name} vs CPU", len(plain["model-output"]),
                           payload, plain, SERVE_RTOL, tags=X.shape[1])
    print(f"fleet patchtst {name}: fused response vs the CPU plain path, worst relative "
          f"difference {worst:.3g} (limit {SERVE_RTOL})")
    cpu.close()
    return launches


# phase 6: the int8 rung. The slice machine and the four PatchTST fleet
# machines (other seeds) share one bucket; two zoo machines beside them.
INT8_ZOO = ("dense-ae-default", "lstm-ae-50tag")
INT8_FLEET = [f"patchtst-int8-{i}" for i in range(4)]


def dequantize_profile(torch, bucket) -> dict:
    """The dequantize pass of one machine of an int8 bucket alone, as the
    program runs it (``q.float() * scale`` per parameter): its kernels
    under torch.profiler and its time by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params = {key: q[0] for key, q in bucket.stacked["params"].items()}
    scales = {key: s[0] for key, s in bucket.stacked["params_scale"].items()}

    def dequantize():
        return {key: q.to(torch.float32) * scales[key] for key, q in params.items()}

    ms = timed_ms(dequantize)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dequantize()
        torch.cuda.synchronize()
    kernels = [evt for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA and evt.self_device_time_total]
    return {"weights": sum(q.numel() for q in params.values()), "tensors": len(params),
            "ms": ms, "kernel_launches": sum(evt.count for evt in kernels),
            "device_ms": sum(evt.self_device_time_total for evt in kernels) / 1e3}


def concurrent_posts(urls_and_bodies: list) -> list:
    """POST each (url, body) from its own thread, all started together;
    returns (status, payload, ms) in order."""
    out = [None] * len(urls_and_bodies)
    start = threading.Barrier(len(urls_and_bodies))

    def client(i, url, body):
        start.wait(timeout=60)
        out[i] = post_body(url, body)

    workers = [threading.Thread(target=client, args=(i, *pair))
               for i, pair in enumerate(urls_and_bodies)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=600)
    if any(w.is_alive() for w in workers) or any(r is None for r in out):
        fail("a concurrent client did not finish")
    return out


def phase_int8(torch, device, tmp: str) -> dict:
    """The int8 rung on the card: the slice machine (W = 1 and W = 16 lone
    requests), two zoo machines (1008 rows) and the four-machine PatchTST
    fleet (a concurrent W = 16 round over HTTP, then one fused dispatch of
    4), every artifact written by the port with its int8 sidecar and served
    by one HTTP server. Every response matches the same artifact at int8 on
    the CPU plain path within SERVE_RTOL, and the same weights served at
    f32 on the card within the int8 parity budget; the stacked weights are
    int8 on the card; the fp32 flash kernel launches once per layer per
    PatchTST dispatch. Returns the phase's flash launches."""
    from gordo_components_tpu_torch import precision, wire
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine, _Item
    from gordo_components_tpu_torch.server.server import make_server

    models_dir = os.path.join(tmp, "int8")
    rng = np.random.default_rng(SEED + 6)
    started = time.perf_counter()
    build_artifact(os.path.join(models_dir, "slice-int8"), device, precision="int8")
    for i, name in enumerate(INT8_FLEET):
        build_artifact(os.path.join(models_dir, name), device, seed=SEED + 3000 + i,
                       precision="int8")
    for name in INT8_ZOO:
        estimator, kwargs, tags = ZOO[name]
        build_zoo_artifact(os.path.join(models_dir, name), estimator, kwargs, tags, device, rng,
                           precision="int8")
    names = sorted(os.listdir(models_dir))
    missing = [n for n in names
               if precision.QUANT_INT8_FILE not in os.listdir(os.path.join(models_dir, n))]
    if missing:
        fail(f"int8: artifacts without {precision.QUANT_INT8_FILE}: {missing}")
    print(f"int8: {len(names)} artifacts with {precision.QUANT_INT8_FILE} written in "
          f"{time.perf_counter() - started:.1f} s")

    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    httpd = make_server(models_dir, port=0, device=device)
    held = torch.cuda.memory_allocated() - allocated
    app = httpd.model_server
    engine = app.engine
    for bucket in engine._buckets:
        leaves = list(bucket.stacked["params"].values())
        if bucket.precision != "int8" or not all(
                t.dtype == torch.int8 and t.device.type == device.type for t in leaves):
            fail(f"int8: bucket {bucket.names} at {bucket.precision} holds "
                 f"{sorted({(str(t.dtype), t.device.type) for t in leaves})}")
    f32 = ServingEngine({name: m.model for name, m in app.machines.items()},
                        precisions={name: "f32" for name in app.machines}, device=device)
    nbytes = {rung: {b.names[0] if len(b.names) == 1 else "patchtst": b.stacked_nbytes()
                     for b in e._buckets} for rung, e in (("int8", engine), ("f32", f32))}
    print(f"int8: stacked trees {json.dumps(nbytes)}; int8 / f32 = "
          f"{sum(nbytes['int8'].values()) / sum(nbytes['f32'].values()):.4f}; device memory "
          f"held by the int8 server after boot {held / 2**20:.1f} MiB")
    per_machine = nbytes["int8"]["patchtst"] / (1 + len(INT8_FLEET))
    print(f"int8: one full-width PatchTST machine {per_machine / 2**20:.2f} MiB at int8, "
          f"{nbytes['f32']['patchtst'] / (1 + len(INT8_FLEET)) / 2**20:.2f} MiB at f32")

    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}/gordo/v0/project"
    slice_bucket = engine._by_name["slice-int8"][0]
    served = []  # (label, machine, X, scored arrays)
    try:
        _kernels.reset_launches()
        before = slice_bucket.dispatch_count
        lone = [("slice-int8", LOOKBACK + w - 1, N_TAGS) for w in (1, 16)]
        lone += [(name, 1008, ZOO[name][2]) for name in INT8_ZOO]
        for name, rows, tags in lone:
            X = sensor_rows(rng, rows, tags)
            status, payload, ms = post(f"{base}/{name}/anomaly/prediction", X)
            print(f"int8 POST {name} {rows} rows: HTTP {status}, {ms:.1f} ms")
            if status != 200:
                fail(f"int8: {name} answered HTTP {status}: {payload}")
            served.append(("lone", name, X, payload["data"]))
        fleet_X = [sensor_rows(rng, LOOKBACK + 15, N_TAGS) for _ in INT8_FLEET]
        replies = concurrent_posts([
            (f"{base}/{name}/anomaly/prediction", json.dumps({"X": X.tolist()}).encode())
            for name, X in zip(INT8_FLEET, fleet_X)])
        for name, X, (status, payload, ms) in zip(INT8_FLEET, fleet_X, replies):
            print(f"int8 fleet POST {name} W=16: HTTP {status}, {ms:.1f} ms")
            if status != 200:
                fail(f"int8: {name} answered HTTP {status}: {payload}")
            served.append(("fleet", name, X, payload["data"]))
        round_dispatches = slice_bucket.dispatch_count - before
        # one fused dispatch of the four machines
        items = []
        for name, X in zip(INT8_FLEET, fleet_X):
            x, m_valid = engine._prepare(slice_bucket, X)
            items.append(_Item(engine._by_name[name][1], x, m_valid))
        slice_bucket._dispatch(items[0].x.shape[0], items, defer=False)
        for name, X, it in zip(INT8_FLEET, fleet_X, items):
            if not it.done.wait(600) or it.error is not None:
                fail(f"int8: fused dispatch failed: {it.error}")
            served.append(("fused", name, X, dict(zip(wire.SCORE_FIELDS, it.result))))
        dispatches = slice_bucket.dispatch_count - before
        launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
        if slice_bucket.max_batch_seen < len(INT8_FLEET):
            fail("int8: the fused dispatch of the fleet did not hold all four requests")
        X16 = served[1][2]
        trace_int8 = profile_request(torch, engine, "slice-int8", X16)
        trace_f32 = profile_request(torch, f32, "slice-int8", X16)
        dequant = dequantize_profile(torch, slice_bucket)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    print(f"int8: {dispatches} PatchTST dispatches ({round_dispatches} for the concurrent "
          f"round of {len(INT8_FLEET)}, then 1 fused), flash launches {launches}")
    if launches != {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"] * dispatches}:
        fail(f"int8: flash launches {launches} for {dispatches} PatchTST dispatches")
    print(f"int8 profile W=16: {json.dumps(trace_int8)}")
    print(f"f32 profile W=16, same weights and rows: {json.dumps(trace_f32)}")
    print(f"int8 dequantize pass of one slice machine: {json.dumps(dequant)}")

    cpu = ServingEngine(
        {name: load(os.path.join(models_dir, name), device="cpu") for name in names},
        precisions={name: "int8" for name in names},
        quantized={name: precision.load_quantized(os.path.join(models_dir, name))
                   for name in names},
        device="cpu")
    budget = precision.error_budget("int8")
    plain_cache = {}
    for label, name, X, data in served:
        key = (name, X.shape[0], float(X[0, 0]))
        if key not in plain_cache:
            # a PatchTST answer's first and last windows, as phase 3 holds it
            plain_cache[key] = cpu_plain_answer(
                lambda rows, name=name: dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, rows))),
                X)
        plain = plain_cache[key]
        rows = len(plain["total-anomaly-score"])
        worst = compare_arrays(f"int8 {label} {name}", rows, end_rows(data, rows), plain,
                               SERVE_RTOL, tags=X.shape[1])
        parity = precision.parity_error(f32.anomaly(name, X).total_anomaly_score,
                                        np.asarray(data["total-anomaly-score"]))
        print(f"int8 {label} {name} {len(X)} rows: card vs CPU at int8, worst relative "
              f"difference {worst:.3g} (limit {SERVE_RTOL}); total-score parity with f32 on "
              f"the card {parity:.4g} (budget {budget})")
        if not parity <= budget:
            fail(f"int8 {name}: parity error {parity} above the int8 budget {budget}")
    cpu.close()
    f32.close()
    return launches


# phase 7: the reference's serving surface on one server. name ->
# (estimator kwargs of a zoo machine, precision pinned in its metadata,
# anomaly detector or a bare pipeline)
SURFACE = {
    "dense-f32": ("dense-ae-10tag", None, True),
    "dense-bf16": ("dense-ae-10tag", "bf16", True),
    "dense-int8": ("dense-ae-10tag", "int8", True),
    "lstm-int8": ("lstm-ae-50tag", "int8", True),
    "bare-dense": ("dense-ae-10tag", None, False),
}
QUARANTINE_COOLDOWN = 1.0  # seconds


def build_bare_artifact(dest: str, tags: int, device, rng: np.random.Generator) -> None:
    """A bare Pipeline([MinMaxScaler, DenseAutoEncoder]): no anomaly
    detector, so it serves /prediction only."""
    from gordo_components_tpu_torch.serializer import dump, pipeline_from_definition

    model = pipeline_from_definition({"Pipeline": {"steps": [
        "MinMaxScaler", {"DenseAutoEncoder": {"kind": "feedforward_hourglass"}}]}})
    scaler, est = (step for _, step in model.steps)
    scaler.fit(sensor_rows(rng, 2016, tags))
    config = est._make_spec(tags, tags).config
    est.to(device).set_state({"params": zoo_weights(config, rng), "n_features": tags,
                              "n_features_out": tags})
    dump(model, dest, metadata=artifact_metadata([f"TAG-{i:03d}" for i in range(tags)]))


def build_surface_machine(models_dir: str, name: str, device, seed: int) -> None:
    zoo_name, rung, detector = SURFACE[name]
    estimator, kwargs, tags = ZOO[zoo_name]
    rng = np.random.default_rng(seed)
    if detector:
        build_zoo_artifact(os.path.join(models_dir, name), estimator, kwargs, tags, device, rng,
                           precision=rung)
    else:
        build_bare_artifact(os.path.join(models_dir, name), tags, device, rng)


def prometheus_counts(base: str) -> dict:
    """``/metrics?format=prometheus`` parsed by the port's parser:
    {(series name, sorted labels): value}."""
    from gordo_components_tpu_torch.observability.exposition import parse_prometheus_text

    status, _, raw, _ = http("GET", base + "/metrics?format=prometheus")
    if status != 200:
        fail(f"surface: /metrics?format=prometheus answered HTTP {status}")
    return {(name, tuple(sorted(labels.items()))): value
            for name, samples in parse_prometheus_text(raw.decode()).items()
            for labels, value in samples}


def phase_surface(torch, device, tmp: str) -> None:
    """The reference's serving surface on the card, against the port's CPU
    plain path: /models, /metadata, /healthz (fleet and per machine),
    /prediction, /anomaly/prediction, npz against JSON, Prometheus
    /metrics, a spent deadline (504, no dispatch), admission (503 +
    Retry-After under GORDO_MAX_INFLIGHT=1, GORDO_MAX_QUEUE=0), quarantine
    and probe recovery, and a reload (a rewritten, an added and a removed
    machine) under in-flight requests."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.observability.tracing import TRACE_HEADER
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import make_server

    models_dir = os.path.join(tmp, "surface")
    for i, name in enumerate(SURFACE):
        build_surface_machine(models_dir, name, device, SEED + 4000 + i)
    expected_precision = {name: rung or "f32" for name, (_, rung, _) in SURFACE.items()}

    def cpu_engine(names):
        return ServingEngine(
            {n: load(os.path.join(models_dir, n), device="cpu") for n in names},
            precisions={n: expected_precision.get(n, "f32") for n in names}, device="cpu")

    def tags_of(name):
        return ZOO[SURFACE.get(name, SURFACE["dense-f32"])[0]][2]

    httpd = make_server(models_dir, port=0, device=device,
                        quarantine_cooldown=QUARANTINE_COOLDOWN)
    app = httpd.model_server
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    root = f"http://127.0.0.1:{httpd.server_address[1]}"
    base = f"{root}/gordo/v0/project"
    rng = np.random.default_rng(SEED + 7)
    cpu = cpu_engine(list(SURFACE))
    made = {}  # (endpoint, status) -> requests, checked against /metrics

    def score(name, X, endpoint="anomaly/prediction", headers=None):
        status, reply, raw, _ = http("POST", f"{base}/{name}/{endpoint}",
                                     json.dumps({"X": X.tolist()}).encode(), headers)
        # the server labels a client error's series "error"
        label = "anomaly" if endpoint.startswith("anomaly") else "prediction"
        key = ("error" if 400 <= status < 500 else label, status)
        made[key] = made.get(key, 0) + 1
        return status, reply, raw

    def get_json(path):
        status, reply, raw, _ = http("GET", root + path)
        return status, reply, json.loads(raw)

    try:
        before = prometheus_counts(root)
        status, _, models = get_json("/models")
        if status != 200 or models["models"] != sorted(SURFACE):
            fail(f"surface: /models answered {status} {models}")
        for name in SURFACE:
            status, _, meta = get_json(f"/gordo/v0/project/{name}/metadata")
            if status != 200 or meta["name"] != name or \
                    meta["metadata"].get("precision") != SURFACE[name][1]:
                fail(f"surface: /metadata of {name} answered {status} {meta}")
            status, _, health = get_json(f"/gordo/v0/project/{name}/healthz")
            if status != 200 or health["precision"] != expected_precision[name]:
                fail(f"surface: /healthz of {name} answered {status} {health}")
        if get_json("/metadata")[0] != 404:
            fail("surface: bare /metadata of a fleet did not answer 404")
        status, _, health = get_json("/healthz")
        if status != 200 or health["status"] != "ok" or \
                health["store"]["precisions"] != expected_precision:
            fail(f"surface: /healthz answered {status} {health}")
        print(f"surface: /models, /metadata, /healthz answer; precisions "
              f"{health['store']['precisions']}")

        # /prediction on the bare machine and on a detector; 422 on the bare
        for name in ("bare-dense", "dense-f32"):
            X = sensor_rows(rng, 144, tags_of(name))
            status, reply, raw = score(name, X, "prediction")
            if status != 200:
                fail(f"surface: /prediction of {name} answered HTTP {status}: {raw[:200]}")
            got = np.asarray(json.loads(raw)["data"]["model-output"])
            ref = cpu.predict(name, X)
            rel = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
            if rel > SERVE_RTOL:
                fail(f"surface: /prediction of {name} differs from the CPU by {rel:.3g}")
        status, _, raw = score("bare-dense", sensor_rows(rng, 144, 10))
        if status != 422:
            fail(f"surface: /anomaly/prediction of the bare machine answered {status}")
        print("surface: /prediction serves the bare machine and a detector; "
              "/anomaly/prediction of the bare machine answers 422")

        # every detector, JSON and npz: the same float32 arrays; the CPU
        npz_requests = 0
        for name in ("dense-f32", "dense-bf16", "dense-int8", "lstm-int8"):
            X = sensor_rows(rng, 1008, tags_of(name))
            status, reply, raw = score(name, X, headers={TRACE_HEADER: f"chip-smoke-{name}"})
            if status != 200 or reply.get(TRACE_HEADER) != f"chip-smoke-{name}":
                fail(f"surface: {name} answered {status}, trace id {reply.get(TRACE_HEADER)}")
            as_json = decode(reply, raw)
            status, reply, raw = score(name, X, headers={"Accept": wire.NPZ_CONTENT_TYPE})
            npz_requests += 1
            if status != 200 or wire.content_type_of(reply.get("Content-Type")) != \
                    wire.NPZ_CONTENT_TYPE:
                fail(f"surface: npz request to {name} answered {status} {reply}")
            as_npz = decode(reply, raw)
            for field in wire.SCORE_FIELDS:
                a = np.asarray(as_json["data"][field], np.float32)
                b = as_npz["data"][field]
                if b.dtype != np.float32 or not np.array_equal(a, b):
                    fail(f"surface: {name} {field}: npz and JSON disagree")
            plain = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, X)))
            rtol = BF16_SERVE_RTOL if name.endswith("bf16") else SERVE_RTOL
            worst = compare_scores(f"surface {name}", len(plain["total-anomaly-score"]),
                                   as_npz, plain, rtol, tags=X.shape[1])
            print(f"surface {name}: npz == JSON in float32; vs the CPU {worst:.3g} (limit {rtol})")

        # a deadline already spent: 504, and no dispatch
        dispatches = app.engine.stats()["dispatches"]
        status, reply, raw = score("dense-f32", sensor_rows(rng, 144, 10),
                                   headers={"X-Gordo-Deadline": "0"})
        if status != 504 or int(reply.get("Retry-After", 0)) < 1 or \
                app.engine.stats()["dispatches"] != dispatches:
            fail(f"surface: spent deadline answered {status} {reply} (dispatches "
                 f"{dispatches} -> {app.engine.stats()['dispatches']})")
        print(f"surface: spent deadline -> 504, Retry-After {reply['Retry-After']}, "
              f"dispatches unchanged ({dispatches})")

        after = prometheus_counts(root)
        for (endpoint, status), n in sorted(made.items()):
            key = ("gordo_server_requests_total",
                   (("endpoint", endpoint), ("status", str(status))))
            delta = after.get(key, 0) - before.get(key, 0)
            if delta != n:
                fail(f"surface: /metrics counts {delta} for {key}, {n} were made")
        npz_key = ("gordo_server_wire_format_total", (("format", "npz"),))
        if after.get(npz_key, 0) - before.get(npz_key, 0) != npz_requests:
            fail("surface: /metrics does not count the npz responses")
        print(f"surface: /metrics?format=prometheus parses and counts {json.dumps({f'{e} {s}': n for (e, s), n in sorted(made.items())})}")

        quarantine_and_recover(app, base, rng)
        reload_under_traffic(app, base, models_dir, device, rng, cpu_engine)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        cpu.close()
    admission_sheds(models_dir, device, rng, cpu_engine)


def quarantine_and_recover(app, base: str, rng) -> None:
    """A device fault while dense-int8 scores quarantines it (503, named by
    /healthz) while the rest answer; after the cooldown one request probes
    and recovers it."""
    bucket, idx = app.engine._by_name["dense-int8"]
    fault = threading.Event()
    program = bucket._program

    def faulty(idxs, xs):
        if fault.is_set() and idx in idxs:
            raise RuntimeError("injected device fault")
        return program(idxs, xs)

    bucket._program = faulty
    X = sensor_rows(rng, 144, 10)
    body = json.dumps({"X": X.tolist()}).encode()
    url = f"{base}/dense-int8/anomaly/prediction"
    fault.set()
    status, reply, raw, _ = http("POST", url, body)
    root = base.rsplit("/gordo/", 1)[0]
    health = json.loads(http("GET", root + "/healthz")[2])
    machine_health = http("GET", f"{base}/dense-int8/healthz")[0]
    others = http("POST", f"{base}/dense-f32/anomaly/prediction", body)[0]
    again = http("POST", url, body)[0]
    if status != 503 or int(reply.get("Retry-After", 0)) < 1 or \
            "dense-int8" not in health["quarantined"] or health["status"] != "degraded" or \
            machine_health != 503 or others != 200 or again != 503:
        fail(f"surface: quarantine: {status} {reply}, /healthz {health['status']} "
             f"{sorted(health['quarantined'])}, machine healthz {machine_health}, "
             f"others {others}, again {again}")
    fault.clear()
    time.sleep(QUARANTINE_COOLDOWN + 0.2)
    probe = http("POST", url, body)[0]
    health = json.loads(http("GET", root + "/healthz")[2])
    bucket._program = program
    if probe != 200 or health["status"] != "ok":
        fail(f"surface: quarantine probe answered {probe}, /healthz {health['status']}")
    print("surface: a scoring fault quarantines dense-int8 (503, named by /healthz, others "
          "200); after the cooldown a probe recovers it")


def reload_under_traffic(app, base: str, models_dir: str, device, rng, cpu_engine) -> None:
    """Rewrite dense-f32's weights, add dense-new, remove dense-bf16 and
    POST /reload while clients keep scoring lstm-int8: every in-flight
    request completes, answers follow the new weights, and the removed
    machine answers 404."""
    import shutil

    from gordo_components_tpu_torch import wire

    X = sensor_rows(rng, 144, 10)
    body = json.dumps({"X": X.tolist()}).encode()
    old = json.loads(http("POST", f"{base}/dense-f32/anomaly/prediction", body)[2])
    build_surface_machine(models_dir, "dense-f32", device, SEED + 5000)
    shutil.copytree(os.path.join(models_dir, "dense-f32"), os.path.join(models_dir, "dense-new"))
    shutil.rmtree(os.path.join(models_dir, "dense-bf16"))
    X_lstm = sensor_rows(rng, 1008, 50)
    lstm_body = json.dumps({"X": X_lstm.tolist()}).encode()
    statuses, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            statuses.append(http("POST", f"{base}/lstm-int8/anomaly/prediction", lstm_body)[0])

    clients = [threading.Thread(target=client) for _ in range(4)]
    for c in clients:
        c.start()
    time.sleep(0.5)
    root = base.rsplit("/gordo/", 1)[0]
    status, _, raw, ms = http("POST", root + "/reload")
    time.sleep(0.5)
    stop.set()
    for c in clients:
        c.join(timeout=120)
    report = json.loads(raw)
    if status != 200 or report["added"] != ["dense-new"] or report["removed"] != ["dense-bf16"] \
            or report["refreshed"] != ["dense-f32"] or report["errors"]:
        fail(f"surface: /reload answered {status} {report}")
    if any(c.is_alive() for c in clients) or not statuses or set(statuses) != {200}:
        fail(f"surface: requests during the reload answered {sorted(set(statuses))}")
    cpu = cpu_engine(["dense-f32", "dense-new"])
    for name in ("dense-f32", "dense-new"):
        status, reply, raw, _ = http("POST", f"{base}/{name}/anomaly/prediction", body)
        if status != 200:
            fail(f"surface: {name} after the reload answered {status}")
        payload = decode(reply, raw)
        plain = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, X)))
        compare_scores(f"surface reload {name}", len(X), payload, plain, SERVE_RTOL, tags=10)
    cpu.close()
    if np.allclose(old["data"]["model-output"], payload["data"]["model-output"]):
        fail("surface: dense-f32 still answers with its old weights after the reload")
    gone = http("POST", f"{base}/dense-bf16/anomaly/prediction", body)[0]
    if gone != 404:
        fail(f"surface: the removed machine answered {gone}")
    print(f"surface: /reload in {ms:.0f} ms ({json.dumps(report)}); {len(statuses)} requests "
          "in flight around it all answered 200; answers follow the new weights; the removed "
          "machine answers 404")


def admission_sheds(models_dir: str, device, rng, cpu_engine) -> None:
    """A server started with GORDO_MAX_INFLIGHT=1 and GORDO_MAX_QUEUE=0
    under 8 concurrent clients sheds some requests with 503 + Retry-After,
    and every 200 it answers is right."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.server.server import make_server

    saved = {k: os.environ.get(k) for k in ("GORDO_MAX_INFLIGHT", "GORDO_MAX_QUEUE")}
    os.environ.update(GORDO_MAX_INFLIGHT="1", GORDO_MAX_QUEUE="0")
    try:
        httpd = make_server(models_dir, port=0, device=device)
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           "/gordo/v0/project/dense-f32/anomaly/prediction")
    Xs = [sensor_rows(rng, 8064, 10) for _ in range(4)]
    bodies = [json.dumps({"X": X.tolist()}).encode() for X in Xs]
    answers = []
    try:
        def client(t):
            for i in range(8):
                k = (t + i) % len(Xs)
                status, reply, raw, _ = http("POST", url, bodies[k])
                answers.append((k, status, reply, raw))

        workers = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    shed = [a for a in answers if a[1] == 503]
    ok = [a for a in answers if a[1] == 200]
    if len(answers) != 64 or not shed or not ok or len(shed) + len(ok) != len(answers) or \
            any(int(a[2].get("Retry-After", 0)) < 1 for a in shed):
        fail(f"surface: admission answered {sorted({a[1] for a in answers})}: {len(shed)} "
             f"sheds, {len(ok)} served of {len(answers)}")
    cpu = cpu_engine(["dense-f32"])
    plain = [dict(zip(wire.SCORE_FIELDS, cpu.anomaly("dense-f32", X))) for X in Xs]
    for k, _, reply, raw in ok:
        compare_scores("surface admission", len(Xs[k]), decode(reply, raw), plain[k],
                       SERVE_RTOL, tags=10)
    cpu.close()
    print(f"surface: GORDO_MAX_INFLIGHT=1 GORDO_MAX_QUEUE=0 under 8 clients: {len(shed)} of "
          f"{len(answers)} shed with 503 (Retry-After {sorted({a[2]['Retry-After'] for a in shed})}"
          f"), {len(ok)} served, each matching the CPU")


# phase 8: training at full width. The slice machine's widths, trained one
# epoch over TRAIN_ROWS seeded rows: 1695 - 1440 + 1 = 256 windows, 8 steps
# of batch 32 (a layer's attention at BH = 32 x 64 x 8 = 16384), Adam
TRAIN_ROWS = LOOKBACK + 255
TRAIN_KWARGS = dict(batch_size=32, epochs=1)
# flash-kernel fit vs dense-attention fit on the card, same initial
# parameters and permutation: float32 both, the attention computed in
# other orders (~1e-6 per step), carried through 8 Adam steps; a wrong
# gradient (a dropped key, a missing term) moves the loss by O(1e-2) or more
TRAIN_RTOL = 1e-3


def slice_definition(attention_impl: str = "flash", **estimator_kwargs) -> dict:
    """The slice machine's definition (the served one of phase 3)."""
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {"PatchTSTAutoEncoder": {
            "kind": "patchtst", "lookback_window": LOOKBACK, "attention_impl": attention_impl,
            **SLICE, **estimator_kwargs}}]}},
        "transformer": "MinMaxScaler"}}}}


def fit_slice(torch, device, attention_impl: str, rows: np.ndarray,
              compute_dtype: str = "float32") -> tuple:
    """The slice machine's regressor (scalers, then PatchTSTAutoEncoder.fit)
    trained on the card; returns (model, estimator, wall s, peak bytes)."""
    from gordo_components_tpu_torch.serializer import pipeline_from_definition

    model = pipeline_from_definition(slice_definition(
        attention_impl, compute_dtype=compute_dtype, **TRAIN_KWARGS))
    est = model.base_estimator.regressor.steps[-1][1].to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    started = time.perf_counter()
    model.base_estimator.fit(rows)
    torch.cuda.synchronize()
    return model, est, time.perf_counter() - started, torch.cuda.max_memory_allocated()


def profile_train_step(torch, est, rows: np.ndarray) -> dict:
    """One warm training step of the fitted flash machine (the library's
    batch step on a batch of 32 windows, on copies of its parameters) under
    torch.profiler: device busy, GEMMs, flash forward and backward, and the
    idle share; then the optimizer update alone, traced the same way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gordo_components_tpu_torch.models import train
    from gordo_components_tpu_torch.models.factories.spec import apply_updates
    from gordo_components_tpu_torch.ops import windowing

    device = est.device
    spec = est._make_spec(est.n_features_, est.n_features_out_)
    module = est.module_
    # copies: the traced steps must leave the trained machine as it is
    params = {k: v.detach().clone().requires_grad_() for k, v in module.named_parameters()}
    x_rows = torch.as_tensor(rows, device=device)
    starts = torch.arange(32, device=device)
    y = x_rows[LOOKBACK - 1:LOOKBACK - 1 + 32]
    w = torch.ones(32, device=device)

    def apply(p, s, g):
        return torch.func.functional_call(
            module, p, (windowing.gather_windows(x_rows, s, LOOKBACK),), {"generator": g})

    step = train.make_batch_step(apply, spec.optimizer, loss=spec.loss)
    state = spec.optimizer.init(list(params.values()))

    def traced(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        events = [evt for evt in prof.key_averages()
                  if evt.device_type == DeviceType.CUDA and evt.self_device_time_total]
        return traced_ms, events

    def one_step():
        nonlocal state
        state, _, _ = step(params, state, (starts, y, w, None))

    traced_ms, events = traced(one_step)
    busy = sum(evt.self_device_time_total for evt in events) / 1e3

    def total(*needles):
        return sum(evt.self_device_time_total for evt in events
                   if any(n in evt.key.lower() for n in needles)) / 1e3

    values = list(params.values())
    grads = [torch.randn_like(p) * 1e-3 for p in values]
    opt_ms, opt_events = traced(lambda: apply_updates(
        values, spec.optimizer.update(grads, spec.optimizer.init(values), values)[0]))
    by_kernel = sorted(((kernel_label(evt.key), evt.self_device_time_total / 1e3, evt.count)
                        for evt in events), key=lambda row: -row[1])
    return {
        "traced_ms": traced_ms, "device_busy_ms": busy, "device_idle_share": 1 - busy / traced_ms,
        "gemm_ms": total("gemm", "cutlass", "xmma"),
        "flash_fwd_ms": total("flash_fwd"), "flash_bwd_ms": total("flash_bwd"),
        "optimizer_alone_device_ms": sum(e.self_device_time_total for e in opt_events) / 1e3,
        "optimizer_alone_traced_ms": opt_ms,
        "kernel_launches": sum(evt.count for evt in events),
        "device_ms_by_kernel": [{"kernel": k, "ms": ms, "launches": n}
                                for k, ms, n in by_kernel[:10]],
    }


def phase_train(torch, device, tmp: str) -> dict:
    """Training at full width: the slice machine fitted on the card through
    PatchTSTAutoEncoder.fit with the flash kernels, forward and backward
    (3 launches each per step), then again with dense attention from the
    same initial parameters and permutation (the card's own yardstick); the
    trained machine dumped, served over HTTP and its W = 16 response held to
    the trained model's own predict."""
    from gordo_components_tpu_torch.models.anomaly.diff import fit_thresholds
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import dump

    rng = np.random.default_rng(SEED + 8)
    rows = sensor_rows(rng, TRAIN_ROWS)
    steps = -(-(TRAIN_ROWS - LOOKBACK + 1) // TRAIN_KWARGS["batch_size"]) * TRAIN_KWARGS["epochs"]
    _kernels.reset_launches()
    model, est, wall, peak = fit_slice(torch, device, "flash", rows)
    launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
    per_step = SLICE["n_layers"] * steps
    print(f"train flash: {steps} steps in {wall:.2f} s ({1e3 * wall / steps:.1f} ms per step, "
          f"initialisation included), peak device memory {peak / 2**30:.2f} GiB, "
          f"loss history {est.history_}, launches {launches}")
    if launches != {**NO_LAUNCHES, "flash_fwd_f32": per_step, "flash_bwd_f32": per_step}:
        fail(f"train: launches {launches}, expected {SLICE['n_layers']} fp32 forward and "
             f"backward launches per step over {steps} steps")
    if not all(np.isfinite(est.history_)):
        fail(f"train: loss history {est.history_} is not finite")

    _kernels.reset_launches()
    dense_model, dense_est, dense_wall, dense_peak = fit_slice(torch, device, "dense", rows)
    dense_launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
    rel = max(abs(a - b) / abs(b) for a, b in zip(est.history_, dense_est.history_))
    X = sensor_rows(rng, LOOKBACK + 15)
    pred, dense_pred = model.base_estimator.predict(X), dense_model.base_estimator.predict(X)
    pred_rel = np.abs(pred - dense_pred).max() / np.abs(dense_pred).max()
    print(f"train dense: {steps} steps in {dense_wall:.2f} s, peak {dense_peak / 2**30:.2f} GiB, "
          f"loss history {dense_est.history_}; flash vs dense: loss max relative difference "
          f"{rel:.3g}, W=16 predictions {pred_rel:.3g} (limit {TRAIN_RTOL})")
    if any(dense_launches.values()) or rel > TRAIN_RTOL or pred_rel > TRAIN_RTOL:
        fail(f"train: the flash fit departs from the dense fit (loss {rel:.3g}, predictions "
             f"{pred_rel:.3g}) or the dense fit launched {dense_launches}")
    del dense_model, dense_est
    torch.cuda.empty_cache()

    scaled = model.base_estimator.regressor.steps[0][1].transform(rows)
    trace = profile_train_step(torch, est, scaled)
    print(f"train step profile (batch 32, BH 16384): {json.dumps(trace)}")

    # the error scaler and thresholds on the training tail, then serve it
    tail = rows[-(LOOKBACK + 127):]
    model.tag_thresholds_, model.total_threshold_ = fit_thresholds(
        model.scaler, np.abs(tail[LOOKBACK - 1:] - model.predict(tail)))
    artifact = os.path.join(tmp, "turbine-trained")
    dump(model, artifact, metadata=artifact_metadata([f"TAG-{i:03d}" for i in range(N_TAGS)]))
    [(X, payload, served, _)] = serve(artifact, device, (16,), rng)
    if served != {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"]}:
        fail(f"train: the trained machine's request launched {served}")
    got = np.asarray(payload["data"]["model-output"], np.float64)
    ref = model.predict(X).astype(np.float64)
    worst = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    print(f"train: the trained machine served over HTTP, W=16 vs its own predict: {worst:.3g} "
          f"(limit {SERVE_RTOL})")
    if got.shape != ref.shape or worst > SERVE_RTOL:
        fail(f"train: served output {got.shape} differs from predict by {worst:.3g}")
    launches["flash_fwd_f32"] += served["flash_fwd_f32"]
    return {"launches": launches, "trace": trace, "peak_gib": peak / 2**30}


def phase_train_bf16(torch, device) -> dict:
    """The bf16 training path: the slice machine with compute_dtype
    bfloat16 fitted through the bf16 flash kernels (3 forward and 3
    backward launches per step, no fp32 launch), against the same bf16 fit
    with dense attention within BF16_SERVE_RTOL of the loss."""
    from gordo_components_tpu_torch.ops import _kernels

    rows = sensor_rows(np.random.default_rng(SEED + 8), TRAIN_ROWS)
    steps = -(-(TRAIN_ROWS - LOOKBACK + 1) // TRAIN_KWARGS["batch_size"]) * TRAIN_KWARGS["epochs"]
    _kernels.reset_launches()
    _, est, wall, peak = fit_slice(torch, device, "flash", rows, "bfloat16")
    launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
    _, dense, _, _ = fit_slice(torch, device, "dense", rows, "bfloat16")
    rel = max(abs(a - b) / abs(b) for a, b in zip(est.history_, dense.history_))
    print(f"train bf16 flash: {steps} steps in {wall:.2f} s, peak {peak / 2**30:.2f} GiB, loss "
          f"history {est.history_}, launches {launches}; dense bf16 {dense.history_}, max "
          f"relative difference {rel:.3g} (limit {BF16_SERVE_RTOL})")
    per_step = SLICE["n_layers"] * steps
    if launches != {**NO_LAUNCHES, "flash_fwd_bf16": per_step, "flash_bwd_bf16": per_step}:
        fail(f"train bf16: launches {launches}, expected {per_step} bf16 forward and backward")
    if not all(np.isfinite(est.history_)) or rel > BF16_SERVE_RTOL:
        fail(f"train bf16: loss {est.history_} against dense attention's {dense.history_}")
    torch.cuda.empty_cache()
    return launches


# phase 9: `gordo build` on the card from a data config. Every build reads
# a TimeSeriesDataset of RandomDataProvider series at 10 minutes; with at
# least two points per bin every bin survives the join, so a range of n bins
# gives n rows. The zoo's machines (phase 4's dense-ae-default and
# lstm-ae-50tag) through build_model over two weeks, cross-validated (3
# folds) and fitted; the slice machine through the CLI over TRAIN_ROWS bins
# (8 Adam steps of batch 32, build_only), then the CLI's build contract:
# a cache hit, an int8 rebuild, a rollback, and the server on the root.
BUILD = {name: ZOO[name] for name in ("dense-ae-default", "lstm-ae-50tag")}
BUILD_ROWS = 2016
BUILD_START = "2023-01-01T00:00:00+00:00"
BUILD_METADATA_KEYS = {"name", "gordo_components_tpu_torch_version", "model", "dataset",
                       "build_duration_s", "build_phases", "user_defined"}
BUILD_MODEL_KEYS = {"model_config", "model_builder_metadata", "cross_validation",
                    "model_training_duration_s", "model_creation_date"}
BUILD_DETECTOR_KEYS = {"type", "base_estimator", "cross_validation", "tag_thresholds",
                       "total_threshold"}
BUILD_PHASES = ("data_fetch", "cross_validation", "fit")
SLICE_MACHINE = "slice-machine"
# runs the CLI as ``python -m gordo_components_tpu_torch.cli`` does (runpy,
# as __main__) and, at exit, writes the process's kernel launch counts and
# peak device memory to the file named by its first argument
CLI_RUNNER = """
import atexit, json, runpy, sys
import torch
from gordo_components_tpu_torch.ops import _kernels
record = sys.argv[1]
def report():
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0
    with open(record, "w") as fh:
        json.dump({"launches": {n: _kernels.LAUNCHES[n] for n in _kernels.KERNEL_NAMES},
                   "peak_bytes": peak}, fh)
atexit.register(report)
sys.argv = ["gordo_components_tpu_torch.cli", *sys.argv[2:]]
runpy.run_module("gordo_components_tpu_torch.cli", run_name="__main__", alter_sys=True)
"""


def data_config(tags: int, rows: int, seed: int) -> dict:
    """A TimeSeriesDataset of ``tags`` RandomDataProvider series over
    ``rows`` 10-minute bins from BUILD_START, 2-3 points per bin."""
    from datetime import datetime, timedelta

    start = datetime.fromisoformat(BUILD_START)
    return {
        "type": "TimeSeriesDataset",
        "train_start_date": BUILD_START,
        "train_end_date": (start + timedelta(minutes=10 * rows)).isoformat(),
        "tag_list": [f"TAG-{i:03d}" for i in range(tags)],
        "resolution": "10min",
        "data_provider": {"type": "RandomDataProvider", "min_size": 2 * rows,
                          "max_size": 3 * rows, "seed": seed},
    }


def phase_walls(metadata: dict) -> str:
    phases = metadata["build_phases"]
    return ", ".join(f"{p} {phases[p]['total_s']:.2f} s" for p in BUILD_PHASES if p in phases)


def phase_build(torch, device, tmp: str) -> None:
    """The zoo's machines built on the card from data configs: the port's
    build_model (the dataset, cross_validate over 3 folds, fit), dumped
    with the build metadata, served by one HTTP server; every response
    against the same artifact on the CPU plain path, and no flash launch."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.builder import build_model
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import dump, load, load_metadata
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import make_server

    models_dir = os.path.join(tmp, "built")
    rng = np.random.default_rng(SEED + 9)
    _kernels.reset_launches()
    for seed, (name, (estimator, kwargs, tags)) in enumerate(BUILD.items()):
        config = {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
            "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {estimator: kwargs}]}},
            "transformer": "MinMaxScaler"}}}}
        started = time.perf_counter()
        model, metadata = build_model(name, config, data_config(tags, BUILD_ROWS, SEED + seed),
                                      device=device)
        dump(model, os.path.join(models_dir, name), metadata=metadata)
        written = load_metadata(os.path.join(models_dir, name))
        cv = written["model"]["cross_validation"]
        rows = written["dataset"]["tag_loading_metadata"]["joined_length"]
        print(f"build {name}: {time.perf_counter() - started:.2f} s ({phase_walls(written)}), "
              f"{rows} joined rows of {tags} tags; fold scores "
              + json.dumps([{k: round(v, 4) for k, v in s["scores"].items()} for s in cv["splits"]])
              + f"; total threshold {model.total_threshold_:.4f}, tag thresholds "
              f"{np.round(model.tag_thresholds_[:5], 4).tolist()}...")
        detector_meta = written["model"]["model_builder_metadata"]
        if (not BUILD_METADATA_KEYS <= set(written) or set(written["model"]) != BUILD_MODEL_KEYS
                or set(detector_meta) != BUILD_DETECTOR_KEYS or len(cv["splits"]) != 3
                or len(detector_meta["tag_thresholds"]) != tags
                or set(written["build_phases"]) != set(BUILD_PHASES)):
            fail(f"build {name}: the metadata lacks the reference's keys: {sorted(written)}, "
                 f"{sorted(written['model'])}, {sorted(detector_meta)}, "
                 f"{sorted(written['build_phases'])}")
        if rows < BUILD_ROWS or written["dataset"]["x_shape"] != [rows, tags]:
            fail(f"build {name}: {rows} joined rows (want {BUILD_ROWS}), x_shape "
                 f"{written['dataset']['x_shape']}")
    launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
    if any(launches.values()):
        fail(f"build: the zoo's fits launched flash kernels: {launches}")

    httpd = make_server(models_dir, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for name, (_, _, tags) in BUILD.items():
            X = sensor_rows(rng, 1008, tags)
            status, payload, ms = post(f"{base}/gordo/v0/project/{name}/anomaly/prediction", X)
            if status != 200:
                fail(f"build {name}: HTTP {status}")
            cpu = ServingEngine({name: load(os.path.join(models_dir, name), device="cpu")},
                                device="cpu")
            plain = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, X)))
            cpu.close()
            w = len(plain["model-output"])
            worst = compare_scores(f"build {name}", w, payload, plain, SERVE_RTOL, tags)
            print(f"build {name}: served 1008 rows over HTTP in {ms:.1f} ms, vs the CPU plain "
                  f"path {worst:.3g} (limit {SERVE_RTOL})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def run_cli(tmp: str, *args: str, record_name: str = "cli-record.json",
            env: dict = None) -> tuple:
    """One ``python -m gordo_components_tpu_torch.cli`` process (through
    CLI_RUNNER, which writes its counts to ``record_name`` under ``tmp``)
    in ``env`` (default this process's); returns (stdout lines, wall s, its
    launch counts, its peak device bytes). Fails on a non-zero exit."""
    record = os.path.join(tmp, record_name)
    if os.path.exists(record):
        os.remove(record)
    root = os.path.dirname(os.path.abspath(__file__))
    started = time.perf_counter()
    result = subprocess.run(
        [sys.executable, "-c", CLI_RUNNER, record, *args], cwd=root, capture_output=True,
        text=True, timeout=900, env={**(os.environ if env is None else env), "PYTHONPATH": root})
    wall = time.perf_counter() - started
    if result.returncode != 0:
        fail(f"cli {' '.join(args[:2])}: exit {result.returncode}\n{result.stderr[-4000:]}")
    with open(record) as fh:
        counts = json.load(fh)
    return result.stdout.strip().splitlines(), wall, counts["launches"], counts["peak_bytes"]


def phase_cli_build(torch, device, tmp: str) -> dict:
    """``python -m gordo_components_tpu_torch.cli build`` of the slice
    machine at full width on the card from a RandomDataProvider data
    config (build_only: 8 Adam steps through the fp32 flash kernels), then
    the CLI's contract: the same build again is a cache hit (no launch, no
    new generation), ``--precision int8`` commits gen-0002 with the int8
    sidecar under another key, ``rollback`` restores gen-0001, ``rollback
    --list`` reports it, and the port's server on the models directory
    serves the machine from its generation root within SERVE_RTOL of the
    CPU plain path. Returns the flash launches of the builds and the
    request."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.builder import calculate_model_key
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.precision import QUANT_INT8_FILE
    from gordo_components_tpu_torch.serializer import load, load_metadata, write_artifact_files
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import make_server
    from gordo_components_tpu_torch.store.generations import (
        commit_generation, current_generation, list_generations)
    from gordo_components_tpu_torch.store.manifest import verify_artifact

    models_dir = os.path.join(tmp, "cli-models")
    root = os.path.join(models_dir, SLICE_MACHINE)
    registry = os.path.join(tmp, "cli-registry")
    model_config = slice_definition("flash", **TRAIN_KWARGS)
    data = data_config(N_TAGS, TRAIN_ROWS, SEED + 10)
    build_args = ["build", SLICE_MACHINE, "--model-config", json.dumps(model_config),
                  "--data-config", json.dumps(data), "--output-dir", root,
                  "--model-register-dir", registry, "--cv-mode", "build_only"]
    steps = -(-(TRAIN_ROWS - LOOKBACK + 1) // TRAIN_KWARGS["batch_size"]) * TRAIN_KWARGS["epochs"]
    per_build = {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"] * steps,
                 "flash_bwd_f32": SLICE["n_layers"] * steps}

    out, wall, built, peak = run_cli(tmp, *build_args)
    meta = load_metadata(root)
    rows = meta["dataset"]["tag_loading_metadata"]["joined_length"]
    key = calculate_model_key(SLICE_MACHINE, model_config, data,
                              evaluation_config={"cv_mode": "build_only", "n_splits": 3})
    gen1 = os.path.join(root, "gen-0001")
    verify_artifact(gen1)
    gen_bytes = sum(e.stat().st_size for e in os.scandir(gen1) if e.is_file())
    print(f"cli build {SLICE_MACHINE}: {wall:.2f} s in the process ({phase_walls(meta)}; "
          f"build_duration_s {meta['build_duration_s']:.2f}), {rows} joined rows of {N_TAGS} "
          f"tags, {steps} Adam steps, peak device memory {peak / 2**30:.2f} GiB, generation "
          f"{gen_bytes} bytes, flash launches {built}")
    if out != [root] or list_generations(root) != ["gen-0001"] or current_generation(root) != \
            "gen-0001" or meta["model"]["cache_key"] != key or meta["precision"] != "f32":
        fail(f"cli build: printed {out}, generations {list_generations(root)}, key "
             f"{meta['model'].get('cache_key')} (want {key})")
    with open(os.path.join(registry, f"{key}.md5")) as fh:
        if fh.read() != root:
            fail("cli build: the registry key does not name the generation root")
    if rows < TRAIN_ROWS or meta["dataset"]["x_shape"] != [rows, N_TAGS]:
        fail(f"cli build: {rows} joined rows, want at least {TRAIN_ROWS}")
    if built != per_build:
        fail(f"cli build: launches {built}, expected {per_build}")

    # the cache hit runs beside the int8 build, which commits gen-0002 at its
    # end, long after the hit's process is done; a generation the hit made
    # would be f32
    trace_dir = os.path.join(tmp, "cli-trace")
    int8_run = {}

    def int8_build():
        # a thread: fail() raises SystemExit here, which the caller reads as
        # a missing result (its message is on stderr already)
        try:
            int8_run["result"] = run_cli(tmp, *build_args, "--precision", "int8", "--trace-dir",
                                         trace_dir, record_name="cli-int8-record.json")
        except SystemExit:
            pass

    int8_thread = threading.Thread(target=int8_build, name="cli-int8-build")
    int8_thread.start()
    out, hit_wall, hit, _ = run_cli(tmp, *build_args)
    after_hit = list_generations(root)
    print(f"cli build again: a cache hit in {hit_wall:.2f} s (the build: {wall:.2f} s; beside "
          f"the int8 build), printed {out}, generations {after_hit}, launches {hit}")
    if out != [root] or after_hit[:1] != ["gen-0001"] or any(
            load_metadata(os.path.join(root, g))["precision"] != "int8" for g in after_hit[1:]) \
            or any(hit.values()) or hit_wall >= wall:
        fail("cli build again: not a cache hit")

    # the commit alone: the same artifact through commit_generation, timed here
    model = load(root, device="cpu")
    started = time.perf_counter()
    commit_generation(os.path.join(tmp, "commit-probe"),
                      lambda staging: write_artifact_files(model, staging, metadata=meta))
    print(f"commit of the {gen_bytes}-byte generation (write, fsync, manifest, rename): "
          f"{time.perf_counter() - started:.3f} s")
    del model

    int8_thread.join()
    if "result" not in int8_run:
        fail("cli build --precision int8 failed")
    out, int8_wall, int8_launches, _ = int8_run["result"]
    int8_meta = load_metadata(root)
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        traced = json.load(fh)["traceEvents"]
    traced_kernels = {n: sum(1 for e in traced if e.get("cat") == "kernel"
                             and n in e.get("name", "")) for n in ("flash_fwd_f32",
                                                                    "flash_bwd_f32")}
    print(f"cli build --precision int8: {int8_wall:.2f} s ({phase_walls(int8_meta)}), "
          f"generations {list_generations(root)}, CURRENT {current_generation(root)}, launches "
          f"{int8_launches}; flash kernels in its torch.profiler trace {traced_kernels}")
    if (list_generations(root) != ["gen-0001", "gen-0002"] or current_generation(root) != "gen-0002"
            or int8_meta["precision"] != "int8" or int8_meta["model"]["cache_key"] == key
            or not os.path.isfile(os.path.join(root, "gen-0002", QUANT_INT8_FILE))
            or len(os.listdir(registry)) != 2 or int8_launches != per_build
            or traced_kernels != {n: per_build[n] for n in traced_kernels}):
        fail("cli build --precision int8: no int8 generation gen-0002 under a new key")

    out, _, _, _ = run_cli(tmp, "rollback", root)
    if out != [gen1] or current_generation(root) != "gen-0001":
        fail("cli rollback: CURRENT is not back on gen-0001")
    # rollback --list (a process) runs beside the served check below
    listed_run = {}

    def rollback_list():
        try:
            listed_run["result"] = run_cli(tmp, "rollback", "--list", root,
                                           record_name="cli-list-record.json")
        except SystemExit:
            pass

    list_thread = threading.Thread(target=rollback_list, name="cli-rollback-list")
    list_thread.start()

    httpd = make_server(models_dir, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}/gordo/v0/project/{SLICE_MACHINE}"
    try:
        _, _, raw, _ = http("GET", f"{base}/healthz")
        generation = json.loads(raw).get("generation")
        X = sensor_rows(np.random.default_rng(SEED + 10), LOOKBACK + 15)
        _kernels.reset_launches()
        status, payload, ms = post(f"{base}/anomaly/prediction", X)
        served = {n: _kernels.LAUNCHES[n] for n in KERNELS}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if status != 200 or generation != "gen-0001":
        fail(f"cli build served: HTTP {status}, generation {generation}")
    list_thread.join()
    if "result" not in listed_run:
        fail("cli rollback --list failed")
    listed = json.loads("\n".join(listed_run["result"][0]))
    print(f"cli rollback: {out}; rollback --list: {json.dumps(listed)}")
    if listed != {"generation": "gen-0001", "generations": ["gen-0001", "gen-0002"],
                  "verified": True, "error": None}:
        fail("cli rollback --list: CURRENT is not back on gen-0001")
    cpu = ServingEngine({SLICE_MACHINE: load(root, device="cpu")}, device="cpu")
    plain = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(SLICE_MACHINE, X)))
    cpu.close()
    worst = compare_arrays("cli build served", 16, payload["data"], plain, SERVE_RTOL, N_TAGS)
    print(f"cli build served from its generation root ({generation}): W=16 HTTP {status} in "
          f"{ms:.1f} ms, launches {served}, vs the CPU plain path {worst:.3g} "
          f"(limit {SERVE_RTOL})")
    if served != {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"]}:
        fail(f"cli build served: launches {served}")
    return {n: built[n] + int8_launches[n] + served[n] for n in KERNELS}


# phase 10: one fleet config, three buckets at the widths of bench.py's
# configs and the slice machine: name -> (machines, estimator, kwargs, tags,
# joined rows, evaluation)
FLEET_BUILD = {
    "dense": (100, "DenseAutoEncoder", dict(kind="feedforward_hourglass", batch_size=64,
                                            epochs=2), 10, 864, {"n_splits": 3}),
    "lstm": (32, "LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[32], lookback_window=24,
                                         batch_size=64, epochs=2), 50, 432, {"n_splits": 2}),
    "patchtst": (2, "PatchTSTAutoEncoder", dict(kind="patchtst", lookback_window=LOOKBACK,
                                                attention_impl="flash", batch_size=32, epochs=1,
                                                **SLICE),
                 N_TAGS, TRAIN_ROWS, {"n_splits": 1, "cv_parallel": False}),
}
FLEET_BUILD_SERVED = 2  # machines per bucket asked over HTTP
# stacked vs one machine at a time on the card: the same arithmetic but for
# the order of the batched GEMMs' sums; thresholds are 99th percentiles of
# residuals scaled by the same fits
FLEET_THRESHOLD_RTOL = 1e-4


def fleet_build_config(counts: dict = None, prefix: str = "", seed: int = SEED + 100,
                       project: str = "chip-smoke-fleet") -> dict:
    """The phase's fleet config: every machine a TimeSeriesDataset of
    RandomDataProvider series at 10 minutes (``data_config``), its own
    seed, in the reference's canonical detector config. ``counts``
    overrides FLEET_BUILD's machines per bucket (phase 19's fleet)."""
    machines = []
    for bucket, (count, estimator, kwargs, tags, rows, evaluation) in FLEET_BUILD.items():
        for i in range((counts or {}).get(bucket, count)):
            machines.append({
                "name": f"{prefix}{bucket}-{i:03d}",
                "model": {"DiffBasedAnomalyDetector": {"base_estimator": {
                    "TransformedTargetRegressor": {
                        "regressor": {"Pipeline": {"steps": ["MinMaxScaler",
                                                             {estimator: kwargs}]}},
                        "transformer": "MinMaxScaler"}}}},
                "dataset": data_config(tags, rows, seed + len(machines)),
                "evaluation": dict(evaluation),
            })
    return {"project-name": project, "machines": machines}


def fleet_flash_launches(rows: int) -> dict:
    """The PatchTST bucket's flash launches: (K+1) = 2 sequential stacked
    fits, 3 forward and 3 backward launches per step, then 3 forward per
    predict chunk (4 batches of windows per chunk when the step count
    allows, as the program widens them)."""
    batch = FLEET_BUILD["patchtst"][2]["batch_size"]
    steps = -(-(rows - LOOKBACK + 1) // batch)
    chunks = steps // next(k for k in range(min(4, steps), 0, -1) if steps % k == 0)
    fits, layers = 2, SLICE["n_layers"]
    return {**NO_LAUNCHES, "flash_fwd_f32": fits * layers * (steps + chunks),
            "flash_bwd_f32": fits * layers * steps}


def stacking_check(torch, device, out: str, config: dict) -> None:
    """Stacking is not an approximation: the PatchTST bucket's two machines
    fitted one at a time at M = 1 on the card, through the same program,
    from the initial parameters and permutations their keys drew in the
    stacked build (injected), against the committed artifacts."""
    import importlib

    from gordo_components_tpu_torch.models.analysis import analyze_model
    from gordo_components_tpu_torch.parallel import FleetMachineConfig, fleet
    from gordo_components_tpu_torch.serializer import load, load_metadata, pipeline_from_definition

    builder = importlib.import_module("gordo_components_tpu_torch.parallel.build_fleet")
    entries = [m for m in config["machines"] if m["name"].startswith("patchtst-")]
    meta = load_metadata(os.path.join(out, entries[0]["name"]))
    bucket, slice_index = meta["model"]["fleet"]["bucket"], meta["model"]["fleet"]["slice"]
    items = [{"machine": FleetMachineConfig(name=m["name"], model_config=m["model"],
                                            data_config=m["dataset"]),
              "dataset": builder._dataset_from_config(m["dataset"])} for m in entries]
    X, y, w, n_rows, *_ = builder._prepare_slice(items, len(items), N_TAGS, N_TAGS, False)
    keys = builder.machine_seeds(0, bucket, slice_index, len(items))
    spec = builder._spec_for(analyze_model(pipeline_from_definition(entries[0]["model"])),
                             N_TAGS, N_TAGS, 1, cv_parallel=False)
    params0 = fleet.initial_params(spec.module, keys)
    batch = spec.batch_size
    padded = -(-(n_rows - LOOKBACK + 1) // batch) * batch

    def timed_fit(m: slice, perms) -> tuple:
        """One train_fleet_arrays call over machines ``m``: (result, wall s,
        peak GiB, the allocator's retries: cudaFree-and-retry rounds)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        started = time.perf_counter()
        result = fleet.train_fleet_arrays(
            spec, fleet.MachineBatch(X[m], y[m], w[m], keys[m]), device=device,
            params0={n: v[m] for n, v in params0.items()}, perms=perms)
        torch.cuda.synchronize()
        return (result, time.perf_counter() - started, torch.cuda.max_memory_allocated() / 2**30,
                torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries)

    def drawn_perms(key: int) -> list:
        return [[torch.randperm(padded, generator=gen) for _ in range(spec.epochs)]
                for gen in (fleet.fit_generator(key, 2), fleet.fit_generator(key, 1))]

    # one machine: phase 19 holds both, a rank each, to the same limits,
    # and the script keeps within its time limit
    for m, entry in enumerate(entries[:1]):
        alone, wall, peak, retries = timed_fit(slice(m, m + 1), [drawn_perms(int(keys[m]))])
        built = load(os.path.join(out, entry["name"]), device="cpu")
        history = analyze_model(built).estimator.history_
        ref_history = alone.loss_history[0].cpu().numpy()
        loss_rel = np.abs(np.asarray(history) - ref_history).max() / np.abs(ref_history).max()
        thresholds = np.append(built.tag_thresholds_, built.total_threshold_)
        ref_thresholds = np.append(alone.tag_thresholds[0].cpu().numpy(),
                                   alone.total_threshold[0].item())
        thr_rel = (np.abs(thresholds - ref_thresholds)
                   / np.maximum(np.abs(ref_thresholds), 1e-6)).max()
        print(f"fleet build stacking: {entry['name']} alone at M=1 in {wall:.2f} s, peak "
              f"{peak:.2f} GiB, allocator retries {retries}, loss {ref_history.tolist()} vs "
              f"stacked {history}: {loss_rel:.3g} (limit {TRAIN_RTOL}); thresholds "
              f"{thr_rel:.3g} (limit {FLEET_THRESHOLD_RTOL})")
        if not np.isfinite(ref_history).all() or loss_rel > TRAIN_RTOL \
                or thr_rel > FLEET_THRESHOLD_RTOL:
            fail(f"fleet build: {entry['name']} stacked departs from the M=1 fit "
                 f"(loss {loss_rel:.3g}, thresholds {thr_rel:.3g})")
        del alone, built
        torch.cuda.empty_cache()


def probe_stacked_gradients(torch, device) -> None:
    """The fleet program's design probe on this card's torch:
    ``torch.func.grad`` of a function through ``gordo::flash_fwd``
    (reported either way), and the design itself: the forward mapped with
    ``torch.func.vmap`` over two stacked machines, one ``autograd.grad`` of
    the summed losses, against each machine's own gradient (must agree:
    the stack folds into one launch at twice the BH, each sequence computed
    as alone)."""
    from gordo_components_tpu_torch.ops.flash_attention import flash_fwd

    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    q, k, v = (torch.randn(2, 4, 200, 16, generator=gen, device=device) for _ in range(3))

    def loss(q, k, v):
        return flash_fwd(q, k, v, 0.25)[0].square().sum()

    try:
        torch.func.grad(loss)(q[0], k[0], v[0])
        answer = "works"
    except Exception as exc:  # the answer is the finding
        answer = f"fails: {type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(torch.func.vmap(loss)(*leaves).sum(), leaves)
    worst, scale = 0.0, max(g.abs().max().item() for g in grads)
    for m in range(2):
        own = [t[m].clone().requires_grad_() for t in (q, k, v)]
        for a, b in zip(grads, torch.autograd.grad(loss(*own), own)):
            worst = max(worst, (a[m] - b).abs().max().item())
    print(f"fleet probe (torch {torch.__version__}): torch.func.grad through gordo::flash_fwd "
          f"{answer}; vmapped forward + one autograd.grad vs per-machine grads: max |diff| "
          f"{worst:.3g} of max |grad| {scale:.3g}")
    if worst > 1e-6 * scale:
        fail(f"fleet probe: stacked gradients differ from per-machine ones by {worst:.3g}")


def phase_fleet_build(torch, device, tmp: str) -> dict:
    """``python -m gordo_components_tpu_torch.cli fleet-build`` of
    FLEET_BUILD's 134 machines on the card in one fresh process: every
    machine committed (a generation, a registry key, a journal record), the
    PatchTST bucket through both fp32 flash kernels once per layer per step
    for its two machines together; the same command again resolves every
    machine cached with no launch; the port's server on the output root
    answers two machines of each bucket within SERVE_RTOL of each one's own
    predict on the card; a PatchTST machine fitted alone matches the
    stacked build. Returns the launches of the build and the requests."""
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import load, load_metadata
    from gordo_components_tpu_torch.server.server import make_server
    from gordo_components_tpu_torch.store.generations import list_generations

    import gc

    probe_stacked_gradients(torch, device)
    # the CLI process needs ~71 GiB of the card: this one must hold nothing
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"fleet build: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
          f"of the card before the build")
    out = os.path.join(tmp, "fleet-out")
    registry = os.path.join(tmp, "fleet-registry")
    config = fleet_build_config()
    config_path = os.path.join(tmp, "fleet.json")
    with open(config_path, "w") as fh:
        json.dump(config, fh)
    names = [m["name"] for m in config["machines"]]
    # the serving export is phase 17's (WB_FLEET); this phase times the build
    args = ["fleet-build", "--machine-config", config_path, "--output-dir", out,
            "--model-register-dir", registry, "--no-serving-cache"]

    lines, wall, built, peak = run_cli(tmp, *args)
    results = json.loads("\n".join(lines))
    with open(os.path.join(out, "fleet_manifest.json")) as fh:
        manifest = json.load(fh)
    generations = sum(len(list_generations(os.path.join(out, n))) for n in names)
    metas = {n: load_metadata(os.path.join(out, n)) for n in names}
    walls = {}
    for bucket in FLEET_BUILD:
        fleet_meta = metas[f"{bucket}-000"]["model"]["fleet"]
        walls[bucket] = (fleet_meta["bucket"], fleet_meta["slice_duration_s"],
                         fleet_meta["cv_parallel"])
    rows = max(metas[n]["dataset"]["x_shape"][0] for n in names if n.startswith("patchtst"))
    expected = fleet_flash_launches(rows)
    print(f"fleet build: {len(results)} machines in {wall:.2f} s in the process "
          f"({3600 * len(results) / wall:.0f} machines per hour), peak device memory "
          f"{peak / 2**30:.2f} GiB, {generations} generations, flash launches {built} "
          f"(expected {expected}); per bucket (index, slice wall s with its fetch, cv_parallel): "
          f"{json.dumps(walls)}; manifest journal {manifest.get('journal')}")
    if (sorted(results) != sorted(names) or generations != len(names)
            or manifest.get("journal") != {"resumed": 0, "torn": 0, "rebuilt": len(names)}
            or len(os.listdir(registry)) != len(names)):
        fail(f"fleet build: {len(results)} results, {generations} generations, manifest "
             f"{manifest.get('journal')}, {len(os.listdir(registry))} registry keys")
    if built != expected:
        fail(f"fleet build: launches {built}, expected {expected}")
    for name in names:
        detector = metas[name]["model"]["model_builder_metadata"]
        history = re.findall(r'"loss": \[([^\]]*)\]', json.dumps(detector))
        losses = [float(v) for v in history[0].split(",")] if history else []
        if (not np.isfinite(detector["tag_thresholds"]).all() or not losses
                or not np.isfinite(losses).all()):
            fail(f"fleet build: {name} has no finite thresholds or loss history")

    # the same command again (a process resolving every machine cached),
    # beside the stacking check in this process; fail() in the thread
    # raises SystemExit, read as a missing result (its message is on stderr)
    again = {}

    def again_thread():
        try:
            again["result"] = run_cli(tmp, *args)
        except SystemExit:
            pass

    again_worker = threading.Thread(target=again_thread, name="fleet-build-again")
    again_worker.start()
    stacking_check(torch, device, out, config)
    again_worker.join()
    if "result" not in again:
        fail("fleet build again: the process failed")
    lines, hit_wall, hit, _ = again["result"]
    with open(os.path.join(out, "fleet_manifest.json")) as fh:
        hit_manifest = json.load(fh)
    print(f"fleet build again: {hit_wall:.2f} s, journal {hit_manifest.get('journal')}, "
          f"launches {hit}")
    if json.loads("\n".join(lines)) != results or any(hit.values()) or hit_manifest.get(
            "journal") != {"resumed": len(names), "torn": 0, "rebuilt": 0} or any(
            len(list_generations(os.path.join(out, n))) != 1 for n in names):
        fail("fleet build again: not every machine resolved cached")

    rng = np.random.default_rng(SEED + 10)
    httpd = make_server(out, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}/gordo/v0/project"
    served = dict(NO_LAUNCHES)
    try:
        for bucket, (_, _, kwargs, tags, _, _) in FLEET_BUILD.items():
            n_rows = kwargs.get("lookback_window", 1) + 143
            for i in range(FLEET_BUILD_SERVED):
                name = f"{bucket}-{i:03d}"
                X = sensor_rows(rng, n_rows, tags)
                _kernels.reset_launches()
                status, payload, ms = post(f"{base}/{name}/anomaly/prediction", X)
                for kernel in KERNELS:
                    served[kernel] += _kernels.LAUNCHES[kernel]
                if status != 200:
                    fail(f"fleet build served {name}: HTTP {status}")
                got = np.asarray(payload["data"]["model-output"], np.float64)
                own = load(os.path.join(out, name), device=device)
                ref = np.asarray(own.predict(X), np.float64)
                del own
                worst = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
                total = np.asarray(payload["data"]["total-anomaly-score"])
                print(f"fleet build served {name}: {n_rows} rows in {ms:.1f} ms, vs its own "
                      f"predict on the card {worst:.3g} (limit {SERVE_RTOL})")
                if got.shape != ref.shape or worst > SERVE_RTOL or not np.isfinite(total).all():
                    fail(f"fleet build served {name}: output {got.shape} vs {ref.shape}, "
                         f"{worst:.3g}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    per_request = {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"] * FLEET_BUILD_SERVED}
    if served != per_request:
        fail(f"fleet build served: launches {served}, expected {per_request}")
    torch.cuda.empty_cache()
    return {n: built[n] + served[n] for n in KERNELS}


# phase 11: the request seams. One server: 24 dense_ae_10tag machines (one
# refused at load by a fault, one slowed at dispatch) and two full-width
# PatchTST machines, under three tenants of three classes
SEAMS_DENSE = [f"seam-dense-{i:03d}" for i in range(24)]
SEAMS_PATCHTST = ["seam-patchtst-0", "seam-patchtst-1"]
SEAMS_BROKEN = SEAMS_DENSE[-1]  # model-load:…:error
SEAMS_SLOW = SEAMS_DENSE[-2]  # engine-dispatch:…:latency:0.05
SEAMS_LATENCY = 0.05  # seconds
SEAMS_TENANTS = "ops:interactive;batch:bulk;metered:standard:5:5"
SEAMS_ROWS = 144  # a day of a dense machine at 10-minute resolution
SEAMS_WINDOWS = 16  # windows of a PatchTST request
# the traffic, (clients, requests each): 8 bulk clients, an interactive
# client on dense machines, one on the PatchTST machines (its requests
# dispatch alone), and a metered burst of 20 requests sent at once
SEAMS_TRAFFIC = {"batch": (8, 80), "ops-dense": (1, 60), "ops-patchtst": (1, 30),
                 "metered": (20, 1)}
SEAMS_STAGES = ("admission", "queue_wait", "dispatch", "device_execute", "fetch", "score",
                "encode")
SEAMS_TOP_STAGES = ("admission", "score", "encode")  # they partition a request
# profiles of the fused PatchTST dispatch with the recorder on, and as many
# off: a profile can lose a kernel's record, so each setting's kernels are
# the most that any one of its profiles saw
SEAMS_PROFILES = 3


def seams_plan(rng) -> list:
    """(plan, bodies, encoded): the plan lists each client's requests as
    (tenant, class, path, machine, body key); the bodies (dense: 48
    distinct 144-row bodies; PatchTST: one W = 16 body per machine) are
    encoded once and shared by both runs."""
    served = [m for m in SEAMS_DENSE if m != SEAMS_BROKEN]
    bodies = {}
    for i in range(48):
        bodies[("dense", i)] = sensor_rows(rng, SEAMS_ROWS, ZOO["dense-ae-10tag"][2])
    for name in SEAMS_PATCHTST:
        bodies[(name, 0)] = sensor_rows(rng, LOOKBACK + SEAMS_WINDOWS - 1)
    encoded = {key: json.dumps({"X": X.tolist()}).encode() for key, X in bodies.items()}
    plan = []
    threads, n = SEAMS_TRAFFIC["batch"]
    for t in range(threads):
        plan.append([("batch", "bulk", "bulk/anomaly/prediction", served[(t * n + i) % len(served)],
                      ("dense", (t * n + i) % 48)) for i in range(n)])
    plan.append([("ops", "interactive", "anomaly/prediction", served[(7 * i) % len(served)],
                  ("dense", (5 * i) % 48)) for i in range(SEAMS_TRAFFIC["ops-dense"][1])])
    plan.append([("ops", "interactive", "anomaly/prediction", SEAMS_PATCHTST[i % 2],
                  (SEAMS_PATCHTST[i % 2], 0)) for i in range(SEAMS_TRAFFIC["ops-patchtst"][1])])
    plan += [[("metered", "standard", "anomaly/prediction", served[i % len(served)],
               ("dense", i))] for i in range(SEAMS_TRAFFIC["metered"][0])]
    return plan, bodies, encoded


def seams_run(base: str, plan: list, encoded: dict, run: str) -> dict:
    """Every client of ``plan`` from its own thread, started together; each
    request carries its own trace id (``<run><client><index>``, zero-padded).
    Returns ({trace id: (client, index, status, headers, body, wall ms,
    perf_counter at the answer)}, perf_counter at the start, the wall)."""
    out, errors = {}, []
    start = threading.Barrier(len(plan) + 1)

    def client(c):
        try:
            start.wait(timeout=60)
            for i, (tenant, _, path, machine, key) in enumerate(plan[c]):
                trace_id = f"{run}{c:02d}{i:04d}".ljust(16, "0")
                status, reply, raw, ms = http(
                    "POST", f"{base}/gordo/v0/project/{machine}/{path}", encoded[key],
                    {"X-Gordo-Tenant": tenant, "X-Gordo-Trace-Id": trace_id})
                out[trace_id] = (c, i, status, reply, raw, ms, time.perf_counter())
        except Exception as exc:  # noqa: BLE001 - reported below, fails the phase
            errors.append(exc)

    workers = [threading.Thread(target=client, args=(c,)) for c in range(len(plan))]
    for w in workers:
        w.start()
    start.wait(timeout=60)
    started = time.perf_counter()
    for w in workers:
        w.join(timeout=900)
    wall = time.perf_counter() - started
    if errors or any(w.is_alive() for w in workers):
        fail(f"seams {run}: {errors[:3] or 'a client did not finish'}")
    return out, started, wall


def seams_classes(plan, results, started) -> dict:
    """req/s (over the class's own span), p50 and p99 ms per class."""
    by_class = {}
    for trace_id, (c, i, status, _, _, ms, done) in results.items():
        by_class.setdefault(plan[c][i][1], []).append((ms, done))
    view = {}
    for klass, rows in sorted(by_class.items()):
        lat = np.asarray([ms for ms, _ in rows])
        span = max(done for _, done in rows) - started
        view[klass] = {"requests": len(rows), "req_per_s": len(rows) / span,
                       "p50_ms": float(np.percentile(lat, 50)),
                       "p99_ms": float(np.percentile(lat, 99))}
    return view


def profile_seams_dispatch(torch, engine, Xs: list, recorded: bool) -> tuple:
    """One fused dispatch of both PatchTST machines under torch.profiler,
    its requests' span contexts bound to a timeline (``recorded``) or to
    none: (a Counter of launches by the kernel's full name, synchronize
    calls, flash launches, the outputs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gordo_components_tpu_torch.observability import spans
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.server.engine import _Item

    bucket, _ = engine._by_name[SEAMS_PATCHTST[0]]

    def dispatch():
        timeline = token = None
        if recorded:
            timeline, token = spans.begin("5eam5000profile0")
        try:
            items = []
            for name, X in zip(SEAMS_PATCHTST, Xs):
                x, m_valid = engine._prepare(bucket, X)
                items.append(_Item(engine._by_name[name][1], x, m_valid))
        finally:
            if token is not None:
                spans.end(token)
        bucket._dispatch(items[0].x.shape[0], items, defer=False)
        for it in items:
            if not it.done.wait(600) or it.error is not None:
                fail(f"seams: the profiled dispatch failed: {it.error}")
        if recorded and {"dispatch", "device_execute", "fetch"} - set(timeline.stage_seconds()):
            fail(f"seams: the profiled dispatch recorded {timeline.stage_seconds()}")
        return [it.result for it in items]

    dispatch()  # warm at this batch size
    torch.cuda.synchronize()
    _kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        results = dispatch()
    launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
    averages = prof.key_averages()
    kernels = Counter({evt.key: evt.count for evt in averages
                       if evt.device_type == DeviceType.CUDA and evt.self_device_time_total})
    syncs = sum(evt.count for evt in averages if "ynchronize" in evt.key
                and evt.device_type != DeviceType.CUDA)
    return kernels, syncs, launches, results


def phase_seams(torch, device, tmp: str, kernels: dict, card: str) -> dict:
    """The serving path's request seams on the card: tenants and quotas,
    the weighted-fair drain, span timelines and the flight recorder,
    exemplars, fault points and the control ledger, under the traffic of
    SEAMS_TRAFFIC, once with the recorder on and once off. The summary
    lines name ``card`` (nvidia-smi's name and power limit). Returns the
    phase's flash launches (the recorder-on run's)."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.observability import flightrec
    from gordo_components_tpu_torch.observability import ledger as control_ledger
    from gordo_components_tpu_torch.observability.exposition import parse_prometheus_text
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.resilience import faults
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import make_server

    models_dir = os.path.join(tmp, "seams")
    ledger_root = os.path.join(tmp, "seams-ledger")
    started = time.perf_counter()
    estimator, kwargs, tags = ZOO["dense-ae-10tag"]
    for i, name in enumerate(SEAMS_DENSE):
        build_zoo_artifact(os.path.join(models_dir, name), estimator, kwargs, tags, device,
                           np.random.default_rng(SEED + 11000 + i))
    for i, name in enumerate(SEAMS_PATCHTST):
        build_artifact(os.path.join(models_dir, name), device, seed=SEED + 11100 + i)
    print(f"seams: {len(SEAMS_DENSE) + len(SEAMS_PATCHTST)} artifacts written in "
          f"{time.perf_counter() - started:.1f} s")
    # as run-server does it: the plan is parsed (and ledgered in memory)
    # before the server points the ledger at its directory, which adopts it
    os.environ.update(GORDO_TENANTS=SEAMS_TENANTS, GORDO_LEDGER_DIR=ledger_root)
    control_ledger.configure(None)
    faults.configure(f"model-load:{SEAMS_BROKEN}:error;"
                     f"engine-dispatch:{SEAMS_SLOW}:latency:{SEAMS_LATENCY}")
    # a recorder that holds every request of a run
    total = sum(n * per for n, per in SEAMS_TRAFFIC.values())
    saved_recorder = flightrec.RECORDER
    flightrec.RECORDER = flightrec.FlightRecorder(keep=total + 64, enabled=True)
    rng = np.random.default_rng(SEED + 11200)
    plan, bodies, encoded = seams_plan(rng)
    started = time.perf_counter()
    httpd = make_server(models_dir, port=0, device=device)
    print(f"seams: server loaded, stacked and warmed up in {time.perf_counter() - started:.1f} s")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    engine = httpd.model_server.engine
    patchtst_bucket, _ = engine._by_name[SEAMS_PATCHTST[0]]
    try:
        # 7. the broken machine is quarantined at load; the fleet serves
        health = json.loads(http("GET", base + "/healthz")[2])
        if list(health["quarantined"]) != [SEAMS_BROKEN] or \
                health["quarantined"][SEAMS_BROKEN]["phase"] != "load" or \
                len(health["machines"]) != len(SEAMS_DENSE) + len(SEAMS_PATCHTST) - 1:
            fail(f"seams: /healthz after a model-load fault: {health}")
        refused = http("POST", f"{base}/gordo/v0/project/{SEAMS_BROKEN}/anomaly/prediction",
                       encoded[("dense", 0)])
        if refused[0] != 503:
            fail(f"seams: the quarantined machine answered HTTP {refused[0]}")
        tenants = json.loads(http("GET", base + "/tenants")[2])
        print(f"seams: /tenants {json.dumps(tenants)}")
        flightrec.RECORDER.clear()
        _kernels.reset_launches()
        dispatches = patchtst_bucket.dispatch_count
        on_t0 = time.time()
        on, on_started, on_wall = seams_run(base, plan, encoded, "a")
        engine.quiesce()
        launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
        patchtst_dispatches = patchtst_bucket.dispatch_count - dispatches
        recorded = flightrec.RECORDER.summaries(limit=0)["recorded"]
        metrics_text = http("GET", base + "/metrics?format=prometheus&exemplars=1")[2].decode()
        debug = {trace_id: http("GET", f"{base}/debug/requests/{trace_id}")
                 for trace_id in on}
        chrome_id = next(t for t, r in on.items() if plan[r[0]][r[1]][3] in SEAMS_PATCHTST)
        chrome = http("GET", f"{base}/debug/requests/{chrome_id}?format=chrome")
        flightrec.RECORDER.set_enabled(False)  # what GORDO_FLIGHTREC=0 sets at boot
        off, off_started, off_wall = seams_run(base, plan, encoded, "b")
        engine.quiesce()
        print(f"seams: runs of {len(on)} requests, recorder on {on_wall:.2f} s, "
              f"off {off_wall:.2f} s")
        # the distinct requests again, one at a time (each its own dispatch)
        replay = {}
        served = sorted(set(SEAMS_DENSE) - {SEAMS_BROKEN})
        for enabled in (False, True):
            flightrec.RECORDER.set_enabled(enabled)
            for j, machine in enumerate(served):
                key = ("dense", j % 48)
                replay.setdefault((machine, key), []).append(http(
                    "POST", f"{base}/gordo/v0/project/{machine}/anomaly/prediction",
                    encoded[key], {"X-Gordo-Tenant": "ops"})[:3:2])
            for machine in SEAMS_PATCHTST:
                replay.setdefault((machine, (machine, 0)), []).append(http(
                    "POST", f"{base}/gordo/v0/project/{machine}/anomaly/prediction",
                    encoded[(machine, 0)], {"X-Gordo-Tenant": "ops"})[:3:2])
        Xs = [bodies[(name, 0)] for name in SEAMS_PATCHTST]
        traces = {True: [], False: []}
        for _ in range(SEAMS_PROFILES):
            for setting in (True, False):
                traces[setting].append(profile_seams_dispatch(torch, engine, Xs, setting))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        faults.clear()
        flightrec.RECORDER = saved_recorder
        for key in ("GORDO_TENANTS", "GORDO_LEDGER_DIR"):
            os.environ.pop(key, None)
        control_ledger.configure(None)

    # 5. metered is refused past its burst; batch and ops never
    statuses = {}
    for trace_id, (c, i, status, reply, raw, ms, _) in {**on, **off}.items():
        tenant = plan[c][i][0]
        statuses.setdefault(tenant, []).append(status)
        if status == 429 and (tenant != "metered" or int(reply.get("Retry-After", 0)) < 1):
            fail(f"seams: {tenant} answered 429 with Retry-After {reply.get('Retry-After')}")
        if status not in (200, 429):
            fail(f"seams: {trace_id} ({tenant}) answered HTTP {status}: {raw[:200]}")
    burst = statuses["metered"][:SEAMS_TRAFFIC["metered"][0]]  # the recorder-on run's
    if burst.count(200) < 5 or 429 not in burst:
        fail(f"seams: metered statuses {statuses['metered']}")
    print("seams: statuses by tenant " + json.dumps(
        {t: {str(code): s.count(code) for code in sorted(set(s))} for t, s in statuses.items()}))

    # 1. the recorder changes no byte. A request that dispatches alone gives
    # the same bytes on and off: the PatchTST client's (never fused) and the
    # serial replay's. A dense request of the concurrent runs fuses with
    # other batch mates in each run, and a fused GEMM sums in another order
    # than a lone one: those pairs are held to FUSED_RTOL
    bad_replay = [key for key, answers in replay.items()
                  if [a[0] for a in answers] != [200, 200] or answers[0][1] != answers[1][1]]
    if bad_replay:
        fail(f"seams: serial replay, recorder off vs on, differs for {bad_replay[:3]}")
    pairs = [(t, on[t], off["b" + t[1:]]) for t in on
             if on[t][2] == 200 and off["b" + t[1:]][2] == 200]
    differ = {}
    for t, a, b in pairs:
        if a[4] == b[4]:
            continue
        machine = plan[a[0]][a[1]][3]
        da, db = (decode(r[3], r[4])["data"] for r in (a, b))
        differ[t] = max(float(np.abs(np.asarray(da[k], np.float64) - np.asarray(db[k], np.float64))
                              .max() / max(1.0, np.abs(np.asarray(db[k], np.float64)).max()))
                        for k in db)
        if machine in SEAMS_PATCHTST or differ[t] > FUSED_RTOL:
            fail(f"seams: {t} ({machine}) differs with the recorder off by {differ[t]:.3g}")
    print(f"seams: recorder on vs off: {len(pairs)} response pairs, {len(pairs) - len(differ)} "
          f"equal to the bit (every PatchTST pair among them), {len(differ)} dense pairs with "
          f"other batch mates within {max(differ.values(), default=0.0):.3g} (limit "
          f"{FUSED_RTOL}); serial replay of {len(replay)} distinct requests: on = off to the bit")
    cpu_models = {name: load(os.path.join(models_dir, name), device="cpu")
                  for name in SEAMS_DENSE[:-1] + SEAMS_PATCHTST}
    cpu = ServingEngine(cpu_models, device="cpu")
    plain, worst = {}, {"dense": 0.0, "patchtst": 0.0}
    for trace_id, (c, i, status, reply, raw, _, _) in {**on, **off}.items():
        if status != 200:
            continue
        _, _, _, machine, key = plan[c][i]
        if (machine, key) not in plain:
            plain[(machine, key)] = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(machine, bodies[key])))
        ref = plain[(machine, key)]
        kind = "patchtst" if machine in SEAMS_PATCHTST else "dense"
        worst[kind] = max(worst[kind], compare_scores(
            f"seams {trace_id} {machine}", len(ref["model-output"]), decode(reply, raw), ref,
            SERVE_RTOL, tags=bodies[key].shape[1]))
    cpu.close()
    print(f"seams: {sum(r[2] == 200 for r in on.values())} + "
          f"{sum(r[2] == 200 for r in off.values())} responses vs the CPU plain path "
          f"({len(plain)} distinct requests), worst relative difference {json.dumps(worst)} "
          f"(limit {SERVE_RTOL})")

    # 2. every answered scoring trace is in the recorder (it holds the run)
    scoring = [t for t, r in on.items() if r[2] in (200, 429)]
    missing = [t for t in scoring if debug[t][0] != 200]
    if missing or recorded != len(on):
        fail(f"seams: {len(missing)} answered traces not in the recorder (e.g. {missing[:3]}); "
             f"recorded {recorded} of {len(on)}")
    timelines = {t: json.loads(debug[t][2]) for t in scoring}

    # 3. a PatchTST request's stages
    breakdown = {}
    for kind, names in (("dense", SEAMS_DENSE), ("patchtst", SEAMS_PATCHTST)):
        chosen = [timelines[t] for t, r in on.items()
                  if r[2] == 200 and plan[r[0]][r[1]][3] in names
                  and plan[r[0]][r[1]][3] != SEAMS_SLOW]
        stages = sorted({s for tl in chosen for s in tl["stages_ms"]})
        breakdown[kind] = {"requests": len(chosen), "duration_ms": float(np.median(
            [tl["duration_ms"] for tl in chosen])), **{s: float(np.median(
                [tl["stages_ms"].get(s, 0.0) for tl in chosen])) for s in stages}}
    print(f"seams [{card}]: median stage breakdown (ms) {json.dumps(breakdown)}")
    # A request's kernels run between the start of its dispatch (their
    # launches) and the end of its fetch, so dispatch + device_execute +
    # fetch holds the flash kernels' time. Mostly they run after the
    # enqueue returns, but not always: the device runs each kernel as it is
    # launched, and a launch of the program slowed by the other threads can
    # end after the device has caught up (tools/torch_enqueue_probe.py).
    # So the device stages alone hold it in the median request
    flash_ms = kernels["flash_fwd_f32"]["ms"]
    need = SLICE["n_layers"] * flash_ms
    device_stages = []
    for t, r in on.items():
        if r[2] != 200 or plan[r[0]][r[1]][3] not in SEAMS_PATCHTST:
            continue
        tl = timelines[t]
        if set(SEAMS_STAGES) - set(tl["stages_ms"]):
            fail(f"seams: PatchTST timeline {t} holds {sorted(tl['stages_ms'])}")
        top = sum(tl["stages_ms"][s] for s in SEAMS_TOP_STAGES)
        device_ms = tl["stages_ms"]["device_execute"] + tl["stages_ms"]["fetch"]
        device_stages.append(device_ms)
        if top > tl["duration_ms"] or tl["stages_ms"]["dispatch"] + device_ms < need:
            fail(f"seams: PatchTST timeline {t}: admission + score + encode {top:.3f} ms of "
                 f"{tl['duration_ms']:.3f}; dispatch {tl['stages_ms']['dispatch']:.3f} + "
                 f"device_execute + fetch {device_ms:.3f} ms for {SLICE['n_layers']} x "
                 f"{flash_ms:.4f} ms of flash_fwd_f32")
    median = float(np.median(device_stages)) if device_stages else 0.0
    if median < need:
        fail(f"seams: PatchTST device_execute + fetch, median {median:.3f} ms for "
             f"{SLICE['n_layers']} x {flash_ms:.4f} ms of flash_fwd_f32")
    print(f"seams: {len(device_stages)} PatchTST timelines, device_execute + fetch median "
          f"{median:.3f} ms, least {min(device_stages):.3f} ms ({SLICE['n_layers']} x "
          f"flash_fwd_f32 {flash_ms:.4f} ms)")
    events = json.loads(chrome[2])["traceEvents"]
    if chrome[0] != 200 or not set(SEAMS_STAGES) <= {e["name"] for e in events if e["ph"] == "X"}:
        fail(f"seams: ?format=chrome of {chrome_id}: HTTP {chrome[0]}")

    # 4. gordo_stage_seconds exemplars name traces the recorder holds
    _, exemplars = parse_prometheus_text(metrics_text, return_exemplars=True)
    # (exemplars older than the run are earlier phases' requests)
    named = {e["labels"]["trace_id"] for _, e in exemplars.get("gordo_stage_seconds_bucket", [])
             if e["timestamp"] >= on_t0}
    stray = named - set(timelines)
    if not named or stray:
        fail(f"seams: {len(named)} stage exemplars, not in the recorder: {sorted(stray)[:5]}")
    print(f"seams: {len(named)} gordo_stage_seconds exemplars, each a recorded trace")

    # 8. the dispatch latency fault shows in the slow machine's timelines
    slow = [min(s["duration_ms"] for s in timelines[t]["spans"] if s["name"] == "dispatch"
                and s.get("machine") == SEAMS_SLOW)
            for t, r in on.items() if r[2] == 200 and plan[r[0]][r[1]][3] == SEAMS_SLOW]
    if not slow or min(slow) < SEAMS_LATENCY * 1e3:
        fail(f"seams: {SEAMS_SLOW}'s dispatch stage {min(slow, default=None)} ms "
             f"(fault {SEAMS_LATENCY * 1e3} ms)")
    print(f"seams: {SEAMS_SLOW}: {len(slow)} timelines, dispatch stage >= {min(slow):.1f} ms")

    # 6. the recorder adds no device work: the same kernels and synchronizes.
    # Each setting's are the most that any one of its profiles saw (the
    # union): a kernel the recorder adds shows in the union of its
    # profiles, while a record one profile lost does not hide the kernel
    fused = {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"]}
    seen, syncs, short = {}, {}, []
    for setting, runs in traces.items():
        seen[setting] = Counter()
        for profiled, _, launches_run, _ in runs:
            seen[setting] |= profiled
            if launches_run != fused:
                fail(f"seams: a profiled fused PatchTST dispatch (recorder "
                     f"{'on' if setting else 'off'}) launched {launches_run}, not {fused}")
        syncs[setting] = max(sync for _, sync, _, _ in runs)
        for i, (profiled, sync, _, _) in enumerate(runs):
            if profiled != seen[setting] or sync != syncs[setting]:
                lost = {k[:120]: n for k, n in (seen[setting] - profiled).items()}
                short.append(f"recorder {'on' if setting else 'off'} profile {i}: "
                             f"{sync} synchronizes, missing {json.dumps(lost)}")
    if seen[True] != seen[False] or syncs[True] != syncs[False]:
        differ = {k[:120]: [seen[True][k], seen[False][k]]
                  for k in seen[True] | seen[False] if seen[True][k] != seen[False][k]}
        fail(f"seams: fused PatchTST dispatch over {SEAMS_PROFILES} profiles each, recorder "
             f"on: {len(seen[True])} kernels, {syncs[True]} synchronizes; off: "
             f"{len(seen[False])}, {syncs[False]}; launches [on, off] of the kernels that "
             f"differ {json.dumps(differ)}; profiles short of their setting's: {short}")
    first = traces[True][0][3]
    for _, _, _, results in traces[True][1:] + traces[False]:
        for a, b in zip(first, results):
            for field_a, field_b in zip(a, b):
                if not np.array_equal(field_a, field_b):
                    fail("seams: the profiled fused dispatch changed between profiles or "
                         "with the recorder off")
    print(f"seams: fused PatchTST dispatch of 2 under torch.profiler, {SEAMS_PROFILES} "
          f"profiles with the recorder on and {SEAMS_PROFILES} off: "
          f"{sum(seen[True].values())} kernel launches of {len(seen[True])} kernels each, "
          f"{syncs[True]} synchronizes each, launches {fused}; profiles that lost a record: "
          f"{short or 'none'}")

    # the flash kernel on the recorder-on run: once per layer per dispatch
    expected = {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"] * patchtst_dispatches}
    if launches != expected or not patchtst_dispatches:
        fail(f"seams: launches {launches} for {patchtst_dispatches} PatchTST dispatches")

    # 9. the ledger holds the fault plan and the quarantine, each valid
    directory = os.path.join(ledger_root, "worker-0")
    records = [json.loads(line) for name in sorted(os.listdir(directory))
               if name.startswith("seg-") for line in open(os.path.join(directory, name))
               if line.strip()]
    kinds = {(e["actor"], e["action"], e["target"]) for e in records}
    want = {("faults", "inject-plan", f"model-load:{SEAMS_BROKEN}"),
            ("faults", "inject-plan", f"engine-dispatch:{SEAMS_SLOW}"),
            ("quarantine", "quarantine", SEAMS_BROKEN)}
    bad = [problems for problems in map(control_ledger.validate_event, records) if problems]
    if want - kinds or bad:
        fail(f"seams: ledger holds {sorted(kinds)}; invalid: {bad[:3]}")
    print(f"seams: ledger {directory}: {len(records)} valid records {sorted(kinds)}")

    classes_on = seams_classes(plan, on, on_started)
    classes_off = seams_classes(plan, off, off_started)
    print(f"seams [{card}]: per class, recorder on " + json.dumps(classes_on))
    print(f"seams [{card}]: per class, recorder off " + json.dumps(classes_off))
    ok = lambda run: [r[5] for r in run.values() if r[2] == 200]  # noqa: E731
    print(f"seams [{card}]: recorder on vs off " + json.dumps({
        "on": {"wall_s": on_wall, "req_per_s": len(on) / on_wall,
               "p50_ms": float(np.percentile(ok(on), 50))},
        "off": {"wall_s": off_wall, "req_per_s": len(off) / off_wall,
                "p50_ms": float(np.percentile(ok(off), 50))},
        "patchtst_dispatches": patchtst_dispatches, "launches": launches}))
    return launches


# phase 12: the bulk client's path. Two slice machines built by ``cli build``
# from InfluxDataProvider data configs at the in-repo Influx double (each
# machine's tags in a measurement of its own, one point a minute), served
# in this process, asked by the port's Client in CLIENT_CHUNKS chunks each
CLIENT_MACHINES = ("client-patchtst-0", "client-patchtst-1")
CLIENT_CHUNKS = 4
CLIENT_START = "2023-03-01T00:00:00+00:00"


def influx_double_module():
    """``tests/influx_double.py`` (standard library only), loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "influx_double.py")
    spec = importlib.util.spec_from_file_location("influx_double", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def indexed_lake():
    """The Influx double with its points indexed by their ``tag``: a query
    naming one tag scans that tag's points, not every point of the
    measurement (the double's own scan, 64 queries a chunk over ~377k
    points, would be what the chunk's ``data_fetch`` measures). Parsing,
    answers and errors are the double's own."""
    import types

    module = influx_double_module()
    tag_filter = re.compile(r"\bWHERE\s+tag\s*=\s*'((?:[^'\\]|\\.)*)'", re.IGNORECASE)

    class IndexedLake(module.InfluxDouble):
        def __init__(self):
            super().__init__()
            self._index = {}  # (db, measurement) -> (points indexed, {tag: points})

        def _select(self, db, q):
            match = tag_filter.search(q)
            if match is None:
                return super()._select(db, q)
            tag = re.sub(r"\\(.)", r"\1", match.group(1))
            with self._lock:
                narrowed = {}
                for key, points in self._points.items():
                    count, by_tag = self._index.get(key, (-1, None))
                    if count != len(points):  # writes only append
                        by_tag = {}
                        for point in points:
                            by_tag.setdefault(point[1].get("tag"), []).append(point)
                        self._index[key] = (len(points), by_tag)
                    narrowed[key] = by_tag.get(tag, [])
            view = types.SimpleNamespace(_points=narrowed, _lock=threading.Lock())
            return module.InfluxDouble._select(view, db, q)

    return IndexedLake()


def phase_client(torch, device, tmp: str, kernels: dict, card: str) -> dict:
    """The bulk client's path on the card (see the module docstring, 12).
    Returns the phase's flash launches: the builds' and those of the
    serving window."""
    from concurrent.futures import ThreadPoolExecutor
    from datetime import datetime, timedelta

    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.client import (
        Client,
        CsvForwarder,
        ForwardPredictionsIntoInflux,
        PredictionForwarder,
    )
    from gordo_components_tpu_torch.dataset.data_provider.influx_client import (
        MinimalInfluxClient,
    )
    from gordo_components_tpu_torch.observability import flightrec
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import loads
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import make_server

    class TimedForwarder(PredictionForwarder):
        def __init__(self, inner):
            self.inner, self.wall = inner, 0.0

        def forward(self, machine, predictions):
            started = time.perf_counter()
            self.inner.forward(machine, predictions)
            self.wall += time.perf_counter() - started

    tags = [f"TAG-{i:03d}" for i in range(N_TAGS)]
    chunk_rows = LOOKBACK + CLIENT_WINDOWS - 1  # scores its last CLIENT_WINDOWS rows
    rows = CLIENT_CHUNKS * chunk_rows
    start = datetime.fromisoformat(CLIENT_START)
    end = (start + timedelta(minutes=rows)).isoformat()
    ns = int(start.timestamp()) * 10**9 + np.arange(rows, dtype=np.int64) * 60 * 10**9
    series = {name: sensor_rows(np.random.default_rng(SEED + 12000 + i), rows)
              for i, name in enumerate(CLIENT_MACHINES)}
    with indexed_lake() as lake:
        # 1-2. the lake, filled through the port's client, and one `cli
        # build` process per machine, each started once its machine's points
        # are written (the next machine's written while the build before
        # runs). Two builds peak near 60 GiB together beside what this
        # process holds; their fits, the peaks, barely overlap
        influx = dict(host=lake.host, port=lake.port, database="lake")
        writer = MinimalInfluxClient(**influx)
        model_config = slice_definition("flash", **TRAIN_KWARGS)
        dirs = {name: os.path.join(tmp, "client-models", name) for name in CLIENT_MACHINES}

        def fill(i):
            started = time.perf_counter()
            for j, tag in enumerate(tags):
                writer.write_points([series[CLIENT_MACHINES[i]][:, j].astype(np.float64)],
                                    ["value"], ns, f"sensor_data_{i}", tags={"tag": tag})
            return time.perf_counter() - started

        def build(i):
            data = {"type": "TimeSeriesDataset", "train_start_date": CLIENT_START,
                    "train_end_date": (start + timedelta(minutes=TRAIN_ROWS)).isoformat(),
                    "tag_list": tags, "resolution": "1min",
                    "data_provider": {"type": "InfluxDataProvider",
                                      "measurement": f"sensor_data_{i}", **influx}}
            name = CLIENT_MACHINES[i]
            return run_cli(tmp, "build", name, "--model-config", json.dumps(model_config),
                           "--data-config", json.dumps(data), "--output-dir", dirs[name],
                           "--cv-mode", "build_only", record_name=f"client-build-{i}.json")

        steps = -(-(TRAIN_ROWS - LOOKBACK + 1) // TRAIN_KWARGS["batch_size"]) * \
            TRAIN_KWARGS["epochs"]
        per_build = {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"] * steps,
                     "flash_bwd_f32": SLICE["n_layers"] * steps}
        torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the builds
        started = time.perf_counter()
        fills, pending = [fill(0)], []
        with ThreadPoolExecutor(len(CLIENT_MACHINES)) as pool:
            for i in range(len(CLIENT_MACHINES)):
                pending.append(pool.submit(build, i))
                if i + 1 < len(CLIENT_MACHINES):
                    fills.append(fill(i + 1))
            builds = [job.result() for job in pending]
        print(f"client [{card}]: the Influx double filled with {len(CLIENT_MACHINES)} x "
              f"{N_TAGS} tags x {rows} one-minute points ({', '.join(f'{f:.1f}' for f in fills)} "
              f"s a machine) and {len(CLIENT_MACHINES)} machines built by cli build from it in "
              f"{time.perf_counter() - started:.2f} s; " + json.dumps(
                  {name: {"wall_s": b[1], "peak_gib": b[3] / 2**30, "launches": b[2]}
                   for name, b in zip(CLIENT_MACHINES, builds)}))
        for name, (out, _, launched, _) in zip(CLIENT_MACHINES, builds):
            if out != [dirs[name]] or launched != per_build:
                fail(f"client: cli build {name} printed {out}, launches {launched} "
                     f"(want {per_build})")
        launches = {n: sum(b[2][n] for b in builds) for n in KERNELS}

        # 3. the client's predict against the port's server in this process
        saved_recorder = flightrec.RECORDER
        flightrec.RECORDER = flightrec.FlightRecorder(keep=256, enabled=True)
        httpd = make_server(dirs, port=0, device=device)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        engine = httpd.model_server.engine
        bucket, _ = engine._by_name[CLIENT_MACHINES[0]]
        forwarders = [TimedForwarder(ForwardPredictionsIntoInflux("anomaly", **influx)),
                      TimedForwarder(CsvForwarder(os.path.join(tmp, "client-csv")))]
        client = Client(base, machines=list(CLIENT_MACHINES), max_interval=f"{chunk_rows}min",
                        parallelism=CLIENT_PARALLELISM, forwarders=forwarders)
        try:
            _kernels.reset_launches()
            dispatches = bucket.dispatch_count
            started = time.perf_counter()
            frames = client.predict(CLIENT_START, end)
            client_wall = time.perf_counter() - started
            engine.quiesce()
            summaries = flightrec.RECORDER.summaries(limit=256)["requests"]
            trace_id = next(r["trace_id"] for r in summaries if r.get("kind") == "client.predict")
            timelines = [t.to_dict() for t in flightrec.RECORDER._all()
                         if t.trace_id == trace_id and t.meta.get("endpoint") == "anomaly"]

            # each chunk against the same rows POSTed alone as npz
            lone = {}
            worst = 0.0
            for name in CLIENT_MACHINES:
                frame = frames[name]
                if frame is None or len(frame) != CLIENT_CHUNKS * CLIENT_WINDOWS:
                    fail(f"client: {name} scored {None if frame is None else len(frame)} rows, "
                         f"want {CLIENT_CHUNKS} x ({chunk_rows} - {LOOKBACK - 1})")
                for c in range(CLIENT_CHUNKS):
                    lo, part = c * chunk_rows, slice(c * CLIENT_WINDOWS, (c + 1) * CLIENT_WINDOWS)
                    X = series[name][lo:lo + chunk_rows]
                    chunk = dict(zip(wire.SCORE_FIELDS, (
                        frame.model_input[part], frame.model_output[part],
                        frame.tag_anomaly_scores[part], frame.total_anomaly_score[part])))
                    if not np.array_equal(frame.timestamps[part],
                                          ns[lo + chunk_rows - CLIENT_WINDOWS:lo + chunk_rows]) \
                            or not np.array_equal(chunk["model-input"], X[-CLIENT_WINDOWS:]):
                        fail(f"client: {name} chunk {c}: the timestamps or rows are not the "
                             "last of the chunk")
                    status, reply, raw, _ = http(
                        "POST", f"{base}/gordo/v0/project/{name}/anomaly/prediction",
                        json.dumps({"X": X.tolist()}).encode(), {"Accept": wire.NPZ_CONTENT_TYPE})
                    if status != 200:
                        fail(f"client: {name} chunk {c} POSTed alone: HTTP {status}")
                    lone[(name, c)] = decode(reply, raw)["data"]
                    worst = max(worst, compare_arrays(f"client {name} chunk {c}", CLIENT_WINDOWS,
                                                      chunk, lone[(name, c)], FUSED_RTOL,
                                                      len(tags)))

            # the chunks' timelines: data_fetch, and the kernels inside
            # dispatch + device_execute + fetch (phase 11's check 3)
            if len(timelines) != len(CLIENT_MACHINES) * CLIENT_CHUNKS or any(
                    t["status"] != "200" for t in timelines):
                fail(f"client: {len(timelines)} chunk timelines for trace {trace_id}: "
                     f"{[t['status'] for t in timelines]}")
            per_chunk = []
            for tl in timelines:
                stages = tl["stages_ms"]
                batch = max((s.get("batch", 0) for s in tl["spans"] if s["name"] == "dispatch"),
                            default=0)
                bh = batch * CLIENT_WINDOWS * N_TAGS * SLICE["n_heads"]
                flash_ms = kernels["flash_fwd_f32"]["shape_ms"].get(bh)
                device_ms = sum(stages.get(k, 0.0) for k in ("dispatch", "device_execute", "fetch"))
                if "data_fetch" not in stages or flash_ms is None \
                        or device_ms < SLICE["n_layers"] * flash_ms:
                    fail(f"client: chunk timeline {json.dumps(stages)}, batch {batch}: no "
                         f"data_fetch, or device stages under {SLICE['n_layers']} x "
                         f"flash_fwd_f32 at BH {bh} ({flash_ms} ms)")
                per_chunk.append({"wall_ms": tl["duration_ms"], "data_fetch_ms": stages["data_fetch"],
                                  "device_ms": device_ms, "batch": batch, "bh": bh})

            # 4. the CLI in a subprocess, against the same server
            cli_csv = os.path.join(tmp, "client-cli-csv")
            out, cli_wall, _, _ = run_cli(
                tmp, "client", "predict", CLIENT_START, end, "--base-url", base,
                *[arg for name in CLIENT_MACHINES for arg in ("--machine", name)],
                "--max-interval", f"{chunk_rows}min", "--parallelism", str(CLIENT_PARALLELISM),
                "--output-dir", cli_csv, record_name="client-cli.json")
            counts = json.loads(out[-1])
            if counts != {name: len(frames[name]) for name in CLIENT_MACHINES} or \
                    sorted(os.listdir(cli_csv)) != sorted(f"{n}.csv" for n in CLIENT_MACHINES):
                fail(f"client: cli client predict printed {out}, wrote {os.listdir(cli_csv)}")

            # 5. the artifact: /download-model, loaded and lifted on the card
            status, _, blob, _ = http("GET", f"{base}/gordo/v0/project/{CLIENT_MACHINES[0]}"
                                             "/download-model")
            if status != 200:
                fail(f"client: /download-model answered HTTP {status}")
            lifted = ServingEngine({"m": loads(blob, device=device)}, device=device)
            first = frames[CLIENT_MACHINES[0]]
            served = dict(zip(wire.SCORE_FIELDS, (
                first.model_input[:CLIENT_WINDOWS], first.model_output[:CLIENT_WINDOWS],
                first.tag_anomaly_scores[:CLIENT_WINDOWS],
                first.total_anomaly_score[:CLIENT_WINDOWS])))
            artifact_worst = compare_arrays(
                "client /download-model", CLIENT_WINDOWS, dict(zip(wire.SCORE_FIELDS, lifted.anomaly(
                    "m", series[CLIENT_MACHINES[0]][:chunk_rows]))), served, SERVE_RTOL,
                len(tags))
            lifted_dispatches = lifted.stats()["dispatches"]
            lifted.close()

            # 6. a parquet body, where pyarrow is installed
            try:
                import pyarrow  # noqa: F401
            except ImportError:
                status = http("POST", f"{base}/gordo/v0/project/{CLIENT_MACHINES[0]}"
                                      "/anomaly/prediction", b"PAR1",
                              {"Content-Type": "application/x-parquet"})[0]
                if status != 415:
                    fail(f"client: a parquet body without pyarrow answered HTTP {status}")
                parquet_text = "pyarrow is absent here: a parquet body answers 415"
            else:
                scored = client.predict_frame(CLIENT_MACHINES[0], series[CLIENT_MACHINES[0]][
                    :chunk_rows], columns=tags, timestamps=ns[:chunk_rows], fmt="parquet")
                parquet_worst = compare_arrays("client parquet", CLIENT_WINDOWS, dict(zip(
                    wire.SCORE_FIELDS, (scored.model_input, scored.model_output,
                                        scored.tag_anomaly_scores, scored.total_anomaly_score))),
                    lone[(CLIENT_MACHINES[0], 0)], FUSED_RTOL, len(tags))
                if not np.array_equal(scored.timestamps,
                                      ns[chunk_rows - CLIENT_WINDOWS:chunk_rows]):
                    fail("client: the parquet answer's timestamps are not its rows'")
                parquet_text = (f"a parquet body equals the npz answer within {parquet_worst:.3g} "
                                f"(limit {FUSED_RTOL}), timestamps included")
            engine.quiesce()
            served_launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
            dispatched = bucket.dispatch_count - dispatches + lifted_dispatches
        finally:
            client.close()
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
            flightrec.RECORDER = saved_recorder

        # the forwarder's points, read back from the double
        reader = MinimalInfluxClient(**influx)
        for name in CLIENT_MACHINES:
            frame = frames[name]
            points = reader.query(f"SELECT * FROM \"anomaly\" WHERE machine = '{name}'")["anomaly"]
            values = np.column_stack([points.columns.get(c, np.zeros(0)) for c in frame.columns])
            if not np.array_equal(points.timestamps, frame.timestamps) or \
                    not np.array_equal(values, frame.values):
                fail(f"client: {name}'s forwarded points do not read back as its scores")
            with open(os.path.join(tmp, "client-csv", f"{name}.csv")) as fh:
                if len(fh.read().splitlines()) != 1 + len(frame):
                    fail(f"client: {name}'s CSV does not hold its {len(frame)} rows")
    expected = {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"] * dispatched}
    if served_launches != expected:
        fail(f"client: launches {served_launches} for {dispatched} PatchTST dispatches")
    total_rows = sum(len(f) for f in frames.values())
    print(f"client: {len(timelines)} chunks, each vs its rows POSTed alone as npz within "
          f"{worst:.3g} (limit {FUSED_RTOL}); the forwarded points read back; the CLI printed "
          f"{json.dumps(counts)} in {cli_wall:.2f} s; /download-model lifted on the card vs the "
          f"served chunk {artifact_worst:.3g} (limit {SERVE_RTOL}); {parquet_text}; launches "
          f"{served_launches} in {dispatched} dispatches")
    print(f"client [{card}]: " + json.dumps({
        "client_wall_s": client_wall, "rows": total_rows, "rows_per_s": total_rows / client_wall,
        "chunks": sorted(per_chunk, key=lambda c: c["wall_ms"]),
        "forwarders_s": {type(f.inner).__name__: f.wall for f in forwarders}}))
    return {n: launches[n] + served_launches[n] for n in KERNELS}



# phase 13: the control loops of one server. 16 dense_ae_10tag machines and
# two full-width PatchTST machines behind one server whose SLO evaluator,
# autopilot, telemetry warehouse and incident correlator run on short
# windows; traffic in three stages (skewed dense, a PatchTST burn under a
# dispatch latency fault, light dense recovery) with scrapes between
CONTROL_DENSE = [f"ctl-dense-{i:02d}" for i in range(16)]
CONTROL_PATCHTST = ["ctl-patchtst-0", "ctl-patchtst-1"]
CONTROL_SKEW = 60  # dense machine i gets round(CONTROL_SKEW / (i + 1)) requests
CONTROL_CLIENTS = 4
CONTROL_BURN = 10  # W = 16 requests per PatchTST machine, the two asked concurrently
CONTROL_FAULT = 0.2  # seconds of engine-dispatch latency over the burn's first half
CONTROL_RECOVER = 32  # dense requests of the recovery stage, spread evenly
CONTROL_LONE = CONTROL_DENSE[:: 5] + CONTROL_PATCHTST[:1]  # asked alone before and after
CONTROL_CARDINALITY = 4
CONTROL_ENV = {
    "GORDO_SLO_LATENCY_MS": "100",
    "GORDO_SLO_FAST_WINDOW": "2", "GORDO_SLO_SLOW_WINDOW": "30",
    "GORDO_SLO_EVAL_INTERVAL": "0",
    "GORDO_AUTOPILOT": "1", "GORDO_AUTOPILOT_COOLDOWN": "1", "GORDO_AUTOPILOT_CONFIRM": "1",
    "GORDO_AUTOPILOT_INTERVAL": "0",
    "GORDO_TELEMETRY_INTERVAL": "1", "GORDO_TELEMETRY_MB": "0.125",
    "GORDO_TELEMETRY_SEGMENT_KB": "16",
    "GORDO_METRICS_MACHINE_CARDINALITY": str(CONTROL_CARDINALITY),
    "GORDO_INCIDENT_COOLDOWN": "5",
}
CONTROL_OFF = {"GORDO_SLO": "0", "GORDO_TELEMETRY": "0", "GORDO_AUTOPILOT": "0"}


def control_plan(rng) -> tuple:
    """(requests, bodies): the skewed stage's (machine, body key) list in a
    seeded order, and one 144-row body per dense machine and one W = 16
    body per PatchTST machine, JSON-encoded."""
    bodies = {name: sensor_rows(rng, SEAMS_ROWS, ZOO["dense-ae-10tag"][2])
              for name in CONTROL_DENSE}
    bodies.update({name: sensor_rows(rng, LOOKBACK + SEAMS_WINDOWS - 1)
                   for name in CONTROL_PATCHTST})
    skewed = [name for i, name in enumerate(CONTROL_DENSE)
              for _ in range(int(round(CONTROL_SKEW / (i + 1))))]
    order = rng.permutation(len(skewed))
    return [skewed[i] for i in order], {k: json.dumps({"X": X.tolist()}).encode()
                                        for k, X in bodies.items()}


def control_drive(base: str, machines: list, encoded: dict, clients: int) -> list:
    """``machines`` asked over ``clients`` threads (request j on client j mod
    clients); every answer must be a 200. Returns the wall ms of each."""
    walls, errors = [], []

    def client(c):
        try:
            for machine in machines[c::clients]:
                status, _, raw, ms = http(
                    "POST", f"{base}/gordo/v0/project/{machine}/anomaly/prediction",
                    encoded[machine])
                if status != 200:
                    errors.append(f"{machine}: HTTP {status} {raw[:200]}")
                walls.append(ms)
        except Exception as exc:  # noqa: BLE001 - reported below, fails the phase
            errors.append(repr(exc))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=600)
    if errors or any(thread.is_alive() for thread in threads):
        fail(f"control: {errors[:3] or 'a client did not finish'}")
    return walls


class Scraper:
    """Scrape ``/metrics?format=prometheus`` every ``period`` s in a thread
    while a stage runs: each scrape ticks the SLO evaluator, the autopilot
    and the warehouse."""

    def __init__(self, base: str, period: float = 0.5):
        self.base, self.period, self.count = base, period, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self.period):
            if http("GET", self.base + "/metrics?format=prometheus")[0] == 200:
                self.count += 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


def control_get(base: str, path: str, method: str = "GET") -> dict:
    status, _, raw, _ = http(method, base + path, b"" if method == "POST" else None)
    if status != 200:
        fail(f"control: {method} {path} answered HTTP {status}: {raw[:300]}")
    return json.loads(raw)


def control_cli(base: str, *args: str) -> dict:
    """``python -m gordo_components_tpu_torch.cli <args> --base-url base``;
    fails unless it exits 0; returns its JSON output."""
    root = os.path.dirname(os.path.abspath(__file__))
    result = subprocess.run(
        [sys.executable, "-m", "gordo_components_tpu_torch.cli", *args, "--base-url", base],
        cwd=root, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": root})
    if result.returncode != 0:
        fail(f"control: cli {' '.join(args)} exit {result.returncode}: {result.stderr[-2000:]}")
    return json.loads(result.stdout)


def control_loop_cost(models_dir: str, skewed: list, encoded: dict, device, card: str) -> None:
    """The skewed dense stage once with the loops off and once on, each on a
    fresh server over the dense machines, scraped every 0.5 s: req/s, p50
    and p99 of each."""
    from gordo_components_tpu_torch.server.server import make_server

    rows = {}
    # on: the phase's knobs, so that every scrape ticks every loop
    for label, env in (("off", CONTROL_OFF), ("on", CONTROL_ENV)):
        os.environ.update(env)
        httpd = make_server(models_dir, port=0, device=device)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            model_server = httpd.model_server
            loops = [model_server.slo, model_server.autopilot, model_server.telemetry]
            if [loop is None for loop in loops] != [label == "off"] * 3:
                fail(f"control: loops {label}: slo, autopilot, telemetry are {loops}")
            started = time.perf_counter()
            with Scraper(base):
                walls = control_drive(base, skewed, encoded, CONTROL_CLIENTS)
            wall = time.perf_counter() - started
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
            for key in env:
                os.environ.pop(key, None)
        rows[label] = {"requests": len(walls), "wall_s": wall, "req_per_s": len(walls) / wall,
                       "p50_ms": float(np.percentile(walls, 50)),
                       "p99_ms": float(np.percentile(walls, 99))}
    print(f"control [{card}]: the skewed dense stage with the loops off and on "
          + json.dumps(rows))


def phase_control(torch, device, tmp: str, card: str) -> dict:
    """The control loops of one server on the card (see the module
    docstring, 13). Returns the phase's flash launches."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.observability import flightrec, traffic
    from gordo_components_tpu_torch.observability import ledger as control_ledger
    from gordo_components_tpu_torch.observability import telemetry as telemetry_engine
    from gordo_components_tpu_torch.observability.exposition import parse_prometheus_text
    from gordo_components_tpu_torch.observability.registry import REGISTRY
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.resilience import faults
    from gordo_components_tpu_torch.server.server import ModelServer, make_server

    phase_started = time.perf_counter()
    dense_dir = os.path.join(tmp, "control-dense")
    models_dir = os.path.join(tmp, "control")
    ledger_root = os.path.join(tmp, "control-ledger")
    estimator, kwargs, tags = ZOO["dense-ae-10tag"]
    for i, name in enumerate(CONTROL_DENSE):
        build_zoo_artifact(os.path.join(dense_dir, name), estimator, kwargs, tags, device,
                           np.random.default_rng(SEED + 13000 + i))
    import shutil

    shutil.copytree(dense_dir, models_dir)
    for i, name in enumerate(CONTROL_PATCHTST):
        build_artifact(os.path.join(models_dir, name), device, seed=SEED + 13100 + i)
    rng = np.random.default_rng(SEED + 13200)
    skewed, encoded = control_plan(rng)
    recover = [CONTROL_DENSE[i % len(CONTROL_DENSE)] for i in range(CONTROL_RECOVER)]
    sent = {}
    for machine in skewed + recover + 2 * CONTROL_LONE + CONTROL_BURN * CONTROL_PATCHTST:
        sent[machine] = sent.get(machine, 0) + 1

    os.environ.update(CONTROL_ENV, GORDO_LEDGER_DIR=ledger_root)
    control_ledger.configure(None)
    faults.clear()
    traffic.ACCOUNTANT.reset()  # process-wide: this phase counts its own traffic
    flightrec.RECORDER.clear()
    # a machine-labeled family that ranks the machines in the reverse of
    # their traffic: the scrape keeps the machines the traffic sketch
    # nominates, not this family's own top four
    index = REGISTRY.gauge("gordo_server_smoke_machine_index",
                           "chip_smoke phase 13: each served machine's index",
                           labels=("machine",))
    for i, name in enumerate(CONTROL_DENSE + CONTROL_PATCHTST):
        index.labels(name).set(float(i))
    httpd = make_server(models_dir, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    server = httpd.model_server
    engine = server.engine
    bucket, _ = engine._by_name[CONTROL_PATCHTST[0]]
    stacked = sum(b.stacked_nbytes() for b in engine._buckets)
    print(f"control: {len(CONTROL_DENSE) + len(CONTROL_PATCHTST)} machines served in "
          f"{time.perf_counter() - phase_started:.1f} s (artifacts written, stacked, warmed)")
    try:
        _kernels.reset_launches()
        dispatches = bucket.dispatch_count
        # the lone PatchTST request misses the 100 ms objective itself: no
        # scrape before the skewed stage, so the first window holds it among
        # the stage's dense requests
        lone_before = {m: http("POST", f"{base}/gordo/v0/project/{m}/anomaly/prediction",
                               encoded[m])[2] for m in CONTROL_LONE}
        stage_walls = {}

        # 1. skewed dense traffic
        started = time.perf_counter()
        skew_walls = control_drive(base, skewed, encoded, CONTROL_CLIENTS)
        stage_walls["skewed"] = time.perf_counter() - started
        control_get(base, "/metrics")
        before_burn = control_get(base, "/slo")

        # 2. the burn: both PatchTST machines asked concurrently, a dispatch
        # latency fault on both over the first half
        started = time.perf_counter()
        plan = ";".join(f"engine-dispatch:{m}:latency:{CONTROL_FAULT}" for m in CONTROL_PATCHTST)
        fault_t0 = time.time()
        with Scraper(base) as burn_scrapes:
            faults.configure(plan)
            half = CONTROL_BURN // 2 * CONTROL_PATCHTST
            burn_walls = control_drive(base, half, encoded, len(CONTROL_PATCHTST))
            faults.clear()
            burn_walls += control_drive(base, (CONTROL_BURN - CONTROL_BURN // 2)
                                        * CONTROL_PATCHTST, encoded, len(CONTROL_PATCHTST))
            time.sleep(1.5)  # the last requests' ticks
        stage_walls["burn"] = time.perf_counter() - started
        slo = control_get(base, "/slo")
        burn_end = time.time()
        pilot = control_get(base, "/autopilot")
        applied = [d for d in pilot["decisions"] if d["direction"] in ("up", "down")]
        tuning = dict(engine.current_tuning(), shed_level=server.admission.shed_level,
                      max_inflight=server.admission.max_inflight)

        # 3. recovery, with the autopilot frozen
        frozen = control_get(base, "/autopilot/disable", "POST")
        started = time.perf_counter()
        with Scraper(base):
            recover_walls = control_drive(base, recover, encoded, 2)
            time.sleep(1.5)
        stage_walls["recover"] = time.perf_counter() - started
        after_recovery = control_get(base, "/autopilot")
        lone_after = {m: http("POST", f"{base}/gordo/v0/project/{m}/anomaly/prediction",
                              encoded[m])[2] for m in CONTROL_LONE}
        engine.quiesce()
        launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
        patchtst_dispatches = bucket.dispatch_count - dispatches

        time.sleep(max(0.0, float(CONTROL_ENV["GORDO_TELEMETRY_INTERVAL"]) + 0.1))
        control_get(base, "/metrics")  # a last warehouse tick over all of it
        telemetry = control_get(base, "/telemetry?window=600")
        export = control_get(base, "/telemetry?view=export&window=600")
        prometheus = parse_prometheus_text(http("GET", base + "/metrics?format=prometheus")[2]
                                           .decode())
        incidents = control_get(base, "/incidents")
        ledger_tail = control_get(base, "/incidents?view=ledger&limit=1000")["events"]
        # newest first: the burn's is the oldest opened after the fault began
        reports = incidents["incidents"]
        burn_reports = [r for r in reversed(reports) if r["ts"] >= fault_t0 - 1.0]
        report = (control_get(base, f"/incidents/{burn_reports[0]['id']}")
                  if burn_reports else None)
        cli = {
            "autopilot": [control_cli(base, "autopilot", verb)["enabled"]
                          for verb in ("status", "enable", "disable")],
            "traffic": control_cli(base, "telemetry", "traffic", "--window", "600"),
            "costs": control_cli(base, "telemetry", "costs", "--window", "600"),
            "export": control_cli(base, "telemetry", "export", "--window", "10m"),
            "incident": (control_cli(base, "incidents", "show", report["id"])
                         if report else None),
        }
        warehouse = server.telemetry
        warehouse_dir, budget = warehouse.directory, warehouse.budget
        on_disk = sum(os.path.getsize(os.path.join(warehouse_dir, n))
                      for n in os.listdir(warehouse_dir))
        run_started_wall = time.time() - (time.perf_counter() - phase_started)
    finally:
        faults.clear()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    # 6. durability: a second server on the same models dir reloads the
    # history (its warm-up is one PatchTST dispatch more)
    second = ModelServer(models_dir, device=device)
    try:
        window = time.time() - run_started_wall + 60.0
        reloaded = json.loads(second.handle("GET", f"/telemetry?window={window:.0f}", {}, b"")
                              .body)
        second_bucket, _ = second.engine._by_name[CONTROL_PATCHTST[0]]
        second_dispatches = second_bucket.dispatch_count
        launches_second = {n: _kernels.LAUNCHES[n] - launches[n] for n in KERNELS}
    finally:
        second.close()
    phase_wall = time.perf_counter() - phase_started

    # 1. the burn crossed the fast window, once per edge, each edge a
    # slo/breach ledger event; the latency budget went to a device-side stage
    # (the lone requests after the recovery stage may burn a short window
    # again: their PatchTST request misses the objective among few others)
    latency = next(o for o in slo["objectives"] if o["name"] == "scoring-latency")
    breach_events = [e for e in ledger_tail if (e["actor"], e["action"], e["target"])
                     == ("slo", "breach", "scoring-latency")]
    fast_events = [e for e in breach_events if (e.get("after") or {}).get("window") == "fast"
                   and e["ts"] <= burn_end]
    fast_breaches = latency["windows"]["fast"]["breaches"]
    before = next(o for o in before_burn["objectives"] if o["name"] == "scoring-latency")
    attribution = slo["attribution"]["scoring-latency"]
    print(f"control: scoring-latency burned {json.dumps(latency['windows'])}, attainment "
          f"{latency['attainment']}; slo/breach ledger events (ts, after) "
          f"{[(e['ts'], e['after']) for e in breach_events]}, the fault from {fault_t0:.3f} "
          f"to the burn's end {burn_end:.3f}; attribution {json.dumps(attribution)}")
    if before["windows"]["fast"]["breaches"] or fast_breaches < 1 or \
            fast_breaches != len(fast_events) or \
            any(e["ts"] < fault_t0 for e in fast_events):
        fail(f"control: scoring-latency fast-window breaches before the burn "
             f"{before['windows']['fast']['breaches']}, after it {fast_breaches} with "
             f"{len(fast_events)} in the ledger")
    if attribution["dominant_stage"] not in ("dispatch", "device_execute", "fetch"):
        fail(f"control: the latency budget went to {attribution}")

    # 2. one incident on disk, the fault plan ranked above any autopilot decision
    incident_dir = os.path.join(ledger_root, "worker-0", "incidents")
    on_disk_reports = sorted(n for n in os.listdir(incident_dir) if n.startswith("incident-"))
    print(f"control: incidents {json.dumps(reports)}; on disk {on_disk_reports}")
    if report is None or len(reports) != len(on_disk_reports) or cli["incident"] != report or \
            f"incident-{report['id']}.json" not in on_disk_reports or \
            any(r["ts"] < fault_t0 - 1.0 for r in reports):
        fail("control: no incident of the burn on disk, or one before it")
    ranked = [(c["actor"], c["action"]) for c in report["candidates"]]
    fault_rank = ranked.index(("faults", "inject-plan")) if ("faults", "inject-plan") in \
        ranked else None
    decision_ranks = [i for i, c in enumerate(ranked) if c == ("autopilot", "decision")]
    if fault_rank is None or (decision_ranks and min(decision_ranks) < fault_rank):
        fail(f"control: incident {report['id']} ranks {ranked[:8]}")
    print(f"control: incident {report['id']} ({report['trigger']}): {len(on_disk_reports)} on "
          f"disk, candidates {json.dumps(report['candidates'][:3])}")

    # 3. the autopilot applied a decision, the engine or the gate reports it,
    # and nothing follows once disabled
    knob = {"dispatch_depth": "dispatch_depth", "fill_window": "fill_window_us",
            "max_inflight": "max_inflight", "shed": "shed_level"}
    last = {}
    for decision in applied:
        last[decision["actuator"]] = decision["to"]
    mismatched = {a: (v, tuning.get(knob.get(a))) for a, v in last.items()
                  if a in knob and tuning.get(knob[a]) != v}
    burn_decisions = {(d["actuator"], d["direction"], d["reason"]) for d in applied}
    print(f"control: autopilot applied {json.dumps(applied)}; live {json.dumps(tuning)}; "
          f"frozen for the recovery stage ({after_recovery['ticks']} ticks)")
    if not burn_decisions & {("dispatch_depth", "down", "burn_device"),
                             ("shed", "up", "sustained_burn")} or mismatched:
        fail(f"control: autopilot decisions {sorted(burn_decisions)}; live values differ "
             f"{mismatched}")
    if frozen["enabled"] or after_recovery["decisions"] != pilot["decisions"] or \
            cli["autopilot"] != [False, True, False]:
        fail(f"control: after disable {len(after_recovery['decisions'])} decisions (had "
             f"{len(pilot['decisions'])}); cli autopilot status|enable|disable {cli['autopilot']}")

    # 4. the knobs moved no score: the lone requests, before and after
    for machine in CONTROL_LONE:
        if lone_before[machine] != lone_after[machine]:
            fail(f"control: {machine}'s lone response changed across the autopilot's moves")
    print(f"control: {len(CONTROL_LONE)} lone requests equal to the bit before and after")

    # 5. traffic: the sketch holds what was sent, in the skew's order; the
    # scrape keeps the most requested machines; the export validates
    machines = telemetry["traffic"]["machines"]
    counted = {m["machine"]: (m["count"], m["error"]) for m in machines}
    bad = {m: (counted.get(m), n) for m, n in sent.items()
           if m not in counted or not counted[m][0] - counted[m][1] <= n <= counted[m][0]}
    dense_order = [m["machine"] for m in machines if m["machine"] in CONTROL_DENSE]
    expected_order = sorted(CONTROL_DENSE, key=lambda m: (-sent[m], m))
    top = sorted(sent, key=lambda m: (-sent[m], m))[:CONTROL_CARDINALITY]
    kept = sorted(labels["machine"] for labels, _ in
                  prometheus.get("gordo_server_smoke_machine_index", ())
                  if labels["machine"] != "other")
    problems = telemetry_engine.validate_layout_input(export) + \
        telemetry_engine.validate_layout_input(cli["export"])
    rung = telemetry["costs"]["engine"]["rungs"]["f32"]
    top_k = [(m["machine"], m["count"], m["error"]) for m in machines]
    print(f"control: traffic top-k {json.dumps(top_k)}; "
          f"the scrape kept {kept}; costs f32 {json.dumps(rung)}; export of "
          f"{len(export['machines'])} machines valid")
    if bad or dense_order != expected_order or kept != sorted(top) or problems or \
            rung["device_bytes"] != stacked or \
            cli["costs"]["costs"]["engine"]["rungs"]["f32"]["device_bytes"] != stacked or \
            [m["machine"] for m in cli["traffic"]["traffic"]["machines"]] != \
            [m["machine"] for m in machines]:
        fail(f"control: traffic counts off {bad}; dense order {dense_order} vs "
             f"{expected_order}; the scrape kept {kept}, the most requested {top}; export "
             f"{problems}; device bytes {rung['device_bytes']} vs stacked {stacked}")

    # 6. the warehouse under its budget; the second server reloaded history
    print(f"control: warehouse {json.dumps(telemetry['warehouse'])}, {on_disk} bytes on disk "
          f"(budget {budget}); the second server reloaded {reloaded['warehouse']['records']} "
          f"records, {reloaded['window']['records']} in its window")
    if on_disk > budget or reloaded["warehouse"]["records"] < 1 or \
            "gordo_server_requests_total" not in reloaded["window"]["rates"] or \
            reloaded["window"]["records"] < 1:
        fail(f"control: warehouse {on_disk} bytes of {budget}; reloaded "
             f"{json.dumps(reloaded['warehouse'])}, window records "
             f"{reloaded['window']['records']}")

    # 7. the flash kernel: once per layer per PatchTST dispatch
    expected = {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"] * patchtst_dispatches}
    expected_second = {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"] * second_dispatches}
    if launches != expected or launches_second != expected_second or not patchtst_dispatches:
        fail(f"control: launches {launches} for {patchtst_dispatches} PatchTST dispatches, "
             f"{launches_second} for the second server's {second_dispatches}")

    # 8. what the loops cost, on the skewed dense stage
    for key in CONTROL_ENV:
        os.environ.pop(key, None)
    os.environ.pop("GORDO_LEDGER_DIR", None)
    control_ledger.configure(None)
    control_loop_cost(dense_dir, skewed, encoded, device, card)
    control_ledger.configure(None)
    print(f"control [{card}]: " + json.dumps({
        "phase_s": time.perf_counter() - phase_started, "stage_s": stage_walls,
        "burn_scrapes": burn_scrapes.count,
        "skewed": {"requests": len(skew_walls), "p50_ms": float(np.percentile(skew_walls, 50)),
                   "p99_ms": float(np.percentile(skew_walls, 99))},
        "burn": {"requests": len(burn_walls), "p50_ms": float(np.percentile(burn_walls, 50)),
                 "p99_ms": float(np.percentile(burn_walls, 99))},
        "recover": {"requests": len(recover_walls),
                    "p50_ms": float(np.percentile(recover_walls, 50))},
        "patchtst_dispatches": patchtst_dispatches, "launches": launches,
        "second_server": {"dispatches": second_dispatches, "launches": launches_second},
        "wall_to_reload_s": phase_wall}))
    return {n: launches[n] + launches_second[n] for n in KERNELS}


TIER_DENSE = [f"tier-dense-{i:02d}" for i in range(24)]
TIER_PATCHTST = ["tier-patchtst-0", "tier-patchtst-1"]
TIER_BF16 = "tier-patchtst-bf16"
TIER_MACHINES = TIER_DENSE + TIER_PATCHTST + [TIER_BF16]
TIER_RELOAD = TIER_DENSE[0]  # a generation root: the rolling reload and the rollback
TIER_SLOW = TIER_DENSE[-1]  # an engine-dispatch latency fault holds its request in flight
TIER_SLOW_S = 2.0  # seconds of that fault: the drain's window
TIER_HOT = TIER_DENSE[1]
TIER_HOT_RPS = 10.0  # the placement's promotion rate (its window is 10 s)
TIER_HOT_REQUESTS = 240
TIER_CLIENTS = 4
TIER_WINDOWS = SEAMS_WINDOWS  # windows of a PatchTST request: BH 8192, as phase 2 holds
# alternating pairs, routed and direct (cut from 400 and 100 to keep the
# script within its time limit)
TIER_OVERHEAD = {"dense": 100, "patchtst": 25}
TIER_WORKERS = 2
TIER_PROBE_S = 0.5
TIER_READY_S = 300.0
TIER_BOOT_GRACE_S = 180.0
TIER_B_REQUESTS = 10


class TierWorkers:
    """Tier A's worker factory: every incarnation of a slot is a
    ``SubprocessWorker`` running the port's ``run-server --worker-id i``
    through CLI_RUNNER, with a launch record and a log of its own. Each
    incarnation banks its engine's PatchTST dispatches (from ``/metrics``)
    before every engine swap and before it stops, so that its launches can
    be held to 3 per dispatch."""

    def __init__(self, tmp: str, models_dir: str, device_arg, env: dict):
        self.tmp, self.models_dir, self.device_arg, self.env = tmp, models_dir, device_arg, env
        self.incarnations = []
        self._logs = []

    def __call__(self, spec):
        from gordo_components_tpu_torch.router import SubprocessWorker, server_worker_argv

        n = len(self.incarnations)
        record = os.path.join(self.tmp, f"tier-{spec.name}-{n}.json")
        log_path = os.path.join(self.tmp, f"tier-{spec.name}-{n}.log")
        log = open(log_path, "wb")
        self._logs.append(log)
        argv = server_worker_argv(spec, self.models_dir,
                                  launcher=[sys.executable, "-c", CLI_RUNNER, record],
                                  device=self.device_arg)
        worker = SubprocessWorker(spec, argv, env=self.env, stdout=log, stderr=subprocess.STDOUT)
        self.incarnations.append({"name": spec.name, "worker": worker, "record": record,
                                  "log": log_path, "banked": {"f32": 0, "bf16": 0},
                                  "killed": False})
        return worker

    def live(self, name: str) -> dict:
        return [inc for inc in self.incarnations if inc["name"] == name][-1]

    def dispatches(self, inc: dict) -> dict:
        """The incarnation's current engine's PatchTST dispatches by
        compute dtype, from its /metrics."""
        status, _, raw, _ = http("GET", inc["worker"].spec.base_url + "/metrics")
        if status != 200:
            fail(f"tier: {inc['name']} /metrics answered HTTP {status}")
        # the PatchTST buckets are the ones of lookback LOOKBACK (the dense
        # machines read flat rows)
        buckets = json.loads(raw)["engine"]["bucket_dispatches"]
        return {rung: sum(counts["dispatches"] for key, counts in buckets.items()
                          if key.startswith(f"L{LOOKBACK}a") and key.endswith(f"/{dtype}"))
                for rung, dtype in (("f32", "float32"), ("bf16", "bfloat16"))}

    def bank(self, inc: dict) -> dict:
        """Add the current engine's PatchTST dispatches to the
        incarnation's total; called once per engine, just before it is
        swapped or stopped."""
        counts = self.dispatches(inc)
        for key, value in counts.items():
            inc["banked"][key] += value
        return counts

    def tail(self, inc: dict, n: int = 3000) -> str:
        try:
            with open(inc["log"], "rb") as fh:
                return fh.read()[-n:].decode(errors="replace")
        except OSError:
            return ""

    def close(self) -> None:
        for log in self._logs:
            log.close()


def tier_launch_sums(incarnations: list, kernels=None) -> tuple:
    """Hold every worker process's launch record to its banked PatchTST
    dispatches: ``flash_fwd_f32`` = 3 x its fp32 dispatches, ``flash_fwd_bf16``
    = 3 x its bf16 ones, no backward launch. A SIGKILLed incarnation writes no
    record and is left out. Returns (the summed launches by kernel, the
    problems found)."""
    kernels = kernels or KERNELS
    layers = SLICE["n_layers"]
    sums = dict.fromkeys(kernels, 0)
    problems = []
    for inc in incarnations:
        if inc["killed"]:
            continue
        try:
            with open(inc["record"]) as fh:
                launches = json.load(fh)["launches"]
        except (OSError, ValueError, KeyError) as exc:
            problems.append(f"{inc['name']}: no launch record ({exc})")
            continue
        want = {name: 0 for name in kernels}
        want["flash_fwd_f32"] = layers * inc["banked"]["f32"]
        want["flash_fwd_bf16"] = layers * inc["banked"]["bf16"]
        got = {name: launches.get(name, 0) for name in kernels}
        if got != want:
            problems.append(f"{inc['name']} ({os.path.basename(inc['record'])}): launches {got}, "
                            f"want {want} for dispatches {inc['banked']}")
        for name in kernels:
            sums[name] += got[name]
    return sums, problems


class TierClients:
    """``TIER_CLIENTS`` threads asking the router for ``machines`` in turn,
    ``pause`` s apart (so that no machine's rate reaches the hot threshold
    by accident), until stopped; every status is kept, every non-200
    named."""

    def __init__(self, base: str, machines: list, encoded: dict, pause: float = 0.05):
        self.base, self.machines, self.encoded, self.pause = base, machines, encoded, pause
        self.statuses, self.errors, self.answered_by = [], [], {}
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(c,), daemon=True)
                         for c in range(TIER_CLIENTS)]

    def _run(self, c: int) -> None:
        i = c
        while not self._stop.is_set():
            machine = self.machines[i % len(self.machines)]
            i += TIER_CLIENTS
            try:
                status, headers, raw, _ = http(
                    "POST", f"{self.base}/gordo/v0/project/{machine}/anomaly/prediction",
                    self.encoded[machine])
            except Exception as exc:  # noqa: BLE001 - reported by the phase
                self.errors.append(f"{machine}: {exc!r}")
                continue
            self.statuses.append(status)
            if status != 200:
                self.errors.append(f"{machine}: HTTP {status} {raw[:200]!r}")
            worker = headers.get("X-Gordo-Worker")
            self.answered_by[worker] = self.answered_by.get(worker, 0) + 1
            self._stop.wait(self.pause)

    def __enter__(self):
        for thread in self._threads:
            thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for thread in self._threads:
            thread.join(timeout=120)

    def check(self, label: str) -> None:
        if self.errors or any(thread.is_alive() for thread in self._threads):
            fail(f"tier {label}: clients saw {len(self.errors)} error(s) of "
                 f"{len(self.statuses)}: {self.errors[:3]}")
        if not self.statuses:
            fail(f"tier {label}: the clients sent nothing")


def tier_build(models_dir: str, device) -> dict:
    """The tier's models root: ``TIER_DENSE`` at bench.py's ``dense_ae_10tag``
    widths (``TIER_RELOAD`` as a generation root), the slice machine twice in
    fp32 and once in bf16. Returns {machine: tags}."""
    import shutil

    from gordo_components_tpu_torch.serializer import load, load_metadata, write_artifact_files
    from gordo_components_tpu_torch.store.generations import commit_generation

    estimator, kwargs, tags = ZOO["dense-ae-10tag"]
    for i, name in enumerate(TIER_DENSE):
        build_zoo_artifact(os.path.join(models_dir, name), estimator, kwargs, tags, device,
                           np.random.default_rng(SEED + 14000 + i))
    flat = os.path.join(models_dir, TIER_RELOAD)
    model, metadata = load(flat, device="cpu"), load_metadata(flat)
    shutil.rmtree(flat)
    commit_generation(flat, lambda staging: write_artifact_files(model, staging, metadata))
    for i, name in enumerate(TIER_PATCHTST):
        build_artifact(os.path.join(models_dir, name), device, seed=SEED + 14100 + i)
    build_artifact(os.path.join(models_dir, TIER_BF16), device, compute_dtype="bfloat16",
                   seed=SEED + 14200)
    return {**{name: tags for name in TIER_DENSE},
            **{name: N_TAGS for name in TIER_PATCHTST + [TIER_BF16]}}


def tier_commit_reload(models_dir: str, device) -> None:
    """A new generation of ``TIER_RELOAD`` (other weights) through the
    port's store."""
    import shutil

    from gordo_components_tpu_torch.serializer import load, load_metadata, write_artifact_files
    from gordo_components_tpu_torch.store.generations import commit_generation

    estimator, kwargs, tags = ZOO["dense-ae-10tag"]
    staged = os.path.join(os.path.dirname(models_dir), "tier-reload-staged")
    build_zoo_artifact(staged, estimator, kwargs, tags, device,
                       np.random.default_rng(SEED + 14300))
    model, metadata = load(staged, device="cpu"), load_metadata(staged)
    shutil.rmtree(staged)
    commit_generation(os.path.join(models_dir, TIER_RELOAD),
                      lambda staging: write_artifact_files(model, staging, metadata))


def tier_cpu_answers(models_dir: str, bodies: dict, names: list) -> dict:
    """Each machine's answer to its body on the CPU plain path."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine

    answers = {}
    for name in names:
        cpu = ServingEngine({name: load(os.path.join(models_dir, name), device="cpu")},
                            device="cpu")
        try:
            answers[name] = cpu_plain_answer(
                lambda rows: dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, rows))), bodies[name])
        finally:
            cpu.close()
    return answers


def tier_wait(predicate, timeout: float, what: str, poll: float = 0.01) -> float:
    """Seconds until ``predicate()`` holds; fails after ``timeout``."""
    started = time.perf_counter()
    while not predicate():
        if time.perf_counter() - started > timeout:
            fail(f"tier: {what} not within {timeout:.0f} s")
        time.sleep(poll)
    return time.perf_counter() - started


def tier_check_scores(label: str, status: int, raw: bytes, plain: dict, tags: int,
                      rtol: float) -> float:
    if status != 200:
        fail(f"tier {label}: HTTP {status} {raw[:300]!r}")
    payload = json.loads(raw)
    rows = len(plain["model-output"])
    payload["data"] = end_rows(payload["data"], rows)
    return compare_scores(f"tier {label}", rows, payload, plain, rtol, tags)


def tier_percentiles(walls: list) -> dict:
    return {"n": len(walls), "p50_ms": float(np.percentile(walls, 50)),
            "p99_ms": float(np.percentile(walls, 99)), "max_ms": float(np.max(walls))}


def tier_overhead(walls: dict) -> dict:
    """Routed and direct walls of alternating pairs: each side's
    percentiles, and the median of the pairs' differences (routed - direct)
    with a 95 % bootstrap interval, which says whether the router's cost is
    resolved at all under the requests' own spread."""
    diffs = np.asarray(walls["routed"]) - np.asarray(walls["direct"])
    rng = np.random.default_rng(SEED)
    medians = np.median(diffs[rng.integers(0, len(diffs), (2000, len(diffs)))], axis=1)
    low, high = np.percentile(medians, [2.5, 97.5])
    return {**{label: tier_percentiles(w) for label, w in walls.items()},
            "paired_median_ms": float(np.median(diffs)),
            "paired_median_95_ms": [float(low), float(high)]}


def tier_scoring_series(url: str) -> dict:
    """The scoring endpoints' request counters of one Prometheus
    exposition, by series."""
    samples = tier_prometheus(url)
    picked = {}
    for family in ("gordo_server_requests_total", "gordo_server_request_duration_seconds_count"):
        for labels, value in samples.get(family, []):
            if labels.get("endpoint") in ("anomaly", "prediction", "bulk-anomaly"):
                picked[(family, tuple(sorted(labels.items())))] = value
    return picked


def phase_tier(torch, device, tmp: str, card: str) -> dict:
    """The fleet tier on the card (see the module docstring, 14). Returns the
    flash launches of Tier A's worker processes."""
    import signal

    from gordo_components_tpu_torch.router import WorkerSpec, assemble_fleet, make_router_server

    phase_started = time.perf_counter()
    models_dir = os.path.join(tmp, "tier")
    tags = tier_build(models_dir, device)
    rng = np.random.default_rng(SEED + 14400)
    bodies = {name: sensor_rows(rng, SEAMS_ROWS, tags[name]) for name in TIER_DENSE}
    bodies.update({name: sensor_rows(rng, LOOKBACK + TIER_WINDOWS - 1)
                   for name in TIER_PATCHTST + [TIER_BF16]})
    encoded = {name: json.dumps({"X": X.tolist()}).encode() for name, X in bodies.items()}
    print(f"tier: {len(TIER_MACHINES)} machines built in {time.perf_counter() - phase_started:.1f} "
          f"s; their CPU plain answers are computed beside the workers' boot")
    plain_run = {}

    def cpu_plain():
        # a thread: fail() raises SystemExit here, which the caller reads as
        # a missing result (its message is on stderr already)
        try:
            started = time.perf_counter()
            plain_run["answers"] = tier_cpu_answers(models_dir, bodies, TIER_MACHINES)
            plain_run["s"] = time.perf_counter() - started
        except SystemExit:
            pass

    plain_thread = threading.Thread(target=cpu_plain, name="tier-cpu-plain")

    for key in ("GORDO_AUTOPILOT", "GORDO_FAULTS", "GORDO_LEDGER_DIR", "GORDO_TELEMETRY_DIR"):
        os.environ.pop(key, None)
    root = os.path.dirname(os.path.abspath(__file__))
    device_arg = "cpu" if device.type == "cpu" else None
    factory = TierWorkers(tmp, models_dir, device_arg, {
        "PYTHONPATH": root,
        "GORDO_FAULTS": f"engine-dispatch:{TIER_SLOW}:latency:{TIER_SLOW_S}",
        "GORDO_LEDGER_DIR": os.path.join(tmp, "tier-ledger"),
    })
    ports = [free_port() for _ in range(TIER_WORKERS)]
    specs = [WorkerSpec(f"worker-{i}", i, "127.0.0.1", port) for i, port in enumerate(ports)]
    router = assemble_fleet(specs, factory, project="project", models_root=models_dir,
                            replicas=2, hot_rps=TIER_HOT_RPS, boot_grace=TIER_BOOT_GRACE_S)
    supervisor, control = router.supervisor, router.control
    front = None
    times = {}
    # Tier B's process boots beside Tier A's workers and is done with
    # before Tier A's checks
    tier_b_state = tier_b_start(models_dir, root, device_arg, set(ports))
    try:
        started = time.perf_counter()
        supervisor.start_all()
        plain_thread.start()
        ready = supervisor.wait_ready(timeout=TIER_READY_S)
        times["boot_s"] = time.perf_counter() - started
        if len(ready) != TIER_WORKERS:
            fail(f"tier: only {ready} of {TIER_WORKERS} workers booted in {TIER_READY_S:.0f} s: "
                 + factory.tail(factory.incarnations[0]))
        times.update(tier_b(tier_b_state, encoded, card))
        control.start(interval=TIER_PROBE_S)
        front = make_router_server(router, "127.0.0.1", 0)
        threading.Thread(target=front.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{front.server_address[1]}"
        worker_url = {spec.name: spec.base_url for spec in specs}
        worker_id = {spec.name: str(spec.worker_id) for spec in specs}
        plain_thread.join()
        if "answers" not in plain_run:
            fail("tier: the CPU plain answers failed")
        plain = plain_run["answers"]
        print(f"tier [{card}]: {TIER_WORKERS} workers on the card ready in "
              f"{times['boot_s']:.1f} s (launched together, beside Tier B's two and the CPU "
              f"plain answers, {plain_run['s']:.1f} s)")

        # 1. placement and bytes
        worst = {"dense": 0.0, "f32": 0.0, "bf16": 0.0}
        for name in TIER_MACHINES:
            owner = router.placement.replica_set(name)[0]
            path = f"/gordo/v0/project/{name}/anomaly/prediction"
            status, headers, routed, _ = http("POST", base + path, encoded[name])
            if headers.get("X-Gordo-Worker") != worker_id[owner]:
                fail(f"tier placement: {name} answered by worker "
                     f"{headers.get('X-Gordo-Worker')}, placed on {owner}")
            direct_status, _, direct, _ = http("POST", worker_url[owner] + path, encoded[name])
            if (status, routed) != (direct_status, direct):
                fail(f"tier placement: {name}'s routed body differs from the direct one "
                     f"(HTTP {status} vs {direct_status})")
            kind = "bf16" if name == TIER_BF16 else "f32" if name in TIER_PATCHTST else "dense"
            rtol = BF16_SERVE_RTOL if kind == "bf16" else SERVE_RTOL
            worst[kind] = max(worst[kind], tier_check_scores(
                f"placement {name}", status, routed, plain[name], tags[name], rtol))
        print(f"tier placement: {len(TIER_MACHINES)} machines answered by their placed worker, "
              f"routed bytes == direct bytes; vs the CPU plain path: dense {worst['dense']:.3g}, "
              f"fp32 PatchTST {worst['f32']:.3g} (limit {SERVE_RTOL}), bf16 "
              f"{worst['bf16']:.3g} (limit {BF16_SERVE_RTOL})")

        # the router's overhead: routed and direct in pairs, one at a time,
        # each pair's order swapped from the last
        # (the PatchTST machine placed on the worker that check 5 drains, if
        # there is one: a SIGTERMed worker records its launches, the one
        # check 6 SIGKILLs none)
        overhead = {}
        drained = router.placement.replica_set(TIER_SLOW)[0]
        timed = next((m for m in TIER_PATCHTST if router.placement.replica_set(m)[0] == drained),
                     TIER_PATCHTST[0])
        for kind, machine in (("dense", TIER_DENSE[3]), ("patchtst", timed)):
            owner = router.placement.replica_set(machine)[0]
            path = f"/gordo/v0/project/{machine}/anomaly/prediction"
            walls = {"routed": [], "direct": []}
            pair = [("routed", base + path), ("direct", worker_url[owner] + path)]
            for i in range(TIER_OVERHEAD[kind]):
                for label, url in (pair if i % 2 == 0 else pair[::-1]):
                    status, _, _, ms = http("POST", url, encoded[machine])
                    if status != 200:
                        fail(f"tier overhead: {label} {machine} HTTP {status}")
                    walls[label].append(ms)
            overhead[kind] = tier_overhead(walls)
        print(f"tier [{card}]: router overhead (workers are processes sharing the card, clients "
              f"and router in this process; not comparable with phase 5's in-process times) "
              + json.dumps(overhead))

        # 2. hot replication
        hot = TierClients(base, [TIER_HOT], encoded, pause=0.0)
        with hot:
            tier_wait(lambda: len(hot.statuses) >= TIER_HOT_REQUESTS, 300, "the hot burst")
        hot.check("hot replication")
        if not router.placement.is_hot(TIER_HOT) or TIER_HOT not in \
                router.placement.stats()["hot_machines"]:
            fail(f"tier hot: {TIER_HOT} not promoted after {len(hot.statuses)} requests")
        if set(hot.answered_by) != set(worker_id.values()):
            fail(f"tier hot: {TIER_HOT} answered by {hot.answered_by}, want both workers")
        print(f"tier hot: {TIER_HOT} promoted at {TIER_HOT_RPS} req/s, {len(hot.statuses)} "
              f"requests answered by workers {hot.answered_by}")

        # 3. one stitched trace
        status, headers, _, _ = http(
            "POST", f"{base}/gordo/v0/project/{TIER_PATCHTST[1]}/anomaly/prediction",
            encoded[TIER_PATCHTST[1]], {"X-Gordo-Trace-Id": "tier-stitched"})
        owner = router.placement.replica_set(TIER_PATCHTST[1])[0]
        timeline = json.loads(http("GET", f"{base}/debug/requests/tier-stitched")[2])
        spans = timeline.get("spans", [])
        route = [s for s in spans if s["name"] == "route"]
        lane = [s for s in spans if s.get("process") == owner]
        if status != 200 or not route or not {"device_execute", "fetch"} <= \
                {s["name"] for s in lane}:
            fail(f"tier stitch: route {bool(route)}, {owner}'s lane "
                 f"{sorted({s['name'] for s in lane})}")
        window = (route[0]["start_ms"] - 2.0, route[0]["start_ms"] + route[0]["duration_ms"] + 2.0)
        if not all(window[0] <= s["start_ms"] and s["start_ms"] + s["duration_ms"] <= window[1]
                   for s in lane):
            fail(f"tier stitch: {owner}'s spans leave the route window {window}")
        samples = tier_prometheus(base + "/metrics?format=prometheus")
        merged = sum(v for labels, v in samples.get("gordo_router_stitch_total", [])
                     if labels.get("outcome") == "merged")
        if merged < 1:
            fail(f"tier stitch: gordo_router_stitch_total merged {merged}")
        stage = {s["name"]: round(s["duration_ms"], 2) for s in lane}
        print(f"tier stitch: a routed PatchTST trace holds route "
              f"{route[0]['duration_ms']:.1f} ms and {owner}'s lane inside it {stage}; "
              f"{merged:.0f} merged")

        # 4. scrape of scrapes
        scrape = "/metrics?format=prometheus"
        workers_series = {name: tier_scoring_series(url + scrape)
                          for name, url in worker_url.items()}
        # the router's own registry, which the aggregate adds: this process's
        # (earlier phases' in-process servers counted into it)
        own = tier_scoring_series(base + scrape)
        aggregate = tier_scoring_series(base + scrape + "&aggregate=1")
        for key in set(own) | set(aggregate) | {k for w in workers_series.values() for k in w}:
            want = own.get(key, 0.0) + sum(w.get(key, 0.0) for w in workers_series.values())
            if abs(aggregate.get(key, 0.0) - want) > 1e-9:
                fail(f"tier aggregate: {key} is {aggregate.get(key)} in the aggregate, "
                     f"{want} summed")
        telemetry = json.loads(http("GET", base + "/telemetry")[2])
        tiers = set(telemetry.get("workers") or [])
        if not set(worker_url) <= tiers or telemetry.get("errors"):
            fail(f"tier telemetry: the fleet view holds workers {sorted(tiers)}, errors "
                 f"{telemetry.get('errors')}")
        for url in [base, *worker_url.values()]:
            slo = json.loads(http("GET", url + "/slo")[2])
            if not slo.get("enabled") or not slo.get("objectives"):
                fail(f"tier slo: {url}/slo answered {str(slo)[:200]}")
        print(f"tier aggregate: {len(aggregate)} scoring series equal the workers' sum (and the "
              f"router's own); /telemetry holds {sorted(tiers)}; /slo answers on the router and "
              f"each worker")

        # 7. rolling reload, then rollback (before 5 and 6: the ring holds
        # the two workers the checks name)
        dense_traffic = [m for m in TIER_DENSE if m != TIER_SLOW]
        for name in worker_url:
            factory.bank(factory.live(name))
        tier_commit_reload(models_dir, device)
        fresh = tier_cpu_answers(models_dir, bodies, [TIER_RELOAD])[TIER_RELOAD]
        with TierClients(base, dense_traffic, encoded) as clients:
            started = time.perf_counter()
            status, _, raw, _ = http("POST", base + "/reload", b"")
            times["reload_s"] = time.perf_counter() - started
        clients.check("reload")
        result = json.loads(raw)
        if status != 200 or result.get("aborted") or result.get("canary") != sorted(worker_url)[0] \
                or list(result["workers"]) != sorted(worker_url) \
                or not all(w["ok"] for w in result["workers"].values()):
            fail(f"tier reload: HTTP {status} {json.dumps(result)[:600]}")
        for url in [base, *worker_url.values()]:
            status, _, raw, _ = http("POST", f"{url}/gordo/v0/project/{TIER_RELOAD}/anomaly/"
                                             "prediction", encoded[TIER_RELOAD])
            tier_check_scores(f"reload {url}", status, raw, fresh, tags[TIER_RELOAD], SERVE_RTOL)
        for name in worker_url:
            factory.bank(factory.live(name))
        started = time.perf_counter()
        status, _, raw, _ = http("POST", base + "/rollback", b"")
        times["rollback_s"] = time.perf_counter() - started
        rolled = json.loads(raw)
        if status != 200 or rolled.get("aborted") or TIER_RELOAD not in rolled.get("restored", {}):
            fail(f"tier rollback: HTTP {status} {json.dumps(rolled)[:600]}")
        for url in [base, *worker_url.values()]:
            status, _, raw, _ = http("POST", f"{url}/gordo/v0/project/{TIER_RELOAD}/anomaly/"
                                             "prediction", encoded[TIER_RELOAD])
            tier_check_scores(f"rollback {url}", status, raw, plain[TIER_RELOAD],
                              tags[TIER_RELOAD], SERVE_RTOL)
        print(f"tier [{card}] reload: canary {result['canary']} then {sorted(result['workers'])}, "
              f"{times['reload_s']:.2f} s, clients {len(clients.statuses)} requests all 200; "
              f"{TIER_RELOAD} answers its new generation on both workers; rollback in "
              f"{times['rollback_s']:.2f} s restores the old answers")

        # 5. graceful drain under dense traffic, the elastic seam's third
        # worker booting beside the victim's respawn (8 checks it)
        elastic = router.autopilot.elastic
        victim = router.placement.replica_set(TIER_SLOW)[0]
        inc = factory.live(victim)
        factory.bank(inc)
        slow = {}

        def slow_request():
            slow["answer"] = http("POST", f"{base}/gordo/v0/project/{TIER_SLOW}/anomaly/"
                                          f"prediction", encoded[TIER_SLOW])

        respawns = supervisor.respawn_counts()[victim]
        with TierClients(base, dense_traffic, encoded) as clients:
            time.sleep(0.5)
            slow_thread = threading.Thread(target=slow_request, daemon=True)
            slow_thread.start()
            time.sleep(0.5)  # the slow request now sleeps in its dispatch's fault
            terminated = time.perf_counter()
            os.kill(inc["worker"].pid, signal.SIGTERM)
            added = elastic.apply_target(TIER_WORKERS + 1)
            seen = {}

            def draining():
                try:
                    status, headers, raw, _ = http("GET", worker_url[victim] + "/healthz")
                except OSError:
                    return False
                if status == 503 and headers.get("X-Gordo-Draining") == "1" and \
                        json.loads(raw).get("status") == "draining":
                    seen["at"] = time.perf_counter() - terminated
                    return True
                return False

            tier_wait(draining, 10, f"{victim}'s /healthz answering draining")
            tier_wait(lambda: not inc["worker"].alive(), 60, f"{victim} exiting")
            times["drain_s"] = time.perf_counter() - terminated
            tier_wait(lambda: supervisor.respawn_counts()[victim] > respawns, 30,
                      f"{victim} respawned")
            times["drain_to_respawn_s"] = time.perf_counter() - terminated
            times["drain_respawn_ready_s"] = tier_wait(
                lambda: control.routable(victim) and
                (control.last_probe(victim) or {}).get("state") == "ok",
                TIER_READY_S, f"{victim} ready again", poll=0.05)
            slow_thread.join(timeout=30)
            if not elastic.join(timeout=TIER_READY_S) or \
                    (elastic.last_op() or {}).get("state") != "spawned":
                fail(f"tier elastic: spawn of {added}: {elastic.last_op()}")
            times["elastic_spawn_s"] = time.perf_counter() - terminated
            placed = next(m for m in dense_traffic if not router.placement.is_hot(m)
                          and router.placement.replica_set(m)[0] == victim)
            status, headers, _, _ = http("POST", f"{base}/gordo/v0/project/{placed}/anomaly/"
                                                 "prediction", encoded[placed])
            if status != 200 or headers.get("X-Gordo-Worker") != worker_id[victim]:
                fail(f"tier drain: {placed} after the respawn: HTTP {status} from "
                     f"{headers.get('X-Gordo-Worker')}")
        clients.check("drain")
        if (slow.get("answer") or (0,))[0] != 200:
            fail(f"tier drain: the in-flight request answered {(slow.get('answer') or ['none'])[0]}")
        if inc["worker"].pid == factory.live(victim)["worker"].pid:
            fail("tier drain: the slot was not respawned")
        print(f"tier [{card}] drain: {victim} answered /healthz draining {seen['at']:.3f} s after "
              f"SIGTERM, exited after {times['drain_s']:.2f} s (its in-flight request 200), "
              f"respawned in the same slot {times['drain_to_respawn_s']:.2f} s after SIGTERM, "
              f"ready {times['drain_respawn_ready_s']:.2f} s later; clients "
              f"{len(clients.statuses)} requests, all 200, answered by {clients.answered_by}")

        # 6. crash under dense traffic
        crashed = next(name for name in worker_url if name != victim)
        inc = factory.live(crashed)
        killed_dispatches = factory.dispatches(inc)
        respawns = supervisor.respawn_counts()[crashed]
        with TierClients(base, dense_traffic, encoded) as clients:
            time.sleep(0.5)
            inc["killed"] = True
            os.kill(inc["worker"].pid, signal.SIGKILL)
            times["eject_s"] = tier_wait(
                lambda: supervisor.respawn_counts()[crashed] > respawns, 30,
                f"{crashed} ejected")
            times["crash_respawn_ready_s"] = tier_wait(
                lambda: control.routable(crashed) and
                (control.last_probe(crashed) or {}).get("state") == "ok",
                TIER_READY_S, f"{crashed} ready again", poll=0.05)
            time.sleep(0.5)
        clients.check("crash")
        events = [e["event"] for e in control.status()["events"] if e["worker"] == crashed]
        if "ejected" not in events or "respawned" not in events:
            fail(f"tier crash: the control plane's events for {crashed}: {events}")
        print(f"tier [{card}] crash: {crashed} SIGKILLed (its last /metrics: PatchTST dispatches "
              f"{killed_dispatches}, no launch record), ejected and respawned after "
              f"{times['eject_s']:.2f} s, ready {times['crash_respawn_ready_s']:.2f} s later; "
              f"clients {len(clients.statuses)} requests, all 200")

        # 8. the elastic seam: the third worker, spawned at 5's SIGTERM,
        # answers its share and retires ring first
        with TierClients(base, dense_traffic, encoded) as clients:
            share = [m for m in TIER_MACHINES if not router.placement.is_hot(m)
                     and router.placement.replica_set(m)[0] == added]
            new_id = str(supervisor.specs[added].worker_id)
            for machine in share:
                status, headers, raw, _ = http(
                    "POST", f"{base}/gordo/v0/project/{machine}/anomaly/prediction",
                    encoded[machine])
                if status != 200 or headers.get("X-Gordo-Worker") != new_id:
                    fail(f"tier elastic: {machine} placed on {added} answered HTTP {status} by "
                         f"{headers.get('X-Gordo-Worker')}")
            factory.bank(factory.live(added))
            retired = elastic.apply_target(TIER_WORKERS)
            if not share or retired != added or added in router.placement.workers():
                fail(f"tier elastic: retired {retired}, ring {router.placement.workers()}")
            if not elastic.join(timeout=120) or (elastic.last_op() or {}).get("state") != "retired":
                fail(f"tier elastic: retire of {added}: {elastic.last_op()}")
        clients.check("elastic")
        print(f"tier [{card}] elastic: {added} booted beside the drain's respawn and joined "
              f"the ring {times['elastic_spawn_s']:.2f} s after the SIGTERM, answered its "
              f"{len(share)} machines, retired ring first; clients {len(clients.statuses)} "
              f"requests all 200")

        # 9. the watchman
        tier_watchman(base, root)

        # 10. flash launches across processes
        for name in worker_url:
            factory.bank(factory.live(name))
    finally:
        tier_b_stop(tier_b_state)
        control.stop()
        supervisor.stop_all(grace=60)
        if front is not None:
            front.shutdown()
            front.server_close()
        else:
            router.close()
        factory.close()
    launches, problems = tier_launch_sums(factory.incarnations)
    if problems:
        fail("tier launches: " + "; ".join(problems))
    print(f"tier launches: {len(factory.incarnations)} worker processes, "
          f"{sum(inc['killed'] for inc in factory.incarnations)} SIGKILLed (no record); the "
          f"others' records {launches} = {SLICE['n_layers']} x their PatchTST dispatches "
          + json.dumps({os.path.basename(inc["record"]): inc["banked"]
                        for inc in factory.incarnations if not inc["killed"]}))
    print(f"tier [{card}] times: " + json.dumps({k: round(v, 3) for k, v in times.items()})
          + f"; phase wall {time.perf_counter() - phase_started:.1f} s")
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def free_port_run(n: int) -> int:
    """The first of ``n`` consecutive free loopback ports."""
    import socket

    for _ in range(100):
        first = free_port()
        socks = []
        try:
            for i in range(n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind(("127.0.0.1", first + i))
            return first
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    fail(f"no {n} consecutive free ports")


def tier_prometheus(url: str) -> dict:
    from gordo_components_tpu_torch.observability.exposition import parse_prometheus_text

    status, _, raw, _ = http("GET", url)
    if status != 200:
        fail(f"tier: {url} answered HTTP {status}")
    return parse_prometheus_text(raw.decode())


def tier_watchman(base: str, root: str) -> None:
    """``run-watchman`` over the router and every machine, twice: all
    healthy, then with a ``probe`` fault on one machine, that one unhealthy
    with the fault's message."""
    import signal

    faulted = TIER_DENSE[5]
    for label, faults_spec in (("clean", None), ("fault", f"probe:{faulted}:error:watchman drill")):
        port = free_port()
        env = {**os.environ, "PYTHONPATH": root}
        env.pop("GORDO_FAULTS", None)
        if faults_spec:
            env["GORDO_FAULTS"] = faults_spec
        argv = [sys.executable, "-m", "gordo_components_tpu_torch.cli", "run-watchman",
                "--project", "project", "--target-url", base, "--host", "127.0.0.1",
                "--port", str(port)]
        for machine in TIER_MACHINES:
            argv += ["--machine", machine]
        proc = subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        try:
            body = None
            end = time.monotonic() + 60
            while time.monotonic() < end and body is None:
                if proc.poll() is not None:
                    fail(f"tier watchman: exited {proc.returncode}: "
                         f"{proc.stdout.read()[-2000:]!r}")
                try:
                    status, _, raw, _ = http("GET", f"http://127.0.0.1:{port}/")
                    body = json.loads(raw) if status == 200 else None
                except OSError:
                    time.sleep(0.2)
            if body is None:
                fail("tier watchman: no answer within 60 s")
        finally:
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=30)
        if code != 0:
            fail(f"tier watchman: exit {code} on SIGTERM")
        by_target = {e["target"]: e for e in body["endpoints"]}
        if sorted(by_target) != sorted(TIER_MACHINES):
            fail(f"tier watchman: probed {sorted(by_target)}")
        unhealthy = sorted(m for m, e in by_target.items() if not e["healthy"])
        want = [faulted] if faults_spec else []
        if unhealthy != want or (faults_spec and "watchman drill" not in by_target[faulted]["error"]):
            fail(f"tier watchman {label}: unhealthy {unhealthy} (want {want}): "
                 f"{[by_target[m]['error'] for m in unhealthy][:3]}")
        slowest = max(e["latency_ms"] for e in body["endpoints"])
        print(f"tier watchman ({label}): {len(by_target)} machines through the router, unhealthy "
              f"{unhealthy}" + (f" ({by_target[faulted]['error'][:80]})" if faults_spec else "")
              + f"; slowest probe {slowest:.1f} ms")


def tier_children(pid: int) -> list:
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            found.append(int(entry))
    return found


def tier_nvidia_files(pid: int) -> list:
    """The NVIDIA device files process ``pid`` holds open."""
    found = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                found.append(target)
    except OSError:
        pass
    return sorted(set(found))


def tier_b_start(models_dir: str, root: str, device_arg, taken: set) -> dict:
    """Tier B's ``run-fleet-server --workers 2`` process, started (it boots
    beside Tier A's workers, whose ports ``taken`` it leaves alone);
    ``tier_b`` checks it, ``tier_b_stop`` ends what is left of it."""
    port = free_port()
    while port in taken:
        port = free_port()
    worker_base = free_port_run(2)
    while {worker_base, worker_base + 1} & (taken | {port}):
        worker_base = free_port_run(2)
    base = f"http://127.0.0.1:{port}"
    log_path = os.path.join(os.path.dirname(models_dir), "tier-b.log")
    log = open(log_path, "wb")
    argv = [sys.executable, "-m", "gordo_components_tpu_torch.cli", "run-fleet-server",
            "--models-dir", models_dir, "--workers", "2", "--host", "127.0.0.1",
            "--port", str(port), "--worker-base-port", str(worker_base),
            "--probe-interval", str(TIER_PROBE_S)]
    if device_arg is not None:
        argv += ["--device", device_arg]
    env = {**os.environ, "PYTHONPATH": root,
           "GORDO_LEDGER_DIR": os.path.join(os.path.dirname(models_dir), "tier-b-ledger")}
    env.pop("GORDO_FAULTS", None)
    started = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    return {"proc": proc, "log": log, "log_path": log_path, "base": base, "started": started,
            "workers": []}


def tier_b_stop(state: dict) -> None:
    proc = state["proc"]
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    for pid in state["workers"]:
        try:
            os.kill(pid, 9)
        except ProcessLookupError:
            pass
    state["log"].close()


def tier_b(state: dict, encoded: dict, card: str) -> dict:
    """Tier B (``tier_b_start``): ``run-fleet-server --workers 2`` as a
    process. It boots and answers TIER_B_REQUESTS requests, PatchTST among
    them; both workers hold the card's device files open and the router
    none (nor maps libcuda or libtorch), and where nvidia-smi reports pids
    of this namespace it lists both workers and not the router; SIGTERM
    exits 0 and leaves no worker alive. Returns its boot seconds (from its
    start, beside Tier A's boot)."""
    import shutil
    import signal

    proc, base, log_path = state["proc"], state["base"], state["log_path"]

    def tail():
        state["log"].flush()
        with open(log_path, "rb") as fh:
            return fh.read()[-3000:].decode(errors="replace")

    try:
        def up():
            if proc.poll() is not None:
                fail(f"tier B: run-fleet-server exited {proc.returncode}: {tail()}")
            try:
                status, _, raw, _ = http("GET", base + "/healthz")
            except OSError:
                return False
            return status == 200 and json.loads(raw).get("status") == "ok"

        tier_wait(up, TIER_READY_S, "run-fleet-server's workers", poll=0.2)
        boot = time.perf_counter() - state["started"]
        workers = state["workers"] = tier_children(proc.pid)
        if len(workers) != 2:
            fail(f"tier B: the router has children {workers}")
        asked = (TIER_DENSE[:TIER_B_REQUESTS - 2] + TIER_PATCHTST)[:TIER_B_REQUESTS]
        for machine in asked:
            status, headers, raw, _ = http(
                "POST", f"{base}/gordo/v0/project/{machine}/anomaly/prediction", encoded[machine])
            if status != 200:
                fail(f"tier B: {machine} HTTP {status} {raw[:200]!r}")
        smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60) \
            if shutil.which("nvidia-smi") else subprocess.CompletedProcess([], 127, "", "")
        listed = {int(line) for line in smi.stdout.split() if line.strip().isdigit()}
        # the process side of the same fact, whatever pid namespace
        # nvidia-smi reports in: a process with a CUDA context holds the
        # /dev/nvidia* files open and maps libcuda
        on_card = {pid: tier_nvidia_files(pid) for pid in [*workers, proc.pid]}
        with open(f"/proc/{proc.pid}/maps") as fh:
            router_maps = fh.read()
        smi_sees_workers = smi.returncode == 0 and set(workers) <= listed
        if not all(on_card[pid] for pid in workers) or on_card[proc.pid] \
                or "libcuda" in router_maps or "libtorch" in router_maps \
                or (smi_sees_workers and proc.pid in listed):
            fail(f"tier B: nvidia-smi compute apps {sorted(listed)} (rc {smi.returncode}), "
                 f"workers {workers}, router {proc.pid}; device files open {on_card}; the "
                 f"router maps libcuda: {'libcuda' in router_maps}, libtorch: "
                 f"{'libtorch' in router_maps}")
        smi_note = ("lists the workers and not the router" if smi_sees_workers else
                    f"lists pids {sorted(listed)} of another pid namespace (rc {smi.returncode})")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        if code != 0:
            fail(f"tier B: exit {code} on SIGTERM: {tail()}")
        alive = [pid for pid in workers if os.path.exists(f"/proc/{pid}")]
        if alive:
            fail(f"tier B: workers {alive} outlived the router")
        print(f"tier [{card}] B: run-fleet-server booted 2 workers in {boot:.1f} s, answered "
              f"{len(asked)} requests; the workers {sorted(workers)} hold the card's device "
              f"files, the router {proc.pid} none and maps no libcuda or libtorch; nvidia-smi "
              f"{smi_note}; SIGTERM exit 0, no worker left")
        return {"tier_b_boot_s": boot}
    finally:
        tier_b_stop(state)


SPILL_DENSE = [f"spill-dense-{i:02d}" for i in range(64)]
SPILL_PATCHTST = ["spill-patchtst-0", "spill-patchtst-1", "spill-patchtst-2"]
SPILL_BF16 = "spill-patchtst-bf16"
SPILL_INT8 = "spill-int8"  # dense_ae_10tag at the int8 rung
SPILL_HOST = "spill-host"  # a scaler pair before the estimator: the engine cannot lift it
SPILL_EAGER = 4  # GORDO_BOOT_EAGER: the index's first names, dense machines
SPILL_RELOAD = SPILL_PATCHTST[0]  # a generation root; a new generation is committed
SPILL_PREFETCH = SPILL_DENSE[-1]  # hinted by /prefetch before its first request
SPILL_PROBED = SPILL_DENSE[-2]  # its machine-scoped /healthz must load nothing
SPILL_WINDOWS = TIER_WINDOWS  # windows of a PatchTST request: BH 8192, as phase 2 holds
SPILL_SCHEDULE = (0, 1, 0, 2, 1, 0, 2, 2, 1, 0)  # the LRU check, over SPILL_PATCHTST
SPILL_HOST_REQUESTS = 3  # host-path requests per server
SPILL_COPY_BYTES = 256 << 20  # the plain pinned copy that bounds a bundle's copy
SPILL_ENV = {"GORDO_BOOT_EAGER": str(SPILL_EAGER), "GORDO_TELEMETRY": "0"}


def spill_lru_prediction(schedule: list, sizes: dict, cap: int) -> dict:
    """The host cache's hit, miss, store and evict counts for a schedule of
    requests to lazy machines, from an empty cache of ``cap`` bytes, as the
    server counts them: a resident machine's request is one hit; any other
    request's first lookup (the server's load of the machine) is a miss
    and a store, evicting the oldest entries to make room, and the engine's
    lookup that follows is a hit, or, for an entry larger than the whole
    cap (never cached), a second miss and store."""
    from collections import OrderedDict

    cache, used = OrderedDict(), 0
    counts = dict.fromkeys(("hit", "miss", "store", "evict"), 0)
    for name in schedule:
        if name in cache:
            counts["hit"] += 1
            cache.move_to_end(name)
            continue
        counts["miss"] += 1
        counts["store"] += 1
        size = sizes[name]
        if size > cap:
            counts["miss"] += 1
            counts["store"] += 1
            continue
        while used + size > cap and cache:
            used -= cache.popitem(last=False)[1]
            counts["evict"] += 1
        cache[name] = size
        used += size
        counts["hit"] += 1
    return counts


def spill_cache_counts(engine) -> dict:
    """The host cache's counters under the names of
    :func:`spill_lru_prediction`."""
    stats = engine.host_cache.stats()
    return {"hit": stats["hits"], "miss": stats["misses"], "store": stats["loads"],
            "evict": stats["evictions"]}


def spill_delta(after: dict, before: dict) -> dict:
    return {key: after[key] - before[key] for key in after}


def spill_commit(models_dir: str, name: str, source: str) -> None:
    """The artifact at ``source`` committed as a new generation of ``name``
    through the port's store (a flat ``name`` becomes a generation root);
    ``source`` is removed."""
    import shutil

    from gordo_components_tpu_torch.serializer import load, load_metadata, write_artifact_files
    from gordo_components_tpu_torch.store.generations import commit_generation

    model, metadata = load(source, device="cpu"), load_metadata(source)
    shutil.rmtree(source)
    commit_generation(os.path.join(models_dir, name),
                      lambda staging: write_artifact_files(model, staging, metadata))


def spill_build(models_dir: str, staged: str, device) -> dict:
    """The phase's models root with its fleet index: ``SPILL_DENSE`` and
    ``SPILL_INT8`` at bench.py's ``dense_ae_10tag`` widths, the slice machine
    three times in fp32 (``SPILL_RELOAD`` a generation root), once in bf16 and
    once behind a MinMaxScaler and a StandardScaler (``SPILL_HOST``); and, at
    ``staged``, the next generation of ``SPILL_RELOAD`` (other weights), built
    here so that no build runs while the launches are counted. Returns
    {machine: tags}."""
    from gordo_components_tpu_torch.store.generations import build_fleet_index, write_fleet_index

    estimator, kwargs, tags = ZOO["dense-ae-10tag"]
    for i, name in enumerate(SPILL_DENSE):
        build_zoo_artifact(os.path.join(models_dir, name), estimator, kwargs, tags, device,
                           np.random.default_rng(SEED + 15000 + i))
    build_zoo_artifact(os.path.join(models_dir, SPILL_INT8), estimator, kwargs, tags, device,
                       np.random.default_rng(SEED + 15100), precision="int8")
    for i, name in enumerate(SPILL_PATCHTST):
        build_artifact(os.path.join(models_dir, name), device, seed=SEED + 15200 + i)
    build_artifact(os.path.join(models_dir, SPILL_BF16), device, compute_dtype="bfloat16",
                   seed=SEED + 15300)
    build_artifact(os.path.join(models_dir, SPILL_HOST), device, seed=SEED + 15400,
                   scalers=("MinMaxScaler", "StandardScaler"))
    flat = os.path.join(os.path.dirname(models_dir), "spill-flat")
    os.rename(os.path.join(models_dir, SPILL_RELOAD), flat)
    spill_commit(models_dir, SPILL_RELOAD, flat)
    build_artifact(staged, device, seed=SEED + 15600)
    write_fleet_index(models_dir, build_fleet_index(models_dir))
    return {**{name: tags for name in SPILL_DENSE + [SPILL_INT8]},
            **{name: N_TAGS for name in SPILL_PATCHTST + [SPILL_BF16, SPILL_HOST]}}


def spill_cpu_answers(models_dir: str, bodies: dict, names: list) -> dict:
    """Each machine's answer on the CPU plain path, at its rung: the engine
    for a machine it lifts, the pipeline's own ``anomaly`` for the host-path
    machine."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import _Machine

    machines = {name: _Machine(name, os.path.join(models_dir, name)) for name in names}
    # one engine for them all: each request still dispatches alone
    cpu = ServingEngine({name: m.model for name, m in machines.items()},
                        precisions={name: m.precision for name, m in machines.items()},
                        quantized={name: m.quantized for name, m in machines.items()
                                   if m.quantized is not None},
                        device="cpu")
    def score(name, rows):
        if cpu.can_score(name):
            return dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, rows)))
        frame = machines[name].model.anomaly(rows)
        return {field: np.ravel(frame[field]) if field == "total-anomaly-score"
                else frame[field] for field in wire.SCORE_FIELDS}

    answers = {}
    try:
        for name in names:
            answers[name] = cpu_plain_answer(lambda rows: score(name, rows), bodies[name])
    finally:
        cpu.close()
    return answers


def spill_same_bits(label: str, got: dict, want: dict, phase: str = "spill") -> None:
    """Two npz answers hold the same arrays, byte for byte."""
    from gordo_components_tpu_torch import wire

    for field in wire.SCORE_FIELDS:
        a, b = np.asarray(got["data"][field]), np.asarray(want["data"][field])
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            diff = (float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())
                    if a.shape == b.shape else None)
            fail(f"{phase} {label}: {field} differs from the eager server's lone answer "
                 f"({a.dtype}{a.shape} vs {b.dtype}{b.shape}, max |diff| {diff})")


def spill_rung(name: str) -> str:
    return {SPILL_INT8: "dense-int8", SPILL_BF16: "patchtst-bf16",
            SPILL_HOST: "patchtst-host-path"}.get(
        name, "patchtst-f32" if name in SPILL_PATCHTST else "dense-f32")


def spill_flash_dispatches(stats: dict, dtype: str) -> int:
    """PatchTST dispatches of the slice machine's shape at one compute
    dtype, stacked and spilled, from an engine's ``stats()``."""
    key = f"L{LOOKBACK}a0f{N_TAGS}/{dtype}"
    return (stats["bucket_dispatches"].get(key, {}).get("dispatches", 0)
            + stats["spill"]["scorer_dispatches"].get(key, 0))


def phase_spill(torch, device, tmp: str, card: str) -> dict:
    """The host-RAM spill tier and the host path on the card (see the module
    docstring, 15). Returns the phase's flash launches."""
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer.persistence import estimators
    from gordo_components_tpu_torch.server.engine import ServingEngine, _tree_map, _tree_nbytes
    from gordo_components_tpu_torch.server.server import ModelServer, make_server
    from gordo_components_tpu_torch.store.generations import build_fleet_index, write_fleet_index

    phase_started = time.perf_counter()
    models_dir = os.path.join(tmp, "spill")
    staged = os.path.join(tmp, "spill-staged")
    tags = spill_build(models_dir, staged, device)
    names = sorted(tags)
    rng = np.random.default_rng(SEED + 15500)
    bodies = {name: sensor_rows(rng, LOOKBACK + SPILL_WINDOWS - 1 if tags[name] == N_TAGS
                                else SEAMS_ROWS, tags[name]) for name in names}
    encoded = {name: json.dumps({"X": X.tolist()}).encode() for name, X in bodies.items()}
    built_s = time.perf_counter() - phase_started
    plain = spill_cpu_answers(models_dir, bodies, names)
    print(f"spill: {len(names)} machines built and indexed in {built_s:.1f} s, scored on the "
          f"CPU plain path in {time.perf_counter() - phase_started - built_s:.1f} s")

    # the cap holds two fp32 PatchTST bundles and not three, sized from the
    # bytes the engine reports for each bundle
    sizer = ServingEngine({}, lazy={name: ModelServer._lazy_loader(
        name, os.path.join(models_dir, name)) for name in SPILL_PATCHTST},
        host_cache_mb=0, device=device)
    sizes = {name: sizer._build_bundle(name, sizer._lazy[name])[1] for name in SPILL_PATCHTST}
    sizer.close()
    del sizer
    cap_mb = math.ceil(2.5 * max(sizes.values()) / 2**20)
    cap = cap_mb << 20
    if not 2 * max(sizes.values()) <= cap < sum(sizes.values()):
        fail(f"spill: a cap of {cap_mb} MiB does not hold two bundles of {sizes} but not three")

    saved = {key: os.environ.get(key) for key in (*SPILL_ENV, "GORDO_HOST_CACHE_MB")}
    os.environ.update(SPILL_ENV, GORDO_HOST_CACHE_MB=str(cap_mb))
    servers = []
    try:
        # the phase's path starts here, with both boots
        _kernels.reset_launches()
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        boot = {}
        for label, lazy_boot in (("lazy", True), ("eager", False)):
            started = time.perf_counter()
            httpd = make_server(models_dir, port=0, device=device, lazy_boot=lazy_boot)
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            servers.append((httpd, thread))
            torch.cuda.synchronize()
            boot[label] = {"wall_s": time.perf_counter() - started,
                           "device_bytes": torch.cuda.memory_allocated() - base_bytes
                           - sum(b["device_bytes"] for b in boot.values())}
        (lazy_httpd, _), (eager_httpd, _) = servers
        lazy_app, eager_app = lazy_httpd.model_server, eager_httpd.model_server
        lazy_url = f"http://127.0.0.1:{lazy_httpd.server_address[1]}"
        eager_url = f"http://127.0.0.1:{eager_httpd.server_address[1]}"
        lazy_engine = lazy_app.engine

        # 1. the lazy boot holds none of the lazy machines' bytes on the card
        lazy_names = sorted(lazy_app._state.lazy_names)
        if sorted(lazy_app.machines) != names[:SPILL_EAGER] or lazy_names != names[SPILL_EAGER:]:
            fail(f"spill: lazy boot made {sorted(lazy_app.machines)} eager and {lazy_names} lazy")
        per_machine = {n: b.stacked_nbytes() // len(b.names)
                       for b in eager_app.engine._buckets for n in b.names}
        lazy_stacked = sum(per_machine.get(n, 0) for n in lazy_names)
        held_less = boot["eager"]["device_bytes"] - boot["lazy"]["device_bytes"]
        if held_less < lazy_stacked or lazy_engine.host_cache.stats()["entries"]:
            fail(f"spill: the lazy boot holds {boot['lazy']['device_bytes']} device bytes, the "
                 f"eager {boot['eager']['device_bytes']}: {held_less} less, not the lazy "
                 f"machines' {lazy_stacked} stacked bytes (or the cache holds entries)")
        print(f"spill [{card}]: boot {json.dumps(boot)}; the lazy machines' stacked bytes "
              f"{lazy_stacked}; cap {cap_mb} MiB for fp32 PatchTST bundles of {sizes} bytes")

        def ask(url, name):
            status, payload, ms = post_body(
                f"{url}/gordo/v0/project/{name}/anomaly/prediction", encoded[name], npz=True)
            if status != 200:
                fail(f"spill: {name} answered HTTP {status}: {str(payload)[:300]}")
            return payload, ms

        # 4. /prefetch, and a probe that loads nothing
        status, _, raw, _ = http("POST", f"{lazy_url}/prefetch",
                                 json.dumps({"machines": [SPILL_PREFETCH, "ghost"]}).encode())
        started = time.perf_counter()
        lazy_engine.host_cache.quiesce()
        prefetch_dense_ms = (time.perf_counter() - started) * 1e3
        if status != 200 or json.loads(raw) != {"queued": 1, "skipped": 0, "unknown": 1}:
            fail(f"spill: /prefetch answered HTTP {status} {raw[:200]!r}")
        before = spill_cache_counts(lazy_engine)
        status, _, raw, _ = http("GET", f"{lazy_url}/gordo/v0/project/{SPILL_PROBED}/healthz")
        if status != 200 or json.loads(raw)["status"] != "lazy" or (
                spill_cache_counts(lazy_engine) != before):
            fail(f"spill: /healthz of {SPILL_PROBED} answered {status} {raw[:200]!r} or moved "
                 f"the cache's counters")

        # 2. every lazy machine: a miss, then a hit, each the eager server's
        # lone answer byte for byte, and the CPU plain path's within tolerance
        walls = {"miss": {}, "hit": {}, "eager": {}}
        eager_answers = {}
        worst = {}
        for name in lazy_names:
            if name == SPILL_HOST:
                continue
            rung = spill_rung(name)
            counts = [spill_cache_counts(lazy_engine)]
            first, miss_ms = ask(lazy_url, name)
            counts.append(spill_cache_counts(lazy_engine))
            second, hit_ms = ask(lazy_url, name)
            counts.append(spill_cache_counts(lazy_engine))
            eager, eager_ms = ask(eager_url, name)
            want_first = ({"hit": 1, "miss": 0, "store": 0, "evict": 0} if name == SPILL_PREFETCH
                          else {"hit": 1, "miss": 1, "store": 1})
            got_first = spill_delta(counts[1], counts[0])
            if {k: got_first[k] for k in want_first} != want_first or spill_delta(
                    counts[2], counts[1]) != {"hit": 1, "miss": 0, "store": 0, "evict": 0}:
                fail(f"spill: {name}'s requests moved the cache by {got_first} and "
                     f"{spill_delta(counts[2], counts[1])}")
            spill_same_bits(f"{name} miss", first, eager)
            spill_same_bits(f"{name} hit", second, eager)
            rtol = BF16_SERVE_RTOL if name == SPILL_BF16 else SERVE_RTOL
            rows = len(plain[name]["model-output"])
            worst[rung] = max(worst.get(rung, 0.0), compare_arrays(
                f"spill {name}", rows, end_rows(first["data"], rows), plain[name], rtol,
                tags[name]))
            eager_answers[name] = eager
            for kind, ms in (("miss" if name != SPILL_PREFETCH else "hit", miss_ms),
                             ("hit", hit_ms), ("eager", eager_ms)):
                walls[kind].setdefault(rung, []).append(ms)
        print(f"spill: {len(eager_answers)} lazy machines, each a miss then a hit equal to the "
              f"eager server's lone answer byte for byte; worst relative difference from the "
              f"CPU plain path by rung {json.dumps(worst)} (limits {SERVE_RTOL}, bf16 "
              f"{BF16_SERVE_RTOL})")

        # 3. the LRU schedule over the fp32 PatchTST machines
        lazy_engine.host_cache.clear()
        schedule = [SPILL_PATCHTST[i] for i in SPILL_SCHEDULE]
        before = spill_cache_counts(lazy_engine)
        for name in schedule:
            kind = "hit" if lazy_engine.host_cache.peek(name) is not None else "miss"
            payload, ms = ask(lazy_url, name)
            spill_same_bits(f"{name} schedule", payload, eager_answers[name])
            walls[kind].setdefault(spill_rung(name), []).append(ms)
        got = spill_delta(spill_cache_counts(lazy_engine), before)
        want = spill_lru_prediction(schedule, sizes, cap)
        if got != want:
            fail(f"spill: the schedule moved the cache by {got}, an LRU of {cap_mb} MiB predicts "
                 f"{want}")
        print(f"spill: the schedule {list(SPILL_SCHEDULE)} moved the cache by {got}, as an LRU "
              f"of {cap_mb} MiB predicts")

        # 4. (cont.) a prefetch of an evicted PatchTST bundle; its request hits
        evicted = [n for n in SPILL_PATCHTST if lazy_engine.host_cache.peek(n) is None][0]
        started = time.perf_counter()
        status, _, raw, _ = http("POST", f"{lazy_url}/prefetch",
                                 json.dumps({"machines": [evicted]}).encode())
        lazy_engine.host_cache.quiesce()
        prefetch_ms = (time.perf_counter() - started) * 1e3
        before = spill_cache_counts(lazy_engine)
        payload, _ = ask(lazy_url, evicted)
        moved = spill_delta(spill_cache_counts(lazy_engine), before)
        if json.loads(raw)["queued"] != 1 or moved["miss"] or moved["hit"] != 1:
            fail(f"spill: /prefetch of {evicted} answered {raw[:200]!r}; its request moved "
                 f"the cache by {moved}")
        spill_same_bits(f"{evicted} prefetched", payload, eager_answers[evicted])

        # the bundle's host-to-device copy against a plain pinned copy
        resident = [n for n in SPILL_PATCHTST if lazy_engine.host_cache.peek(n) is not None][0]
        tree = lazy_engine.host_cache.peek(resident)["entry"]
        tree_bytes = _tree_nbytes(tree)
        copy_ms = timed_ms(lambda: _tree_map(lambda a: a.to(device, non_blocking=True), tree))
        src = torch.empty(SPILL_COPY_BYTES, dtype=torch.uint8).pin_memory()
        dst = torch.empty_like(src, device=device)
        plain_copy_ms = timed_ms(lambda: dst.copy_(src, non_blocking=True))
        del src, dst

        # 5. the host path, on both servers, on the card
        host_walls, host_answers, forwards = {}, {}, []
        for label, url, app in (("lazy", lazy_url, lazy_app), ("eager", eager_url, eager_app)):
            if label == "lazy":  # the first request loads it, on the host path
                payload, ms = ask(url, SPILL_HOST)
                host_walls.setdefault(label, []).append(ms)
                host_answers[label] = payload
                forwards.append(1)
                model = lazy_engine.host_cache.peek(SPILL_HOST)["context"].model
            else:
                model = app.machines[SPILL_HOST].model
            est = next(estimators(model))
            if {p.device.type for p in est.module_.parameters()} != {"cuda"}:
                fail(f"spill: the {label} server's host-path estimator is not on the card")
            hook = est.module_.register_forward_hook(lambda *args: forwards.append(1))
            try:
                for _ in range(SPILL_HOST_REQUESTS):
                    payload, ms = ask(url, SPILL_HOST)
                    host_walls.setdefault(label, []).append(ms)
                    host_answers.setdefault(label, payload)
            finally:
                hook.remove()
        for label, payload in host_answers.items():
            rows = len(plain[SPILL_HOST]["model-output"])
            compare_arrays(f"spill host path ({label})", rows, end_rows(payload["data"], rows),
                           plain[SPILL_HOST], SERVE_RTOL, N_TAGS)
        spill_same_bits("host path", host_answers["lazy"], host_answers["eager"])
        if len(forwards) != 1 + 2 * SPILL_HOST_REQUESTS:
            fail(f"spill: {len(forwards)} host-path forwards for "
                 f"{1 + 2 * SPILL_HOST_REQUESTS} requests")

        # 6. a new generation of one lazy machine, adopted by /reload
        eager_dispatches = {dtype: spill_flash_dispatches(eager_app.engine.stats(), dtype)
                            for dtype in ("float32", "bfloat16")}
        spill_commit(models_dir, SPILL_RELOAD, staged)
        write_fleet_index(models_dir, build_fleet_index(models_dir))
        reloads = {}
        for label, url in (("lazy", lazy_url), ("eager", eager_url)):
            started = time.perf_counter()
            status, _, raw, _ = http("POST", f"{url}/reload")
            reloads[label] = {"wall_s": time.perf_counter() - started, **json.loads(raw)}
            if status != 200 or reloads[label].get("refreshed") != [SPILL_RELOAD]:
                fail(f"spill: {label} /reload answered {status} {raw[:300]!r}")
        before = spill_cache_counts(lazy_engine)
        payload, _ = ask(lazy_url, SPILL_RELOAD)
        moved = spill_delta(spill_cache_counts(lazy_engine), before)
        if (moved["miss"], moved["store"]) != (1, 1):
            fail(f"spill: the refreshed machine's request moved the cache by {moved}")
        # the new generation's answer: the eager server's, which reloaded it
        spill_same_bits("new generation", payload, ask(eager_url, SPILL_RELOAD)[0])
        if np.array_equal(payload["data"]["model-output"],
                          eager_answers[SPILL_RELOAD]["data"]["model-output"]):
            fail("spill: the new generation answers as the old one did")

        # 7. the launches: 3 per PatchTST dispatch, stacked or spilled, and
        # per host-path forward
        launches = {name: _kernels.LAUNCHES[name] for name in KERNELS}
        spilled = {dtype: spill_flash_dispatches(lazy_engine.stats(), dtype)
                   for dtype in ("float32", "bfloat16")}
        stacked = {dtype: eager_dispatches[dtype] + spill_flash_dispatches(
            eager_app.engine.stats(), dtype) for dtype in ("float32", "bfloat16")}
        layers = SLICE["n_layers"]
        want = {**NO_LAUNCHES,
                "flash_fwd_f32": layers * (spilled["float32"] + stacked["float32"]
                                           + len(forwards)),
                "flash_fwd_bf16": layers * (spilled["bfloat16"] + stacked["bfloat16"])}
        if launches != want or not spilled["float32"] or not spilled["bfloat16"]:
            fail(f"spill: launches {launches}, want {want} for spilled dispatches {spilled}, "
                 f"stacked {stacked} and {len(forwards)} host-path forwards")

        def percentiles(by_rung):
            return {rung: {"n": len(ms), "p50_ms": float(np.percentile(ms, 50)),
                           "p99_ms": float(np.percentile(ms, 99))}
                    for rung, ms in sorted(by_rung.items())}

        print(f"spill [{card}]: request walls by rung {json.dumps({k: percentiles(v) for k, v in walls.items()})}")
        print(f"spill [{card}]: a {resident} bundle ({tree_bytes} bytes, pinned) to the card in "
              f"{copy_ms:.4f} ms ({tree_bytes / copy_ms / 1e6:.2f} GB/s); a plain pinned copy_ of "
              f"{SPILL_COPY_BYTES >> 20} MiB {plain_copy_ms:.4f} ms "
              f"({SPILL_COPY_BYTES / plain_copy_ms / 1e6:.2f} GB/s); prefetch loads: "
              f"{evicted} {prefetch_ms:.1f} ms, {SPILL_PREFETCH} {prefetch_dense_ms:.1f} ms")
        print(f"spill [{card}]: host path {json.dumps(percentiles(host_walls))} against the "
              f"eager fp32 PatchTST lone request {json.dumps(percentiles({'eager': walls['eager']['patchtst-f32']}))}; "
              f"reloads {json.dumps(reloads)}")
        print(f"spill [{card}]: {json.dumps({'launches': launches, 'spilled': spilled, 'stacked': stacked, 'host_forwards': len(forwards), 'cache': lazy_engine.host_cache.stats(), 'phase_s': time.perf_counter() - phase_started})}")
        return launches
    finally:
        for httpd, thread in servers:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


FC_DENSE = [f"fc-dense-{i:02d}" for i in range(16)]
FC_SLICE = "fc-slice-a"  # a generation root: gen-0001 and gen-0002, of other seeds
FC_NEWER = FC_SLICE + "-newer"  # the newer generation, flat, on the eager server
FC_EAGER = "fc-slice-eager"
FC_LAZY = {"float32": "fc-slice-lazy-f32", "bfloat16": "fc-slice-lazy-bf16"}
FC_EAGER_N = len(FC_DENSE) + 2  # GORDO_BOOT_EAGER: the index's first names
FC_WORKERS = ("worker-0", "worker-1")
FC_WINDOWS = TIER_WINDOWS  # windows of a PatchTST request: BH 8192, as phase 2 holds
# the hot machine lives on the lazy machines' worker of the uniform ring,
# the paced one on the other: the first such pair (sorted) for which
# fc_design moves both lazy machines to the paced one's worker over every
# rate combination
FC_HOT = "fc-dense-13"
FC_PACED = "fc-dense-00"
FC_HOT_REQUESTS = 240
FC_HOT_PAUSE_S = 0.04  # about 25 req/s: under the placement's hot rate of 50
FC_PACED_PAUSE_S = 1.0  # each of TIER_CLIENTS threads: about 4 req/s in all
FC_WARM = 2  # requests to each lazy machine before the plan
FC_CAP = 1  # the plan's residency cap: one resident per worker, the rest hinted
FC_CONVERGE_S = 240.0
# the reconciler ticks on every /metrics scrape and a repaired class rests
# half a second; the autopilot's envelope and the spec's default bounds
# agree on the fleet's two workers; a committed plan is not re-derived
# (the rates move while the phase runs; the CPU tests hold the re-derive)
FC_ENV = {"GORDO_LAZY_BOOT": "1", "GORDO_BOOT_EAGER": str(FC_EAGER_N),
          "GORDO_FLEET_INTERVAL": "0", "GORDO_FLEET_COOLDOWN": "0.5",
          "GORDO_TELEMETRY_INTERVAL": "2", "GORDO_AUTOPILOT_WORKER_BOUNDS": "2:2",
          "GORDO_LAYOUT_REDERIVE": "0"}
# the rates (req/s) the plan's design assumes, each over a spread it must
# survive: the hot machine, the paced one, the slice machine asked once,
# each lazy machine
FC_RATES = {"hot": (9.0, 16.0, 40.0), "paced": (2.0, 4.0, 6.0), "slice": (0.05, 0.5),
            "lazy": (0.05, 0.2, 0.5)}
FC_BAD_OUTCOMES = ("failed", "canary_failed", "aborted", "unwired", "hold")
# runs ``cli run-fleet-server`` as ``python -m`` does, each worker process
# under CLI_RUNNER (its second argument), which writes that process's launch
# counts at exit to ``<first argument>/<worker>-<n>.json``
FLEET_RUNNER = """
import itertools, os, runpy, sys
import gordo_components_tpu_torch.router as router
records, runner = sys.argv[1], sys.argv[2]
plain, count = router.server_worker_argv, itertools.count()
def recorded(spec, *args, **kwargs):
    record = os.path.join(records, f"{spec.name}-{next(count)}.json")
    return plain(spec, *args, launcher=[sys.executable, "-c", runner, record], **kwargs)
router.server_worker_argv = recorded
sys.argv = ["gordo_components_tpu_torch.cli", *sys.argv[3:]]
runpy.run_module("gordo_components_tpu_torch.cli", run_name="__main__", alter_sys=True)
"""


def fc_layout_doc(rates: dict) -> dict:
    """A ``gordo-layout-input/v1`` document with these per-machine rates
    (req/s) at the 1m horizon, shaped as the router's export."""
    total = sum(rates.values())
    return {
        "schema": "gordo-layout-input/v1", "generated_t": 1.0, "window_s": 60.0,
        "horizon": "1m",
        "source": {"workers": list(FC_WORKERS), "interval_s": 2.0, "coverage_s": 60.0,
                   "sketch_capacity": 512},
        "machines": [{"machine": m, "count": r * 60.0, "error": 0.0, "rates": {"1m": r},
                      "rate": r} for m, r in sorted(rates.items())],
        "rungs": {"f32": {"machines": len(rates), "buckets": 2, "device_bytes": 1 << 30,
                          "requests": total * 60.0, "count": total * 60.0,
                          "rates": {"1m": total}, "dispatch_seconds_total": total * 0.6,
                          "latency_s": 0.01, "compile_seconds": 0.0}},
        "tiers": {"host_cache": {}, "spill": {}},
        "totals": {"count": total * 60.0, "rates": {"1m": total},
                   "machines_tracked": len(rates)},
    }


def fc_plan_outcome(plan: dict) -> tuple:
    """``({lazy machine: the worker hinted to prefetch it, or None},
    {worker: its resident machines})`` of a plan."""
    hinted = {m: next((w for w, names in sorted(plan["prefetch"].items()) if m in names), None)
              for m in FC_LAZY.values()}
    resident = {w: list(e["resident"]) for w, e in plan["residency"]["workers"].items()}
    return hinted, resident


def fc_design(hot: str, paced: str) -> tuple:
    """Whether the plan (cap ``FC_CAP``) makes ``hot`` and ``paced`` the two
    residents and hints both lazy machines over every combination of
    ``FC_RATES``, and in how many it moves both off their worker of the
    uniform ring (their ``home``, where the warm-up loads them: the moved
    worker's cache must then load them). Returns ``(home, combinations that
    moved both, combinations)``, or None when a combination breaks it."""
    from itertools import product

    from gordo_components_tpu_torch.layout import compile_plan
    from gordo_components_tpu_torch.router.placement import HashRing

    ring = HashRing(FC_WORKERS, vnodes=64)
    homes = {ring.primary(m) for m in FC_LAZY.values()}
    if len(homes) != 1:
        fail(f"fleet control: the lazy machines live on {sorted(homes)} of the uniform ring")
    home = homes.pop()
    combos = list(product(*FC_RATES.values()))
    moved = 0
    for h, p, sl, lz in combos:
        rates = {hot: h, paced: p, FC_SLICE: sl, **dict.fromkeys(FC_LAZY.values(), lz)}
        hinted, resident = fc_plan_outcome(
            compile_plan(fc_layout_doc(rates), residency_cap=FC_CAP, parity_budget=0.0))
        if sorted(sum(resident.values(), [])) != sorted([hot, paced]) or (
                None in hinted.values()):
            return None
        moved += all(worker != home for worker in hinted.values())
    return home, moved, len(combos)


def fc_build(models_dir: str, eager_dir: str, staged: str, device) -> dict:
    """The phase's models root with its fleet index, and ``eager_dir``, the
    in-process eager server's root: ``FC_SLICE``'s two generations as flat
    machines (``FC_SLICE`` the older, ``FC_NEWER`` the newer) and copies of
    the lazy machines. Returns {machine: tags}."""
    import shutil

    from gordo_components_tpu_torch.store.generations import build_fleet_index, write_fleet_index

    estimator, kwargs, tags = ZOO["dense-ae-10tag"]
    for i, name in enumerate(FC_DENSE):
        build_zoo_artifact(os.path.join(models_dir, name), estimator, kwargs, tags, device,
                           np.random.default_rng(SEED + 16000 + i))
    for i, flat in enumerate((FC_SLICE, FC_NEWER)):
        build_artifact(staged, device, seed=SEED + 16100 + i)
        spill_commit(models_dir, FC_SLICE, staged)
        shutil.copytree(os.path.join(models_dir, FC_SLICE, f"gen-{i + 1:04d}"),
                        os.path.join(eager_dir, flat))
    build_artifact(os.path.join(models_dir, FC_EAGER), device, seed=SEED + 16200)
    for i, (dtype, name) in enumerate(FC_LAZY.items()):
        build_artifact(os.path.join(models_dir, name), device, compute_dtype=dtype,
                       seed=SEED + 16300 + i)
        shutil.copytree(os.path.join(models_dir, name), os.path.join(eager_dir, name))
    write_fleet_index(models_dir, build_fleet_index(models_dir))
    return {**{name: tags for name in FC_DENSE},
            **{name: N_TAGS for name in (FC_SLICE, FC_EAGER, *FC_LAZY.values())}}


def fc_get(url: str) -> dict:
    status, _, raw, _ = http("GET", url)
    if status != 200:
        fail(f"fleet control: GET {url} answered HTTP {status} {raw[:300]!r}")
    return json.loads(raw)


def fc_cli(root: str, *args: str) -> str:
    """One ``python -m gordo_components_tpu_torch.cli`` command; its stdout.
    Fails on a non-zero exit."""
    result = subprocess.run([sys.executable, "-m", "gordo_components_tpu_torch.cli", *args],
                            cwd=root, capture_output=True, text=True, timeout=300,
                            env={**os.environ, "PYTHONPATH": root})
    if result.returncode != 0:
        fail(f"fleet control: cli {' '.join(args[:2])} exited {result.returncode}: "
             f"{result.stderr[-2000:]}")
    return result.stdout


def fc_converge(base: str, label: str) -> tuple:
    """Scrape the router's /metrics (each scrape ticks the reconciler) until
    a fresh /fleet/diff is empty; fails after ``FC_CONVERGE_S`` or on a
    repair step that failed. Returns (seconds, the longest scrape's
    seconds)."""
    started = time.perf_counter()
    longest = 0.0
    while True:
        t0 = time.perf_counter()
        fc_get(base + "/metrics")
        longest = max(longest, time.perf_counter() - t0)
        diff = fc_get(base + "/fleet/diff")
        bad = [r for r in fc_get(base + "/fleet/status")["repairs"]
               if r["outcome"] in FC_BAD_OUTCOMES]
        if bad:
            fail(f"fleet control {label}: reconciler steps {bad[:3]}")
        if not diff["divergences"]:
            return time.perf_counter() - started, longest
        if time.perf_counter() - started > FC_CONVERGE_S:
            fail(f"fleet control {label}: no convergence within {FC_CONVERGE_S:.0f} s: "
                 f"{diff['divergences'][:3]}")
        time.sleep(0.1)


def fc_dispatches(url: str) -> dict:
    """A worker's PatchTST dispatches at the slice's shape by rung, stacked
    and spilled, from its /metrics."""
    stats = fc_get(url + "/metrics")["engine"]
    return {rung: spill_flash_dispatches(stats, dtype)
            for rung, dtype in (("f32", "float32"), ("bf16", "bfloat16"))}


def fc_cache(url: str) -> dict:
    return fc_get(url + "/metrics")["engine"]["spill"]["host_cache"]


def fc_ask(base: str, name: str, body: bytes) -> tuple:
    """A W = 16 request through the router asking for npz: (payload, the
    answering worker's name, wall ms)."""
    from gordo_components_tpu_torch import wire

    status, headers, raw, ms = http("POST", f"{base}/gordo/v0/project/{name}/anomaly/prediction",
                                    body, {"Accept": wire.NPZ_CONTENT_TYPE})
    if status != 200:
        fail(f"fleet control: {name} answered HTTP {status} {raw[:300]!r}")
    return decode(headers, raw), f"worker-{headers.get('X-Gordo-Worker')}", ms


def fc_expected(torch, device, eager_dir: str, encoded: dict) -> dict:
    """The eager in-process server's lone answers on the card (npz), one per
    machine of ``eager_dir``, for ``FC_SLICE``'s rows on both generations."""
    from gordo_components_tpu_torch.server.server import make_server

    saved = os.environ.get("GORDO_TELEMETRY")
    os.environ["GORDO_TELEMETRY"] = "0"
    httpd = make_server(eager_dir, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        expected = {}
        for name in (FC_SLICE, FC_NEWER, *FC_LAZY.values()):
            body = encoded[FC_SLICE if name == FC_NEWER else name]
            expected[name] = fc_ask(url, name, body)[0]
        return expected
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        httpd.model_server.close()
        if saved is None:
            os.environ.pop("GORDO_TELEMETRY", None)
        else:
            os.environ["GORDO_TELEMETRY"] = saved
        torch.cuda.synchronize()


def phase_fleet_control(torch, device, tmp: str, card: str, beside=None) -> dict:
    """The declarative fleet reconciler, the layout compiler and ``/layout``
    on the card (see the module docstring, 16). ``beside`` (phase 18), if
    given, runs in a thread from the moment the fleet is up (its ports
    bound) until the phase ends. Returns the flash launches of the fleet's
    worker processes."""
    import signal

    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import ModelServer

    phase_started = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    device_arg = "cpu" if device.type == "cpu" else None
    models_dir = os.path.join(tmp, "fleetctl")
    eager_dir = os.path.join(tmp, "fleetctl-eager")
    tags = fc_build(models_dir, eager_dir, os.path.join(tmp, "fleetctl-staged"), device)
    hot, paced = FC_HOT, FC_PACED
    design = fc_design(hot, paced)
    if design is None or design[1] != design[2]:
        fail(f"fleet control: the plan's design does not hold for {hot} and {paced}: {design}")
    home, moved, combos = design
    rng = np.random.default_rng(SEED + 16400)
    bodies = {name: sensor_rows(rng, LOOKBACK + FC_WINDOWS - 1 if n == N_TAGS else SEAMS_ROWS, n)
              for name, n in tags.items()}
    encoded = {name: json.dumps({"X": X.tolist()}).encode() for name, X in bodies.items()}
    sizer = ServingEngine({}, lazy={name: ModelServer._lazy_loader(
        name, os.path.join(models_dir, name)) for name in FC_LAZY.values()},
        host_cache_mb=0, device=device)
    sizes = {name: sizer._build_bundle(name, sizer._lazy[name])[1] for name in FC_LAZY.values()}
    sizer.close()
    del sizer
    cap_mb = math.ceil(2.25 * max(sizes.values()) / 2**20)  # holds both bundles
    expected = fc_expected(torch, device, eager_dir, encoded)
    print(f"fleet control: {len(tags)} machines built and indexed, the eager answers computed "
          f"in {time.perf_counter() - phase_started:.1f} s; hot {hot}, paced {paced}, the lazy "
          f"machines' home {home} (moved off it in {moved} of {combos} rate combinations); a "
          f"host cache of {cap_mb} MiB for bundles of {sizes} bytes")

    records = os.path.join(tmp, "fleetctl-records")
    os.makedirs(records, exist_ok=True)
    port = free_port()
    worker_base = free_port_run(len(FC_WORKERS))
    base = f"http://127.0.0.1:{port}"
    workers = {name: f"http://127.0.0.1:{worker_base + i}" for i, name in enumerate(FC_WORKERS)}
    log_path = os.path.join(tmp, "fleetctl.log")
    log = open(log_path, "wb")
    argv = [sys.executable, "-c", FLEET_RUNNER, records, CLI_RUNNER, "run-fleet-server",
            "--models-dir", models_dir, "--workers", str(len(FC_WORKERS)), "--host", "127.0.0.1",
            "--port", str(port), "--worker-base-port", str(worker_base),
            "--probe-interval", str(TIER_PROBE_S)]
    if device_arg is not None:
        argv += ["--device", device_arg]
    env = {**os.environ, "PYTHONPATH": root, **FC_ENV, "GORDO_HOST_CACHE_MB": str(cap_mb),
           "GORDO_LEDGER_DIR": os.path.join(tmp, "fleetctl-ledger")}
    env.pop("GORDO_FAULTS", None)
    proc = subprocess.Popen(argv, cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    children = []

    def tail():
        log.flush()
        with open(log_path, "rb") as fh:
            return fh.read()[-3000:].decode(errors="replace")

    try:
        def up():
            if proc.poll() is not None:
                fail(f"fleet control: run-fleet-server exited {proc.returncode}: {tail()}")
            try:
                status, _, raw, _ = http("GET", base + "/healthz")
            except OSError:
                return False
            return status == 200 and json.loads(raw).get("status") == "ok"

        boot = tier_wait(up, TIER_READY_S, "run-fleet-server's workers", poll=0.2)
        children = tier_children(proc.pid)
        walls = {"boot_s": boot}
        if beside is not None:
            beside_thread = threading.Thread(target=beside, name="beside-fleet-control")
            beside_thread.start()

        # 2. no spec yet
        status_body = fc_get(base + "/fleet")
        if not status_body.get("enabled") or status_body.get("spec") is not None or fc_get(
                base + "/fleet/diff")["divergences"]:
            fail(f"fleet control: /fleet before any spec answered {status_body}")
        banked = {name: fc_dispatches(url) for name, url in workers.items()}

        with TierClients(base, [paced], encoded, pause=FC_PACED_PAUSE_S) as clients:
            # 3. a spec pinning the older generation
            spec_file = os.path.join(tmp, "fleetctl-spec.json")
            with open(spec_file, "w") as fh:
                json.dump({"machines": {FC_SLICE: {"generation": "gen-0001"}}}, fh)
            record = json.loads(fc_cli(root, "fleet", "apply", spec_file, "--base-url",
                                       base))["record"]
            if record["revision"] != 1:
                fail(f"fleet control: the spec committed as {record}")
            walls["pin_converge_s"], walls["longest_scrape_s"] = fc_converge(base, "pin")
            with open(os.path.join(models_dir, FC_SLICE, "CURRENT")) as fh:
                current = fh.read().strip()
            served = {name: fc_get(url + "/healthz")["store"]["generations"].get(FC_SLICE)
                      for name, url in workers.items()}
            steps = [(r["class"], r["target"], r["outcome"])
                     for r in fc_get(base + "/fleet/status")["repairs"]
                     if r["class"] in ("generation", "adoption")]
            want_steps = [("generation", FC_SLICE, "applied"),
                          *(("adoption", name, "applied") for name in FC_WORKERS)]
            if current != "gen-0001" or set(served.values()) != {"gen-0001"} or (
                    steps != want_steps):
                fail(f"fleet control: CURRENT {current}, served {served}, journal {steps}")
            before = {name: fc_dispatches(url) for name, url in workers.items()}
            payload, answered, pin_ms = fc_ask(base, FC_SLICE, encoded[FC_SLICE])
            moved_by = {name: {k: v - before[name][k] for k, v in fc_dispatches(url).items()}
                        for name, url in workers.items()}
            if moved_by[answered] != {"f32": 1, "bf16": 0} or any(
                    any(d.values()) for name, d in moved_by.items() if name != answered):
                fail(f"fleet control: the pinned request ({answered}) moved dispatches {moved_by}")
            spill_same_bits("pinned generation", payload, expected[FC_SLICE], "fleet control")
            if np.array_equal(payload["data"]["model-output"],
                              expected[FC_NEWER]["data"]["model-output"]):
                fail("fleet control: the pinned generation answers as the newer one does")
            print(f"fleet control [{card}]: spec revision 1 pins {FC_SLICE} to gen-0001: converged "
                  f"in {walls['pin_converge_s']:.2f} s (journal {steps}); the longest scrape, an "
                  f"adoption reload, {walls['longest_scrape_s']:.2f} s; {answered} answers it byte "
                  f"for byte as the eager server does, in {pin_ms:.1f} ms")

            # 4. skewed traffic, then a plan compiled, explained and applied
            for _ in range(FC_HOT_REQUESTS):
                status, _, raw, _ = http(
                    "POST", f"{base}/gordo/v0/project/{hot}/anomaly/prediction", encoded[hot])
                if status != 200:
                    fail(f"fleet control: {hot} answered HTTP {status} {raw[:200]!r}")
                time.sleep(FC_HOT_PAUSE_S)
            warmed = {}
            for name in FC_LAZY.values():
                for _ in range(FC_WARM):
                    payload, warmed[name], _ = fc_ask(base, name, encoded[name])
                    spill_same_bits(f"{name} warm", payload, expected[name], "fleet control")
            if set(warmed.values()) != {home}:
                fail(f"fleet control: the lazy machines warmed on {warmed}, not {home}")
            plan_file = os.path.join(tmp, "fleetctl-plan.json")
            fc_cli(root, "layout", "plan", "--base-url", base, "--window", "1m", "--cap",
                   str(FC_CAP), "--parity-budget", "0", "-o", plan_file)
            with open(plan_file) as fh:
                plan = json.load(fh)
            hinted, resident = fc_plan_outcome(plan)
            if plan["precision"] or None in hinted.values() or sorted(
                    sum(resident.values(), [])) != sorted([hot, paced]):
                fail(f"fleet control: the plan hints {hinted}, pins {resident}, downgrades "
                     f"{plan['precision']}; rates {plan['source']['rates']}")
            explained = fc_cli(root, "layout", "explain", plan_file)
            held = {name: fc_get(f"{workers[w]}/gordo/v0/project/{name}/healthz")["resident"]
                    for name, w in hinted.items()}
            caches = {name: fc_cache(url) for name, url in workers.items()}
            record = json.loads(fc_cli(root, "layout", "apply", plan_file, "--base-url",
                                       base))["record"]
            if record["revision"] != 2:
                fail(f"fleet control: the plan committed as {record}")
            walls["plan_converge_s"], _ = fc_converge(base, "plan")
            fingerprint = plan["fingerprint"]
            weights = {w: v for w, v in plan["weights"].items() if v != 1.0}
            ring = fc_get(base + "/router/status")["placement"]["weights"]
            if ring != weights:
                fail(f"fleet control: the router's ring weights {ring}, the plan's {weights}")
            loads = {}
            for name, url in workers.items():
                layout = fc_get(url + "/layout")
                mine = [m for m, w in hinted.items() if w == name and not held[m]]
                loads[name] = len(mine)
                if (fc_get(url + "/healthz")["layout"] != fingerprint
                        or layout["fingerprint"] != fingerprint or layout["cap"] != FC_CAP
                        or layout["resident"] != resident[name]
                        or (layout["applied"].get("prefetch") or {}).get("queued", 0) != len(mine)):
                    fail(f"fleet control: {name} applied {layout}, the plan {fingerprint} pins "
                         f"{resident[name]} and hints {mine} to load")
                tier_wait(lambda: fc_cache(url)["prefetches"] - caches[name]["prefetches"]
                          >= len(mine), 120, f"{name}'s prefetches of {mine}", poll=0.1)
            hits = {}  # the first and the second request's walls, both hits
            for dtype, name in FC_LAZY.items():
                worker = hinted[name]
                cache, dispatched = fc_cache(workers[worker]), fc_dispatches(workers[worker])
                payload, answered, first_ms = fc_ask(base, name, encoded[name])
                cache_moved = {k: fc_cache(workers[worker])[k] - cache[k]
                               for k in ("hits", "misses", "loads")}
                rung = "f32" if dtype == "float32" else "bf16"
                if answered != worker or cache_moved != {"hits": 1, "misses": 0, "loads": 0} or (
                        fc_dispatches(workers[worker])[rung] - dispatched[rung] != 1):
                    fail(f"fleet control: {name}, hinted to {worker}, answered by {answered} "
                         f"moved its cache by {cache_moved}")
                spill_same_bits(f"{name} hinted", payload, expected[name], "fleet control")
                payload, answered, second_ms = fc_ask(base, name, encoded[name])
                if answered != worker:
                    fail(f"fleet control: {name}'s second request answered by {answered}")
                spill_same_bits(f"{name} hinted, again", payload, expected[name], "fleet control")
                hits[name] = [round(first_ms, 1), round(second_ms, 1)]
            print(f"fleet control [{card}]: spec revision 2 carries plan {fingerprint} (weights "
                  f"{weights}, residents {resident}, hints {hinted}): converged in "
                  f"{walls['plan_converge_s']:.2f} s; prefetch loads {loads}; each hinted lazy "
                  f"machine's next request a host-cache hit with no store read, byte for byte "
                  f"the eager answer, in {json.dumps(hits)} ms (the first and a second "
                  f"request); explain:\n" + "\n".join(explained.splitlines()[:4]))

            # 5. rollback
            record = json.loads(fc_cli(root, "fleet", "rollback", "--base-url", base))["record"]
            if (record["revision"], record["reverted_to"]) != (3, 1):
                fail(f"fleet control: the rollback committed as {record}")
            walls["rollback_converge_s"], _ = fc_converge(base, "rollback")
            left = {name: (fc_get(url + "/healthz")["layout"], fc_get(url + "/layout")["fingerprint"])
                    for name, url in workers.items()}
            ring = fc_get(base + "/router/status")["placement"]["weights"]
            if any(v != (None, None) for v in left.values()) or ring:
                fail(f"fleet control: after the rollback the workers hold {left}, the ring {ring}")
        clients.check("fleet control (paced clients)")

        # the launches: 3 per PatchTST dispatch, stacked or spilled, per process
        for name, url in workers.items():
            final = fc_dispatches(url)
            banked[name] = {k: banked[name][k] + final[k] for k in final}
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        if code != 0:
            fail(f"fleet control: run-fleet-server exited {code} on SIGTERM: {tail()}")
        alive = [pid for pid in children if os.path.exists(f"/proc/{pid}")]
        if alive:
            fail(f"fleet control: workers {alive} outlived the router")
        incarnations = []
        for name in FC_WORKERS:
            found = sorted(f for f in os.listdir(records) if f.startswith(f"{name}-"))
            if len(found) != 1:
                fail(f"fleet control: launch records {found} for {name}")
            incarnations.append({"name": name, "record": os.path.join(records, found[0]),
                                 "banked": banked[name], "killed": False})
        launches, problems = tier_launch_sums(incarnations)
        if problems:
            fail(f"fleet control: {problems}")
        print(f"fleet control [{card}]: {json.dumps({'walls': walls, 'dispatches': banked, 'launches': launches, 'paced_requests': len(clients.statuses), 'phase_s': time.perf_counter() - phase_started})}")
        if beside is not None:
            beside_thread.join()
        return launches
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for pid in children:
            try:
                os.kill(pid, 9)
            except ProcessLookupError:
                pass
        log.close()


# phase 17: warm boot. A models tree of the full-width slice machine at
# fp32 and at bf16 (compute and rung), served by fresh run-server processes
# over the store under the tree (<models>/.compile-cache/torch-cuda, the
# default); nvcc reached through a logging wrapper first on PATH
WB_MACHINES = {"wb-slice-f32": ("float32", None), "wb-slice-bf16": ("bfloat16", "bf16")}
WB_WINDOWS = 16
WB_READY_S = 300.0
# the store off for every phase but 17, which go on as they were: every process
# builds into the package's build directory
WB_OFF = {"GORDO_COMPILE_CACHE_STORE": "off", "GORDO_COMPILE_CACHE": "off"}
# fleet-build --serving-cache: two narrow PatchTST machines whose 129
# patches still take the flash kernel (BH 32 * 4 tags * 4 heads = 512)
WB_FLEET_SLICE = dict(kind="patchtst", lookback_window=1040, patch_length=16, stride=8,
                      d_model=64, n_heads=4, n_layers=1, ff_dim=128, attention_impl="flash",
                      batch_size=32, epochs=1)
WB_FLEET_TAGS = 4
WB_FLEET_ROWS = 1040 + 63
WB_FLEET = ("wb-fleet-0", "wb-fleet-1")
REFERENCE_ENTRY = "cc-00000000000000000000000000000000"  # a reference-format entry


def expected_forward_libraries(dtypes) -> list:
    """The forward libraries a warm-up resolves for buckets computing in
    these dtypes (``float32``/``bfloat16``; int8 computes in float32)."""
    names = {"float32": "flash_fwd_f32", "bfloat16": "flash_fwd_bf16", "int8": "flash_fwd_f32"}
    return sorted({names[d] for d in dtypes})


def write_nvcc_wrapper(bin_dir: str, real: str, log: str) -> str:
    """An ``nvcc`` in ``bin_dir`` that appends its arguments to ``log`` and
    runs ``real``; returns its path."""
    os.makedirs(bin_dir, exist_ok=True)
    path = os.path.join(bin_dir, "nvcc")
    with open(path, "w") as fh:
        fh.write(f'#!/bin/sh\nprintf "%s\\n" "$*" >> "{log}"\nexec "{real}" "$@"\n')
    os.chmod(path, 0o755)
    return path


def nvcc_compiled(log: str) -> list:
    """The sources the logged ``nvcc`` invocations compiled, in order (a
    ``--version`` query compiles nothing)."""
    if not os.path.exists(log):
        return []
    with open(log) as fh:
        lines = [line.split() for line in fh if " -o " in line]
    return [os.path.basename(args[-1]) for args in lines]


def env_without_nvcc(env: dict, empty_dir: str) -> dict:
    """``env`` with every ``PATH`` directory that holds an ``nvcc`` left out
    and ``CUDA_HOME`` at an empty directory: no ``nvcc`` can be found."""
    os.makedirs(empty_dir, exist_ok=True)
    path = [d for d in env.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc"))]
    return {**env, "PATH": os.pathsep.join(path), "CUDA_HOME": empty_dir}


def store_entry(root: str, library: str, debug: bool = False) -> str:
    """The entry directory of ``library`` (a debug build's or not) in a
    store root, read from each entry's KEY.json."""
    for name in sorted(os.listdir(root)):
        try:
            with open(os.path.join(root, name, "KEY.json")) as fh:
                key = json.load(fh)
        except (OSError, ValueError):
            continue
        if key["program"]["library"] == library and key["backend"]["debug"] == debug:
            return os.path.join(root, name)
    fail(f"warm boot: no {library} entry (debug {debug}) in {root}")


def flip_a_bit(path: str) -> None:
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        byte = fh.read(1)[0]
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([byte ^ 0x01]))


def wb_boot(tmp: str, models_dir: str, label: str, env: dict, bodies: dict,
            telemetry: bool = False) -> dict:
    """One fresh ``run-server`` process over ``models_dir`` (through
    CLI_RUNNER): the wall from its start to a 200 on ``/healthz``, the
    engine's ``compile_cache`` and ``kernel_libraries``, the score arrays
    of each body's machine, optionally the telemetry's compile block and the
    layout export's rungs; then SIGTERM (exit 0) and its launch counts."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    base = None  # the server binds its own port (see shard_server) and logs it
    record = os.path.join(tmp, f"wb-{label}.json")
    log_path = os.path.join(tmp, f"wb-{label}.log")
    log = open(log_path, "wb")
    argv = [sys.executable, "-c", CLI_RUNNER, record, "run-server", "--models-dir", models_dir,
            "--host", "127.0.0.1", "--port", "0"]
    started = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)

    def tail():
        log.flush()
        with open(log_path, "rb") as fh:
            return fh.read()[-3000:].decode(errors="replace")

    try:
        def up():
            nonlocal base
            if proc.poll() is not None:
                fail(f"warm boot {label}: run-server exited {proc.returncode}: {tail()}")
            log.flush()
            base = base or served_url(log_path)
            if base is None:
                return False
            try:
                return http("GET", base + "/healthz")[0] == 200
            except OSError:
                return False

        tier_wait(up, WB_READY_S, f"warm boot {label}'s /healthz", poll=0.05)
        boot_s = time.perf_counter() - started
        engine = json.loads(http("GET", base + "/metrics")[2])["engine"]
        out = {"boot_s": boot_s, "compile_cache": engine["compile_cache"],
               "kernel_libraries": engine["kernel_libraries"], "scores": {}}
        for name, body in bodies.items():
            status, reply, raw, _ = http(
                "POST", f"{base}/gordo/v0/project/{name}/anomaly/prediction", body)
            if status != 200:
                fail(f"warm boot {label}: {name} HTTP {status} {raw[:300]!r}")
            data = decode(reply, raw)["data"]
            out["scores"][name] = {field: np.asarray(data[field], np.float64)
                                   for field in ("model-output", "tag-anomaly-scores",
                                                 "total-anomaly-score")}
        if telemetry:
            out["compile"] = json.loads(http("GET", base + "/telemetry")[2])["costs"]["compile"]
            out["rungs"] = json.loads(http("GET", base + "/telemetry?view=export")[2])["rungs"]
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        if code != 0:
            fail(f"warm boot {label}: exit {code} on SIGTERM: {tail()}")
        with open(record) as fh:
            out["launches"] = json.load(fh)["launches"]
        return out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def cli_output(*args: str) -> str:
    """What ``python -m gordo_components_tpu_torch.cli ARGS`` prints, run in
    this process (a command that needs no card); fails on a non-zero exit."""
    import contextlib
    import io

    from gordo_components_tpu_torch.cli.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli_main(["--log-level", "WARNING", *args])
    if code != 0:
        fail(f"cli {' '.join(args[:2])}: exit {code}")
    return out.getvalue()


def wb_same_bits(label: str, got: dict, want: dict) -> None:
    for name, fields in want.items():
        for field, array in fields.items():
            other = got["scores"][name][field]
            if other.shape != array.shape or other.tobytes() != array.tobytes():
                fail(f"warm boot {label}: {name} {field} differs from the cold boot's")


def wb_counts(label: str, boot: dict, expected: dict, libraries: dict) -> None:
    counters = {key: 0 for key in ("hit", "miss", "stale", "invalid", "write", "write_error")}
    counters.update(expected)
    if boot["compile_cache"] != counters or boot["kernel_libraries"] != libraries:
        fail(f"warm boot {label}: compile_cache {boot['compile_cache']}, libraries "
             f"{boot['kernel_libraries']}; expected {counters}, {libraries}")


def wb_fleet_config() -> dict:
    return {"project-name": "chip-smoke-warm-boot", "machines": [{
        "name": name,
        "model": {"DiffBasedAnomalyDetector": {"base_estimator": {
            "TransformedTargetRegressor": {
                "regressor": {"Pipeline": {"steps": [
                    "MinMaxScaler", {"PatchTSTAutoEncoder": WB_FLEET_SLICE}]}},
                "transformer": "MinMaxScaler"}}}},
        "dataset": data_config(WB_FLEET_TAGS, WB_FLEET_ROWS, SEED + 700 + i),
        "evaluation": {"n_splits": 1, "cv_parallel": False},
    } for i, name in enumerate(WB_FLEET)]}


def phase_warm_boot(torch, device, tmp: str, card: str) -> dict:
    """Warm boot on the card: fresh run-server processes over one models
    tree and the kernel-library store under it. The cold boot runs nvcc for
    exactly the two forward libraries and writes both; a warm boot with no
    nvcc to be found (so it runs none) reads two hits and answers bit for
    bit what the cold boot did; a flipped bit in the fp32 entry (of a copy
    of the store, booted beside the warm boot) reads invalid, is rebuilt
    and written back; under CUDA_KERNEL_DEBUG the
    boot's resolution makes two new entries, never a stale hit;
    ``cache list`` marks the entries, ``cache purge --stale`` removes a
    damaged entry and the debug ones and leaves the current ones and a
    reference-format entry beside the store; ``fleet-build`` (its serving
    export on by default) over two narrow PatchTST machines, beside the
    cold, warm and flipped boots, makes the next boot over its output (run
    beside the debug build and the cache verbs) run no nvcc; the telemetry's compile block shows fp32 and bf16 build
    seconds. Returns the launches of every process."""
    import shutil

    from gordo_components_tpu_torch.compile_cache import CompileCacheStore, default_root
    from gordo_components_tpu_torch.ops import _kernels

    root = os.path.dirname(os.path.abspath(__file__))
    wb = os.path.join(tmp, "warm-boot")
    models = os.path.join(wb, "models")
    store = default_root(models)
    rng = np.random.default_rng(SEED + 17)
    bodies = {}
    for seed, (name, (dtype, precision)) in enumerate(WB_MACHINES.items()):
        tags = build_artifact(os.path.join(models, name), device, compute_dtype=dtype,
                              seed=SEED + 170 + seed, precision=precision)
        X = sensor_rows(rng, LOOKBACK + WB_WINDOWS - 1, len(tags))
        bodies[name] = json.dumps({"X": X.tolist()}).encode()
    log = os.path.join(wb, "nvcc.log")
    wrapper_dir = os.path.join(wb, "bin")
    write_nvcc_wrapper(wrapper_dir, _kernels._nvcc(), log)
    env = {key: value for key, value in os.environ.items() if key not in WB_OFF}
    env.update({"PYTHONPATH": root, "PATH": wrapper_dir + os.pathsep + env.get("PATH", ""),
                "GORDO_LEDGER_DIR": os.path.join(wb, "ledger"),
                "GORDO_TELEMETRY": "1", "GORDO_TELEMETRY_INTERVAL": "0"})
    for key in ("CUDA_KERNEL_DEBUG", "GORDO_FAULTS", "GORDO_LAZY_BOOT", "GORDO_TELEMETRY_DIR"):
        env.pop(key, None)
    f32, bf16 = "flash_fwd_f32", "flash_fwd_bf16"
    wanted = expected_forward_libraries([d for d, _ in WB_MACHINES.values()])
    launches = dict(NO_LAUNCHES)
    boots = {}

    def boot(label, boot_env, **kwargs):
        before = len(nvcc_compiled(log))
        result = wb_boot(wb, models, label, boot_env, bodies, **kwargs)
        result["nvcc"] = nvcc_compiled(log)[before:]
        for name in KERNELS:
            launches[name] += result["launches"][name]
        boots[label] = result
        return result

    fleet_bin = os.path.join(wb, "fleet-bin")
    fleet_log = os.path.join(wb, "fleet-nvcc.log")
    write_nvcc_wrapper(fleet_bin, _kernels._nvcc(), fleet_log)
    fleet_env = {**env, "PATH": fleet_bin + os.pathsep + os.environ.get("PATH", "")}
    config_path = os.path.join(wb, "fleet.json")
    with open(config_path, "w") as fh:
        json.dump(wb_fleet_config(), fh)
    out = os.path.join(wb, "fleet-out")
    fleet_run = {}

    def fleet_build():
        # a thread: fail() raises SystemExit here, which the caller reads
        # as a missing result (its message is on stderr already)
        try:
            fleet_run["result"] = run_cli(wb, "fleet-build", "--machine-config", config_path,
                                          "--output-dir", out,
                                          record_name="wb-fleet-build.json", env=fleet_env)
        except SystemExit:
            pass

    # fleet-build --serving-cache runs beside the cold, warm and flipped
    # boots (its own store, its own nvcc log): their walls are taken beside
    # it
    fleet_thread = threading.Thread(target=fleet_build, name="wb-fleet-build")
    fleet_thread.start()
    cold = boot("cold", env)
    if sorted(cold["nvcc"]) != sorted(f"{n}.cu" for n in wanted):
        fail(f"warm boot cold: nvcc compiled {cold['nvcc']}, expected the libraries {wanted}")
    wb_counts("cold", cold, {"miss": 2, "write": 2}, {f32: "miss", bf16: "miss"})

    # the flipped boot runs beside the warm one, over a tree of its own:
    # hard links of the models, a copy of the store with a bit flipped in
    # the fp32 entry's library, its own nvcc log and ledger
    flipped_models = os.path.join(wb, "models-flipped")
    for name in WB_MACHINES:
        shutil.copytree(os.path.join(models, name), os.path.join(flipped_models, name),
                        copy_function=os.link)
    flipped_store = default_root(flipped_models)
    shutil.copytree(store, flipped_store)
    flip_a_bit(os.path.join(store_entry(flipped_store, f32), "library.so"))
    flipped_log = os.path.join(wb, "flipped-nvcc.log")
    write_nvcc_wrapper(os.path.join(wb, "flipped-bin"), _kernels._nvcc(), flipped_log)
    flipped_env = {**env, "PATH": os.path.join(wb, "flipped-bin") + os.pathsep
                   + os.environ.get("PATH", ""),
                   "GORDO_LEDGER_DIR": os.path.join(wb, "flipped-ledger")}
    flipped_run = {}

    def flipped_boot():
        # a thread: fail() raises SystemExit here, which the caller reads as
        # a missing result (its message is on stderr already)
        try:
            flipped_run["result"] = wb_boot(wb, flipped_models, "flipped", flipped_env, bodies)
        except SystemExit:
            pass

    flipped_thread = threading.Thread(target=flipped_boot, name="wb-flipped-boot")
    flipped_thread.start()
    # no nvcc can be found: the boot serves only if it needs none
    warm = boot("warm", env_without_nvcc(env, os.path.join(wb, "no-cuda")), telemetry=True)
    if warm["nvcc"]:
        fail(f"warm boot warm: nvcc ran for {warm['nvcc']}")
    wb_counts("warm", warm, {"hit": 2}, {f32: "hit", bf16: "hit"})
    wb_same_bits("warm", warm, cold["scores"])
    compile_block = warm["compile"]
    by_rung = compile_block["by_precision"]
    if compile_block["keys"] != 2 or not (by_rung.get("f32", 0) > 0 and by_rung.get("bf16", 0) > 0) \
            or not all(warm["rungs"][r]["compile_seconds"] == by_rung[r] for r in ("f32", "bf16")):
        fail(f"warm boot telemetry: compile block {compile_block}, export rungs "
             f"{ {r: v.get('compile_seconds') for r, v in warm['rungs'].items()} }")
    flipped_thread.join()
    if "result" not in flipped_run:
        fail("warm boot: the flipped boot failed")
    healed = flipped_run["result"]
    healed["nvcc"] = nvcc_compiled(flipped_log)
    for name in KERNELS:
        launches[name] += healed["launches"][name]
    boots["flipped"] = healed
    if healed["nvcc"] != [f"{f32}.cu"]:
        fail(f"warm boot flipped: nvcc compiled {healed['nvcc']}, expected {f32} alone")
    wb_counts("flipped", healed, {"invalid": 1, "hit": 1, "write": 1}, {f32: "invalid", bf16: "hit"})
    wb_same_bits("flipped", healed, cold["scores"])

    # fleet-build --serving-cache: the export after the commits fills the
    # store a server over the output defaults to; the boot over it runs
    # beside the debug build and the cache verbs
    fleet_thread.join()
    if "result" not in fleet_run:
        fail("warm boot: fleet-build failed")
    _, fleet_wall, fleet_launches, _ = fleet_run["result"]
    fleet_nvcc = nvcc_compiled(fleet_log)
    for name in KERNELS:
        launches[name] += fleet_launches[name]
    if sorted(fleet_nvcc) != ["flash_bwd_f32.cu", "flash_fwd_f32.cu"]:
        fail(f"warm boot fleet-build: nvcc compiled {fleet_nvcc}, expected the fp32 forward "
             f"and backward (the fit's) and nothing for the export")
    fleet_bodies = {name: json.dumps({"X": sensor_rows(
        rng, WB_FLEET_SLICE["lookback_window"] + WB_WINDOWS - 1, WB_FLEET_TAGS).tolist()}).encode()
        for name in WB_FLEET}
    fleet_served = {}

    def fleet_boot():
        try:
            fleet_served["result"] = wb_boot(wb, out, "fleet", fleet_env, fleet_bodies)
        except SystemExit:
            pass

    fleet_boot_thread = threading.Thread(target=fleet_boot, name="wb-fleet-boot")
    fleet_boot_thread.start()

    # a CUDA_KERNEL_DEBUG build, resolved in this process by the boot's own
    # call (_kernels.resolve) with the wrapper first on PATH
    saved = {key: os.environ.get(key) for key in ("CUDA_KERNEL_DEBUG", "PATH")}
    os.environ.update(CUDA_KERNEL_DEBUG="1", PATH=env["PATH"])
    try:
        before = len(nvcc_compiled(log))
        debug_store = CompileCacheStore(store)
        debug = {"compile_cache": debug_store.counters,
                 "kernel_libraries": _kernels.resolve(wanted, debug_store)}
        debug_nvcc = nvcc_compiled(log)[before:]
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    if sorted(debug_nvcc) != sorted(f"{n}.cu" for n in wanted):
        fail(f"warm boot debug: nvcc compiled {debug_nvcc}")
    wb_counts("debug", debug, {"miss": 2, "write": 2}, {f32: "miss", bf16: "miss"})

    # the cache verbs: a damaged bf16 entry, the debug entries of another
    # backend, and a reference-format entry beside the port's subdirectory
    flip_a_bit(os.path.join(store_entry(store, bf16), "library.so"))
    reference = os.path.join(os.path.dirname(store), REFERENCE_ENTRY)
    os.makedirs(reference)
    with open(os.path.join(reference, "KEY.json"), "w") as fh:
        json.dump({"program": {"kind": "serving-cold"}, "backend": {"jax": "0"}}, fh)
    listed = json.loads(cli_output("cache", "list", "--store", store))
    marks = {(e["program"]["library"], e["backend"]["debug"]): (e["current"], e["verified"])
             for e in listed["entries"]}
    if marks != {(f32, False): (True, True), (bf16, False): (True, False),
                 (f32, True): (False, True), (bf16, True): (False, True)}:
        fail(f"warm boot cache list: (library, debug) -> (current, verified) {marks}")
    damaged = {os.path.basename(store_entry(store, bf16)),
               os.path.basename(store_entry(store, f32, True)),
               os.path.basename(store_entry(store, bf16, True))}
    kept = os.path.basename(store_entry(store, f32))
    purged = json.loads(cli_output("cache", "purge", "--store", store, "--stale"))
    left = sorted(n for n in os.listdir(store) if n.startswith("cc-"))
    if set(purged["removed"]) != damaged or left != [kept] or not os.path.isdir(reference):
        fail(f"warm boot cache purge --stale: removed {purged['removed']}, left {left}, the "
             f"reference-format entry {'kept' if os.path.isdir(reference) else 'removed'}")

    fleet_boot_thread.join()
    if "result" not in fleet_served:
        fail("warm boot: the boot over fleet-build's output failed")
    served = fleet_served["result"]
    for name in KERNELS:
        launches[name] += served["launches"][name]
    if nvcc_compiled(fleet_log) != fleet_nvcc:
        fail(f"warm boot fleet: the boot over the exported store ran nvcc "
             f"{nvcc_compiled(fleet_log)[len(fleet_nvcc):]}")
    wb_counts("fleet", served, {"hit": 1}, {f32: "hit"})
    if not served["launches"]["flash_fwd_f32"]:
        fail("warm boot fleet: the served PatchTST machines launched no flash_fwd_f32")


    walls = ", ".join(f"{label} {b['boot_s']:.2f} s" for label, b in boots.items())
    print(f"warm boot [{card}]: boot walls (start to /healthz 200) {walls}; nvcc "
          f"invocations cold {len(cold['nvcc'])}, warm (no nvcc on the host) "
          f"{len(warm['nvcc'])}, flipped "
          f"{len(healed['nvcc'])}, debug {len(debug_nvcc)}; warm answers equal the cold "
          f"boot's bit for bit; compile block keys {compile_block['keys']}, bytes "
          f"{compile_block['bytes_total']}, seconds by rung {by_rung}")
    print(f"warm boot [{card}]: fleet-build with the serving export {fleet_wall:.2f} s, "
          f"beside the cold, warm and flipped boots (nvcc {fleet_nvcc}), the boot over its "
          f"output, beside the debug build and the cache verbs, {served['boot_s']:.2f} s with "
          f"{served['compile_cache']['hit']} hit and no nvcc; cache purge --stale removed "
          f"{len(purged['removed'])} and kept {kept} and {REFERENCE_ENTRY}")
    return launches


# phase 18: the port's lint on the card's host, and the lock witness over a
# server on the card
LW_DENSE = [f"lw-dense-{i}" for i in range(8)]
LW_F32 = "lw-slice-f32"  # phase 3's artifact
LW_BF16 = "lw-slice-bf16"  # phase 3b's
LW_LAZY = ["lw-zlazy-0", "lw-zlazy-1"]  # sorted after the eager machines
LW_RELOAD = LW_DENSE[0]  # rebuilt in place before POST /reload
LW_CLIENTS = 8
LW_SECONDS = 15.0
LW_WINDOWS = 16  # BH 8192, as phase 2 holds
LW_ENV = {"GORDO_LOCKCHECK": "1", "GORDO_LAZY_BOOT": "1",
          "GORDO_BOOT_EAGER": str(len(LW_DENSE) + 2), "GORDO_SLO_EVAL_INTERVAL": "0",
          "GORDO_AUTOPILOT_INTERVAL": "0", "GORDO_TELEMETRY_INTERVAL": "0"}
LW_MARK = "lock-witness: "
LW_FIELDS = ("model-input", "model-output", "tag-anomaly-scores", "total-anomaly-score")
LW_SHOWN = ("kernels.", "compile_cache.", "engine.template", "engine.spill")
# edges only the card makes, which the run must show: a bucket's program
# launching under its template lock, a spilled machine's under the spill
# lock, the boot's library resolution through the store
LW_REQUIRED = (("engine.template", "kernels.launch"), ("engine.spill", "kernels.launch"),
               ("kernels.load", "compile_cache.store"))
LW_CHILD = r"""
import json
import os
import sys
import threading
import time

config = json.load(open(sys.argv[1]))
from gordo_components_tpu_torch.analysis import lockcheck

if not lockcheck.enabled:
    sys.exit("GORDO_LOCKCHECK was not set when the port was imported")
from gordo_components_tpu_torch.ops import _kernels
from gordo_components_tpu_torch.server.server import ModelServer

server = ModelServer(config["models_dir"], device=config["device"], lazy_boot=True)
engines = [server.engine]
bodies = {name: open(path, "rb").read() for name, path in config["bodies"].items()}
statuses = {}
tally = threading.Lock()
HEADERS = {"Content-Type": "application/json"}


def ask(method, path, body=b""):
    response = server.handle(method, path, HEADERS, body)
    with tally:
        statuses[str(response.status)] = statuses.get(str(response.status), 0) + 1
    return response


def score(name):
    return ask("POST", f"/gordo/v0/project/{name}/anomaly/prediction", bodies[name])


def client(i, deadline):
    dense = config["dense"]
    schedule = []
    for k in range(len(dense)):
        schedule += [dense[(i + k) % len(dense)], config["slice"][k % 2]]
        if k % 2:
            schedule.append(config["lazy"][(i + k // 2) % 2])
    k = i
    while time.monotonic() < deadline:
        score(schedule[k % len(schedule)])
        k += 1


events = {}
started = time.monotonic()
deadline = started + config["seconds"]
threads = [threading.Thread(target=client, args=(i, deadline)) for i in range(config["clients"])]
for thread in threads:
    thread.start()
reads = 0
for at, step in ((0.05, "check"), (0.15, "read"), (0.2, "prefetch"), (0.33, "reload"),
                 (0.5, "read"), (0.8, "read")):
    time.sleep(max(0.0, started + at * config["seconds"] - time.monotonic()))
    if step == "check":
        reply = score(config["check"]["machine"])
        data = json.loads(reply.body)["data"] if reply.status == 200 else {}
        import numpy as np

        np.savez(config["check"]["out"], **{field: np.asarray(data[field], np.float64)
                                            for field in data if field in config["fields"]})
    elif step == "read":
        for path in ("/slo", "/telemetry", "/autopilot"):
            reads += ask("GET", path).status == 200
    elif step == "prefetch":
        reply = ask("POST", "/prefetch", json.dumps({"machines": [config["prefetch"]]}).encode())
        events["prefetch"] = json.loads(reply.body)
    else:
        directory = os.path.join(config["models_dir"], config["reload"])
        later = time.time() + 10
        for entry in os.scandir(directory):
            if entry.is_file():
                os.utime(entry.path, (later, later))
        reply = ask("POST", "/reload")
        events["reload"] = json.loads(reply.body)
        engines.append(server.engine)
for thread in threads:
    thread.join()
server.close()


def flash_dispatches(engine, dtype):
    stats = engine.stats()
    key = f"{config['shape']}/{dtype}"
    return (stats["bucket_dispatches"].get(key, {}).get("dispatches", 0)
            + stats["spill"]["scorer_dispatches"].get(key, 0))


cache = {}
for engine in engines:
    for field, value in engine.host_cache.stats().items():
        if field in ("hits", "misses", "evictions", "loads", "prefetches"):
            cache[field] = cache.get(field, 0) + value
print(config["mark"] + json.dumps({
    "violations": lockcheck.violations(),
    "report": lockcheck.report(),
    "edges": [[a, b, n] for (a, b), n in sorted(lockcheck.observed_edges().items())],
    "launches": dict(_kernels.LAUNCHES),
    "dispatches": {dtype: sum(flash_dispatches(e, dtype) for e in engines)
                   for dtype in ("float32", "bfloat16")},
    "statuses": statuses,
    "reads": reads,
    "engines": len(engines),
    "cache": cache,
    **events,
}), flush=True)
"""


def lw_lint(card: str) -> dict:
    """The port's lint over this checkout (stdlib only): 0 fresh findings.
    Returns {"baselined": n, "seconds": wall, "timings": per checker}."""
    from gordo_components_tpu_torch.analysis.findings import Baseline
    from gordo_components_tpu_torch.analysis.runner import BASELINE_RELPATH, run_lint

    root = os.path.dirname(os.path.abspath(__file__))
    timings = {}
    started = time.perf_counter()
    findings = run_lint(root, jobs=1, timings=timings)
    fresh, baselined = Baseline.load(os.path.join(root, BASELINE_RELPATH)).split(findings)
    wall = time.perf_counter() - started
    if fresh:
        fail("lint: " + "; ".join(f.render().splitlines()[0] for f in fresh[:5]))
    out = {"baselined": len(baselined), "seconds": round(wall, 3),
           "timings": {name: round(spent, 3) for name, spent in sorted(timings.items())}}
    print(f"lint [{card}]: 0 findings, {out['baselined']} baselined, {wall:.2f} s; per "
          f"checker (s) {json.dumps(out['timings'])}")
    return out


def lw_build(models_dir: str, tmp: str, device) -> dict:
    """The phase's tree, fleet index included: ``LW_DENSE`` at bench.py's
    ``dense_ae_10tag`` widths, phase 3's fp32 and phase 3b's bf16 slice
    machines (built here when those phases did not run), two more fp32
    slice machines of other seeds. Returns {machine: tags}."""
    import shutil

    from gordo_components_tpu_torch.store.generations import build_fleet_index, write_fleet_index

    estimator, kwargs, tags = ZOO["dense-ae-10tag"]
    for i, name in enumerate(LW_DENSE):
        build_zoo_artifact(os.path.join(models_dir, name), estimator, kwargs, tags, device,
                           np.random.default_rng(SEED + 18000 + i))
    for name, source, dtype in ((LW_F32, "turbine-long-window", "float32"),
                                (LW_BF16, "turbine-long-window-bf16", "bfloat16")):
        if os.path.isdir(os.path.join(tmp, source)):
            shutil.copytree(os.path.join(tmp, source), os.path.join(models_dir, name))
        else:
            build_artifact(os.path.join(models_dir, name), device, compute_dtype=dtype)
    for i, name in enumerate(LW_LAZY):
        build_artifact(os.path.join(models_dir, name), device, seed=SEED + 18100 + i)
    write_fleet_index(models_dir, build_fleet_index(models_dir))
    return {**{name: tags for name in LW_DENSE}, **dict.fromkeys([LW_F32, LW_BF16, *LW_LAZY],
                                                                  N_TAGS)}


def lw_cap_mb(models_dir: str, device) -> int:
    """A host-cache size in MiB that holds one lazy slice bundle and not
    two, from the bytes the engine reports for each."""
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import ModelServer

    sizer = ServingEngine({}, lazy={name: ModelServer._lazy_loader(
        name, os.path.join(models_dir, name)) for name in LW_LAZY}, host_cache_mb=0,
        device=device)
    sizes = [sizer._build_bundle(name, sizer._lazy[name])[1] for name in LW_LAZY]
    sizer.close()
    cap_mb = math.ceil(1.5 * max(sizes) / 2**20)
    if not max(sizes) <= cap_mb << 20 < sum(sizes):
        fail(f"lock witness: a cap of {cap_mb} MiB does not hold one bundle of {sizes} but "
             "not two")
    return cap_mb


def lw_run_child(config: dict, env: dict, timeout: float = 600.0) -> dict:
    """Run ``LW_CHILD`` over ``config`` and return its JSON line."""
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(os.path.dirname(config["check"]["out"]), "lw-config.json")
    with open(path, "w") as fh:
        json.dump({**config, "mark": LW_MARK}, fh)
    proc = subprocess.run([sys.executable, "-c", LW_CHILD, path], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    lines = [line[len(LW_MARK):] for line in proc.stdout.splitlines()
             if line.startswith(LW_MARK)]
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"lock witness: the child exited {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(lines[0])


def lw_check(report: dict, n_layers: int = SLICE["n_layers"]) -> dict:
    """Hold the child's line to the phase's contract; returns the flash
    launches by kernel."""
    if report["violations"] or report["report"]:
        fail(f"lock witness: {len(report['violations'])} violation(s), report "
             f"{(report['report'] or report['violations'])[:3]}")
    bad = {status: n for status, n in report["statuses"].items() if status != "200"}
    if bad or not report["statuses"].get("200"):
        fail(f"lock witness: answers by status {report['statuses']}")
    launches = {name: report["launches"].get(name, 0) for name in KERNELS}
    for dtype, kernel in (("float32", "flash_fwd_f32"), ("bfloat16", "flash_fwd_bf16")):
        dispatches = report["dispatches"][dtype]
        if not dispatches or launches[kernel] != n_layers * dispatches:
            fail(f"lock witness: {launches[kernel]} {kernel} launches for {dispatches} "
                 f"{dtype} PatchTST dispatches (want {n_layers} each)")
    if any(launches[name] for name in BWD_KERNELS):
        fail(f"lock witness: a serving run launched a backward: {launches}")
    if not report["cache"].get("evictions") or report.get("prefetch", {}).get("unknown", 1):
        fail(f"lock witness: host cache {report['cache']}, prefetch {report.get('prefetch')}")
    if LW_RELOAD not in report.get("reload", {}).get("refreshed", []) or report["engines"] != 2:
        fail(f"lock witness: reload answered {report.get('reload')}")
    seen = {(a, b) for a, b, _ in report["edges"]}
    missing = [edge for edge in LW_REQUIRED if edge not in seen]
    if missing:
        fail(f"lock witness: edges {missing} were not observed")
    return launches


def phase_lock_witness(torch, device, tmp: str, card: str) -> dict:
    """The port's lint on this host, beside the lock witness over a server
    on the card (see the module docstring, 18). Returns the phase's flash
    launches."""
    root = os.path.dirname(os.path.abspath(__file__))
    if LW_WINDOWS not in SERVED:  # run alone: phase 3 makes its artifact and answer
        phase_serve(torch, device, tmp)
    models_dir = os.path.join(tmp, "lock-witness")
    started = time.perf_counter()
    tags = lw_build(models_dir, tmp, device)
    cap_mb = lw_cap_mb(models_dir, device)
    X, answer = SERVED[LW_WINDOWS]
    rng = np.random.default_rng(SEED + 18200)
    bodies = {}
    for name, n in tags.items():
        rows = X if name == LW_F32 else sensor_rows(
            rng, LOOKBACK + LW_WINDOWS - 1 if n == N_TAGS else SEAMS_ROWS, n)
        bodies[name] = os.path.join(tmp, f"lw-{name}.json")
        with open(bodies[name], "w") as fh:
            json.dump({"X": rows.tolist()}, fh)
    built_s = time.perf_counter() - started
    config = {"models_dir": models_dir, "device": str(device), "bodies": bodies,
              "dense": LW_DENSE, "slice": [LW_F32, LW_BF16], "lazy": LW_LAZY,
              "reload": LW_RELOAD, "prefetch": LW_LAZY[1], "seconds": LW_SECONDS,
              "clients": LW_CLIENTS, "shape": f"L{LOOKBACK}a0f{N_TAGS}",
              "fields": list(LW_FIELDS), "check": {"machine": LW_F32,
                                                 "out": os.path.join(tmp, "lw-check.npz")}}
    env = {key: value for key, value in os.environ.items() if key not in WB_OFF}
    env.update(LW_ENV, PYTHONPATH=root, GORDO_HOST_CACHE_MB=str(cap_mb))
    # the lint (host only) runs in a thread while this process only waits on
    # the witness's child (beside this process's own Python work it would
    # share the interpreter lock and save nothing); fail() there raises
    # SystemExit, read as a missing result (its message is on stderr already)
    linted = {}

    def lint_thread():
        try:
            linted["out"] = lw_lint(card)
        except SystemExit:
            pass

    lint_worker = threading.Thread(target=lint_thread, name="lint")
    lint_worker.start()
    started = time.perf_counter()
    report = lw_run_child(config, env)
    child_s = time.perf_counter() - started
    lint_worker.join()
    if "out" not in linted:
        fail("lint: see above")
    lint = linted["out"]
    launches = lw_check(report)
    with np.load(config["check"]["out"]) as got:
        worst = compare_arrays("lock witness", LW_WINDOWS, dict(got), {
            field: np.asarray(answer[field], np.float64) for field in LW_FIELDS}, FUSED_RTOL)
    shown = [edge for edge in report["edges"]
             if any(part.startswith(LW_SHOWN) for part in edge[:2])]
    print(f"lock witness [{card}]: tree built in {built_s:.1f} s (host cache {cap_mb} MiB); "
          f"child {child_s:.1f} s, {sum(report['statuses'].values())} answers "
          f"{report['statuses']}, {report['reads']} control reads, dispatches "
          f"{report['dispatches']}, launches {launches}, cache {report['cache']}, "
          f"{len(report['edges'])} edges, 0 violations; the W = {LW_WINDOWS} answer vs phase "
          f"3's: worst relative difference {worst:.3g} (limit {FUSED_RTOL}); lint "
          f"{lint['seconds']} s")
    print(f"lock witness edges (card only) [{card}]: {json.dumps(shown)}")
    return launches


# phase 19: the fleet build as two ranks of one gloo group on this card.
# FLEET_BUILD's three buckets with their own kwargs at 16 dense, 4 LSTM and
# 2 full-width PatchTST machines, in slices of 8: dense trains in two
# slices, and each rank owns one PatchTST machine
MR_COUNTS = {"dense": 16, "lstm": 4, "patchtst": 2}
MR_SLICE = 8
MR_WORLD = 2
MR_PREFIX = "mr-"
MR_GRACE_S = 15.0  # rank 0's exit after its watchdog's budget, at most
MR_RUN_TIMEOUT_S = 600.0
MR_WATCHDOG_FLOOR_S = 20.0
MR_WATCHDOG_FACTOR = 1.1  # the drill's budget over B's worst healthy watched span
MR_HOLD_S = 5.0  # the drill's late fetch of dense slice 1, inside its budget
MR_DEVICE_ARGS = ()  # the card; a CPU rehearsal passes ("--device", "cpu")


def mr_owners(config: dict) -> dict:
    """Each machine's rank: within its bucket (fleet order) slices of
    MR_SLICE, each padded to a multiple of the ranks, rank r owning the
    r-th contiguous block of every slice."""
    by_bucket = {}
    for machine in config["machines"]:
        by_bucket.setdefault(machine["name"][len(MR_PREFIX):].rsplit("-", 1)[0], []).append(
            machine["name"])
    owners = {}
    for names in by_bucket.values():
        eff = min(MR_SLICE, len(names))
        block = -(-eff // MR_WORLD)
        for j, name in enumerate(names):
            owners[name] = (j % eff) // block
    return owners


def mr_start(tmp: str, config_path: str, root: str, label: str, env: dict,
             world: int = MR_WORLD) -> list:
    """The rank processes of ``cli fleet-build`` (CLI_RUNNER, a record and a
    log each) on one coordinator port; ``world`` 1: one process, no group."""
    repo = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    ranks = []
    for rank in range(world):
        record = os.path.join(tmp, f"mr-{label}-rank{rank}.json")
        log = os.path.join(tmp, f"mr-{label}-rank{rank}.log")
        if os.path.exists(record):
            os.remove(record)
        args = ["fleet-build", "--machine-config", config_path, "--output-dir", root,
                "--slice-size", str(MR_SLICE), "--no-serving-cache", *MR_DEVICE_ARGS]
        if world > 1:
            args += ["--coordinator-address", f"127.0.0.1:{port}", "--num-processes",
                     str(world), "--process-id", str(rank)]
        fh = open(log, "w")
        proc = subprocess.Popen([sys.executable, "-c", CLI_RUNNER, record, *args], cwd=repo,
                                stdout=fh, stderr=subprocess.STDOUT,
                                env={**env, "PYTHONPATH": repo})
        fh.close()
        entry = {"rank": rank, "proc": proc, "record": record, "log": log,
                 "started": time.perf_counter(), "wall": None}

        def watch(entry=entry):  # the exit's time, whenever it is read
            entry["proc"].wait()
            entry["ended"] = time.perf_counter()

        threading.Thread(target=watch, daemon=True).start()
        ranks.append(entry)
    return ranks


def mr_tail(rank: dict, n: int = 3000) -> str:
    with open(rank["log"]) as fh:
        return fh.read()[-n:]


def mr_bind_failed(ranks: list) -> bool:
    """Rank 0 could not listen on the chosen port (taken after it was
    found free)."""
    code = ranks[0]["proc"].poll()
    return code not in (None, 0) and "EADDRINUSE" in mr_tail(ranks[0], 20000)


def mr_stop(ranks: list) -> None:
    for rank in ranks:
        if rank["proc"].poll() is None:
            rank["proc"].kill()
        rank["proc"].wait()


def mr_wait(ranks: list, timeout: float) -> str:
    """Wait for every rank; "bind" when rank 0 could not listen (the rest
    are killed), else "done". Fails past ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        for rank in ranks:
            if rank["wall"] is None and rank["proc"].poll() is not None:
                rank["wall"] = rank.get("ended", time.perf_counter()) - rank["started"]
        if all(rank["wall"] is not None for rank in ranks):
            return "done"
        if mr_bind_failed(ranks):
            mr_stop(ranks)
            return "bind"
        if time.monotonic() > deadline:
            mr_stop(ranks)
            fail("multi-rank: ranks still running after "
                 f"{timeout:.0f} s:\n" + "\n".join(mr_tail(r) for r in ranks))
        time.sleep(0.05)


def mr_run(tmp: str, config_path: str, root: str, label: str, env: dict,
           world: int = MR_WORLD) -> list:
    """Every rank to its end, on a fresh port once more if rank 0 could
    not bind its first; fails unless all exit 0. Returns the ranks with
    their walls, launches and peak device bytes."""
    for attempt in range(2):
        ranks = mr_start(tmp, config_path, root, label, env, world)
        if mr_wait(ranks, MR_RUN_TIMEOUT_S) == "bind" and attempt == 0:
            print(f"multi-rank {label}: rank 0 could not bind its port; retrying once")
            continue
        break
    return mr_records(label.upper(), ranks)


def mr_records(label: str, ranks: list) -> list:
    """Fails unless every process exited 0 with its record; adds each one's
    launches and peak device bytes."""
    bad = [rank for rank in ranks
           if rank["proc"].returncode != 0 or not os.path.exists(rank["record"])]
    if bad:
        fail(f"multi-rank {label}: exits {[rank['proc'].returncode for rank in ranks]}\n"
             + "\n".join(f"rank {rank['rank']}: {mr_tail(rank, 1500)}" for rank in bad))
    for rank in ranks:
        with open(rank["record"]) as fh:
            record = json.load(fh)
        rank["launches"], rank["peak"] = record["launches"], record["peak_bytes"]
    return ranks


def mr_manifests(root: str) -> list:
    out = []
    for rank in range(MR_WORLD):
        name = "fleet_manifest.json" if rank == 0 else f"fleet_manifest.p{rank}.json"
        with open(os.path.join(root, name)) as fh:
            out.append(json.load(fh))
    return out


def mr_outputs(root: str, config: dict, device) -> dict:
    """Each machine of ``root``: its predictions on fixed rows on the card,
    its thresholds and its loss history."""
    import torch

    from gordo_components_tpu_torch.serializer import load, load_metadata

    rng = np.random.default_rng(SEED + 1900)
    out = {}
    for machine in config["machines"]:
        name = machine["name"]
        _, _, kwargs, tags, _, _ = FLEET_BUILD[name[len(MR_PREFIX):].rsplit("-", 1)[0]]
        X = sensor_rows(rng, kwargs.get("lookback_window", 1) + 15, tags)
        model = load(os.path.join(root, name), device=device)
        pred = np.asarray(model.predict(X), np.float64)
        del model
        detector = load_metadata(os.path.join(root, name))["model"]["model_builder_metadata"]
        history = re.findall(r'"loss": \[([^\]]*)\]', json.dumps(detector))
        out[name] = (pred, np.append(detector["tag_thresholds"], detector["total_threshold"]),
                     np.array([float(v) for v in history[0].split(",")] if history else []))
    # the builds that follow need the card's memory back: two slice-machine
    # fits take all but a few GiB of it
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def mr_compare(label: str, got: dict, want: dict) -> tuple:
    """Every machine's outputs (``mr_outputs``) against the one-rank
    build's: predictions relative to max(1, max |prediction|) and
    thresholds (relative, floor 1e-6) within FLEET_THRESHOLD_RTOL, the loss
    history within TRAIN_RTOL (as phase 10's ``stacking_check``). Returns
    the worst of each."""
    worst = np.zeros(3)
    for name, (pred, thresholds, losses) in got.items():
        ref_pred, ref_thresholds, ref_losses = want[name]
        pred_rel = np.abs(pred - ref_pred).max() / max(1.0, np.abs(ref_pred).max())
        thr_rel = (np.abs(thresholds - ref_thresholds)
                   / np.maximum(np.abs(ref_thresholds), 1e-6)).max()
        loss_rel = (np.abs(losses - ref_losses).max() / np.abs(ref_losses).max()
                    if ref_losses.size and losses.shape == ref_losses.shape else np.inf)
        if (pred.shape != ref_pred.shape or not np.isfinite(pred).all()
                or not pred_rel <= FLEET_THRESHOLD_RTOL or not thr_rel <= FLEET_THRESHOLD_RTOL
                or not loss_rel <= TRAIN_RTOL):
            fail(f"multi-rank {label}: {name} departs from the one-rank build (predictions "
                 f"{pred_rel:.3g}, thresholds {thr_rel:.3g}, limit {FLEET_THRESHOLD_RTOL}; "
                 f"loss {loss_rel:.3g}, limit {TRAIN_RTOL})")
        worst = np.maximum(worst, (pred_rel, thr_rel, loss_rel))
    return tuple(worst)


def mr_committed(root: str) -> dict:
    """rank -> the machines its journal records committed."""
    from gordo_components_tpu_torch.store import journal as store_journal

    out = {}
    for rank in range(MR_WORLD):
        path = store_journal.journal_path(root, rank)
        names = set()
        if os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    try:
                        record = json.loads(line)
                    except ValueError:
                        continue  # a line being written
                    if record.get("event") == store_journal.EVENT_COMMITTED:
                        names.add(record.get("machine"))
        out[rank] = names
    return out


def mr_wedge(tmp: str, config_path: str, root: str, env: dict, owners: dict,
             timeout_s: float) -> dict:
    """Two ranks under GORDO_SLICE_TIMEOUT_S; once both journals show their
    share of dense slice 0 committed, SIGSTOP rank 1: rank 0 must exit 75
    with the watchdog's line within the budget plus MR_GRACE_S. Then
    SIGKILL rank 1. Returns what the drill saw."""
    import signal

    slice0 = {rank: {f"{MR_PREFIX}dense-{i:03d}" for i in range(MR_SLICE)
                     if owners[f"{MR_PREFIX}dense-{i:03d}"] == rank} for rank in range(MR_WORLD)}
    # each rank's first machine of dense slice 1 is fetched MR_HOLD_S late
    # (a latency fault): both ranks then wait inside slice 1's budget, so
    # the stop below lands mid-build however slowly this process polls
    # (without it, a starved poll can see slice 0 only once a small fleet
    # is done, and rank 0 exits 0)
    slice1 = [f"{MR_PREFIX}dense-{i:03d}" for i in range(MR_SLICE, 2 * MR_SLICE)]
    held = [next(name for name in slice1 if owners[name] == rank) for rank in range(MR_WORLD)]
    drill_env = {**env, "GORDO_SLICE_TIMEOUT_S": f"{timeout_s:.0f}",
                 "GORDO_FAULTS": ";".join(f"data-fetch:{name}:latency:{MR_HOLD_S}"
                                          for name in held)}
    for attempt in range(2):
        ranks = mr_start(tmp, config_path, root, "wedge", drill_env)
        deadline = time.monotonic() + MR_RUN_TIMEOUT_S
        while True:
            committed = mr_committed(root)
            if all(slice0[rank] <= committed[rank] for rank in range(MR_WORLD)):
                break
            if mr_bind_failed(ranks) and attempt == 0:
                break
            if any(r["proc"].poll() is not None for r in ranks) or time.monotonic() > deadline:
                mr_stop(ranks)
                fail("multi-rank wedge: a rank ended before dense slice 0 was committed:\n"
                     + "\n".join(mr_tail(r) for r in ranks))
            time.sleep(0.05)
        if mr_bind_failed(ranks) and attempt == 0:
            mr_stop(ranks)
            print("multi-rank wedge: rank 0 could not bind its port; retrying once")
            continue
        break
    os.kill(ranks[1]["proc"].pid, signal.SIGSTOP)
    stopped = time.perf_counter()
    at_stop = sum(len(names) for names in mr_committed(root).values())
    try:
        code = ranks[0]["proc"].wait(timeout=timeout_s + MR_GRACE_S)
    except subprocess.TimeoutExpired:
        code = None
    exit_s = time.perf_counter() - stopped
    os.kill(ranks[1]["proc"].pid, signal.SIGKILL)
    mr_stop(ranks)
    log = mr_tail(ranks[0], 20000)
    if code != 75 or "Fleet slice watchdog" not in log or "exiting 75" not in log:
        fail(f"multi-rank wedge: rank 0 exit {code} {exit_s:.1f} s after rank 1 stopped "
             f"(budget {timeout_s:.0f} s + {MR_GRACE_S:.0f}):\n{log[-3000:]}")
    # rank 0 commits on until its next collective: count at the end
    return {"exit_s": exit_s, "code": code, "rank1": ranks[1]["proc"].returncode,
            "at_stop": at_stop,
            "committed": {rank: sorted(names) for rank, names in mr_committed(root).items()},
            "watchdog": [line for line in log.splitlines() if "Fleet slice watchdog" in line][0]}


def phase_multirank(torch, device, tmp: str, card: str, beside_drill=None) -> dict:
    """The fleet build as two ranks on this card (see the module
    docstring, 19). ``beside_drill`` (phase 20), if given, runs in a thread
    beside the wedge drill, whose ranks sit mostly idle (one stopped, the
    other blocked until its watchdog fires), and is done before A, which
    needs the card alone. Returns the launches of every process that ran
    to its end."""
    import gc

    from gordo_components_tpu_torch.serializer import load_metadata

    phase_started = time.perf_counter()
    # each rank's PatchTST fit needs about half the card: this process must
    # hold nothing, and the builds' allocators grow segments in place
    # instead of stranding a few GiB each in fragments
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"multi-rank: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB of "
          f"the card before the builds ({torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated)")
    config = fleet_build_config(MR_COUNTS, MR_PREFIX, SEED + 1900, "chip-smoke-multirank")
    names = [m["name"] for m in config["machines"]]
    owners = mr_owners(config)
    config_path = os.path.join(tmp, "mr-fleet.json")
    with open(config_path, "w") as fh:
        json.dump(config, fh)
    env = {**os.environ, "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    roots = {key: os.path.join(tmp, f"mr-{key}") for key in "ABC"}

    # (b) two ranks, first: the drill's budget comes from their slice walls
    # and the spans their watchdogs log at DEBUG
    ranks = mr_run(tmp, config_path, roots["B"], "b", {**env, "GORDO_LOG_LEVEL": "DEBUG"})
    manifests = mr_manifests(roots["B"])
    owned = {rank: sorted(m["machines"]) for rank, m in enumerate(manifests)}
    want = {rank: sorted(n for n in names if owners[n] == rank) for rank in range(MR_WORLD)}
    if owned != want or any(m["journal"] != {"resumed": 0, "torn": 0, "rebuilt": len(want[r])}
                            for r, m in enumerate(manifests)):
        fail(f"multi-rank B: manifests {owned} (want {want}), journals "
             f"{[m.get('journal') for m in manifests]}")
    metas = {n: load_metadata(os.path.join(roots["B"], n)) for n in names}
    rows = max(metas[n]["dataset"]["x_shape"][0] for n in names if "-patchtst-" in n)
    expected = fleet_flash_launches(rows)
    for rank in ranks:
        if rank["launches"] != expected:
            fail(f"multi-rank B: rank {rank['rank']} launched {rank['launches']}, expected "
                 f"{expected} for its one PatchTST machine")
    pair_wall = max(rank["wall"] for rank in ranks)
    slice_walls = {}
    for name in names:
        fleet_meta = metas[name]["model"]["fleet"]
        key = f"{name[len(MR_PREFIX):].rsplit('-', 1)[0]}/{fleet_meta['slice']}"
        slice_walls[key] = max(slice_walls.get(key, 0.0), fleet_meta["slice_duration_s"])
    print(f"multi-rank [{card}]: two ranks (B): "
          + "; ".join(f"rank {r['rank']} {r['wall']:.2f} s, peak {r['peak'] / 2**30:.2f} GiB, "
                      f"launches {r['launches']}, {len(owned[r['rank']])} machines"
                      for r in ranks)
          + f"; the pair {3600 * len(names) / pair_wall:.0f} machines per hour; slice walls "
          f"(bucket/slice: s) {json.dumps({k: round(v, 2) for k, v in slice_walls.items()})}")

    # (c) the wedge drill; its ranks are gone before A starts. The budget
    # is sized from the spans the watchdog guards in B (the plan's
    # agreement, and each slice's fit, artifacts and checkpoint), which
    # B's ranks log at DEBUG; a slice's training wall alone is shorter
    spans = [float(m.group(1)) for rank in ranks for m in re.finditer(
        r"Fleet slice span: .* took ([0-9.]+)s", mr_tail(rank, 1 << 24))]
    if not spans:
        fail("multi-rank B: its ranks logged no watched span")
    budget = max(MR_WATCHDOG_FLOOR_S,
                 math.ceil(MR_WATCHDOG_FACTOR * max(max(slice_walls.values()), max(spans))))
    beside = None
    if beside_drill is not None:
        beside = threading.Thread(target=beside_drill, name="beside-the-drill")
        beside.start()
    drill = mr_wedge(tmp, config_path, roots["C"], env, owners, budget)
    if beside is not None:
        beside.join()
        # what ran beside the drill in this process goes back to the card
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    resumed = len(set().union(*drill["committed"].values()))
    print(f"multi-rank wedge [{card}]: GORDO_SLICE_TIMEOUT_S={budget:.0f} "
          f"({MR_WATCHDOG_FACTOR} x the worst healthy span the watchdog guards in B, "
          f"{max(spans):.2f} s); rank 1 stopped with "
          f"{drill['at_stop']} machines committed, {resumed} at the end "
          f"({ {r: len(n) for r, n in drill['committed'].items()} } by rank); rank 0 exited "
          f"{drill['code']} {drill['exit_s']:.1f} s later; rank 1 SIGKILLed "
          f"({drill['rank1']}); "
          f"{drill['watchdog'][drill['watchdog'].index('Fleet slice watchdog'):][:120]}")

    # (a) one rank, alone on the card: its PatchTST slice stacks both slice
    # machines, twice a rank's memory, and leaves no room for another build
    (one,) = mr_run(tmp, config_path, roots["A"], "a", env, world=1)
    with open(os.path.join(roots["A"], "fleet_manifest.json")) as fh:
        built = json.load(fh)["machines"]
    if sorted(built) != sorted(names) or one["launches"] != expected:
        fail(f"multi-rank A: {len(built)} machines, launches {one['launches']} (expected "
             f"{expected})")
    want = mr_outputs(roots["A"], config, device)
    worst_b = mr_compare("B", mr_outputs(roots["B"], config, device), want)
    print(f"multi-rank [{card}]: one rank (A) {one['wall']:.2f} s in the process, alone on the "
          f"card, peak {one['peak'] / 2**30:.2f} GiB, launches {one['launches']}, "
          f"{3600 * len(names) / one['wall']:.0f} machines per hour (the pair: "
          f"{3600 * len(names) / pair_wall:.0f}); B vs A: predictions "
          f"{worst_b[0]:.3g}, thresholds {worst_b[1]:.3g} (limit {FLEET_THRESHOLD_RTOL}), "
          f"losses {worst_b[2]:.3g} (limit {TRAIN_RTOL})")

    # (c) the re-run of both ranks on C
    gc.collect()
    torch.cuda.empty_cache()
    print(f"multi-rank: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB of "
          f"the card before the re-run")
    rerun = mr_run(tmp, config_path, roots["C"], "c", {**env, "GORDO_SLICE_TIMEOUT_S": "900"})
    manifests = mr_manifests(roots["C"])
    if any(m["journal"]["resumed"] != resumed for m in manifests):
        fail(f"multi-rank C: journals {[m['journal'] for m in manifests]}, {resumed} resumed "
             "expected")
    checkpoints = os.path.join(roots["C"], ".slice_checkpoints")
    if os.path.isdir(checkpoints) and os.listdir(checkpoints):
        fail(f"multi-rank C: checkpoints left: {os.listdir(checkpoints)}")
    for rank in rerun:
        if rank["launches"] != expected:
            fail(f"multi-rank C: rank {rank['rank']} launched {rank['launches']}, expected "
                 f"{expected}")
    worst_c = mr_compare("C", mr_outputs(roots["C"], config, device), want)
    print(f"multi-rank re-run [{card}]: "
          + "; ".join(f"rank {r['rank']} {r['wall']:.2f} s, journal "
                      f"{manifests[r['rank']]['journal']}" for r in rerun)
          + f"; C vs A: predictions {worst_c[0]:.3g}, thresholds {worst_c[1]:.3g}, losses "
          f"{worst_c[2]:.3g}; phase wall {time.perf_counter() - phase_started:.1f} s")
    launches = dict(one["launches"])
    for rank in ranks + rerun:
        for name in KERNELS:
            launches[name] += rank["launches"][name]
    return launches


# phase 20: the fleet-sharded serving mesh. Two shards over one models root:
# the two full-width slice machines (fp32 and bf16) and four dense ones,
# hard links of phase 14's artifacts where that phase built them. The
# names are pinned so that each shard owns one slice machine and two dense
# ones (tests/test_torch_chip_smoke_mesh.py finds them): the plan is a pure
# function of the names
MESH_SHARDS = 2
MESH_SLICE = {"float32": "mesh-slice-f32-a", "bfloat16": "mesh-slice-bf16"}
MESH_DENSE = [f"mesh-dense-{i}" for i in range(4)]
MESH_WINDOWS = TIER_WINDOWS  # windows of a PatchTST request: BH 8192, as phase 2 holds
# each machine's artifact in phase 14's models root
MESH_SOURCES = {MESH_SLICE["float32"]: TIER_PATCHTST[0], MESH_SLICE["bfloat16"]: TIER_BF16,
                **{name: TIER_DENSE[2 + i] for i, name in enumerate(MESH_DENSE)}}


def mesh_build(models_dir: str, tier_dir: str, device) -> dict:
    """The phase's models root: each machine a hard-linked copy of its
    phase 14 artifact (``MESH_SOURCES``), or built here when that phase did
    not run. Returns {machine: tags}."""
    import shutil

    estimator, kwargs, dense_tags = ZOO["dense-ae-10tag"]
    tags = {}
    for i, (name, source) in enumerate(sorted(MESH_SOURCES.items())):
        dest = os.path.join(models_dir, name)
        dtype = next((d for d, n in MESH_SLICE.items() if n == name), None)
        tags[name] = dense_tags if dtype is None else N_TAGS
        if os.path.isdir(os.path.join(tier_dir, source)):
            shutil.copytree(os.path.join(tier_dir, source), dest, copy_function=os.link)
        elif dtype is None:
            build_zoo_artifact(dest, estimator, kwargs, dense_tags, device,
                               np.random.default_rng(SEED + 20000 + i))
        else:
            build_artifact(dest, device, compute_dtype=dtype, seed=SEED + 20100 + i)
    return tags


def mesh_ask(url: str, name: str, body: bytes, trace: str = None) -> tuple:
    """A request asking for npz: (payload, answering shard, answering
    worker, wall ms)."""
    from gordo_components_tpu_torch import wire

    headers = {"Accept": wire.NPZ_CONTENT_TYPE}
    if trace is not None:
        headers["X-Gordo-Trace-Id"] = trace
    status, reply, raw, ms = http("POST", f"{url}/gordo/v0/project/{name}/anomaly/prediction",
                                  body, headers)
    if status != 200:
        fail(f"mesh: {name} answered HTTP {status} {raw[:300]!r}")
    return decode(reply, raw), reply.get("X-Gordo-Shard"), reply.get("X-Gordo-Worker"), ms


def mesh_counts(url: str) -> dict:
    """A worker's gordo_mesh_requests_total by path, and its
    gordo_mesh_shard_machines."""
    samples = tier_prometheus(url + "/metrics?format=prometheus")
    counts = {"owned": 0.0, "fallback": 0.0}
    for labels, value in samples.get("gordo_mesh_requests_total", []):
        counts[labels["path"]] = counts.get(labels["path"], 0.0) + value
    counts["machines"] = sum(v for _, v in samples.get("gordo_mesh_shard_machines", []))
    return counts


def mesh_expected(torch, device, models_dir: str, encoded: dict) -> dict:
    """A single-host eager server's lone answers on the card (npz) over the
    same root, and their walls: {machine: (payload, ms)}."""
    from gordo_components_tpu_torch.server.server import make_server

    saved = os.environ.get("GORDO_TELEMETRY")
    os.environ["GORDO_TELEMETRY"] = "0"
    httpd = make_server(models_dir, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        if httpd.model_server.mesh_shard is not None:
            fail("mesh: the single-host server runs as a shard")
        expected = {}
        for name in sorted(encoded):
            payload, shard, _, ms = mesh_ask(url, name, encoded[name])
            if shard is not None:
                fail(f"mesh: the single-host server stamped X-Gordo-Shard {shard}")
            expected[name] = (payload, ms)
        return expected
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        httpd.model_server.close()
        if saved is None:
            os.environ.pop("GORDO_TELEMETRY", None)
        else:
            os.environ["GORDO_TELEMETRY"] = saved
        torch.cuda.synchronize()


def mesh_worker_pid(router_pid: int, worker_id: int) -> int:
    """The pid of the router's worker process of slot ``worker_id``."""
    for pid in tier_children(router_pid):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                argv = fh.read().decode(errors="replace").split("\0")
        except OSError:
            continue
        if "--worker-id" in argv and argv[argv.index("--worker-id") + 1] == str(worker_id):
            return pid
    fail(f"mesh: no worker process of slot {worker_id} under the router {router_pid}")


def phase_mesh(torch, device, tmp: str, card: str) -> dict:
    """The fleet-sharded serving mesh on the card (see the module docstring,
    20). Returns the flash launches of the mesh's worker processes."""
    import signal

    from gordo_components_tpu_torch.parallel.shard_plan import FleetShardPlan

    phase_started = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    device_arg = "cpu" if device.type == "cpu" else None
    models_dir = os.path.join(tmp, "mesh")
    tags = mesh_build(models_dir, os.path.join(tmp, "tier"), device)
    names = sorted(tags)
    plan = FleetShardPlan(MESH_SHARDS)
    owner = plan.assign(names)
    slice_owner = {dtype: owner[name] for dtype, name in MESH_SLICE.items()}
    if plan.policy(len(names)) != "sharded" or sorted(slice_owner.values()) != list(
            range(MESH_SHARDS)):
        fail(f"mesh: the plan is {plan.policy(len(names))} and puts the slice machines on shards "
             f"{slice_owner}")
    rng = np.random.default_rng(SEED + 20400)
    encoded = {name: json.dumps({"X": sensor_rows(
        rng, LOOKBACK + MESH_WINDOWS - 1 if n == N_TAGS else SEAMS_ROWS, n).tolist()}).encode()
        for name, n in tags.items()}

    records = os.path.join(tmp, "mesh-records")
    os.makedirs(records, exist_ok=True)
    port = free_port()
    worker_base = free_port_run(MESH_SHARDS)
    base = f"http://127.0.0.1:{port}"
    workers = [f"http://127.0.0.1:{worker_base + i}" for i in range(MESH_SHARDS)]
    log_path = os.path.join(tmp, "mesh.log")
    log = open(log_path, "wb")
    argv = [sys.executable, "-c", FLEET_RUNNER, records, CLI_RUNNER, "run-fleet-server",
            "--models-dir", models_dir, "--workers", str(MESH_SHARDS), "--mesh-shards",
            str(MESH_SHARDS), "--host", "127.0.0.1", "--port", str(port), "--worker-base-port",
            str(worker_base), "--probe-interval", str(TIER_PROBE_S)]
    if device_arg is not None:
        argv += ["--device", device_arg]
    env = {**os.environ, "PYTHONPATH": root, "GORDO_TELEMETRY": "0",
           "GORDO_LEDGER_DIR": os.path.join(tmp, "mesh-ledger")}
    for key in ("GORDO_FAULTS", "GORDO_LAZY_BOOT", "GORDO_BOOT_EAGER", "GORDO_HOST_CACHE_MB",
                "GORDO_MESH_SHARDS", "GORDO_MESH_SHARD", "GORDO_MESH_MIN_SHARD_MACHINES"):
        env.pop(key, None)
    started = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    children = []

    def tail():
        log.flush()
        with open(log_path, "rb") as fh:
            return fh.read()[-3000:].decode(errors="replace")

    try:
        # the single-host answers, while the mesh's workers boot
        expected = mesh_expected(torch, device, models_dir, encoded)

        def up():
            if proc.poll() is not None:
                fail(f"mesh: run-fleet-server exited {proc.returncode}: {tail()}")
            try:
                status, _, raw, _ = http("GET", base + "/healthz")
            except OSError:
                return False
            return status == 200 and json.loads(raw).get("status") == "ok"

        tier_wait(up, TIER_READY_S, "the mesh's workers", poll=0.2)
        walls = {"boot_s": round(time.perf_counter() - started, 3)}
        children = tier_children(proc.pid)
        maps = ""
        try:
            with open(f"/proc/{proc.pid}/maps") as fh:
                maps = fh.read()
        except OSError:
            pass
        if tier_nvidia_files(proc.pid) or "libcuda" in maps or "libtorch" in maps:
            fail(f"mesh: the router holds {tier_nvidia_files(proc.pid)} or maps libcuda or "
                 f"libtorch")
        if device.type == "cuda" and not all(tier_nvidia_files(pid) for pid in children):
            fail(f"mesh: a worker of {children} holds no device file of the card")

        # 1. each worker's slice of the layout
        for shard, url in enumerate(workers):
            health = fc_get(url + "/healthz")
            owned = plan.owned(names, shard)
            want = {"shard": shard, "shards": MESH_SHARDS, "owned": len(owned),
                    "remote_or_lazy": len(names) - len(owned)}
            if health.get("mesh") != want or health.get("machines") != owned or \
                    mesh_counts(url)["machines"] != len(owned):
                fail(f"mesh: worker {shard}'s /healthz mesh {health.get('mesh')} and machines "
                     f"{health.get('machines')}, gauge {mesh_counts(url)['machines']}; the plan "
                     f"{want}, {owned}")
        counts = [mesh_counts(url) for url in workers]
        banked = [fc_dispatches(url) for url in workers]

        # 2. the owned rung: every machine through the router from its owner
        owned_ms = {}
        for name in names:
            payload, shard, worker, ms = mesh_ask(base, name, encoded[name])
            if shard != str(owner[name]) or worker != str(owner[name]):
                fail(f"mesh owned: {name} answered by shard {shard} (worker {worker}), the plan's "
                     f"owner is {owner[name]}")
            spill_same_bits(f"owned {name}", payload, expected[name][0], "mesh")
            owned_ms[name] = round(ms, 3)
        moved = [{k: mesh_counts(url)[k] - counts[s][k] for k in ("owned", "fallback")}
                 for s, url in enumerate(workers)]
        want_moved = [{"owned": float(sum(owner[n] == s for n in names)), "fallback": 0.0}
                      for s in range(MESH_SHARDS)]
        if moved != want_moved:
            fail(f"mesh owned: gordo_mesh_requests_total moved {moved}, want {want_moved}")
        print(f"mesh [{card}]: run-fleet-server --workers {MESH_SHARDS} --mesh-shards "
              f"{MESH_SHARDS} ready in {walls['boot_s']:.2f} s (the single-host server's answers "
              f"taken meanwhile); the plan {plan.counts(names)} machines per shard, slice "
              f"machines on shards {slice_owner}; every machine answered by its owner through "
              f"the router, byte for byte the single-host answer, counted owned {moved}")

        # 3. the fallback rung of the bf16 slice machine, asked of the other
        # shard straight: a miss, then a hit
        fallback_ms = {}
        name = MESH_SLICE["bfloat16"]
        other = 1 - owner[name]
        before = mesh_counts(workers[other])
        cache = fc_cache(workers[other])
        walls_bf16 = []
        for _ in range(2):
            payload, shard, _, ms = mesh_ask(workers[other], name, encoded[name])
            if shard != str(other):
                fail(f"mesh fallback: {name} asked of shard {other} answered as {shard}")
            spill_same_bits(f"fallback {name}", payload, expected[name][0], "mesh")
            walls_bf16.append(round(ms, 3))
        cache_moved = {k: fc_cache(workers[other])[k] - cache[k] for k in ("hits", "misses")}
        after = mesh_counts(workers[other])
        # a miss counts miss, store and hit (the load, then the lookup that
        # scores), the hit one hit
        if after["fallback"] - before["fallback"] != 2 or cache_moved != {"hits": 2,
                                                                          "misses": 1}:
            fail(f"mesh fallback: {name} moved shard {other}'s fallback count by "
                 f"{after['fallback'] - before['fallback']}, its cache by {cache_moved}")
        fallback_ms["bf16"] = walls_bf16

        # 4. the owner of the fp32 slice machine SIGKILLed: the other shard
        # answers it through the router before the owner is back
        name = MESH_SLICE["float32"]
        victim, survivor = owner[name], 1 - owner[name]
        banked[victim] = fc_dispatches(workers[victim])
        before = mesh_counts(workers[survivor])
        os.kill(mesh_worker_pid(proc.pid, victim), signal.SIGKILL)
        killed = time.perf_counter()
        walls_f32 = []
        for i in range(2):
            payload, shard, worker, ms = mesh_ask(base, name, encoded[name], f"mesh-fallback-{i}")
            if (shard, worker) != (str(survivor), str(survivor)):
                fail(f"mesh fallback: with shard {victim} down, {name} answered by shard {shard} "
                     f"(worker {worker})")
            spill_same_bits(f"fallback {name}", payload, expected[name][0], "mesh")
            walls_f32.append(round(ms, 3))
        fallback_ms["f32"] = walls_f32
        events = [e.get("name") for e in fc_get(
            f"{workers[survivor]}/debug/requests/mesh-fallback-0").get("events", [])]
        moved = mesh_counts(workers[survivor])["fallback"] - before["fallback"]
        if "mesh_fallback" not in events or moved != 2:
            fail(f"mesh fallback: shard {survivor}'s timeline events {events}, its fallback "
                 f"count moved by {moved}")

        def owner_answers():
            if proc.poll() is not None:
                fail(f"mesh: run-fleet-server exited {proc.returncode}: {tail()}")
            payload, shard, _, _ = mesh_ask(base, name, encoded[name])
            if shard != str(victim):
                return False
            spill_same_bits(f"respawned {name}", payload, expected[name][0], "mesh")
            return True

        def victim_up():
            try:
                return http("GET", workers[victim] + "/healthz")[0] == 200
            except OSError:
                return False

        tier_wait(victim_up, TIER_READY_S, f"shard {victim}'s respawn", poll=0.2)
        tier_wait(owner_answers, 60, f"shard {victim} answering {name} again", poll=0.5)
        walls["owner_back_s"] = round(time.perf_counter() - killed, 3)
        print(f"mesh [{card}] fallback: {MESH_SLICE['bfloat16']} asked of shard "
              f"{1 - owner[MESH_SLICE['bfloat16']]} straight and {name} through the router with "
              f"shard {victim} SIGKILLed, each a miss then a hit, byte for byte the "
              f"single-host answer (tolerance 0: phase 15 holds a spilled answer to the eager "
              f"one's bytes), X-Gordo-Shard the other shard, its fallback count +2, "
              f"mesh_fallback in its timeline; shard {victim} respawned and answering "
              f"{name} again {walls['owner_back_s']:.2f} s after the kill")

        # 5. the launches: 3 per slice dispatch, stacked or spilled, per process
        finals = [fc_dispatches(url) for url in workers]
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        if code != 0:
            fail(f"mesh: run-fleet-server exited {code} on SIGTERM: {tail()}")
        alive = [pid for pid in tier_children(proc.pid) + children
                 if os.path.exists(f"/proc/{pid}")]
        if alive:
            fail(f"mesh: workers {alive} outlived the router")
        incarnations = []
        for shard in range(MESH_SHARDS):
            found = sorted((f for f in os.listdir(records) if f.startswith(f"worker-{shard}-")),
                           key=lambda f: int(f[:-5].rsplit("-", 1)[1]))
            if len(found) != 1:
                fail(f"mesh: launch records {found} for worker-{shard}")
            if shard == victim:
                # the SIGKILLed incarnation writes no record: the one found
                # is its respawn's
                incarnations.append({"name": f"worker-{shard}", "record": "", "killed": True,
                                     "banked": banked[shard]})
            incarnations.append({"name": f"worker-{shard}",
                                 "record": os.path.join(records, found[0]),
                                 "banked": finals[shard], "killed": False})
        launches, problems = tier_launch_sums(incarnations)
        if problems:
            fail("mesh launches: " + "; ".join(problems))
        if device.type == "cuda" and not (launches["flash_fwd_f32"] and launches["flash_fwd_bf16"]):
            fail(f"mesh launches: {launches}, both forward kernels expected")
        single_ms = {dtype: round(expected[n][1], 3) for dtype, n in MESH_SLICE.items()}
        print(f"mesh [{card}]: " + json.dumps({
            "walls": walls,
            "slice_ms": {"single_host": single_ms,
                         "owned": {d: owned_ms[n] for d, n in MESH_SLICE.items()},
                         "fallback_miss_hit": fallback_ms},
            "dispatches": {f"worker-{s}": finals[s] for s in range(MESH_SHARDS)},
            "killed_dispatches": banked[victim], "launches": launches,
            "phase_s": round(time.perf_counter() - phase_started, 1)}))
        return launches
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for pid in children + tier_children(proc.pid):
            try:
                os.kill(pid, 9)
            except ProcessLookupError:
                pass
        log.close()


SHARD_DENSE = [f"shard-dense-{i:02d}" for i in range(12)]
SHARD_SLICE = {"float32": "shard-slice-f32", "bfloat16": "shard-slice-bf16"}
SHARD_INT8 = "shard-int8"
SHARD_ADDED = "shard-dense-added"  # joins the tree before the reload
SHARD_WINDOWS = TIER_WINDOWS  # windows of a PatchTST request: BH 8192, as phase 2 holds
SHARD_RESIDENCY = 4  # part (b)'s megabatch_residency: 12 dense machines make a partial bucket
SHARD_RESIZED = 8
SHARD_BUCKETS = 4  # dense f32, dense int8, the fp32 and the bf16 slice machine
# each machine's artifact: (phase root, name there); built here when absent
SHARD_SOURCES = {SHARD_SLICE["float32"]: ("tier", TIER_PATCHTST[0]),
                 SHARD_SLICE["bfloat16"]: ("tier", TIER_BF16),
                 SHARD_INT8: ("spill", SPILL_INT8),
                 SHARD_ADDED: ("tier", TIER_DENSE[14]),
                 **{name: ("tier", TIER_DENSE[2 + i]) for i, name in enumerate(SHARD_DENSE)}}


def shard_build(root: str, tmp: str, device) -> dict:
    """Every machine of the phase under ``root``: a hard-linked copy of its
    phase 14 or 15 artifact (``SHARD_SOURCES``), or built here when that
    phase did not run. Returns {machine: tags}."""
    import shutil

    estimator, kwargs, dense_tags = ZOO["dense-ae-10tag"]
    tags = {}
    for i, (name, (phase, source)) in enumerate(sorted(SHARD_SOURCES.items())):
        dest = os.path.join(root, name)
        dtype = next((d for d, n in SHARD_SLICE.items() if n == name), None)
        tags[name] = dense_tags if dtype is None else N_TAGS
        if os.path.isdir(os.path.join(tmp, phase, source)):
            shutil.copytree(os.path.join(tmp, phase, source), dest, copy_function=os.link)
        elif dtype is None:
            build_zoo_artifact(dest, estimator, kwargs, dense_tags, device,
                               np.random.default_rng(SEED + 21000 + i),
                               precision="int8" if name == SHARD_INT8 else None)
        else:
            build_artifact(dest, device, compute_dtype=dtype, seed=SEED + 21100 + i)
    return tags


def shard_expected(torch, device, models_dir: str, encoded: dict) -> dict:
    """A single-host eager server's lone answers on the card (npz) over
    ``models_dir``, and their walls: {machine: (payload, ms)}."""
    from gordo_components_tpu_torch.server.server import make_server

    saved = os.environ.get("GORDO_TELEMETRY")
    os.environ["GORDO_TELEMETRY"] = "0"
    httpd = make_server(models_dir, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        if httpd.model_server.engine.stats()["shard_mesh_devices"]:
            fail("shard: the single-host server runs in shard mode")
        return {name: mesh_ask(url, name, encoded[name])[::3] for name in sorted(encoded)}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        httpd.model_server.close()
        if saved is None:
            os.environ.pop("GORDO_TELEMETRY", None)
        else:
            os.environ["GORDO_TELEMETRY"] = saved
        torch.cuda.synchronize()


def shard_series(url: str) -> dict:
    """A server's gordo_engine_requests_total by path and its
    gordo_engine_hot_cache_events_total by event."""
    samples = tier_prometheus(url + "/metrics?format=prometheus")
    out = {}
    for series, label in (("gordo_engine_requests_total", "path"),
                          ("gordo_engine_hot_cache_events_total", "event")):
        for labels, value in samples.get(series, []):
            out[labels[label]] = out.get(labels[label], 0.0) + value
    return out


def shard_server(tmp: str, models_dir: str, env: dict, device_arg) -> tuple:
    """``run-server --shard-fleet`` over ``models_dir`` as a process (through
    CLI_RUNNER, which records its launches), on a port the server binds
    itself (``--port 0``): a port picked free here and bound after the
    boot's ~20 s can be taken in between by the other process's servers
    and clients. (process, record, log path, started)."""
    root = os.path.dirname(os.path.abspath(__file__))
    record = os.path.join(tmp, "shard-server.json")
    log_path = os.path.join(tmp, "shard-server.log")
    argv = [sys.executable, "-c", CLI_RUNNER, record, "run-server", "--models-dir", models_dir,
            "--shard-fleet", "--host", "127.0.0.1", "--port", "0"]
    if device_arg is not None:
        argv += ["--device", device_arg]
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(argv, cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, record, log_path, time.perf_counter()


def served_url(log_path: str):
    """The base url a ``run-server`` process logged once it was listening
    (``Serving [...] on http://HOST:PORT``), or None before that."""
    with open(log_path, "rb") as fh:
        found = re.search(rb"Serving \[.*?\] on (http://[0-9.]+:[0-9]+)", fh.read())
    return found[1].decode() if found else None


def shard_partial(torch, device, models_dir: str, encoded: dict, expected: dict,
                  card: str) -> dict:
    """Part (b): the partial residency tier in this process on the card.
    Returns its launches."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.observability.registry import REGISTRY
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.server.engine import ServingEngine, _Item
    from gordo_components_tpu_torch.server.server import _Machine

    names = SHARD_DENSE + [SHARD_SLICE["float32"]]
    machines = {name: _Machine(name, os.path.join(models_dir, name)) for name in names}
    events = REGISTRY.counter("gordo_engine_megabatch_events_total", "", labels=("event",))
    before = dict(events.collect())
    _kernels.reset_launches()
    engine = ServingEngine({n: m.model for n, m in machines.items()},
                           precisions={n: m.precision for n, m in machines.items()},
                           device=device, megabatch_residency=SHARD_RESIDENCY, fill_window_us=0)
    try:
        bucket, _ = engine._by_name[SHARD_DENSE[0]]
        if bucket._mega_full or not engine._by_name[SHARD_SLICE["float32"]][0]._mega_full:
            fail("shard partial: the dense bucket is not partial, or the slice machine's not full")
        engine.warmup()
        promotion_s = []
        promote = bucket._maybe_promote_mega

        def timed_promote(items):
            with bucket._mega_lock:
                resident = len(bucket._mega_slots)
            started = time.perf_counter()
            promote(items)
            with bucket._mega_lock:
                grew = len(bucket._mega_slots) > resident
            if grew:
                promotion_s.append(time.perf_counter() - started)

        bucket._maybe_promote_mega = timed_promote
        rows = {name: np.asarray(json.loads(encoded[name])["X"], np.float32) for name in names}
        lone = {}
        for name in SHARD_DENSE[:5]:
            for hit in range(2):  # cold, then cold and promote
                scored = engine.anomaly(name, rows[name])
                engine.quiesce()
                lone.setdefault(name, scored)
                with bucket._mega_lock:
                    resident = sorted(bucket.names[i] for i in bucket._mega_slots)
                if len(resident) > SHARD_RESIDENCY:
                    fail(f"shard partial: {len(resident)} resident machines past the cap")
        if resident != SHARD_DENSE[:SHARD_RESIDENCY]:
            fail(f"shard partial: resident {resident}, want the first {SHARD_RESIDENCY} "
                 f"promoted (the freshness guard keeps them)")
        mega_before = engine.stats()["megabatch"]["requests"]
        again = engine.anomaly(SHARD_DENSE[0], rows[SHARD_DENSE[0]])
        if engine.stats()["megabatch"]["requests"] != mega_before + 1 or any(
                np.asarray(a).tobytes() != np.asarray(b).tobytes()
                for a, b in zip(again, lone[SHARD_DENSE[0]])):
            fail("shard partial: a resident machine's lone answer is not the cold one's bits")
        # a fused resident batch against the cold path's answer to that batch
        fused = {}
        for path in ("mega", "cold"):
            items = []
            for name in SHARD_DENSE[:SHARD_RESIDENCY]:
                x, m_valid = engine._prepare(bucket, rows[name])
                items.append(_Item(engine._by_name[name][1], x, m_valid))
            count = bucket.mega_dispatch_count
            if path == "mega":
                bucket._dispatch(items[0].x.shape[0], items, defer=False)
            else:
                bucket._dispatch_cold(items[0].x.shape[0], items, defer=False)
            if not all(it.done.wait(60) and it.error is None for it in items) or (
                    bucket.mega_dispatch_count != count + (path == "mega")):
                fail(f"shard partial: the {path} batch of {len(items)} failed or went elsewhere")
            fused[path] = [[np.asarray(a) for a in it.result] for it in items]
        for name, mega, cold in zip(SHARD_DENSE, fused["mega"], fused["cold"]):
            if any(a.tobytes() != b.tobytes() for a, b in zip(mega, cold)):
                fail(f"shard partial: {name} in the fused resident batch differs from the cold "
                     f"batch's bits")
            for a, b in zip(mega, lone[name]):
                if not np.allclose(a, np.asarray(b), rtol=FUSED_RTOL, atol=FUSED_RTOL):
                    fail(f"shard partial: {name} fused differs from its lone answer past "
                         f"FUSED_RTOL")
        # the live cap, and a layout pin
        applied = engine.apply_tuning(megabatch_residency=SHARD_RESIZED)
        if applied != {"megabatch_residency": SHARD_RESIZED} or engine.stats()["megabatch"][
                "resident_machines"] != 1:  # the slice machine's full bucket
            fail(f"shard partial: apply_tuning answered {applied}, "
                 f"{engine.stats()['megabatch']['resident_machines']} resident after it")
        pinned_name = SHARD_DENSE[5]
        pin = engine.pin_residency([pinned_name])
        if pin != {"pinned": 1, "resident": 0, "seeded": 1, "unknown": []}:
            fail(f"shard partial: pin_residency answered {pin}")
        engine.anomaly(pinned_name, rows[pinned_name])
        engine.quiesce()
        with bucket._mega_lock:
            if engine._by_name[pinned_name][1] not in bucket._mega_slots:
                fail("shard partial: the pinned machine's next cold hit did not promote it")
        moved = {key[0]: value - before.get(key, 0.0) for key, value in events.collect().items()}
        if moved.get("residency_resize") != 1 or moved.get("promote") != SHARD_RESIDENCY + 1:
            fail(f"shard partial: megabatch events moved {moved}")
        # the slice machine's full bucket: mega dispatches, 3 launches each
        slice_name = SHARD_SLICE["float32"]
        for _ in range(2):
            scored = engine.anomaly(slice_name, rows[slice_name])
            for field, array in zip(wire.SCORE_FIELDS, scored):
                want = np.asarray(expected[slice_name][0]["data"][field])
                if np.asarray(array).tobytes() != want.tobytes():
                    fail(f"shard partial: {slice_name} {field} differs from the single-host "
                         f"server's answer")
        engine.quiesce()
        torch.cuda.synchronize()
        dispatches = spill_flash_dispatches(engine.stats(), "float32")
        launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
        if launches != {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"] * dispatches}:
            fail(f"shard partial launches: {launches} for {dispatches} fp32 slice dispatches")
        stats = engine.stats()["megabatch"]
        print(f"shard [{card}] (b) partial residency: megabatch_residency {SHARD_RESIDENCY} over "
              f"{len(SHARD_DENSE)} dense machines and the slice machine; the first "
              f"{SHARD_RESIDENCY} promoted on their second hit, the fifth kept out by the "
              f"freshness guard; a fused resident batch of {SHARD_RESIDENCY} equals the cold "
              f"batch bit for bit and its lone answers within FUSED_RTOL; apply_tuning "
              f"answered {SHARD_RESIZED}, the pin promoted on its next hit; events {moved}; "
              f"promotion walls (ms) {[round(s * 1e3, 3) for s in promotion_s]}; mega "
              f"{stats['dispatches']} dispatches / {stats['requests']} requests; launches "
              f"{launches}")
        return launches
    finally:
        engine.close()


def phase_shard(torch, device, tmp: str, card: str) -> dict:
    """The host-sharded capacity mode and the partial residency tier on the
    card (see the module docstring, 21). Returns the flash launches of the
    shard server's process and of part (b)."""
    import shutil
    import signal

    phase_started = time.perf_counter()
    device_arg = "cpu" if device.type == "cpu" else None
    on_card = device.type == "cuda"
    base_dir = os.path.join(tmp, "shard")
    expected_dir = os.path.join(base_dir, "expected")
    models_dir = os.path.join(base_dir, "models")
    os.makedirs(models_dir, exist_ok=True)
    tags = shard_build(expected_dir, tmp, device)
    for name in tags:
        if name != SHARD_ADDED:
            shutil.copytree(os.path.join(expected_dir, name), os.path.join(models_dir, name),
                            copy_function=os.link)
    served = sorted(n for n in tags if n != SHARD_ADDED)
    rng = np.random.default_rng(SEED + 21400)
    encoded = {name: json.dumps({"X": sensor_rows(
        rng, LOOKBACK + SHARD_WINDOWS - 1 if n == N_TAGS else SEAMS_ROWS, n).tolist()}).encode()
        for name, n in sorted(tags.items())}
    walls = {}
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
           "GORDO_TELEMETRY": "0", "GORDO_LEDGER_DIR": os.path.join(base_dir, "ledger")}
    for key in ("GORDO_COMPILE_CACHE_STORE", "GORDO_COMPILE_CACHE", "GORDO_FAULTS",
                "GORDO_LAZY_BOOT", "GORDO_MEGABATCH", "GORDO_SERVE_HOT_CACHE",
                "GORDO_MESH_SHARDS", "GORDO_MESH_SHARD"):
        env.pop(key, None)
    libraries = {}
    if on_card:
        # (a) the store first: cache warm --shard-fleet (the reference's
        # command line; the libraries stored are the plain warm's), run in
        # this process (its libraries, loaded by the earlier phases, are
        # copied in; a process that loaded none builds them)
        from gordo_components_tpu_torch.ops import _kernels

        started = time.perf_counter()
        before = dict(_kernels.LAUNCHES)
        summary = json.loads(cli_output("cache", "warm", "--models-dir", models_dir,
                                        "--shard-fleet"))
        warm_launches = {n: _kernels.LAUNCHES[n] - before[n] for n in KERNELS}
        walls["cache_warm_s"] = round(time.perf_counter() - started, 3)
        libraries = dict.fromkeys(expected_forward_libraries(("float32", "bfloat16")), "hit")
        if (summary["machines"], summary["buckets"], summary["skipped"]) != (
                len(served), SHARD_BUCKETS, {}) or any(warm_launches.values()) or \
                summary["cache"].get("write", 0) != len(libraries):
            fail(f"shard: cache warm --shard-fleet summary {summary}, launches {warm_launches}")
        # a boot that needed nvcc fails here: there is none on its PATH
        env = env_without_nvcc(env, os.path.join(base_dir, "no-nvcc"))
    proc, record, log_path, started = shard_server(base_dir, models_dir, env, device_arg)
    url = None

    def tail():
        with open(log_path, "rb") as fh:
            return fh.read()[-3000:].decode(errors="replace")

    try:
        # the single-host answers while the shard server boots
        expected = shard_expected(torch, device, expected_dir, encoded)

        def up():
            nonlocal url
            if proc.poll() is not None:
                fail(f"shard: run-server --shard-fleet exited {proc.returncode}: {tail()}")
            url = url or served_url(log_path)
            if url is None:
                return False
            try:
                return http("GET", url + "/healthz")[0] == 200
            except OSError:
                return False

        tier_wait(up, TIER_READY_S, "run-server --shard-fleet", poll=0.05)
        walls["boot_s"] = round(time.perf_counter() - started, 3)
        engine = fc_get(url + "/metrics")["engine"]
        counters = {key: 0 for key in ("hit", "miss", "stale", "invalid", "write",
                                       "write_error")}
        counters["hit"] = len(libraries)
        if engine["shard_mesh_devices"] != 1 or engine["megabatch"]["enabled"] or \
                engine["machines"] != len(served) or engine["buckets"] != SHARD_BUCKETS:
            fail(f"shard: /metrics shard_mesh_devices {engine['shard_mesh_devices']}, megabatch "
                 f"{engine['megabatch']}, machines {engine['machines']}, buckets "
                 f"{engine['buckets']}")
        if on_card and (engine["compile_cache"] != counters
                        or engine["kernel_libraries"] != libraries):
            fail(f"shard: the boot's store counts {engine['compile_cache']}, libraries "
                 f"{engine['kernel_libraries']}; want {counters}, {libraries} (no nvcc)")
        before = shard_series(url)
        slice_ms = {dtype: [] for dtype in SHARD_SLICE}
        for _ in range(3):  # cold, cold and promote, hot
            for name in served:
                payload, _, _, ms = mesh_ask(url, name, encoded[name])
                spill_same_bits(f"{name}", payload, expected[name][0], "shard")
                for dtype, slice_name in SHARD_SLICE.items():
                    if name == slice_name:
                        slice_ms[dtype].append(round(ms, 3))
        after = shard_series(url)
        moved = {key: after.get(key, 0.0) - before.get(key, 0.0)
                 for key in ("cold", "hot", "mega", "promote", "evict", "demote")}
        # the warm-up request was each bucket's first machine's first cold
        # hit (as in the reference): those answer cold once and hot twice
        want = {"cold": 2 * len(served) - SHARD_BUCKETS, "hot": len(served) + SHARD_BUCKETS,
                "mega": 0, "promote": len(served), "evict": 0, "demote": 0}
        engine = fc_get(url + "/metrics")["engine"]
        if moved != {k: float(v) for k, v in want.items()} or (
                engine["hot_machines"], engine["hot_requests"]) != (len(served), want["hot"]):
            fail(f"shard: the three rounds moved {moved}, hot {engine['hot_machines']} machines "
                 f"{engine['hot_requests']} requests; want {want}")
        banked = fc_dispatches(url)
        # a reload keeps shard mode: one machine joins the tree
        shutil.copytree(os.path.join(expected_dir, SHARD_ADDED),
                        os.path.join(models_dir, SHARD_ADDED), copy_function=os.link)
        status, _, raw, reload_ms = http("POST", url + "/reload", b"")
        reloaded = json.loads(raw) if status == 200 else {}
        engine = fc_get(url + "/metrics")["engine"]
        if reloaded.get("added") != [SHARD_ADDED] or engine["shard_mesh_devices"] != 1 or \
                engine["machines"] != len(tags) or engine["megabatch"]["enabled"]:
            fail(f"shard reload: HTTP {status} {raw[:300]!r}; shard_mesh_devices "
                 f"{engine['shard_mesh_devices']}, machines {engine['machines']}")
        payload = mesh_ask(url, SHARD_ADDED, encoded[SHARD_ADDED])[0]
        spill_same_bits(f"reloaded {SHARD_ADDED}", payload, expected[SHARD_ADDED][0], "shard")
        reloaded_banked = fc_dispatches(url)
        banked = {rung: banked[rung] + reloaded_banked[rung] for rung in banked}
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        if code != 0:
            fail(f"shard: run-server --shard-fleet exited {code} on SIGTERM: {tail()}")
        launches, problems = tier_launch_sums([{"name": "shard-server", "record": record,
                                                "banked": banked, "killed": False}])
        if problems:
            fail("shard launches: " + "; ".join(problems))
        print(f"shard [{card}] (a) run-server --shard-fleet over {len(served)} machines in "
              f"{SHARD_BUCKETS} buckets: " + json.dumps({
                  "walls": walls, "reload_ms": round(reload_ms, 3),
                  "slice_ms_cold_cold_hot": slice_ms,
                  "single_host_ms": {d: round(expected[n][1], 3)
                                     for d, n in SHARD_SLICE.items()},
                  "moved": moved, "dispatches": banked, "launches": launches,
                  "store": libraries}))
        print(f"shard [{card}] (a): "
              + ("no nvcc on the boot's PATH, its libraries store hits; " if on_card else "")
              + f"/metrics shard_mesh_devices 1, megabatching off; every machine asked 3 times, "
              f"each answer byte for byte the single-host server's (tolerance 0, as phases 15 "
              f"and 20), {int(moved['promote'])} promotions; a reload kept shard mode")
        partial = shard_partial(torch, device, expected_dir, encoded, expected, card)
        for name in KERNELS:
            launches[name] += partial[name]
        print(f"shard [{card}]: phase {round(time.perf_counter() - phase_started, 1)} s")
        return launches
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- phase 22: ring attention over torch.distributed ----------------------------

RING_WORLD = 2
RING_LOOKBACK = 1448  # 180 patches: the slice's 179 are prime and divide over no 2 ranks
RING_WINDOWS = 16  # windows of the kernel-level inputs: BH = 16·64·8 = 8192
RING_TRAIN_WINDOWS = 8  # one batch of the model-level fit
RING_TRAIN_STEPS = 2  # Adam steps: epochs of one batch
RING_HOPS = 3  # timed K/V hops alone
RING_TIMEOUT_S = 420.0  # each rank's wall; one rank's death ends both
RING_ATOL = 2e-5  # float32: the reference's ring-vs-dense bound (tests/test_transformer.py)
# bf16 gradients of Σout² reach magnitudes of 10 and more, where one unit in
# the last place is past BF16_ATOL's cap: they are held to BF16_ULPS units
# of the largest |grad| (a ring sums its hops' bf16 grads, each rounded once,
# where the one-process backward rounds once: about one unit apart)
RING_CONFIG = "ring-config.json"
RING_CALLS = (("ring_flash f32", "float32", "flash"), ("ring f32", "float32", "dense"),
              ("ring_flash bf16", "bfloat16", "flash"))


def ring_config(device) -> dict:
    """What both ranks read: the card or the CPU, the kernel-level shape
    (windows x tags, patches, heads, head dim) and the model-level fit."""
    patches = (RING_LOOKBACK - SLICE["patch_length"]) // SLICE["stride"] + 1
    return {"device": device.type, "timeout_s": RING_TIMEOUT_S,
            "shape": [RING_WINDOWS * N_TAGS, patches, SLICE["n_heads"],
                      SLICE["d_model"] // SLICE["n_heads"]],
            "lookback": RING_LOOKBACK, "slice": SLICE, "tags": N_TAGS,
            "train_windows": RING_TRAIN_WINDOWS, "train_steps": RING_TRAIN_STEPS}


def ring_train_rows(config: dict) -> np.ndarray:
    return sensor_rows(np.random.default_rng(SEED + 22),
                       config["lookback"] + config["train_windows"] - 1, config["tags"])


def ring_fit(torch, device, config: dict, attention_impl: str) -> dict:
    """The model-level run: the slice machine's regressor at ``lookback``
    fitted for ``train_steps`` Adam steps of one batch, parameters from
    the estimator's seed; its loss history, wall, peak memory, launches."""
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import pipeline_from_definition

    model = pipeline_from_definition(slice_definition(
        attention_impl, **config["slice"], lookback_window=config["lookback"],
        batch_size=config["train_windows"], epochs=config["train_steps"]))
    est = model.base_estimator.regressor.steps[-1][1].to(device)
    rows = ring_train_rows(config)
    ring_sync(torch, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    started = time.perf_counter()
    model.base_estimator.fit(rows)
    ring_sync(torch, device)
    return {"history": [float(v) for v in est.history_],
            "wall_s": round(time.perf_counter() - started, 3),
            "peak_gib": ring_peak_gib(torch, device),
            "launches": {name: _kernels.LAUNCHES[name] for name in KERNELS}}


def ring_sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def ring_peak_gib(torch, device) -> float:
    return round(torch.cuda.max_memory_allocated() / 2**30, 2) if device.type == "cuda" else 0.0


def ring_digest(t) -> str:
    import hashlib

    return hashlib.sha1(t.detach().float().contiguous().cpu().numpy().tobytes()).hexdigest()


def ring_call(torch, device, group, dtype: str, impl: str, config: dict) -> dict:
    """One ``ring_attention`` call at the kernel-level shape and its
    backward (Σout²): launches counted from 0 around each, walls, and the
    worst differences of out, dq, dk, dv against the single-process
    ``flash_attention`` of the whole sequence (its autograd) and the plain
    version (dense attention in float32), all on this rank's device."""
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.ops.attention import dense_attention, ring_attention
    from gordo_components_tpu_torch.ops.flash_attention import flash_attention

    generator = torch.Generator(device=device).manual_seed(SEED + 22)
    shape = config["shape"]
    q, k, v = (torch.randn(shape, generator=generator, device=device)
               .to(getattr(torch, dtype)).requires_grad_() for _ in range(3))
    ring_sync(torch, device)
    _kernels.reset_launches()
    started = time.perf_counter()
    out = ring_attention(q, k, v, group=group, block_impl=impl)
    ring_sync(torch, device)
    forward_s = time.perf_counter() - started
    forward = {name: _kernels.LAUNCHES[name] for name in KERNELS}
    _kernels.reset_launches()
    started = time.perf_counter()
    grads = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
    ring_sync(torch, device)
    backward_s = time.perf_counter() - started
    backward = {name: _kernels.LAUNCHES[name] for name in KERNELS}
    result = {"forward_launches": forward, "backward_launches": backward,
              "forward_s": round(forward_s, 4), "backward_s": round(backward_s, 4),
              "digest": ring_digest(out), "errors": {}}
    # the yardsticks (their launches are comparisons, not counted)
    for label, fn, cast in (("flash", flash_attention, None),
                            ("plain", dense_attention, torch.float32)):
        inputs = [t.detach().to(cast or t.dtype).requires_grad_() for t in (q, k, v)]
        ref = fn(*inputs)
        ref_grads = torch.autograd.grad((ref.float() ** 2).sum(), inputs)
        for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads)):
            if dtype == "float32":
                atol = RING_ATOL
            elif name == "out":
                atol = bf16_atol(want)
            else:
                top = want.float().abs().max().item()
                atol = BF16_ULPS * math.ldexp(1.0, math.frexp(top)[1] - 8)
            err = (got.float() - want.float()).abs().max().item()
            result["errors"][f"{name} vs {label}"] = [err, atol]
        del inputs, ref, ref_grads
    return result


def ring_rank_main(rank: int, tmp: str) -> None:
    """One rank of phase 22 (``--ring-rank R TMP``): joins the gloo group
    through a ``file://`` store in TMP, runs the kernel-level calls, times
    K/V hops alone, runs the model-level fit at ``ring_flash``, writes its
    record to ``TMP/ring-rank<R>.json``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from gordo_components_tpu_torch.ops.attention import _Rotation, set_ring_group

    with open(os.path.join(tmp, RING_CONFIG)) as fh:
        config = json.load(fh)
    device = torch.device(config["device"], 0) if config["device"] == "cuda" else \
        torch.device("cpu")
    started = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            rank=rank, world_size=RING_WORLD,
                            timeout=timedelta(seconds=config["timeout_s"]))
    group = dist.group.WORLD
    record = {"rank": rank, "join_s": round(time.perf_counter() - started, 3), "calls": {}}
    for label, dtype, impl in RING_CALLS:
        record["calls"][label] = ring_call(torch, device, group, dtype, impl, config)
    # a hop alone: this rank's K and V blocks of the float32 shape, one rank on
    batch, seq, heads, head_dim = config["shape"]
    block = torch.randn((batch, seq // RING_WORLD, heads, head_dim), device=device)
    hops = []
    for _ in range(RING_HOPS):
        ring_sync(torch, device)
        hop_started = time.perf_counter()
        _Rotation(group, [block, block]).wait()
        ring_sync(torch, device)
        hops.append(round(time.perf_counter() - hop_started, 4))
    record["hop_s"] = hops
    record["hop_bytes"] = 2 * block.numel() * block.element_size()
    del block
    set_ring_group(group)
    try:
        record["fit"] = ring_fit(torch, device, config, "ring_flash")
    finally:
        set_ring_group(None)
    record["peak_gib"] = ring_peak_gib(torch, device)
    record["wall_s"] = round(time.perf_counter() - started, 3)
    with open(os.path.join(tmp, f"ring-rank{rank}.json"), "w") as fh:
        json.dump(record, fh)
    dist.barrier()
    dist.destroy_process_group()


def ring_spawn(tmp: str) -> list:
    """Both ranks, each with its log; their wall is bounded by
    RING_TIMEOUT_S, and one rank's failure stops the other."""
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for rank in range(RING_WORLD):
        log = open(os.path.join(tmp, f"ring-rank{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ring-rank", str(rank), tmp],
            cwd=repo, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": repo}, start_new_session=True))
        log.close()
    deadline = time.monotonic() + RING_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * RING_WORLD:
        tails = []
        for rank in range(RING_WORLD):
            with open(os.path.join(tmp, f"ring-rank{rank}.log")) as fh:
                tails.append(f"rank {rank}:\n{fh.read()[-2000:]}")
        fail(f"phase 22: the ranks exited {codes} (limit {RING_TIMEOUT_S:.0f} s)\n"
             + "\n".join(tails))
    records = []
    for rank in range(RING_WORLD):
        with open(os.path.join(tmp, f"ring-rank{rank}.json")) as fh:
            records.append(json.load(fh))
    return records


def ring_launch_checks(records: list, n_layers: int) -> dict:
    """Each ``ring_flash`` call launches its dtype's forward kernel once per
    hop (RING_WORLD per rank) and its backward kernel once per hop; a
    ``ring`` call launches none; the fit launches both once per hop per
    layer per step. Returns the launches of every rank summed."""
    total = dict(NO_LAUNCHES)
    for record in records:
        for label, dtype, impl in RING_CALLS:
            call = record["calls"][label]
            suffix = "f32" if dtype == "float32" else "bf16"
            want_fwd = {**NO_LAUNCHES, f"flash_fwd_{suffix}": RING_WORLD} if impl == "flash" \
                else dict(NO_LAUNCHES)
            want_bwd = {**NO_LAUNCHES, f"flash_bwd_{suffix}": RING_WORLD} if impl == "flash" \
                else dict(NO_LAUNCHES)
            if call["forward_launches"] != want_fwd or call["backward_launches"] != want_bwd:
                fail(f"phase 22 (a) rank {record['rank']} {label}: launches forward "
                     f"{call['forward_launches']}, backward {call['backward_launches']} "
                     f"(want {want_fwd}, {want_bwd})")
            for name in KERNELS:
                total[name] += call["forward_launches"][name] + call["backward_launches"][name]
        hops = RING_WORLD * n_layers * RING_TRAIN_STEPS
        want = {**NO_LAUNCHES, "flash_fwd_f32": hops, "flash_bwd_f32": hops}
        if record["fit"]["launches"] != want:
            fail(f"phase 22 (b) rank {record['rank']}: the fit's launches "
                 f"{record['fit']['launches']} (want {want})")
        for name in KERNELS:
            total[name] += record["fit"]["launches"][name]
    return total


def ring_engine(torch, device, tmp: str) -> dict:
    """(c): the slice machine built twice from one seed, at ``flash`` and
    at ``ring_flash`` (179 patches, one rank: one hop), scored W = 16 by
    one ``ServingEngine``; the ring's answer within SERVE_RTOL of the
    flash one's, one forward launch per layer per dispatch."""
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine

    models = {}
    for impl in ("flash", "ring_flash"):
        dest = os.path.join(tmp, f"ring-engine-{impl}")
        build_artifact(dest, device, attention_impl=impl)
        models[impl] = load(dest, device="cpu")
    engine = ServingEngine(models, device=device)
    try:
        if engine.skipped:
            fail(f"phase 22 (c): the engine could not lift {engine.skipped}")
        X = sensor_rows(np.random.default_rng(SEED + 23), LOOKBACK + RING_WINDOWS - 1)
        answers, launches, walls = {}, {}, {}
        for impl in ("flash", "ring_flash"):
            engine.anomaly(impl, X)  # the bucket's first dispatch
            ring_sync(torch, device)
            dispatches = engine.stats()["dispatches"]
            _kernels.reset_launches()
            started = time.perf_counter()
            scored = engine.anomaly(impl, X)
            ring_sync(torch, device)
            walls[impl] = round((time.perf_counter() - started) * 1e3, 3)
            launches[impl] = {name: _kernels.LAUNCHES[name] for name in KERNELS}
            dispatched = engine.stats()["dispatches"] - dispatches
            answers[impl] = {"model-input": scored.model_input,
                             "model-output": scored.model_output,
                             "tag-anomaly-scores": scored.tag_anomaly_scores,
                             "total-anomaly-score": scored.total_anomaly_score}
            want = {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"] * dispatched}
            if dispatched < 1 or launches[impl] != want:
                fail(f"phase 22 (c) {impl}: {dispatched} dispatch(es) launched "
                     f"{launches[impl]} (want {want})")
        worst = compare_arrays("phase 22 (c) ring_flash vs flash", RING_WINDOWS,
                               answers["ring_flash"], answers["flash"], SERVE_RTOL, N_TAGS)
    finally:
        engine.close()
    return {"launches": launches["ring_flash"], "worst": worst, "walls_ms": walls}


def phase_ring(torch, device, tmp: str, card: str) -> dict:
    """Phase 22: ring attention over two gloo ranks on the card (a, b) and
    at one rank in the engine (c); returns the ring's launches."""
    ring_dir = os.path.join(tmp, "ring")
    os.makedirs(ring_dir, exist_ok=True)
    config = ring_config(device)
    with open(os.path.join(ring_dir, RING_CONFIG), "w") as fh:
        json.dump(config, fh)
    started = time.perf_counter()
    records = ring_spawn(ring_dir)
    ranks_s = time.perf_counter() - started
    for record in records:
        print(f"ring [{card}] rank {record['rank']}: join {record['join_s']} s, wall "
              f"{record['wall_s']} s, peak {record['peak_gib']} GiB; hop of "
              f"{record['hop_bytes'] / 2**20:.1f} MiB (K+V) {record['hop_s']} s")
        for label, _, _ in RING_CALLS:
            call = record["calls"][label]
            errors = ", ".join(f"{what} {err:.3g} (limit {atol:.3g})"
                               for what, (err, atol) in call["errors"].items())
            print(f"ring [{card}] rank {record['rank']} {label} {tuple(config['shape'])}: "
                  f"forward {call['forward_s']} s, backward {call['backward_s']} s, "
                  f"launches {call['forward_launches']} / {call['backward_launches']}; "
                  f"max |Δ| {errors}")
        fit = record["fit"]
        print(f"ring [{card}] rank {record['rank']} ring_flash fit ({config['train_windows']} "
              f"windows, {RING_TRAIN_STEPS} Adam steps, lookback {config['lookback']}): "
              f"{fit['wall_s']} s, peak {fit['peak_gib']} GiB, losses {fit['history']}")
    launches = ring_launch_checks(records, SLICE["n_layers"])
    for label, _, _ in RING_CALLS:
        digests = {record["calls"][label]["digest"] for record in records}
        if len(digests) != 1:
            fail(f"phase 22 (a) {label}: the ranks returned different outputs")
        for record in records:
            for what, (err, atol) in record["calls"][label]["errors"].items():
                if not err <= atol:
                    fail(f"phase 22 (a) rank {record['rank']} {label}: {what} differs by "
                         f"{err:.3g} (limit {atol:.3g})")
    histories = [record["fit"]["history"] for record in records]
    if any(h != histories[0] for h in histories):
        fail(f"phase 22 (b): the ranks' loss histories differ: {histories}")
    flash_fit = ring_fit(torch, device, config, "flash")
    ring_h, flash_h = np.asarray(histories[0]), np.asarray(flash_fit["history"])
    if ring_h.shape != (RING_TRAIN_STEPS,) or not np.isfinite(ring_h).all():
        fail(f"phase 22 (b): loss history {ring_h.tolist()}")
    loss_rel = float(np.max(np.abs(ring_h - flash_h) / np.abs(flash_h)))
    if not loss_rel <= TRAIN_RTOL:
        fail(f"phase 22 (b): ring_flash losses {ring_h.tolist()} vs one-process flash "
             f"{flash_h.tolist()}: {loss_rel:.3g} relative (limit {TRAIN_RTOL})")
    engine = ring_engine(torch, device, tmp)
    for name in KERNELS:
        launches[name] += engine["launches"][name]
    print(f"ring [{card}]: ranks {ranks_s:.1f} s; one-process flash fit {flash_fit['wall_s']} "
          f"s, losses {flash_fit['history']} (ring vs flash {loss_rel:.3g} relative); engine "
          f"at one rank: ring_flash vs flash {engine['worst']:.3g} relative, W = "
          f"{RING_WINDOWS} walls {engine['walls_ms']} ms, launches {engine['launches']}")
    return launches


# phases 11, 13, 14, 15, 17 and 21 run in a second process of this script
# (``--side TMP``) beside phases 3-9b, 23, 12 and 16 (18 beside it) in this one.
# They share the temporary directory (each phase keeps to subdirectories of
# its own; phases 20 and 21 read phase 14's artifacts later, 21 phase 15's
# too) and none of them
# depends on another's state in the process. The side holds none of the
# phases that fill most of the card (8, 9b and 12's builds stay here), and
# phases 10 and 19, which need about all of it, run after both.
DN_WINDOWS = 16  # windows of the flagged answers: BH 8192, the slice shape phase 2 holds
DN_BATCH = 32  # windows of the flagged Adam step: BH 16384, phase 8's step
DN_SERVER_S = 240.0  # the flagged run-server's boot, at most
DN_CLEAN, DN_NAN = "dn-slice", "dn-slice-nan"  # sorted: the boot warms the clean machine
DN_DEVICE_ARGS = ()  # the card; a CPU rehearsal passes ("--device", "cpu")


def dn_nan_weight(est) -> str:
    """One NaN in the slice machine's patch embedding (``Dense_0``'s first
    kernel entry, in the flax tree its artifact holds), its module rebuilt
    from it; returns the weight's name."""
    params = dict(est.params_)
    kernel = np.array(params["Dense_0"]["kernel"], np.float32)
    kernel.flat[0] = np.nan
    params["Dense_0"] = {**params["Dense_0"], "kernel": kernel}
    est.set_state({**est.get_state(), "params": params})
    return "Dense_0.kernel[0, 0]"


def dn_server(tmp: str, models_dir: str) -> tuple:
    """``run-server`` over ``models_dir`` as a process (CLI_RUNNER records
    its launches) with ``GORDO_DEBUG_NANS=1`` in its environment, as a
    fleet tier's worker gets it; (process, record, log path)."""
    root = os.path.dirname(os.path.abspath(__file__))
    record = os.path.join(tmp, "dn-server.json")
    log_path = os.path.join(tmp, "dn-server.log")
    env = {**os.environ, "GORDO_DEBUG_NANS": "1", "PYTHONPATH": root}
    with open(log_path, "wb") as log:
        proc = subprocess.Popen([sys.executable, "-c", CLI_RUNNER, record, "run-server",
                                 "--models-dir", models_dir, "--host", "127.0.0.1", "--port", "0",
                                 *DN_DEVICE_ARGS], cwd=root, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
    return proc, record, log_path


def dn_raises(label: str, fn) -> str:
    """``fn()`` must raise ``FloatingPointError`` naming the op; returns
    the message."""
    try:
        fn()
    except FloatingPointError as exc:
        message = str(exc)
        if "invalid value (nan) encountered in " not in message:
            fail(f"debug nans: {label} raised {message!r}, which names no op")
        print(f"debug nans: {label} raised FloatingPointError: {message}")
        return message
    fail(f"debug nans: {label} raised nothing under the flag")


def dn_step(torch, est, rows, flagged: bool) -> tuple:
    """One Adam step of batch ``DN_BATCH`` (the library's batch step) from
    copies of the estimator's parameters, under the sanitizer when
    ``flagged``; (parameters after the step as host bytes, loss, wall s)."""
    from gordo_components_tpu_torch.models import train
    from gordo_components_tpu_torch.ops import windowing
    from gordo_components_tpu_torch.utils import backend

    device = est.device
    spec = est._make_spec(est.n_features_, est.n_features_out_)
    module = est.module_
    params = {k: v.detach().clone().requires_grad_() for k, v in module.named_parameters()}
    x_rows = torch.as_tensor(rows, device=device)
    starts = torch.arange(DN_BATCH, device=device)
    y = x_rows[LOOKBACK - 1:LOOKBACK - 1 + DN_BATCH]
    w = torch.ones(DN_BATCH, device=device)

    def apply(p, s, g):
        return torch.func.functional_call(
            module, p, (windowing.gather_windows(x_rows, s, LOOKBACK),), {"generator": g})

    step = train.make_batch_step(apply, spec.optimizer, loss=spec.loss)
    state = spec.optimizer.init(list(params.values()))
    backend.set_debug_nans(flagged)
    try:
        torch.cuda.synchronize()
        started = time.perf_counter()
        with backend.nan_guard():
            _, loss, _ = step(params, state, (starts, y, w, None))
        torch.cuda.synchronize()
        wall = time.perf_counter() - started
    finally:
        backend.set_debug_nans(False)
    return [p.detach().cpu().numpy().tobytes() for p in params.values()], float(loss), wall


def dn_backward_thread(torch, device) -> dict:
    """``sqrt(square(x @ v))`` with ``v = 0`` is 0 forward and NaN in its
    backward (``g / 0`` through the sqrt, then ``inf * 0``). Autograd runs a
    CUDA backward on its device thread: a hook there records the thread
    and whether the sanitizer is on it, and the NaN must raise."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    from gordo_components_tpu_torch.utils import backend

    x = torch.randn(8, 3, device=device)
    w = torch.randn(3, 3, device=device, requires_grad=True)
    v = torch.zeros(3, 1, device=device, requires_grad=True)
    seen = []
    backend.set_debug_nans(True)
    try:
        with backend.nan_guard():
            root = torch.sqrt(torch.square(x @ v))
            root.register_hook(lambda grad: seen.append((
                threading.get_ident(), any(isinstance(mode, backend.NanSanitizer)
                                           for mode in _get_current_dispatch_mode_stack()))))
            loss = (x @ w + root).square().sum()
            message = dn_raises("a NaN born in a CUDA backward",
                                lambda: torch.autograd.grad(loss, [w, v]))
    finally:
        backend.set_debug_nans(False)
    if not seen or seen[0][0] == threading.get_ident() or not seen[0][1]:
        fail(f"debug nans: the backward's hook ran on {seen} (this thread "
             f"{threading.get_ident()}): expected autograd's device thread, under the sanitizer")
    return {"message": message, "device_thread": seen[0][0] != threading.get_ident()}


def dn_inf_in_q(torch, device) -> None:
    """One ``inf`` in q and no NaN in the inputs: under the flag the kernel's
    operator raises naming ``gordo::flash_fwd``; without it, the kernel's
    output marks NaN the rows its plain version marks."""
    from gordo_components_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_reference
    from gordo_components_tpu_torch.utils import backend

    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(64, SLICE_SHAPE[1], SLICE_SHAPE[2], device=device, generator=gen,
                               dtype=dtype) for _ in range(3))
        q[0, 1, 2] = float("inf")
        scale = SLICE_SHAPE[2] ** -0.5
        backend.set_debug_nans(True)
        try:
            with backend.nan_guard():
                message = dn_raises(f"an inf in q ({dtype})", lambda: flash_fwd(q, k, v, scale))
        finally:
            backend.set_debug_nans(False)
        if "gordo::flash_fwd" not in message:
            fail(f"debug nans: an inf in q raised at {message!r}, not at gordo::flash_fwd")
        out, _ = flash_fwd(q, k, v, scale)
        plain, _ = flash_fwd_reference(q, k, v, scale)
        rows, plain_rows = torch.isnan(out).any(-1), torch.isnan(plain).any(-1)
        if not torch.equal(rows, plain_rows) or int(rows.sum()) < 1:
            fail(f"debug nans: the {dtype} kernel marks {int(rows.sum())} rows NaN, its plain "
                 f"version {int(plain_rows.sum())}, at other rows")
        print(f"debug nans: an inf in q ({dtype}): {int(rows.sum())} NaN row(s), the kernel's "
              f"and the plain version's the same")


def dn_units(torch, device, f32: str, bf16: str, X: np.ndarray, rng) -> tuple:
    """The clean machine under the flag gives the unflagged bytes through
    the kernels: a W = 16 fp32 answer, a bf16 one and one fp32 Adam step of
    batch ``DN_BATCH``, each run unflagged (a warm-up, then timed) and
    flagged; (walls by (unit, flagged), the flagged runs' launches)."""
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.utils import backend

    walls, launches = {}, dict(NO_LAUNCHES)
    for label, path in (("W=16 fp32 answer", f32), ("W=16 bf16 answer", bf16)):
        engine = ServingEngine({"m": load(path, device=device)}, device=device)
        try:
            answers = {}
            for flagged in (False, False, True):
                backend.set_debug_nans(flagged)
                try:
                    _kernels.reset_launches()
                    torch.cuda.synchronize()
                    started = time.perf_counter()
                    result = engine.anomaly("m", X)
                    walls[(label, flagged)] = time.perf_counter() - started
                    counted = {n: _kernels.LAUNCHES[n] for n in KERNELS}
                finally:
                    backend.set_debug_nans(False)
                answers[flagged] = [np.asarray(a).tobytes() for a in result]
        finally:
            engine.close()
        dtype = "bf16" if "bf16" in label else "f32"
        if counted != {**NO_LAUNCHES, f"flash_fwd_{dtype}": SLICE["n_layers"]}:
            fail(f"debug nans: the flagged {label} launched {counted}, expected "
                 f"{SLICE['n_layers']} flash_fwd_{dtype} launches")
        if answers[True] != answers[False]:
            fail(f"debug nans: the flagged {label} differs from the unflagged bytes")
        for name in KERNELS:
            launches[name] += counted[name]
    est = load(f32, device=device).base_estimator.regressor.steps[-1][1]
    rows = sensor_rows(rng, LOOKBACK + DN_BATCH - 1)
    dn_step(torch, est, rows, flagged=False)
    plain_params, plain_loss, walls[("fp32 Adam step", False)] = dn_step(
        torch, est, rows, flagged=False)
    _kernels.reset_launches()
    params, loss, walls[("fp32 Adam step", True)] = dn_step(torch, est, rows, flagged=True)
    counted = {n: _kernels.LAUNCHES[n] for n in KERNELS}
    if counted != {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"],
                   "flash_bwd_f32": SLICE["n_layers"]}:
        fail(f"debug nans: the flagged Adam step launched {counted}")
    if params != plain_params or loss != plain_loss:
        fail(f"debug nans: the flagged Adam step (loss {loss}) differs from the unflagged bytes "
             f"(loss {plain_loss})")
    for name in KERNELS:
        launches[name] += counted[name]
    return walls, launches


def dn_ask_server(proc, log_path: str, X: np.ndarray, started: float, card: str) -> None:
    """The flagged server answers the clean machine 200 and the NaN one 503
    (quarantined: FloatingPointError), as the CPU test holds."""
    base = None
    while base is None and time.perf_counter() - started < DN_SERVER_S:
        if proc.poll() is not None:
            break
        time.sleep(0.2)
        base = served_url(log_path)
    if base is None:
        with open(log_path, "rb") as fh:
            fail(f"debug nans: the flagged server did not come up: "
                 f"{fh.read()[-3000:].decode(errors='replace')}")
    ready_s = time.perf_counter() - started
    answers = {name: post(f"{base}/gordo/v0/project/{name}/anomaly/prediction", X)
               for name in (DN_NAN, DN_CLEAN)}
    if answers[DN_CLEAN][0] != 200 or answers[DN_NAN][0] != 503 or \
            "FloatingPointError: invalid value (nan)" not in json.dumps(answers[DN_NAN][1]):
        fail(f"debug nans: the flagged server answered {answers[DN_CLEAN][0]} for the clean "
             f"machine and {answers[DN_NAN][0]} {answers[DN_NAN][1]} for the NaN one; the "
             "CPU test holds 200 and 503 (quarantined: FloatingPointError)")
    print(f"debug nans [{card}]: run-server with GORDO_DEBUG_NANS=1 ready {ready_s:.1f} s after "
          f"its start; the clean machine 200 in {answers[DN_CLEAN][2]:.1f} ms, the NaN one 503: "
          f"{answers[DN_NAN][1]}")


def phase_debug_nans(torch, device, tmp: str, card: str) -> dict:
    """Phase 23: the numeric sanitizer (``--debug-nans``) on the card,
    through the flash kernels; returns the launches of its flagged units
    and of its flagged server."""
    from gordo_components_tpu_torch.serializer import dump, load
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.utils import backend

    root = os.path.join(tmp, "debug-nans")
    os.makedirs(root)
    f32, bf16 = (os.path.join(tmp, name) for name in ("turbine-long-window",
                                                      "turbine-long-window-bf16"))
    os.symlink(f32, os.path.join(root, DN_CLEAN))
    nan_model = load(f32, device=device)
    nan_est = nan_model.base_estimator.regressor.steps[-1][1]
    poisoned = dn_nan_weight(nan_est)
    dump(nan_model, os.path.join(root, DN_NAN),
         metadata=artifact_metadata([f"TAG-{i:03d}" for i in range(N_TAGS)]))
    # the server boots (a process's first flash launch among it) beside the
    # checks and the timed units
    server_started = time.perf_counter()
    proc, record, log_path = dn_server(tmp, root)
    try:
        # a first flagged op pays the dispatch mode's one-time import
        backend.set_debug_nans(True)
        with backend.nan_guard():
            torch.ones(1, device=device).add(1)
        backend.set_debug_nans(False)
        rng = np.random.default_rng(SEED + 23)
        X = sensor_rows(rng, LOOKBACK + DN_WINDOWS - 1)

        # the NaN machine: scoring and a fit step raise, naming the op
        nan_engine = ServingEngine({"nan": nan_model}, device=device)
        backend.set_debug_nans(True)
        try:
            scoring = dn_raises("scoring the NaN machine", lambda: nan_engine.anomaly("nan", X))
        finally:
            backend.set_debug_nans(False)
            nan_engine.close()
        scaled = nan_model.base_estimator.regressor.steps[0][1].transform(
            sensor_rows(rng, LOOKBACK + DN_BATCH - 1))
        fitting = dn_raises("a fit step of the NaN machine",
                            lambda: dn_step(torch, nan_est, scaled, flagged=True))
        del nan_model, nan_est
        backward = dn_backward_thread(torch, device)
        dn_inf_in_q(torch, device)
        walls, launches = dn_units(torch, device, f32, bf16, X, rng)
        dn_ask_server(proc, log_path, X, server_started, card)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    with open(record) as fh:
        served = json.load(fh)["launches"]
    for name in KERNELS:
        launches[name] += served[name]
    print(f"debug nans [{card}]: flagged units give the unflagged bytes; walls in ms, "
          f"unflagged -> flagged: " + json.dumps({
              label: [round(1e3 * walls[(label, False)], 3), round(1e3 * walls[(label, True)], 3)]
              for label in ("W=16 fp32 answer", "W=16 bf16 answer", "fp32 Adam step")}))
    print(f"debug nans [{card}]: NaN weight {poisoned}: scoring raised {scoring!r}, the fit step "
          f"{fitting!r}; the backward's NaN on autograd's device thread: "
          f"{backward['message']!r}; launches of the flagged units and the server {launches}")
    return launches


SIDE_PHASES = ("11 seams", "13 control", "14 tier", "15 spill", "17 warm boot", "21 shard")
SIDE_IN, SIDE_OUT, SIDE_STDOUT = "side-in.json", "side-out.json", "side-stdout.txt"
SIDE_FAILED = "side-failed.txt"  # the side's failing phase and why, for the main's message
SIDE_STOP_S = 30.0  # a stopped side's phases clean up their servers in this
# every thread's stack goes to stderr this long after the start, in both
# processes: where a run outlives its limit (1200 s), the stack shows where
DUMP_STACKS_S = 1140.0
CARD_POLL_S = 0.25  # the card-wide memory sampler's period


class CardMemory:
    """Samples the card's memory in use (``cudaMemGetInfo``: every process
    on the card, this one and the side's and their servers) every
    ``CARD_POLL_S`` in a daemon thread; ``peak(t0, t1)`` is the most in use
    between two ``time.time()`` stamps, in GiB."""

    def __init__(self, torch):
        self._torch, self._samples, self._stop = torch, [], threading.Event()
        self._thread = threading.Thread(target=self._run, name="card-memory", daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(CARD_POLL_S):
            free, total = self._torch.cuda.mem_get_info()
            self._samples.append((time.time(), total - free))

    def peak(self, t0: float, t1: float) -> float:
        used = [u for t, u in list(self._samples) if t0 <= t <= t1]
        return round(max(used) / 2**30, 2) if used else 0.0

    def close(self):
        self._stop.set()
        self._thread.join()


def memory_in_use(torch) -> str:
    """The card's memory in use (every process on it) once this process
    holds a context, and the host's available memory, for a phase's start
    line."""
    parts = []
    if torch.cuda.is_initialized():
        free, total = torch.cuda.mem_get_info()
        parts.append(f"the card's memory {(total - free) / 2**30:.1f} of "
                     f"{total / 2**30:.1f} GiB in use")
    try:
        with open("/proc/meminfo") as fh:
            info = dict(line.split(":", 1) for line in fh)
        parts.append(f"{int(info['MemAvailable'].split()[0]) / 2**20:.1f} GiB of the host's "
                     f"memory available")
    except (OSError, KeyError, ValueError):
        pass
    return ", ".join(parts)


def release_cached(torch) -> None:
    """After a phase: what its engines cached goes back to the card, where
    the other process's phases and the next phase's servers need it."""
    gc.collect()
    torch.cuda.empty_cache()


def side_main(tmp: str) -> None:
    """The side process: ``SIDE_PHASES`` one after another, with the card's
    name and phase 2's record from ``SIDE_IN``; writes each phase's launches,
    wall and span (``time.time()``) to ``SIDE_OUT``. Its stdout is a file the
    main process prints after it; its stderr is the main process's."""
    import faulthandler
    import signal

    faulthandler.dump_traceback_later(DUMP_STACKS_S, exit=False)
    faulthandler.enable()  # a fatal signal prints every thread's stack
    # each line reaches the file as printed: a side that dies leaves its tail
    sys.stdout.reconfigure(line_buffering=True)
    # a SIGTERM from the main process runs every phase's clean-up
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    import torch

    from gordo_components_tpu_torch.utils.backend import resolve_device

    with open(os.path.join(tmp, SIDE_IN)) as fh:
        given = json.load(fh)
    # phase 2's record through JSON: phase 11 reads its slice-shape times
    # (``shape_ms``'s keys are strings here)
    kernels = given["kernels"]
    device = resolve_device(None)
    card = given["card"]
    phases = {"11 seams": (phase_seams, (torch, device, tmp, kernels, card)),
              "13 control": (phase_control, (torch, device, tmp, card)),
              "14 tier": (phase_tier, (torch, device, tmp, card)),
              "15 spill": (phase_spill, (torch, device, tmp, card)),
              "17 warm boot": (phase_warm_boot, (torch, device, tmp, card)),
              "21 shard": (phase_shard, (torch, device, tmp, card))}
    out = {"launches": {}, "walls": {}, "spans": {}}
    for label in SIDE_PHASES:
        phase, args = phases[label]
        print(f"chip_smoke: side phase {label} started ({memory_in_use(torch)})",
              file=sys.stderr, flush=True)
        started, stamp = time.perf_counter(), time.time()
        try:
            out["launches"][label] = phase(*args)
        except BaseException as exc:
            # the main process ends its own message with this: the stderr
            # the side shares with it may have scrolled past the cause
            import traceback

            reason = (FAILED_WITH[-1] if isinstance(exc, SystemExit) and FAILED_WITH
                      else "".join(traceback.format_exception(exc))[-2000:])
            with open(os.path.join(tmp, SIDE_FAILED), "w") as fh:
                fh.write(f"side phase {label}: {reason}")
            raise
        release_cached(torch)
        out["walls"][label] = round(time.perf_counter() - started, 1)
        out["spans"][label] = (stamp, time.time())
        print(f"phase wall {label} (side): {out['walls'][label]:.1f} s", flush=True)
    with open(os.path.join(tmp, SIDE_OUT), "w") as fh:
        json.dump(out, fh)


def side_start(tmp: str, card: str, kernels: dict) -> subprocess.Popen:
    """Start the side process in a session of its own (its servers with it)."""
    with open(os.path.join(tmp, SIDE_IN), "w") as fh:
        json.dump({"card": card, "kernels": kernels}, fh, default=float)
    stdout = open(os.path.join(tmp, SIDE_STDOUT), "wb")
    try:
        return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--side", tmp],
                                cwd=os.path.dirname(os.path.abspath(__file__)),
                                stdout=stdout, start_new_session=True)
    finally:
        stdout.close()


def side_tail(tmp: str, n: int = 3000) -> str:
    with open(os.path.join(tmp, SIDE_STDOUT), "rb") as fh:
        return fh.read()[-n:].decode(errors="replace")


def side_check(side: subprocess.Popen, tmp: str) -> None:
    """Fail now if the side process has already failed; the message ends
    with the side's failing phase and its reason."""
    if side.poll() not in (None, 0):
        try:
            with open(os.path.join(tmp, SIDE_FAILED)) as fh:
                reason = fh.read()
        except OSError:
            reason = "no phase reported a failure (killed by a signal?)"
        fail(f"the side process's stdout ends: {side_tail(tmp)}\n"
             f"chip_smoke: the side process (phases {', '.join(SIDE_PHASES)}) exited "
             f"{side.returncode}: {reason}")


def side_join(side: subprocess.Popen, tmp: str) -> dict:
    """Wait for the side, print its stdout, return what it wrote."""
    side.wait()
    side_check(side, tmp)
    with open(os.path.join(tmp, SIDE_STDOUT), "rb") as fh:
        sys.stdout.write(fh.read().decode(errors="replace"))
    with open(os.path.join(tmp, SIDE_OUT)) as fh:
        return json.load(fh)


def side_stop(side: subprocess.Popen) -> None:
    """Stop the side and whatever of its session is left: SIGTERM (its
    phases' clean-up runs), then SIGKILL."""
    import signal

    if side.poll() is None:
        try:
            os.killpg(side.pid, signal.SIGTERM)
            side.wait(timeout=SIDE_STOP_S)
        except (ProcessLookupError, subprocess.TimeoutExpired):
            pass
    try:
        os.killpg(side.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    side.wait()


def main() -> None:
    import faulthandler

    faulthandler.dump_traceback_later(DUMP_STACKS_S, exit=False)
    faulthandler.enable()  # a fatal signal prints every thread's stack
    # this process's allocator gives back what it no longer uses: phase 19's
    # builds need the card but for a few GiB, and a fixed segment that keeps
    # one small live block would hold its whole size
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available; this script measures the card")
    try:
        from gordo_components_tpu_torch.utils.backend import resolve_device
    except ImportError as exc:
        fail(f"run from the root of a checkout: {exc}")
    device = resolve_device(None)
    # the other phases run as they did before the store: phase 17 measures
    # it (the side process inherits this)
    os.environ.update(WB_OFF)
    script_started = time.perf_counter()
    walls, spans = {}, {}
    side = None

    def timed(label, phase, *args):
        if side is not None:
            side_check(side, tmp)
        print(f"chip_smoke: phase {label} started ({memory_in_use(torch)})", file=sys.stderr,
              flush=True)
        started, stamp = time.perf_counter(), time.time()
        result = phase(*args)
        release_cached(torch)
        walls[label] = round(time.perf_counter() - started, 1)
        spans[label] = (stamp, time.time())
        print(f"phase wall {label}: {walls[label]:.1f} s")
        return result

    card = timed("1 environment", phase_environment)
    kernels = timed("2 kernels", phase_kernels, torch, device)
    memory = CardMemory(torch)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        side = side_start(tmp, card, kernels)
        try:
            launches = timed("3 serve", phase_serve, torch, device, tmp)
            launches["flash_fwd_bf16"] = timed("3b serve bf16", phase_serve_bf16, torch, device,
                                               tmp)["flash_fwd_bf16"]
            timed("4 zoo", phase_zoo, torch, device, tmp)
            launches["flash_fwd_f32"] += timed("5 fleet", phase_fleet, torch, device,
                                               tmp)["flash_fwd_f32"]
            launches["flash_fwd_f32"] += timed("6 int8", phase_int8, torch, device,
                                               tmp)["flash_fwd_f32"]
            timed("7 surface", phase_surface, torch, device, tmp)
            trained = timed("8 train", phase_train, torch, device, tmp)["launches"]
            trained_bf16 = timed("8b train bf16", phase_train_bf16, torch, device)
            debug_nans = timed("23 debug nans", phase_debug_nans, torch, device, tmp, card)
            timed("9 build", phase_build, torch, device, tmp)
            built = timed("9b cli build", phase_cli_build, torch, device, tmp)
            client = timed("12 client", phase_client, torch, device, tmp, kernels, card)
            witness_run = {}

            def witness_beside_fleet_control():
                # phase 18 in a thread beside phase 16, once its fleet is up:
                # fail() raises SystemExit here, which is read below as a
                # missing result
                started, stamp = time.perf_counter(), time.time()
                try:
                    witness_run["launches"] = phase_lock_witness(torch, device, tmp, card)
                except SystemExit:
                    pass
                label = "18 lint and lock witness (beside 16)"
                walls[label] = round(time.perf_counter() - started, 1)
                spans[label] = (stamp, time.time())
                print(f"phase wall {label}: {walls[label]:.1f} s")

            fleet_control = timed("16 fleet control", phase_fleet_control, torch, device, tmp,
                                  card, witness_beside_fleet_control)
            if "launches" not in witness_run:
                fail("phase 18 (lint and lock witness) failed")
            witness = witness_run["launches"]
            concurrent_s = time.perf_counter() - script_started
            sided = side_join(side, tmp)
            joined_s = time.perf_counter() - script_started
            walls.update({f"{label} (side)": wall for label, wall in sided["walls"].items()})
            spans.update({f"{label} (side)": tuple(span) for label, span in
                          sided["spans"].items()})
            print(f"side process [{card}]: phases {', '.join(SIDE_PHASES)} beside this "
                  f"process's 3-9b, 23, 12 and 16; this process's were done at "
                  f"{concurrent_s:.1f} s of the script, the side's joined at {joined_s:.1f} s")
            ring = timed("22 ring", phase_ring, torch, device, tmp, card)
            fleet_built = timed("10 fleet build", phase_fleet_build, torch, device, tmp)
            mesh_run = {}

            def mesh_beside_the_drill():
                # phase 20 in a thread beside phase 19's wedge drill: fail()
                # raises SystemExit here, which is read below as a missing
                # result
                started, stamp = time.perf_counter(), time.time()
                try:
                    mesh_run["launches"] = phase_mesh(torch, device, tmp, card)
                except SystemExit:
                    pass
                label = "20 mesh (beside 19's wedge drill)"
                walls[label] = round(time.perf_counter() - started, 1)
                spans[label] = (stamp, time.time())
                print(f"phase wall {label}: {walls[label]:.1f} s")

            multirank = timed("19 multi-rank fleet build", phase_multirank, torch, device, tmp,
                              card, mesh_beside_the_drill)
            if "launches" not in mesh_run:
                fail("phase 20 (the mesh) failed")
            mesh = mesh_run["launches"]
        finally:
            side_stop(side)
            memory.close()
        side_launches = sided["launches"]
        for name in KERNELS:
            launches[name] += (trained[name] + trained_bf16[name] + built[name]
                               + fleet_built[name] + client[name] + fleet_control[name]
                               + witness[name] + multirank[name] + mesh[name] + ring[name]
                               + debug_nans[name]
                               + sum(side_launches[label][name] for label in SIDE_PHASES))
    print(f"card memory in use [{card}], peak GiB during each phase (every process on the "
          f"card): {json.dumps({label: memory.peak(*span) for label, span in spans.items()})}")
    print(f"script wall [{card}]: {time.perf_counter() - script_started:.1f} s; phase walls "
          f"{json.dumps(walls)}")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": REPLACES[name],
        "launches": launches[name],
        **{key: kernels[name][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library")},
    } for name, (_, source) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--side"]:
        side_main(sys.argv[2])
    elif sys.argv[1:2] == ["--ring-rank"]:
        ring_rank_main(int(sys.argv[2]), sys.argv[3])
    else:
        main()
