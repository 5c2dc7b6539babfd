"""Machine-checked invariants of the port: its concurrency and
conventions contracts as analyzers, not prose.

The port's serving system is threaded end to end (the engine's
leader/collector pipeline, the server's admission and reload, the
router's supervisor and rollouts, the control loops), and its
correctness rules are the reference's: lock ordering across the
engine/router/resilience layers, the thread seam rule that spans and
log records must carry an explicit ``SpanContext``, ``gordo_*`` metric
naming and label conventions, and the ``GORDO_*`` env-knob registry.
This package encodes those rules over the port's own tree, so
``python -m gordo_components_tpu_torch.analysis`` (and the CLI's
``lint``) can search it for violations:

- :mod:`.locks` — THE declared lock order (ranks), hot-lock set, and
  guarded fields of the port, shared by the static checker and the
  runtime validator.
- :mod:`.lock_discipline` — static lock-order + blocking-under-hot-lock
  checker (``# lint: allow-blocking(<reason>)`` escape hatches).
- :mod:`.guarded_state` — declared fields touched only under their lock.
- :mod:`.span_seam` — thread handoffs whose far side records spans or
  logs must capture-and-bind ``SpanContext``.
- :mod:`.metrics_conventions` — ``gordo_<component>_<noun>_<unit>``
  name grammar + label allowlist.
- :mod:`.knobs` / :mod:`.knob_registry` — every ``GORDO_*`` env read
  must be declared in the port's knob registry; the README's port knob
  table is generated from it.
- :mod:`.wire_contracts` / :mod:`.fault_coverage` /
  :mod:`.exception_hygiene` — the HTTP surface, fault-seam coverage,
  and broad swallows that leave no evidence.
- :mod:`.lockcheck` — the optional ``GORDO_LOCKCHECK=1`` runtime
  validator: named locks record real acquisition orders and fail on
  any order the declaration forbids. Static analysis proposes, the
  runtime witness confirms.

Everything here is pure stdlib (``ast``): the lint runs in seconds, on
a host with no torch. Keep this ``__init__`` import-free for the same
reason: every module of the port that creates a lock imports
:mod:`.lockcheck` at module scope.
"""
