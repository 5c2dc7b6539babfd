"""Workflow emission: fleet config → deployable manifests (port of
``gordo_components_tpu/workflow/workflow_generator.py``).

:func:`generate_argo_workflow` emits an Argo ``Workflow`` (one builder pod
per machine, bounded ``parallelism``) plus a model-server
Deployment/Service per machine and a watchman Deployment.
:func:`generate_tpu_job` emits ONE fleet-build Job (``fleet-build`` trains
every machine of a bucket in one stacked program) and ONE multi-model
server Deployment; with ``hosts > 1`` an Indexed Job whose pods join one
group of ranks (``fleet-build``'s ``GORDO_COORDINATOR`` /
``GORDO_NUM_PROCESSES`` / ``GORDO_PROCESS_ID``) behind a headless
coordinator Service.

The manifests are the reference's, parsed, but for two things: every
container runs ``python -m gordo_components_tpu_torch.cli``, and the
limits request ``nvidia.com/gpu`` where the reference's request
``google.com/tpu``, with the same counts. ``jinja2`` and ``yaml`` are
imported by the functions that use them (the card's machine may lack
both).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Union

from .config_elements import NormalizedConfig

_ARGO_TEMPLATE = """\
apiVersion: argoproj.io/v1alpha1
kind: Workflow
metadata:
  generateName: {{ project }}-
  labels:
    applications.gordo.equinor.com/project-name: {{ project }}
spec:
  entrypoint: build-fleet
  parallelism: {{ parallelism }}
  templates:
    - name: build-fleet
      dag:
        tasks:
{% for machine in machines %}
          - name: build-{{ machine.name }}
            template: model-builder
            arguments:
              parameters:
                - name: machine-name
                  value: "{{ machine.name }}"
                - name: model-config
                  value: {{ machine.model_json }}
                - name: data-config
                  value: {{ machine.data_json }}
{% endfor %}
    - name: model-builder
      inputs:
        parameters:
          - name: machine-name
          - name: model-config
          - name: data-config
      container:
        image: {{ image }}
        command: [python, -m, gordo_components_tpu_torch.cli]
        args: [build, "{{ '{{inputs.parameters.machine-name}}' }}"]
        env:
          - name: MODEL_CONFIG
            value: "{{ '{{inputs.parameters.model-config}}' }}"
          - name: DATA_CONFIG
            value: "{{ '{{inputs.parameters.data-config}}' }}"
          - name: OUTPUT_DIR
            value: {{ output_dir }}/{{ '{{inputs.parameters.machine-name}}' }}
          - name: MODEL_REGISTER_DIR
            value: {{ register_dir }}
"""

_SERVER_TEMPLATE = """\
apiVersion: apps/v1
kind: Deployment
metadata:
  name: gordo-server-{{ machine }}
  labels: {app: gordo-server, machine: {{ machine }}}
spec:
  replicas: 1
  selector:
    matchLabels: {app: gordo-server, machine: {{ machine }}}
  template:
    metadata:
      labels: {app: gordo-server, machine: {{ machine }}}
    spec:
      containers:
        - name: server
          image: {{ image }}
          command: [python, -m, gordo_components_tpu_torch.cli]
          args: [run-server, --model-dir, {{ output_dir }}/{{ machine }},
                 --port, "5555", --project, {{ project }}]
          readinessProbe:
            httpGet: {path: /healthz, port: 5555}
---
apiVersion: v1
kind: Service
metadata:
  name: gordo-server-{{ machine }}
spec:
  selector: {app: gordo-server, machine: {{ machine }}}
  ports: [{port: 5555}]
"""

_WATCHMAN_TEMPLATE = """\
apiVersion: apps/v1
kind: Deployment
metadata:
  name: gordo-watchman
  labels: {app: gordo-watchman, project: {{ project }}}
spec:
  replicas: 1
  selector:
    matchLabels: {app: gordo-watchman}
  template:
    metadata:
      labels: {app: gordo-watchman}
    spec:
      containers:
        - name: watchman
          image: {{ image }}
          command: [python, -m, gordo_components_tpu_torch.cli]
          args: [run-watchman, --project, {{ project }}, --port, "5556",
{% for machine in machines %}
                 --machine, {{ machine }},
{% endfor %}
                 --target-url, http://gordo-server:5555]
"""

_TPU_JOB_TEMPLATE = """\
{% if hosts > 1 -%}
apiVersion: v1
kind: Service
metadata:
  name: {{ project }}-fleet-coord
  labels: {app: gordo-fleet-builder, project: {{ project }}}
spec:
  # the k8s API's headless marker is the literal STRING "None" (yaml null
  # would mean "unset" and get a ClusterIP allocated, killing the per-pod
  # DNS names the coordinator address depends on)
  clusterIP: "None"
  selector: {app: gordo-fleet-builder, project: {{ project }}}
  ports: [{port: 6000, name: coordinator}]
---
{% endif -%}
apiVersion: batch/v1
kind: Job
metadata:
  name: {{ project }}-fleet-build
  labels: {app: gordo-fleet-builder, project: {{ project }}}
spec:
{% if hosts > 1 %}
  # every wedge/peer-death event costs up to `hosts` pod failures (the
  # victim plus each watchdog-freed survivor), so the budget scales with
  # hosts — and the retryable code 75 is excluded from the count entirely
  # below, or a single event would exhaust a flat limit and permanently
  # fail the Job for exactly the failure mode the watchdog recovers
  backoffLimit: {{ 3 * hosts }}
{% else %}
  backoffLimit: 3
{% endif %}
  # make the exit-code contract real at the Job layer (k8s >= 1.26,
  # requires restartPolicy Never): transient/watchdog exits (75) restart
  # without counting toward backoffLimit; the CLI's permanent config/data/
  # device codes (64/66/70 — 70 is a deterministic device failure such as
  # an out-of-memory on the card) fail the Job immediately instead of
  # burning retries on a build that can never succeed
  podFailurePolicy:
    rules:
      - action: Ignore
        onExitCodes: {containerName: fleet-builder, operator: In, values: [75]}
      - action: FailJob
        onExitCodes: {containerName: fleet-builder, operator: In, values: [64, 66, 70]}
  # global wall-clock bound: because exit 75 is Ignored above, a failure
  # mode that keeps presenting as retryable (e.g. a device error the CLI's
  # permanent-marker list doesn't recognise) could otherwise crash-loop on
  # card quota forever without ever touching backoffLimit
  activeDeadlineSeconds: {{ active_deadline_s }}
{% if hosts > 1 %}
  # one indexed pod per host: every pod runs the SAME fleet-build
  # command, joins the gloo group of ranks at pod 0, and trains/writes
  # only its own machine shard (output/registry dirs must be shared
  # storage). Restart semantics match single-host: the per-machine
  # registry resume makes retries idempotent.
  completionMode: Indexed
  completions: {{ hosts }}
  parallelism: {{ hosts }}
{% endif %}
  template:
    metadata:
      labels: {app: gordo-fleet-builder, project: {{ project }}}
    spec:
      restartPolicy: Never
{% if hosts > 1 %}
      subdomain: {{ project }}-fleet-coord
{% endif %}
      containers:
        - name: fleet-builder
          image: {{ image }}
          command: [python, -m, gordo_components_tpu_torch.cli]
          args: [fleet-build, --machine-config, /config/machines.yaml,
                 --output-dir, {{ output_dir }},
                 --model-register-dir, {{ register_dir }}]
{% if hosts > 1 %}
          env:
            - name: GORDO_NUM_PROCESSES
              value: "{{ hosts }}"
            - name: GORDO_PROCESS_ID
              valueFrom:
                fieldRef:
                  fieldPath: "metadata.annotations['batch.kubernetes.io/job-completion-index']"
            - name: GORDO_COORDINATOR
              value: "{{ project }}-fleet-build-0.{{ project }}-fleet-coord:6000"
            # slice liveness watchdog: a pod wedged in a collective (dead
            # peer the transport can't see) exits the retryable code 75
            # after this budget instead of hanging the Job forever; the
            # backoffLimit restart then resumes from registry + slice
            # checkpoints. Size it above the worst healthy slice wall time.
            - name: GORDO_SLICE_TIMEOUT_S
              value: "{{ slice_timeout_s }}"
{% endif %}
          resources:
            limits: {"nvidia.com/gpu": {{ tpu_chips }}}
---
apiVersion: apps/v1
kind: Deployment
metadata:
  name: {{ project }}-model-server
  labels: {app: gordo-server, project: {{ project }}}
spec:
  replicas: 1
  selector:
    matchLabels: {app: gordo-server, project: {{ project }}}
  template:
    metadata:
      labels: {app: gordo-server, project: {{ project }}}
    spec:
      containers:
        - name: server
          image: {{ image }}
          command: [python, -m, gordo_components_tpu_torch.cli]
          args: [run-server, --models-dir, {{ output_dir }},
                 --port, "5555", --project, {{ project }}]
          resources:
            limits: {"nvidia.com/gpu": 1}
          readinessProbe:
            httpGet: {path: /healthz, port: 5555}
"""


def _templates() -> Dict[str, Any]:
    """The four templates, compiled by a lazily imported ``jinja2``."""
    try:
        from jinja2 import Environment, StrictUndefined
    except ImportError as exc:
        raise ImportError("generating workflows needs the 'jinja2' package, which is not "
                          "installed") from exc
    env = Environment(undefined=StrictUndefined, trim_blocks=True, lstrip_blocks=True)
    return {name: env.from_string(text) for name, text in (
        ("argo", _ARGO_TEMPLATE), ("server", _SERVER_TEMPLATE),
        ("watchman", _WATCHMAN_TEMPLATE), ("tpu_job", _TPU_JOB_TEMPLATE))}


def generate_argo_workflow(
    config: Union[str, Dict[str, Any], NormalizedConfig],
    image: str = "gordo-components-tpu:latest",
    parallelism: int = 10,
    output_dir: str = "/gordo/models",
    register_dir: str = "/gordo/registry",
) -> str:
    """Argo Workflow (a builder pod per machine) + a server
    Deployment/Service per machine + the watchman."""
    if not isinstance(config, NormalizedConfig):
        config = NormalizedConfig(config)
    templates = _templates()
    machines = [
        {
            "name": machine.name,
            "model_json": json.dumps(json.dumps(machine.model)),
            "data_json": json.dumps(json.dumps(machine.dataset)),
        }
        for machine in config.machines
    ]
    documents = [
        templates["argo"].render(
            project=config.project_name,
            machines=machines,
            image=image,
            parallelism=parallelism,
            output_dir=output_dir,
            register_dir=register_dir,
        )
    ]
    for machine in config.machines:
        documents.append(
            templates["server"].render(
                machine=machine.name,
                image=image,
                output_dir=output_dir,
                project=config.project_name,
            )
        )
    documents.append(
        templates["watchman"].render(
            project=config.project_name,
            machines=[machine.name for machine in config.machines],
            image=image,
        )
    )
    return "\n---\n".join(documents)


def generate_tpu_job(
    config: Union[str, Dict[str, Any], NormalizedConfig],
    image: str = "gordo-components-tpu:latest",
    output_dir: str = "/gordo/models",
    register_dir: str = "/gordo/registry",
    tpu_chips: int = 16,
    hosts: int = 1,
    slice_timeout_s: int = 1800,
    active_deadline_s: int = 86400,
) -> str:
    """One fleet-build Job + one multi-model server Deployment for the
    whole fleet; the name and the ``tpu_chips`` keyword are the
    reference's, the count is requested as ``nvidia.com/gpu``.

    ``hosts > 1`` emits the multi-host layout: a headless coordinator
    Service plus an Indexed Job (one pod per host) whose pods derive
    ``GORDO_PROCESS_ID`` from their completion index and join the group of
    ranks at pod 0, the wiring of ``fleet-build --coordinator-address``.
    Those pods also carry ``GORDO_SLICE_TIMEOUT_S`` (``slice_timeout_s``,
    default 30 min): the slice watchdog that turns a wedged collective into
    the retryable exit 75 the Job's backoffLimit can act on."""
    if not isinstance(config, NormalizedConfig):
        config = NormalizedConfig(config)
    if hosts < 1:
        raise ValueError(f"hosts must be >= 1, got {hosts}")
    if active_deadline_s < 1:
        raise ValueError(
            f"active_deadline_s must be >= 1, got {active_deadline_s}: the "
            "deadline is the only bound on retryable (exit 75) crash loops, "
            "which the podFailurePolicy excludes from backoffLimit"
        )
    return _templates()["tpu_job"].render(
        project=config.project_name,
        image=image,
        output_dir=output_dir,
        register_dir=register_dir,
        tpu_chips=tpu_chips,
        hosts=hosts,
        slice_timeout_s=slice_timeout_s,
        active_deadline_s=active_deadline_s,
    )


def validate_generated(manifest: str) -> None:
    """Every emitted document must be parseable YAML with a ``kind``."""
    try:
        import yaml
    except ImportError as exc:
        raise ImportError("validating workflows needs the 'yaml' package (PyYAML), which is "
                          "not installed") from exc
    for document in yaml.safe_load_all(manifest):
        if document is None:
            continue
        if "kind" not in document:
            raise ValueError(f"Document missing 'kind': {document}")
