"""Fleet-config normalization and workflow generation of the port (copies
of ``gordo_components_tpu/workflow/``)."""

from .config_elements import Machine, NormalizedConfig  # noqa: F401
from .workflow_generator import generate_argo_workflow, generate_tpu_job  # noqa: F401
