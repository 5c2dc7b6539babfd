"""Fleet-config normalization of the port (copy of
``gordo_components_tpu/workflow/config_elements.py``); the reference's
Argo workflow generator is not ported."""

from .config_elements import Machine, NormalizedConfig  # noqa: F401
