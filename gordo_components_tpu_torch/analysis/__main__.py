"""``python -m gordo_components_tpu_torch.analysis`` — the port's lint
entry point (the CLI's ``lint`` verb delegates here too)."""

import sys

from .runner import main

if __name__ == "__main__":
    sys.exit(main())
