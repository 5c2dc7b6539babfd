"""``python -m gordo_components_tpu_torch.server [run-server flags]``: the
CLI's ``run-server`` (``python -m gordo_components_tpu_torch.cli run-server
--help`` lists the flags)."""

import sys

from ..cli.cli import main

sys.exit(main(["run-server", *sys.argv[1:]]))
