#!/usr/bin/env python3
"""Run ``chip_smoke.py`` phase 11 alone with many profiles of its fused
dispatch, to see how often ``torch.profiler`` loses a kernel's record.

    python3 tools/torch_profile_probe.py [PROFILES]

Builds the flash libraries and runs phase 11 (``chip_smoke.phase_seams``)
in the environment the smoke's main process gives its side process, while
a second process keeps the card busy with GEMMs (in the smoke the main
process works beside phase 11). The phase profiles its fused dispatch of
both PatchTST machines ``PROFILES`` times (default 20) with the recorder on
and as often off, and its line ``seams: fused PatchTST dispatch ...`` names
every profile that lost a record. A failed phase exits 1.
"""

import os
import subprocess
import sys
import tempfile

FLASH_MS = 2.2  # phase 2's flash_fwd_f32 ms at the slice shape (the timelines' floor)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOAD = """
import time, torch
a = torch.randn(8192, 8192, device="cuda")
while True:
    for _ in range(20):
        a = (a @ a).clamp_(-1, 1)
    torch.cuda.synchronize()
    time.sleep(0.005)
"""


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    smoke.SEAMS_PROFILES = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    # the side process's environment, which it inherits from the smoke's main
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    os.environ.update(smoke.WB_OFF)
    import torch

    from gordo_components_tpu_torch.ops import _kernels

    print(f"kernels built in {_kernels.build_all():.1f} s", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    load = subprocess.Popen([sys.executable, "-c", LOAD])
    try:
        with tempfile.TemporaryDirectory() as tmp:
            smoke.phase_seams(torch, torch.device("cuda"), tmp,
                              {"flash_fwd_f32": {"ms": FLASH_MS}}, card)
    finally:
        load.kill()
        load.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
