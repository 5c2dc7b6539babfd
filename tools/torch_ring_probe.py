#!/usr/bin/env python3
"""Split a rank's first ring call into its steps, on the card.

    python3 tools/torch_ring_probe.py            # two gloo ranks on one card

Builds the flash libraries (``_kernels.build_all``), then starts two ranks
of itself (``--rank R TMP``; ``file://`` rendezvous in a temporary
directory). Each rank times, the card synchronised at every mark: the
imports, the group's join, the first CUDA tensor, two host copies of a
90-patch block of ``chip_smoke.py`` phase 22's shape, a small collective,
two K/V hops alone, the first and second flash forward launch, then two
``ring_flash`` calls and their backward (Σout²). Prints one JSON line per
rank: ``{"rank", "marks": [[step, seconds since the start], ...]}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (1024, 180, 8, 64)  # phase 22 (a): W = 16 x 64 tags, 180 patches, 8 heads
WORLD = 2
TIMEOUT_S = 300


def rank_main(rank: int, tmp: str) -> None:
    started = time.perf_counter()
    marks = []

    def mark(step):
        import torch

        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        marks.append((step, round(time.perf_counter() - started, 3)))

    from datetime import timedelta

    import torch
    import torch.distributed as dist

    mark("import torch")
    from gordo_components_tpu_torch.ops.attention import _Rotation, ring_attention
    from gordo_components_tpu_torch.ops.flash_attention import flash_block_with_lse

    mark("import the port")
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                            rank=rank, world_size=WORLD, timeout=timedelta(seconds=TIMEOUT_S))
    group = dist.group.WORLD
    mark("join the group")
    x = torch.randn(SHAPE, device="cuda")
    mark("first CUDA tensor")
    block = x[:, : SHAPE[1] // WORLD].contiguous()
    for i in range(2):
        block.to("cpu")
        mark(f"host copy {i}")
    dist.all_reduce(torch.ones(4))
    mark("small collective")
    for i in range(2):
        _Rotation(group, [block, block]).wait()
        mark(f"K/V hop {i}")
    q3 = block.movedim(-2, -3).reshape(-1, block.shape[1], SHAPE[-1]).contiguous()
    for i in range(2):
        flash_block_with_lse(q3, q3, q3, SHAPE[-1] ** -0.5)
        mark(f"flash launch {i}")
    for i in range(2):
        q = x.clone().requires_grad_()
        out = ring_attention(q, q, q, group=group, block_impl="flash")
        mark(f"ring_flash forward {i}")
        torch.autograd.grad((out ** 2).sum(), q)
        mark(f"ring_flash backward {i}")
    print(json.dumps({"rank": rank, "marks": marks}), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    sys.path.insert(0, ROOT)
    from gordo_components_tpu_torch.ops import _kernels

    print(f"kernels built in {_kernels.build_all():.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank",
                                   str(rank), tmp], env={**os.environ, "PYTHONPATH": ROOT})
                 for rank in range(WORLD)]
        try:
            codes = [proc.wait(timeout=TIMEOUT_S) for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return 0 if codes == [0] * WORLD else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.path.insert(0, ROOT)
        rank_main(int(sys.argv[2]), sys.argv[3])
    else:
        sys.exit(main())
