#!/usr/bin/env python3
"""Time the port's flash-forward kernels at the slice shape, design against
design, on one CUDA card.

    python3 tools/flash_kernel_sweep.py [--rounds 2]

- fp32 (``csrc/flash_fwd_f32.cu``): the served tiling (4 x 8 register
  tiles, at most 64 q rows per block) against other q rows per block and
  against 8 x 8 tiles (4 FFMA per float loaded from shared memory, at 254
  registers), up to one block holding all 179 rows of a sequence. Each
  tiling is a library of its own, built from the source with
  ``-DFLASH_F32_ROWS_PER_BLOCK`` and ``-DFLASH_F32_TILE_ROWS`` (the served
  library takes the source's defaults, 64 and 4);
- bf16 (``csrc/flash_fwd_bf16.cu``): the served design (TMA ring, three
  consumer warpgroups, persistent blocks) against its first build-up step
  (one warpgroup, one stage, one bh per block).

Before timing, each source is compiled once more with ``-Xptxas -v`` and
its SASS read with ``cuobjdump -sass``: registers, spills and shared memory
of every instantiation, and the count of tensor-core (HGMMA, HMMA), TMA
(UTMALDG) and fp32 FMA (FFMA) instructions.

Every variant is first held against ``flash_fwd_reference`` (fp32 atol
2e-5, bf16 ``chip_smoke.bf16_atol``), then timed with CUDA events (10
launches after 2 warm-ups) in ``--rounds`` rounds of turns. Prints the
card's name and power limit and one JSON line. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# fp32 tilings, (q rows per block, register tile rows at D <= 64): the
# served library is (64, 4); (256, 8) is one block holding all 179 rows of
# a slice sequence
TILINGS = ((64, 4), (128, 4), (48, 4), (256, 8), (96, 8), (64, 8))
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "FFMA")


def compile_source(_kernels, source: str, lib: str, defines=()) -> list:
    """nvcc with ``-Xptxas -v`` into ``lib``; ptxas's report per entry."""
    ptxas = subprocess.run(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, *defines, "-Xptxas", "-v", "-o", lib,
         os.path.join(_kernels.SRC_DIR, source)],
        capture_output=True, text=True, timeout=600,
    )
    if ptxas.returncode != 0:
        sys.exit(f"nvcc failed for {source} {list(defines)}:\n{ptxas.stderr}")
    entries, current = [], None
    for line in ptxas.stderr.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            current = {"entry": found.group(1)}
            entries.append(current)
        elif current is not None and "spill" in line:
            current["spill"] = line.strip()
        elif current is not None and "registers" in line:
            current["usage"] = line.split(":", 1)[1].strip()
    return entries


def resources(_kernels) -> dict:
    """ptxas's report and SASS instruction counts of every kernel source."""
    report = {}
    for name, source in _kernels.SOURCES.items():
        lib = os.path.join(_kernels.BUILD_DIR, f"resources-{name}.so")
        entries = compile_source(_kernels, source, lib)
        sass = subprocess.run([os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump"),
                               "-sass", lib], capture_output=True, text=True, timeout=600).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}
        os.remove(lib)
        for entry in entries:
            print(f"{source}: {entry['entry']}: {entry.get('usage')}; {entry.get('spill')}")
        print(f"{source}: SASS instructions {counts}")
        for op in SASS_OPS:  # one instance of each, as cuobjdump prints it
            found = re.search(rf"^.*\b{op}\b.*$", sass, re.MULTILINE)
            if found:
                print(f"{source}: first {op}: {' '.join(found.group(0).split()[:-2])}")
        report[name] = {"entries": entries, "sass": counts}
    return report


def build_tilings(_kernels) -> dict:
    """One fp32 library per tiling, all compiled together: (rows, tile rows)
    -> (library path, ptxas's report of its D <= 64 instantiation)."""
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)

    def build(tiling):
        rows, tile = tiling
        lib = os.path.join(_kernels.BUILD_DIR, f"sweep-f32-rows{rows}-tile{tile}.so")
        entries = compile_source(_kernels, _kernels.SOURCES["flash_fwd_f32"], lib, (
            f"-DFLASH_F32_ROWS_PER_BLOCK={rows}", f"-DFLASH_F32_TILE_ROWS={tile}"))
        # the D <= 64 instantiation, flash_fwd_f32_kernel<64, tile>
        [entry] = [e for e in entries if f"ILi64ELi{tile}E" in e["entry"]]
        return lib, entry

    with ThreadPoolExecutor(len(TILINGS)) as pool:
        return dict(zip(TILINGS, pool.map(build, TILINGS)))


def f32_launcher(_kernels, lib_path: str, scale: float):
    """Launch ``gordo_flash_fwd_f32`` of one sweep library on (BH, S, D)
    float32 CUDA tensors."""
    import torch

    entry = ctypes.CDLL(lib_path).gordo_flash_fwd_f32
    _kernels.bind_flash_entry(entry)

    def run(q, k, v):
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
        status = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                       *q.shape, scale, torch.cuda.current_stream(q.device).cuda_stream)
        if status != 0:
            sys.exit(f"{os.path.basename(lib_path)}: launch failed with CUDA error {status}")
        return out, lse

    return run


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()

    import torch

    import chip_smoke
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.ops.flash_attention import flash_fwd_reference
    from gordo_components_tpu_torch.utils.backend import resolve_device

    device = resolve_device(None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    _kernels.build_all()
    report = resources(_kernels)
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
    shape = chip_smoke.SLICE_SHAPE
    scale = shape[-1] ** -0.5

    variants = {}
    for (rows, tile), (lib, entry) in build_tilings(_kernels).items():
        print(f"f32 {tile}x8 tiles, rows<={rows}: {entry.get('usage')}; {entry.get('spill')}")
        variants[f"f32 {tile}x8 tiles, rows<={rows}"] = (
            torch.float32, f32_launcher(_kernels, lib, scale))
    variants["bf16 served"] = (torch.bfloat16, lambda q, k, v: _kernels.flash_fwd_cuda(q, k, v, scale))
    variants["bf16 single-stage step"] = (
        torch.bfloat16, lambda q, k, v: _kernels.flash_fwd_bf16_single_stage(q, k, v, scale))

    inputs = {dt: [(0.5 * torch.randn(shape, generator=gen, device=device)).to(dt) for _ in range(3)]
              for dt in (torch.float32, torch.bfloat16)}
    for name, (dt, fn) in variants.items():
        q, k, v = inputs[dt]
        out, lse = fn(q, k, v)
        ref_out, ref_lse = flash_fwd_reference(q, k, v, scale)
        err = (out.float() - ref_out.float()).abs().max().item()
        atol = 2e-5 if dt == torch.float32 else chip_smoke.bf16_atol(ref_out)
        if err > atol or (lse - ref_lse).abs().max().item() > 1e-4:
            sys.exit(f"{name} disagrees with its plain version: max|out-plain| {err}")
    times = {name: [] for name in variants}
    for _ in range(args.rounds):
        for name, (dt, fn) in variants.items():
            q, k, v = inputs[dt]
            times[name].append(chip_smoke.timed_ms(lambda: fn(q, k, v)))
    result = {}
    for name, ms in times.items():
        dt = variants[name][0]
        bound = chip_smoke.attention_bound(*shape, dt)
        mean = sum(ms) / len(ms)
        result[name] = {"ms": ms, "share_of_bound": bound["bound_ms"] / mean}
        print(f"{name}: {' / '.join(f'{t:.4f}' for t in ms)} ms, "
              f"{100 * bound['bound_ms'] / mean:.1f} % of the {bound['bound_ms']:.4f} ms bound")
    print(card)
    print(json.dumps({"card": card, "shape": shape, "variants": result,
                      "resources": report}))


if __name__ == "__main__":
    main()
