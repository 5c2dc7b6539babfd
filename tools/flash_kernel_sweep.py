#!/usr/bin/env python3
"""Time the port's flash kernels, design against design, on one CUDA card:
the forward at the slice shape, the backward at the training shape.

    python3 tools/flash_kernel_sweep.py [--rounds 2] [--part all|fwd|bwd]

- fp32 (``csrc/flash_fwd_f32.cu``): the served tiling (4 x 8 register
  tiles, at most 64 q rows per block) against other q rows per block and
  against 8 x 8 tiles (4 FFMA per float loaded from shared memory, at 254
  registers), up to one block holding all 179 rows of a sequence. Each
  tiling is a library of its own, built from the source with
  ``-DFLASH_F32_ROWS_PER_BLOCK`` and ``-DFLASH_F32_TILE_ROWS`` (the served
  library takes the source's defaults, 64 and 4);
- bf16 (``csrc/flash_fwd_bf16.cu``): the served design (TMA ring, three
  consumer warpgroups, persistent blocks) against its first build-up step
  (one warpgroup, one stage, one bh per block);
- the backward, at (16384, 179, 64): fp32 (``csrc/flash_bwd_f32.cu``)
  with 192 q rows resident per block (served: a slice sequence at once)
  against 128 and 64 (``-DFLASH_BWD_F32_ROWS``: the chunked walk, dK and
  dV summed across chunks); bf16 (``csrc/flash_bwd_bf16.cu``) with three
  q-tile stages (served) against two (``-DFLASH_BWD_BF16_QSTAGES``).

Before timing, each source is compiled once more with ``-Xptxas -v`` and
its SASS read with ``cuobjdump -sass``: registers, spills and shared memory
of every instantiation, and the count of tensor-core (HGMMA, HMMA), TMA
(UTMALDG) and fp32 FMA (FFMA) instructions.

Every variant is first held against its plain version
(``flash_fwd_reference``: fp32 atol 2e-5, bf16 ``chip_smoke.bf16_atol``;
``flash_bwd_reference``: ``chip_smoke.bwd_atol``), then timed with CUDA events (10
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
# backward builds: label -> (library name, defines); the served ones take
# the sources' defaults
BWD_VARIANTS = {
    "bwd f32 192 resident rows (served)": ("flash_bwd_f32", ()),
    "bwd f32 128 resident rows": ("flash_bwd_f32", ("-DFLASH_BWD_F32_ROWS=128",)),
    "bwd f32 64 resident rows": ("flash_bwd_f32", ("-DFLASH_BWD_F32_ROWS=64",)),
    "bwd bf16 3 q stages (served)": ("flash_bwd_bf16", ()),
    "bwd bf16 2 q stages": ("flash_bwd_bf16", ("-DFLASH_BWD_BF16_QSTAGES=2",)),
}
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


def build_bwd_variants(_kernels) -> dict:
    """One library per backward variant, all compiled together: label ->
    (library path, ptxas's report)."""
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)

    def build(item):
        label, (name, defines) = item
        lib = os.path.join(_kernels.BUILD_DIR, f"sweep-{name}-{len(defines)}-"
                           f"{'-'.join(x.split('=')[-1] for x in defines)}.so")
        return label, (lib, compile_source(_kernels, _kernels.SOURCES[name], lib, defines))

    with ThreadPoolExecutor(len(BWD_VARIANTS)) as pool:
        return dict(pool.map(build, BWD_VARIANTS.items()))


def bwd_launcher(_kernels, name: str, lib_path: str, scale: float):
    """Launch ``gordo_<name>`` of one sweep library on (BH, S, D) CUDA
    tensors, with its workspace, as ``_kernels.flash_bwd_cuda`` does."""
    import torch

    lib = ctypes.CDLL(lib_path)
    entry = getattr(lib, f"gordo_{name}")
    _kernels.bind_flash_bwd_entry(entry)
    workspace = getattr(lib, f"gordo_{name}_workspace")
    workspace.argtypes = [ctypes.c_int] * 3
    workspace.restype = ctypes.c_longlong

    def run(q, k, v, out, lse, do):
        grads = [torch.empty_like(q) for _ in range(3)]
        nbytes = workspace(*q.shape)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
        status = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                       lse.data_ptr(), None, *(g.data_ptr() for g in grads),
                       None if scratch is None else scratch.data_ptr(), *q.shape, scale,
                       torch.cuda.current_stream(q.device).cuda_stream)
        if status != 0:
            sys.exit(f"{os.path.basename(lib_path)}: launch failed with CUDA error {status}")
        return grads

    return run


def sweep_bwd(torch, chip_smoke, _kernels, device, rounds: int) -> dict:
    """Every backward variant held against flash_bwd_reference at the
    training shape, then timed in rounds of turns."""
    from gordo_components_tpu_torch.ops.flash_attention import (
        flash_bwd_reference,
        flash_fwd_reference,
    )

    shape = chip_smoke.TRAIN_SHAPE
    scale = shape[-1] ** -0.5
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 11)
    variants = {}
    for label, (lib, entries) in build_bwd_variants(_kernels).items():
        for entry in entries:
            print(f"{label}: {entry['entry']}: {entry.get('usage')}; {entry.get('spill')}")
        name = BWD_VARIANTS[label][0]
        variants[label] = (name, bwd_launcher(_kernels, name, lib, scale))
    inputs = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = [(0.5 * torch.randn(shape, generator=gen, device=device)).to(dt)
                       for _ in range(4)]
        out, lse = flash_fwd_reference(q, k, v, scale)
        inputs[dt] = (q, k, v, out, lse, do)
    dtype = {"flash_bwd_f32": torch.float32, "flash_bwd_bf16": torch.bfloat16}
    for label, (name, fn) in variants.items():
        q, k, v, out, lse, do = inputs[dtype[name]]
        plain = flash_bwd_reference(q, k, v, out, lse, do, scale)
        for got, ref in zip(fn(q, k, v, out, lse, do), plain):
            err = (got.float() - ref.float()).abs().max().item()
            if err > chip_smoke.bwd_atol(ref):
                sys.exit(f"{label} disagrees with its plain version: max|grad-plain| {err}")
        del plain
    times = {label: [] for label in variants}
    for _ in range(rounds):
        for label, (name, fn) in variants.items():
            args = inputs[dtype[name]]
            times[label].append(chip_smoke.timed_ms(lambda: fn(*args)))
    result = {}
    for label, ms in times.items():
        bound = chip_smoke.bwd_bound(*shape, dtype[variants[label][0]])
        mean = sum(ms) / len(ms)
        result[label] = {"ms": ms, "share_of_bound": bound["bound_ms"] / mean}
        print(f"{label} {shape}: {' / '.join(f'{t:.4f}' for t in ms)} ms, "
              f"{100 * bound['bound_ms'] / mean:.1f} % of the {bound['bound_ms']:.4f} ms bound")
    return result


def sweep_fwd(torch, chip_smoke, _kernels, device, rounds: int) -> dict:
    """Every forward variant held against flash_fwd_reference at the slice
    shape, then timed in rounds of turns."""
    from gordo_components_tpu_torch.ops.flash_attention import flash_fwd_reference

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
    for _ in range(rounds):
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
    return result


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--part", choices=("all", "fwd", "bwd"), default="all")
    args = parser.parse_args()

    import torch

    import chip_smoke
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.utils.backend import resolve_device

    device = resolve_device(None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    _kernels.build_all()
    report = resources(_kernels)
    result = {}
    if args.part in ("all", "fwd"):
        result["forward"] = sweep_fwd(torch, chip_smoke, _kernels, device, args.rounds)
    if args.part in ("all", "bwd"):
        result["backward"] = sweep_bwd(torch, chip_smoke, _kernels, device, args.rounds)
    print(card)
    print(json.dumps({"card": card, "slice_shape": chip_smoke.SLICE_SHAPE,
                      "train_shape": chip_smoke.TRAIN_SHAPE, "variants": result,
                      "resources": report}))


if __name__ == "__main__":
    main()
