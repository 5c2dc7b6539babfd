"""Read the control of a cell's ``correct`` on the card, seed by seed:

    python3 portbench/control.py --workload <name> --seeds 11 12 13 [--mode tf32|fp8|fp32]

The plain reference, a step below the configuration's precision, against
the reference at float32 over as many requests as a run compares, at the
cell's own sizes (``harness/control.py``). Prints one JSON line per seed,
then each number's least reading beside the cell's limit: every number a
limit is set from reads above it, or the control would pass.
"""

import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)


def main() -> int:
    import argparse

    import torch

    from harness import compare, control, manifest

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--mode", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    root = os.getcwd()
    man = manifest.load(root)
    cell = manifest.cell(man, args.workload)
    config = manifest.config(man, root, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    least, passed = {}, []
    for seed in args.seeds:
        reading = control.readings(config, traffic, seed, "cuda:0", args.mode)
        correct = compare.judge(reading, config["limits"])
        print(json.dumps({"seed": seed, "mode": args.mode or config["control"],
                          "correct": correct, **reading}), flush=True)
        passed += [seed] if correct else []
        for name, value in reading.items():
            least[name] = min(least.get(name, value), value)
    print(json.dumps({"least": least, "limits": config["limits"],
                      "seeds_where_the_control_passed": passed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
