"""Runs of a cell with a plant of controls.py under the timed path, on the
card, one process for all seeds; the benchmark's own runs never do this.

    python3 benchmark/control.py --workload <cell> --plant <name> \
        --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line a seed: the plant, `correct` and every compared
number with its limit. A plant that the check catches reads correct false.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--plant", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from benchmark import controls
    from benchmark.core import runner, spec

    if not torch.cuda.is_available():
        print("control.py: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    kind = cell.traffic["kind"]
    for seed in args.seeds:
        t0 = time.time()
        drv = runner.prepare(cell, seed, device=device)
        with controls.plant(kind, args.plant, drv):
            result, _ = runner.measure(cell, drv, args.seconds, False,
                                       device=device,
                                       setup_s=time.time() - t0)
        print(json.dumps({"workload": args.workload, "plant": args.plant,
                          "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
