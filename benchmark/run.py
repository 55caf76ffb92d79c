"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs as many CUDA cards as the cell asks for; without them it exits with
an error and prints no result. The last line of standard output is the
result (JSON); the compared numbers, each beside its limit, are the last
lines of standard error. A run that would leave a child process alive, or
that loaded JAX or the JAX package, prints no result and exits non-zero.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import glob  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# what the port must not load: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "go_curdleproofs_tpu")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def live_children():
    """The pids of this process's children, from
    /proc/self/task/*/children (Linux), else from every process's ppid."""
    tasks = glob.glob("/proc/self/task/*/children")
    pids = set()
    for path in tasks:
        try:
            pids.update(int(x) for x in Path(path).read_text().split())
        except OSError:
            pass                                # a thread that has ended
    if not tasks:
        me = os.getpid()
        for stat in glob.glob("/proc/[0-9]*/stat"):
            try:
                fields = Path(stat).read_text().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == me:
                pids.add(int(Path(stat).parent.name))
    return sorted(pids)


def end_children(pids):
    """Kill and reap each of `pids`."""
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in pids:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass


def finish(result, checks) -> int:
    """Print the result line, unless the run left a child process alive
    or loaded what the port must not: then end the children, say why on
    standard error and print no result."""
    left = live_children()
    if left:
        end_children(left)
        print(f"run.py: child processes {left} were still alive after the "
              "check; a run may leave none, so it gives no result",
              file=sys.stderr)
        return 4
    found = forbidden_modules()
    if found:
        print(f"run.py: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for c in checks:
        print(c.line(), file=sys.stderr)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.core import runner, spec

    print(f"set-up: imports {time.time() - T_PROCESS:.3f} s", file=sys.stderr)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("run.py: CUDA is not available; a run needs the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = runner.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), device=device,
                                     t_process=T_PROCESS)
    return finish(result, checks)


if __name__ == "__main__":
    sys.exit(main())
