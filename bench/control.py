"""The readings the limits of ``correct`` are set from, on the card.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell with a short window (long enough to
reach its checked ticks), then every number compared twice: the program
against the float32 reference (the lower reading) and the control, the
reference put in the program's place in bfloat16, against the float32
reference (the upper reading).  One JSON line a seed, then the largest
lower and the smallest upper reading of each number.  The benchmark's own
runs do not run this.
"""

import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None):
    import argparse

    import torch

    from bench.harness import cell as cellmod
    from bench.harness import check
    from bench.harness.spec import load_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    lower, upper = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        data, run = cellmod.run_cell(cell, seed, args.seconds, False, device,
                                     t0, log=lambda *a, **k: None)
        prog, checked = check.judge(run, device)
        ctrl, _ = check.judge(run, device, torch.bfloat16)
        ok = check.verdict(prog, checked, run)
        ctrl_ok = check.verdict(ctrl, checked, run)
        for k, v in prog.items():
            lower[k] = max(lower.get(k, 0), v)
            upper[k] = min(upper.get(k, ctrl[k]), ctrl[k])
        print(json.dumps({"seed": seed, "ticks": data.ticks,
                          "checked": checked, "missing": run.missing, "correct": ok,
                          "control_correct": ctrl_ok, "program": prog, "control": ctrl,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del data, run
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
