"""Run one cell of the monitor benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is looked up in ``BENCHMARK.json``;
its configuration, traffic mix and metric readers are files under
``bench/``.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` (with
``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit.
The same numbers are the last lines of standard error.  Exits non-zero,
with no result, without enough CUDA devices, when the program cannot be
imported, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Caches of the program's builds live at fixed paths inside the checkout.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None):
    args = _parse(argv)
    import torch

    from bench.harness import cell as cellmod
    from bench.harness import check
    from bench.harness.spec import load_cell

    cell = load_cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails without the program)

    device = torch.device("cuda", 0)
    data, run = cellmod.run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), device, T_START)
    metrics = cellmod.measure(cell, data, bool(args.trace))
    t0 = time.perf_counter()
    numbers, checked = check.judge(run, device)
    ref_s = time.perf_counter() - t0
    bad = cellmod.forbidden_modules()
    if bad:
        print(f"error: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    correct = check.verdict(numbers, checked, run)
    result = {
        "correct": bool(correct),
        "attempted": data.q * len(run.records),
        "failed": int(run.missing + numbers["record_mismatch"]
                      + numbers["region_mismatch"]),
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": 1, "memory_peak_bytes": int(data.peak_bytes)},
    }
    if args.trace:
        if data.trace is None:
            print("error: the profiler saw no device time", file=sys.stderr)
            return 4
        result["device"]["busy_s"] = data.trace["busy_s"]
        result["device"]["window_s"] = data.trace["window_s"]
        result["breakdown"] = cellmod.breakdown(data)
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    print(f"[run] {args.workload} seed {args.seed}: {data.ticks} ticks in "
          f"{data.window_s:.3f} s (+{data.snapshot_s:.3f} s of checked "
          f"ticks' copies), set-up {data.setup_s:.3f} s, reference "
          f"{ref_s:.1f} s over {checked} checked ticks "
          f"{sorted(run.checked_ticks)}; launches "
          f"{ {k: v for k, v in data.launches.items() if v} }, host syncs "
          f"{data.host_syncs}; feeds at the window's start and end "
          f"{run.reports}; card {_power_limit()}", file=sys.stderr)
    if args.trace:
        print(f"[run] longest idle gaps {data.trace['longest_gaps']}; "
              f"counting pass {vars(data.count_pass)}; its kernels "
              f"{ {k: v for k, v in data.trace['pass_by_name'].items() if 'tiles' in k or 'warps' in k or 'long' in k} }",
              file=sys.stderr)
    for k, v in numbers.items():
        print(f"check {k} {v} limit {check.LIMITS[k]}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
