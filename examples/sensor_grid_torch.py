"""Wireless-sensor-network scenario on the PyTorch port.

The twin of ``examples/sensor_grid.py``: a 48x48 grid of sensors tracks
which of k "sources" is closest to the fleet-average reading while (a)
readings drift, (b) 2% of messages are lost, and (c) sensors die.  On the
GPU (the default) every cycle runs through the CUDA kernels; ``--device
cpu`` runs the plain PyTorch formulas:

    PYTHONPATH=src python examples/sensor_grid_torch.py
    PYTHONPATH=src python examples/sensor_grid_torch.py --device cpu --n 576 --cycles 120 --warmup 30 --drop 0
"""

import argparse

from repro_torch import resolve_device
from repro_torch.core import lss, sim, topology

NOISE_PPMC = 1000.0
CHURN_PPMC = 100.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48 * 48,
                    help="sensors (a square)")
    ap.add_argument("--cycles", type=int, default=400)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--drop", type=float, default=0.02,
                    help="message-loss rate")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda, which raises without "
                         "a card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = args.n
    topo = topology.grid(n)
    spec = sim.ProblemSpec(n=n, k=3, d=2, bias=0.2, std=2.0, seed=7)

    print(f"{n} sensors, {args.drop * 100:g}% message loss, data drift "
          f"{NOISE_PPMC:g} ppmc, churn {CHURN_PPMC:g} ppmc")
    res = sim.run_dynamic(
        topo, spec,
        lss.LSSConfig(drop_rate=args.drop),
        cycles=args.cycles,
        noise_ppmc=NOISE_PPMC,
        churn_ppmc=CHURN_PPMC,
        warmup=args.warmup,
        device=dev,
    )
    print(f"average accuracy over live sensors : "
          f"{res['avg_accuracy']*100:6.2f}%")
    print(f"messages per link per cycle        : "
          f"{res['msgs_per_link_per_cycle']:.3f}  (paper's normalized "
          f"messaging)")
    print(f"sensors still alive at the end     : {res['alive_frac']*100:6.1f}%")
    return {**res, "seed": spec.seed, "cycles": args.cycles,
            "warmup": args.warmup, "drop_rate": args.drop,
            "noise_ppmc": NOISE_PPMC, "churn_ppmc": CHURN_PPMC}


if __name__ == "__main__":
    main()
