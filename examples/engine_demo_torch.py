"""The sharded engine + batched sweeps on the PyTorch port.

The twin of ``examples/engine_demo.py``: the computation of
``quickstart_torch.py``, but

  * the 4096 peers are partitioned over 4 shards (BFS edge-cut), boundary
    messages travel through the halo exchange, and 10 cycles run per
    dispatch;
  * then a 5-seed scenario sweep runs as ONE batched state (the seeds as
    slots of one stacked state) and prints the paper's "cycles to 95%"
    statistic across trials.

On the GPU (the default) the cycles run through the CUDA kernels;
``--device cpu`` runs the plain PyTorch formulas:

    PYTHONPATH=src python examples/engine_demo_torch.py
    PYTHONPATH=src python examples/engine_demo_torch.py --device cpu --n 1024 --seeds 3 --sweep-cycles 60
"""

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import sim, topology
from repro_torch.engine import EngineConfig, sweep_static
from repro_torch.engine.sweep import cycles_to_accuracy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096, help="peers (a square)")
    ap.add_argument("--cycles", type=int, default=300,
                    help="the engine run's cycle budget")
    ap.add_argument("--seeds", type=int, default=5, help="sweep seeds 0..")
    ap.add_argument("--sweep-cycles", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda, which raises without "
                         "a card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = args.n
    topo = topology.grid(n)  # 64x64 grid, full of cycles
    spec = sim.ProblemSpec(n=n, seed=0)

    # --- sharded engine ---------------------------------------------------
    res = sim.run_static(
        topo, spec, max_cycles=args.cycles,
        engine=EngineConfig(num_shards=4, cycles_per_dispatch=10),
        device=dev,
    )
    print(f"engine: {res['engine_shards']} shards, "
          f"{res['cut_edges']}/{topo.num_edges} edges cut by the partition")
    print(f"quiesced at cycle {res['quiesced_at']} "
          f"(accuracy {res['final_accuracy']:.3f}), "
          f"{res['msgs_per_link']:.2f} messages per link\n")

    # --- batched scenario sweep -------------------------------------------
    seeds = list(range(args.seeds))
    sweep = sweep_static(topo, spec, seeds, cycles=args.sweep_cycles,
                         device=dev)
    c95 = cycles_to_accuracy(sweep["accuracy"], 0.95)
    c100 = cycles_to_accuracy(sweep["accuracy"], 1.0)
    end = (sweep["msgs"][:, -1] / sweep["num_edges"]).round(2).tolist()
    print(f"sweep over seeds {seeds} (one batched state):")
    print(f"  cycles to 95%:  {c95.tolist()}  (mean {np.mean(c95):.1f})")
    print(f"  cycles to 100%: {c100.tolist()}")
    print(f"  msgs/link at end: {end}")
    return {**res, "num_edges": topo.num_edges, "seeds": seeds,
            "c95": c95.tolist(), "c100": c100.tolist(),
            "msgs_per_link_end": end}


if __name__ == "__main__":
    main()
