"""Quickstart on the PyTorch port: the paper's algorithm in ~60 lines.

The twin of ``examples/quickstart.py``: 1024 peers on a *cyclic* grid pick,
with purely local messages, the option closest to the global average of
their inputs — no coordinator, no all-to-all, no spanning tree.  On the GPU
(the default) every cycle runs through the CUDA kernels; ``--device cpu``
runs the plain PyTorch formulas:

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --n 256
"""

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import lss, regions, sim, topology, wvs
from repro_torch.kernels import ops
from repro_torch.kernels.suite import resolve_suite


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024, help="peers (a square)")
    ap.add_argument("--cycles", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda, which raises without "
                         "a card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = args.n
    topo = topology.grid(n)                      # 32x32 grid: full of cycles
    ta = lss.TopoArrays.from_topology(topo, dev)

    # Three options ("sources", Sec. V); peers vote with noisy 2-D inputs
    # whose true mean is nearest to option 1.
    centers = torch.tensor([[0.0, 0.0], [2.0, 2.0], [4.0, 0.0]], device=dev)
    rng = np.random.default_rng(0)
    inputs = rng.normal(loc=(1.8, 1.9), scale=1.5,
                        size=(n, 2)).astype(np.float32)

    state = lss.init_state(ta, wvs.from_vector(
        torch.from_numpy(inputs).to(dev),
        torch.ones((n,), dtype=torch.float32, device=dev)))
    cfg = lss.LSSConfig(beta=1e-3, ell=1)
    # The CUDA kernels on the card, the reference formulas on the CPU; the
    # options' tables are prepared once, as the experiment driver does.
    suite = resolve_suite(None, dev)
    slot = regions.PackedSlot.voronoi(centers)
    tables = ops.prep_slots(slot, cfg.eps)
    observe = ops.prep_slots(slot, sim.OBSERVE_EPS)

    printed = []
    quiesced_at = None
    for cycle in range(args.cycles):
        state, sent = lss.cycle(state, ta, centers, cfg, suite=suite,
                                regions=tables)
        acc, quiescent, _ = lss.metrics(state, ta, centers, suite=suite,
                                        regions=observe)
        acc, quiescent = float(acc), bool(quiescent)
        if cycle % 5 == 0 or quiescent:
            msgs = int(state.msgs)
            printed.append((cycle, acc, msgs, quiescent))
            print(f"cycle {cycle:3d}  accuracy={acc:6.3f}  "
                  f"msgs so far={msgs:6d}  quiescent={quiescent}")
        if quiescent:
            quiesced_at = cycle
            break

    gx = inputs.mean(0)
    true_choice = int(np.argmin(((gx - centers.cpu().numpy()) ** 2).sum(-1)))
    per_link = float(state.msgs) / topo.num_edges
    print(f"\nglobal mean = {gx.round(3)} -> true option {true_choice}; "
          f"all {n} peers agree, using {per_link:.2f} messages per link.")
    return {"printed": printed, "quiesced_at": quiesced_at,
            "global_mean": gx.round(3).tolist(), "true_choice": true_choice,
            "msgs": int(state.msgs), "msgs_per_link": per_link}


if __name__ == "__main__":
    main()
