"""Gossip against centralized convergence curves (counterpart of the JAX
package's ``tools/gossip_curves.py``).

Runs the same tiny synthetic federation through the centralized dense
round and the decentralized gossip round (``execution="gossip"``, the
node replicas stacked on one device) on each requested peer graph,
evaluating every round, and writes the curves in the accuracy-curves
table format: each row also carries ``topology``, ``spectral_gap`` and
the per-round ``test_acc_curve`` / ``loss_curve``.  The table's
completeness stamps are computed against the reference grid of
:mod:`blades_tpu_torch.benchmarks.accuracy_curves` (``complete: false``
with the missing cells listed is the expected state of a gossip study).

    python -m blades_tpu_torch.tools.gossip_curves --out gossip/curves.json
    python -m blades_tpu_torch.tools.gossip_curves --rounds 40 \\
        --graphs ring,complete --device cpu

On the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from blades_tpu_torch.obs.trace import now

NUM_CLIENTS = 16
NUM_MALICIOUS = 4


def _dataset(n_clients: int, seed: int):
    import numpy as np

    from blades_tpu_torch.data.datasets import FLDataset
    from blades_tpu_torch.data.partition import partition_dataset

    shape, num_classes, rows = (6, 6, 1), 4, 16
    rng = np.random.default_rng(seed)
    n = n_clients * rows
    mus = rng.normal(size=(num_classes,) + shape).astype(np.float32)
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    x = (mus[y] + 0.8 * rng.normal(size=(n,) + shape)).astype(np.float32)
    train = partition_dataset(x, y, n_clients, iid=True, seed=seed)
    test = partition_dataset(x[: 4 * n_clients], y[: 4 * n_clients],
                             n_clients, iid=True, seed=seed + 1)
    return FLDataset(name="synthcluster", train=train, test_x=x[:128],
                     test_y=y[:128], test=test, num_classes=num_classes,
                     input_shape=shape, synthetic=True)


def _config(graph, *, aggregator, adversary, num_malicious, seed):
    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.models.mlp import MLP

    cfg = (
        FedavgConfig()
        .data(dataset=_dataset(NUM_CLIENTS, seed), num_clients=NUM_CLIENTS,
              seed=seed)
        .training(global_model=MLP(36, hidden1=16, hidden2=16,
                                   num_classes=4),
                  num_classes=4, input_shape=(6, 6, 1), server_lr=1.0,
                  train_batch_size=8, aggregator={"type": aggregator})
        .client(lr=0.05)
        .evaluation(evaluation_interval=1)
    )
    if graph is not None:
        cfg.resources(execution="gossip")
        cfg.topology(graph=graph, k=4)
    if num_malicious:
        cfg.adversary(num_malicious_clients=num_malicious,
                      adversary_config=adversary)
    return cfg


def _run_arm(graph, *, aggregator, adversary, num_malicious, rounds, seed,
             device):
    """One (path, aggregator, adversary) trajectory as a curves row."""
    label = "centralized" if graph is None else f"gossip_{graph}"
    adv_name = adversary["type"] if isinstance(adversary, dict) else adversary
    algo = _config(graph, aggregator=aggregator, adversary=adversary,
                   num_malicious=num_malicious, seed=seed).build(
                       device=device)
    accs, losses = [], []
    t0 = now()
    try:
        for _ in range(rounds):
            row = algo.train()
            losses.append(round(float(row["train_loss"]), 5))
            accs.append(round(float(row["test_acc"]), 4))
        out = {
            "dataset": "synthcluster", "model": "mlp",
            "aggregator": aggregator,
            "adversary": adv_name if num_malicious else None,
            "num_malicious": num_malicious, "rounds": rounds,
            "topology": graph, "path": label,
            "final_test_acc": accs[-1], "best_test_acc": max(accs),
            "synthetic_data": True, "wall_s": round(now() - t0, 1),
            "test_acc_curve": accs, "loss_curve": losses,
        }
        if graph is not None:
            out["spectral_gap"] = round(float(row["spectral_gap"]), 4)
            out["gossip_ici_bytes"] = int(row["gossip_ici_bytes"])
            out["consensus_dist"] = round(float(row["consensus_dist"]), 5)
        return out
    finally:
        algo.stop()


def completeness_stamps(table: dict) -> dict:
    """The table's completeness stamps against the reference grid (all
    nine reference aggregators at 0/10/20/30% malicious of its client
    count), from its rows."""
    from blades_tpu_torch.benchmarks.accuracy_curves import (
        REFERENCE_AGGREGATORS,
        REFERENCE_MALICIOUS_FRACS,
    )

    n = int(table.get("num_clients") or 0)
    mal = sorted({int(round(f * n)) for f in REFERENCE_MALICIOUS_FRACS})
    ran = {(r.get("aggregator"), r.get("num_malicious"))
           for r in table.get("rows", [])}
    missing = sorted(f"{a}@{m}" for a in REFERENCE_AGGREGATORS for m in mal
                     if (a, m) not in ran)
    return {"reference_grid": {"aggregators": list(REFERENCE_AGGREGATORS),
                               "malicious": mal},
            "reference_cells_missing": missing, "complete": not missing}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=25)
    p.add_argument("--graphs", default="ring,kregular,complete",
                   help="comma-separated gossip graphs (the centralized "
                        "baseline always runs)")
    p.add_argument("--aggregator", default="Median")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=Path,
                   default=Path("gossip_curves") / "curves.json")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)

    adversary = {"type": "TopologyAttack", "base": "ALIE"}
    rows = []
    for graph in [None] + [g for g in args.graphs.split(",") if g]:
        # The gossip arms carry the topology-scoped attack; the
        # centralized baseline the same forge through its base.
        adv = adversary if graph is not None else {"type": "ALIE"}
        for nm in (0, NUM_MALICIOUS):
            row = _run_arm(graph, aggregator=args.aggregator,
                           adversary=adv, num_malicious=nm,
                           rounds=args.rounds, seed=args.seed,
                           device=args.device)
            rows.append(row)
            print(f"{row['path']:18s} f={nm}: "
                  f"final={row['final_test_acc']:.3f} "
                  f"best={row['best_test_acc']:.3f} wall={row['wall_s']}s",
                  flush=True)
    table = {
        "source": "SYNTHETIC gossip-vs-centralized study "
                  "(blades_tpu_torch.tools.gossip_curves; smoke shape, "
                  "not a reproduction)",
        "dataset": "synthcluster", "model": "mlp",
        "adversary": "TopologyAttack[ALIE]", "rounds": args.rounds,
        "num_clients": NUM_CLIENTS, "client_lr": 0.05, "server_lr": 1.0,
        "batch_size": 8, "compute_dtype": None, "rows": rows,
    }
    table.update(completeness_stamps(table))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(table, indent=2) + "\n")
    print(f"wrote {args.out} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
