"""Robust accuracy against the number of malicious clients (counterpart
of ``blades_tpu/benchmarks/accuracy_curves.py``): the final test accuracy
of each aggregator as the malicious count grows, the reference's headline
figure.

    python -m blades_tpu_torch.benchmarks.accuracy_curves \
        --dataset fashionmnist --rounds 200 --out curves_out

Writes ``<out>/curves.json`` (the table, in the JAX package's format with
its data-provenance and completeness stamps, rewritten after every cell)
and ``<out>/curves.png`` where matplotlib imports (a line says when it is
not written).  Runs on real data when the raw files are on disk under
``BLADES_TPU_DATA_ROOT`` and otherwise on the deterministic synthetic
fallback; the provenance is stamped into the table.  On the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from blades_tpu_torch.obs.trace import now

DEFAULT_AGGREGATORS = ["Mean", "Median", "Trimmedmean", "GeoMed", "Multikrum",
                       "Signguard", "Clippedclustering"]
DEFAULT_MALICIOUS = [0, 6, 12, 18]
MODELS = {"mnist": "mlp", "fashionmnist": "cnn", "cifar10": "resnet10",
          "cifar100": "resnet34"}

# The reference figure's grid: all nine aggregators
# (fedavg_cifar10_resnet_noniid.yaml:49-60) at 0/10/20/30% malicious
# (:75-87).  ``complete: true`` in curves.json means this grid ran, not
# merely the rows the invocation planned.
REFERENCE_AGGREGATORS = ["Mean", "Median", "Trimmedmean", "GeoMed",
                         "Multikrum", "Centeredclipping", "Signguard",
                         "Clippedclustering", "DnC"]
REFERENCE_MALICIOUS_FRACS = [0.0, 0.1, 0.2, 0.3]


def run_cell(dataset, model, aggregator, num_malicious, adversary, rounds,
             seed, num_clients, chunk, iid=True, alpha=0.1,
             synthetic_noise=0.5, synthetic_heterogeneity=0.0,
             client_lr=0.1, server_lr=1.0,
             batch_size=None, compute_dtype=None, device=None):
    from blades_tpu_torch.algorithms import FedavgConfig

    spec = dataset
    if synthetic_noise != 0.5 or synthetic_heterogeneity > 0.0:
        # Difficulty and per-client drift of the synthetic fallback (real
        # data ignores both).
        spec = {"type": dataset, "synthetic_noise": synthetic_noise,
                "synthetic_heterogeneity": synthetic_heterogeneity}
    agg_spec = {"type": aggregator}
    if aggregator == "Multikrum":
        # Multi-Krum averages the n - f best-scoring updates (pure Krum's
        # one update a round starves even the benign baseline under
        # non-IID partitions).
        agg_spec["k"] = max(num_clients - num_malicious, 1)
    cfg = (
        FedavgConfig()
        .data(dataset=spec, num_clients=num_clients, iid=iid,
              dirichlet_alpha=alpha, seed=seed)
        .training(global_model=model, aggregator=agg_spec,
                  server_lr=server_lr, train_batch_size=batch_size)
        .client(lr=client_lr)
        .adversary(
            num_malicious_clients=num_malicious,
            adversary_config=(
                (json.loads(adversary) if adversary.lstrip().startswith("{")
                 else {"type": adversary}) if num_malicious else None
            ),
        )
        .evaluation(evaluation_interval=max(rounds // 4, 1))
    )
    cfg.rounds_per_dispatch = chunk
    if compute_dtype:
        cfg = cfg.resources(compute_dtype=compute_dtype)
    algo = cfg.build(device=device)
    best = 0.0
    try:
        while algo.iteration < rounds:
            r = algo.train()
            best = max(best, r.get("test_acc", 0.0))
        final = algo.evaluate()
        synthetic = bool(algo.dataset.synthetic)
        done = algo.iteration
    finally:
        algo.stop()
    return {
        "dataset": dataset, "model": model, "aggregator": aggregator,
        "adversary": adversary if num_malicious else None,
        "num_malicious": num_malicious, "rounds": done,
        "final_test_acc": round(final["test_acc"], 4),
        "best_test_acc": round(best, 4),
        "synthetic_data": synthetic,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="fashionmnist")
    p.add_argument("--model", default=None,
                   help="default: the dataset's canonical model")
    p.add_argument("--rounds", type=int, default=200,
                   help="reduced from the canonical 2000 for turnaround")
    p.add_argument("--num-clients", type=int, default=60)
    p.add_argument("--adversary", default="ALIE",
                   help="attack name, or a JSON spec like "
                   "'{\"type\": \"IPM\", \"scale\": 100.0}'")
    p.add_argument("--aggregators", nargs="+", default=DEFAULT_AGGREGATORS)
    p.add_argument("--malicious", nargs="+", type=int, default=DEFAULT_MALICIOUS)
    p.add_argument("--rounds-per-dispatch", type=int, default=10)
    p.add_argument("--out", default="curves_out")
    p.add_argument("--seed", type=int, default=122)
    p.add_argument("--noniid-alpha", type=float, default=None,
                   help="partition non-IID with this Dirichlet alpha "
                   "(default: IID, the historical behavior)")
    p.add_argument("--synthetic-noise", type=float, default=0.5,
                   help="difficulty of the synthetic fallback (no effect "
                   "on real data); ~3.0 makes attack/defense orderings "
                   "visible on cifar10/resnet10, ~8.0 on mnist/mlp")
    p.add_argument("--synthetic-heterogeneity", type=float, default=0.0,
                   help="per-client feature drift of the synthetic "
                   "fallback (no effect on real data): class-conditional "
                   "mean shifts + noise-scale jitter that widen the "
                   "benign update spread the way real non-IID data does "
                   "(datasets._heterogenize_partition)")
    p.add_argument("--client-lr", type=float, default=0.1)
    p.add_argument("--server-lr", type=float, default=1.0,
                   help="the reference figure runs client 1.0 / server "
                   "0.1 (fedavg_cifar10_resnet_noniid.yaml)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="per-client train batch (reference figure: 64)")
    p.add_argument("--compute-dtype", default=None,
                   help="e.g. bfloat16 (half the activation memory)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--resume-from", default=None,
                   help="path to an existing curves.json: its rows seed "
                   "this run and already-run (aggregator, num_malicious) "
                   "cells are skipped — the way to COMPLETE a grid "
                   "toward the reference matrix without re-running "
                   "finished cells")
    args = p.parse_args(argv)

    model = args.model or MODELS.get(args.dataset, "mlp")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    if args.resume_from:
        prior = json.loads(Path(args.resume_from).read_text())

        def norm_adv(a):
            try:
                return json.loads(a) if isinstance(a, str) \
                    and a.lstrip().startswith("{") else a
            except Exception:
                return a

        # Seed only cells whose run configuration matches this one; a key
        # the prior table lacks is warned about, not failed.
        checks = {
            "dataset": args.dataset, "model": model,
            "adversary": args.adversary, "rounds": args.rounds,
            "num_clients": args.num_clients,
            "noniid_alpha": args.noniid_alpha,
            "synthetic_noise": args.synthetic_noise,
            "synthetic_heterogeneity": args.synthetic_heterogeneity,
            "client_lr": args.client_lr, "server_lr": args.server_lr,
            "batch_size": args.batch_size,
            "compute_dtype": args.compute_dtype, "seed": args.seed,
        }
        for k, ours in checks.items():
            if k not in prior:
                print(f"# WARNING: --resume-from artifact predates the "
                      f"{k!r} stamp; cannot verify it matches {ours!r}",
                      flush=True)
                continue
            theirs = prior[k]
            if k == "adversary":
                theirs, ours = norm_adv(theirs), norm_adv(ours)
            if theirs != ours:
                raise SystemExit(
                    f"--resume-from config mismatch on {k!r}: "
                    f"{theirs} != {ours}")
        rows = list(prior["rows"])
        print(f"# resumed {len(rows)} cells from {args.resume_from}",
              flush=True)

    # The reference figure's cells for this client count.
    ref_malicious = sorted({int(round(f * args.num_clients))
                            for f in REFERENCE_MALICIOUS_FRACS})

    def write_table():
        # Rewritten after every cell: a killed sweep leaves a valid
        # partial table.
        synthetic = any(r["synthetic_data"] for r in rows)
        ran = {(r["aggregator"], r["num_malicious"]) for r in rows}
        # "complete": the full reference grid ran (9 aggregators x
        # {0, 10, 20, 30}%), not merely the planned rows.
        reference_cells = [(a, m) for a in REFERENCE_AGGREGATORS
                           for m in ref_malicious]
        table = {
            "source": "SYNTHETIC fallback data (smoke shape, not a "
                      "reproduction)" if synthetic else "real raw data",
            "dataset": args.dataset, "model": model,
            "adversary": args.adversary, "rounds": args.rounds,
            "num_clients": args.num_clients,
            "noniid_alpha": args.noniid_alpha,
            "synthetic_noise": args.synthetic_noise,
            "synthetic_heterogeneity": args.synthetic_heterogeneity,
            "client_lr": args.client_lr,
            "server_lr": args.server_lr,
            "batch_size": args.batch_size,
            "compute_dtype": args.compute_dtype,
            "seed": args.seed,
            "planned": {"aggregators": list(args.aggregators),
                        "malicious": list(args.malicious)},
            "planned_complete": all(
                (a, m) in ran for a in args.aggregators
                for m in args.malicious),
            "reference_grid": {"aggregators": REFERENCE_AGGREGATORS,
                               "malicious": ref_malicious},
            "reference_cells_missing": sorted(
                f"{a}@{m}" for a, m in reference_cells if (a, m) not in ran),
            "complete": all(c in ran for c in reference_cells),
            "rows": rows,
        }
        (out / "curves.json").write_text(json.dumps(table, indent=2))
        return synthetic

    done = {(r["aggregator"], r["num_malicious"]) for r in rows}
    for agg in args.aggregators:
        for m in args.malicious:
            if (agg, m) in done:
                continue
            t0 = now()
            row = run_cell(args.dataset, model, agg, m, args.adversary,
                           args.rounds, args.seed, args.num_clients,
                           args.rounds_per_dispatch,
                           iid=args.noniid_alpha is None,
                           alpha=args.noniid_alpha or 0.1,
                           synthetic_noise=args.synthetic_noise,
                           synthetic_heterogeneity=args.synthetic_heterogeneity,
                           client_lr=args.client_lr,
                           server_lr=args.server_lr,
                           batch_size=args.batch_size,
                           compute_dtype=args.compute_dtype,
                           device=args.device)
            row["wall_s"] = round(now() - t0, 1)
            rows.append(row)
            print(json.dumps(row), flush=True)
            write_table()

    synthetic = write_table()
    try:
        import matplotlib
    except ImportError:
        print(f"wrote {out}/curves.json ({'synthetic' if synthetic else 'real'}"
              " data); curves.png not written: matplotlib is not installed")
        return 0
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    # The planned and the resumed aggregators: the whole stitched grid.
    plot_aggs = list(dict.fromkeys(
        [*args.aggregators, *(r["aggregator"] for r in rows)]))
    for agg in plot_aggs:
        pts = sorted((r["num_malicious"], r["final_test_acc"]) for r in rows
                     if r["aggregator"] == agg)
        if pts:
            ax.plot(*zip(*pts), marker="o", label=agg)
    ax.set_xlabel("# malicious clients")
    ax.set_ylabel(f"test accuracy after {args.rounds} rounds")
    title = f"{args.dataset}/{model} vs {args.adversary}"
    if synthetic:
        title += "  [SYNTHETIC DATA]"
    ax.set_title(title)
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out / "curves.png", dpi=120)
    print(f"wrote {out}/curves.json and {out}/curves.png "
          f"({'synthetic' if synthetic else 'real'} data)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
