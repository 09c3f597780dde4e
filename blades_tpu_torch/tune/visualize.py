"""Sweep results as a table and a plot (counterpart of
``blades_tpu/tune/visualize.py``): read every trial directory under a
storage path (``params.json`` + ``result.json``) into one list of flat
rows, print each trial's final row, and plot the final accuracy against
the number of malicious clients per aggregator, one panel per adversary.

Reads the results with :mod:`json` alone: the card's machine has no
pandas.  The plot needs matplotlib and is skipped, with a line saying
so, where it does not import.

    python -m blades_tpu_torch.tune.visualize ~/blades_tpu_results \\
        --plot grid.png
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

_COLUMNS = ("experiment", "trial", "aggregator", "adversary",
            "num_malicious", "test_acc", "train_loss")


def load_results(storage_path: str) -> List[Dict]:
    """Every trial's rows under ``storage_path``, flattened: the trial's
    name, experiment, aggregator, adversary, malicious count and
    Dirichlet alpha beside each row's scalar fields."""
    rows = []
    root = Path(storage_path).expanduser()
    for result_file in sorted(root.glob("**/result.json")):
        tdir = result_file.parent
        params = {}
        pfile = tdir / "params.json"
        if pfile.exists():
            params = json.loads(pfile.read_text())
        agg = (params.get("server_config", {}) or {}).get("aggregator", {})
        adv = params.get("adversary_config", {}) or {}
        meta = {
            "trial": tdir.name,
            "experiment": tdir.parent.name,
            "aggregator": (agg.get("type", "Mean") if isinstance(agg, dict)
                           else str(agg)),
            "adversary": (adv.get("type", "None") if isinstance(adv, dict)
                          else str(adv)),
            "num_malicious": params.get("num_malicious_clients", 0),
            "alpha": (params.get("dataset_config", {}) or {}).get("alpha"),
        }
        for line in result_file.read_text().splitlines():
            r = json.loads(line)
            rows.append({**meta, **{k: v for k, v in r.items()
                                    if not isinstance(v, (dict, list))}})
    return rows


def final_rows(rows: List[Dict]) -> List[Dict]:
    """Each trial's last evaluated row (by ``training_iteration``)."""
    last: Dict[tuple, Dict] = {}
    for r in rows:
        if r.get("test_acc") is None:
            continue
        key = (r["experiment"], r["trial"])
        if (key not in last or r.get("training_iteration", 0)
                >= last[key].get("training_iteration", 0)):
            last[key] = r
    return [last[k] for k in sorted(last)]


def plot_accuracy_grid(rows: List[Dict], out_path: Optional[str] = None):
    """The final accuracy against the malicious count, one panel per
    adversary, one line per aggregator; returns the figure, or None when
    matplotlib does not import."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    final = final_rows(rows)
    advs = sorted({r["adversary"] for r in final})
    cols = min(3, max(len(advs), 1))
    nrows = -(-max(len(advs), 1) // cols)
    fig, axes = plt.subplots(nrows, cols, figsize=(3.5 * cols, 3 * nrows),
                             squeeze=False)
    for ax, adv in zip(axes.flat, advs):
        for agg in sorted({r["aggregator"] for r in final
                           if r["adversary"] == adv}):
            pts = sorted((r["num_malicious"], r["test_acc"]) for r in final
                         if r["adversary"] == adv and r["aggregator"] == agg)
            ax.plot(*zip(*pts), marker="o", label=agg)
        ax.set_title(adv)
        ax.set_xlabel("# malicious")
        ax.set_ylabel("test_acc")
        ax.legend(fontsize=7)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
    return fig


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="summarise / plot sweep results")
    p.add_argument("storage_path")
    p.add_argument("--plot", default=None, help="output PNG path")
    args = p.parse_args(argv)
    rows = load_results(args.storage_path)
    if not rows:
        print("no results found")
        return 1
    final = final_rows(rows)
    cols = [c for c in _COLUMNS if any(c in r for r in final)]
    print("  ".join(cols))
    for r in final:
        print("  ".join(str(r.get(c, "")) for c in cols))
    if args.plot:
        if plot_accuracy_grid(rows, args.plot) is None:
            print(f"{args.plot} not written: matplotlib is not installed")
        else:
            print(f"wrote {args.plot}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
