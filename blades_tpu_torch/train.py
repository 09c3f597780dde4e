"""Command line of the port (counterpart of ``blades_tpu/train.py``'s
``run`` subcommand):

    python -m blades_tpu_torch.train run FEDAVG --rounds 3 \\
        --config-json '{"dataset_config": {"type": "mnist", "num_clients": 6}}'

runs one algorithm with flat or nested config overrides on the card
(``--device cpu`` for the CPU), prints one line per round and writes the
result rows to ``<storage-path>/<algo>_run/result.json`` (one JSON object
per line) beside ``params.json`` (the overrides).  The ``file``
subcommand and its grids come with a later slice.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="blades_tpu_torch.train",
        description="Byzantine-robust FL training on the card (PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="run one algorithm with overrides")
    p_run.add_argument("algo", help="FEDAVG")
    p_run.add_argument("--config-json", default="{}",
                       help="flat/nested config overrides as JSON, e.g. "
                       "'{\"dataset_config\": {\"type\": \"mnist\"}}'")
    p_run.add_argument("--rounds", type=int, default=100)
    p_run.add_argument("--storage-path", default="~/blades_tpu_results")
    p_run.add_argument("--device", default=None,
                       help="torch device (default: the card)")
    args = parser.parse_args(argv)

    from blades_tpu_torch.algorithms import get_algorithm_class

    overrides = json.loads(args.config_json)
    _, config = get_algorithm_class(args.algo, return_config=True)
    config.update_from_dict(overrides)
    algo = config.build(device=args.device)
    out = Path(args.storage_path).expanduser() / f"{args.algo.lower()}_run"
    out.mkdir(parents=True, exist_ok=True)
    (out / "params.json").write_text(json.dumps(overrides, indent=1))
    best = None
    try:
        with open(out / "result.json", "w") as fh:
            for _ in range(args.rounds):
                row = algo.train()
                fh.write(json.dumps(row) + "\n")
                fh.flush()
                acc = row.get("test_acc")
                if acc is not None:
                    best = acc if best is None else max(best, acc)
                print(f"round {row['training_iteration']}: train_loss "
                      f"{row['train_loss']:.4f}"
                      + ("" if acc is None else f" test_acc {acc:.4f}"),
                      flush=True)
    finally:
        algo.stop()
    if best is not None:
        print(f"best test_acc={best:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
