"""Command line of the port (counterpart of ``blades_tpu/train.py``):

    python -m blades_tpu_torch.train file blades_tpu/tuned_examples/fedavg_dp.yaml
    python -m blades_tpu_torch.train run FEDAVG --rounds 3 \\
        --config-json '{"dataset_config": {"type": "mnist", "num_clients": 6}}'
    python -m blades_tpu_torch.train run FEDAVG --execution async \\
        --arrivals-json '{"rate": 0.25, "agg_every": 16}'
    python -m blades_tpu_torch.train run FEDAVG --window 100 \\
        --state-store host --data-store memmap
    python -m blades_tpu_torch.train run FEDAVG --execution gossip \\
        --topology kregular --mixing metropolis --graph-seed 0
    python -m blades_tpu_torch.train file grid.yaml --watchdog \\
        --trace-dir /tmp/spans --metrics-csv --flightrec-rounds 4
    python -m blades_tpu_torch.train file fedavg_dp.yaml --no-lanes
    python -m blades_tpu_torch.train run FEDAVG --client-packing auto

``file`` runs every trial of an experiment file's grids (each eligible
group of trials that differ only in seed, learning rates, DP epsilon or
clip or IPM's scale as the lanes of one program, unless ``--no-lanes``),
``run`` one
algorithm with flat or nested config overrides (as the experiment
``<algo>_run``); both go through
:func:`~blades_tpu_torch.tune.sweep.run_experiments`, on the card unless
``--device cpu`` is given.  Each trial writes ``params.json``,
``result.json`` (one JSON row per dispatch) and ``metrics.jsonl`` (the
rows, schema-validated; ``--metrics-csv`` adds ``metrics.csv``) under
``<storage-path>/<experiment>/<trial>/``; the best trial's test accuracy is
printed last.  ``--trace-dir`` exports each trial's span tree as Chrome
trace JSON, ``--trace`` captures a ``torch.profiler`` trace around the
whole command, ``--watchdog`` / ``--watchdog-rules`` arm the anomaly
watchdog and ``--flightrec-rounds`` sizes the flight recorder.  The JAX command's flags for subsystems the port does not
have yet are absent, so argparse refuses them.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="blades_tpu_torch.train",
        description="Byzantine-robust FL training on the card (PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--storage-path", default="~/blades_tpu_results")
    common.add_argument("--metrics-every", type=int, default=1, metavar="N",
                        help="fetch the rounds' scalar metrics N rows at a "
                        "time (flushed before checkpoints)")
    common.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    common.add_argument("--trace", default=None, metavar="DIR",
                        help="capture a torch.profiler trace (host and "
                        "the card's kernels) of the whole command into DIR "
                        "as Chrome trace JSON; composes with --trace-dir")
    common.add_argument("--trace-dir", default=None, metavar="DIR",
                        help="export each trial's host span tree (trial -> "
                        "round -> phase, round provenance as args) as "
                        "Chrome/Perfetto trace JSON into DIR")
    common.add_argument("--watchdog", action="store_true",
                        help="arm the anomaly watchdog: schema-driven rules "
                        "(NaN aggregate, update-norm spike, detection-FPR "
                        "collapse, round-time regression, ...) over the "
                        "written rows; events land in the rows as "
                        "watchdog_events and trigger the flight recorder")
    common.add_argument("--watchdog-rules", default=None, metavar="JSON",
                        help="replace the watchdog's rule table with a JSON "
                        "list of rule specs, e.g. '[{\"name\": \"acc\", "
                        "\"kind\": \"collapse\", \"field\": "
                        "\"test_acc\"}]'; implies --watchdog; checked "
                        "before any trial starts")
    common.add_argument("--flightrec-rounds", type=int, default=16,
                        metavar="K",
                        help="flight recorder: a ring of the last K row "
                        "digests per trial, dumped to <trial>/"
                        "flightrec.json on a NaN aggregate, a watchdog "
                        "event, a crash or a preemption; 0 disables")
    common.add_argument("--metrics-csv", action="store_true",
                        help="also write <trial>/metrics.csv beside "
                        "metrics.jsonl")
    common.add_argument("-v", "--verbose", action="count", default=1)

    p_file = sub.add_parser("file", parents=[common],
                            help="run experiments from a YAML grid file")
    p_file.add_argument("experiment_file")
    p_file.add_argument("--checkpoint-freq", type=int, default=0)
    p_file.add_argument("--checkpoint-at-end", action="store_true")
    p_file.add_argument("--checkpoint-keep-num", type=int, default=None,
                        help="keep only the N best periodic checkpoints")
    p_file.add_argument("--checkpoint-score-attr",
                        default="training_iteration",
                        help="result key ranking checkpoints for "
                        "--checkpoint-keep-num (e.g. test_acc)")
    p_file.add_argument("--resume", action="store_true",
                        help="skip finished trials, restore in-flight ones "
                        "from their latest checkpoint")
    p_file.add_argument("--max-rounds", type=int, default=None,
                        help="override every experiment's "
                        "training_iteration")
    p_file.add_argument("--max-failures", type=int, default=0,
                        help="retry a crashed trial from its latest "
                        "checkpoint up to N times, then mark it failed and "
                        "keep sweeping")
    p_file.add_argument("--preempt-after", type=int, default=None,
                        metavar="N",
                        help="raise a SimulatedPreemption once, the first "
                        "time a trial finishes round N (between its row "
                        "write and its checkpoint save)")
    p_file.add_argument("--no-lanes", action="store_true",
                        help="disable laned execution of shape-"
                        "compatible trial groups (seed/lr/eps/scale grids); "
                        "every trial then runs sequentially")

    p_run = sub.add_parser("run", parents=[common],
                           help="run one algorithm with overrides")
    p_run.add_argument("algo", help="FEDAVG or FEDAVG_DP")
    p_run.add_argument("--config-json", default="{}",
                       help="flat/nested config overrides as JSON, e.g. "
                       "'{\"dataset_config\": {\"type\": \"mnist\"}}'")
    p_run.add_argument("--rounds", type=int, default=100)
    p_run.add_argument("--client-packing", default=None, metavar="P",
                       help="client lane-packing on the dense round: "
                       "'auto' (pack 2 clients per grouped-kernel lane "
                       "iff the width/divisibility heuristic passes, loud "
                       "fallback otherwise), an int P>=2 to force, 'off' "
                       "(default; see README \"Client packing\")")
    p_run.add_argument("--execution", default=None,
                       choices=("auto", "dense", "streamed", "async",
                                "gossip"),
                       help="execution path; 'async' runs buffered-async "
                       "cycles (a Poisson arrival process, clients training "
                       "against the version they pulled, staleness-weighted "
                       "aggregation every K buffered arrivals); 'gossip' "
                       "runs the decentralized per-node round over a peer "
                       "graph (--topology)")
    p_run.add_argument("--topology", default=None,
                       choices=("ring", "torus", "kregular", "erdos",
                                "complete"),
                       help="peer graph family for --execution gossip; "
                       "'complete' with Mean aggregates as the centralized "
                       "dense round does")
    p_run.add_argument("--mixing", default=None,
                       choices=("metropolis", "uniform"),
                       help="doubly-stochastic mixing scheme for "
                       "--execution gossip; Metropolis-Hastings weights "
                       "by default")
    p_run.add_argument("--graph-seed", type=int, default=None, metavar="S",
                       help="seed of the random graph family (--topology "
                       "erdos); part of the run's provenance, so two "
                       "processes build the same graph")
    p_run.add_argument("--arrivals-json", default=None, metavar="SPEC",
                       help="the async arrival spec as JSON (AsyncSpec "
                       "knobs, e.g. '{\"rate\": 0.25, \"agg_every\": "
                       "16}'; the seed defaults to the trial seed)")
    p_run.add_argument("--state-store", default=None,
                       choices=("resident", "host", "disk"),
                       help="where the off-cohort client state rows live; "
                       "'host' / 'disk' need --window (or --execution "
                       "async)")
    p_run.add_argument("--window", type=int, default=None, metavar="W",
                       help="participation window: clients sampled into "
                       "each round's cohort (0 = stateless clients)")
    p_run.add_argument("--data-store", default=None,
                       choices=("resident", "memmap"),
                       help="the training shards' store; 'memmap' keeps "
                       "them in CRC-checked disk shards and gathers each "
                       "cohort's rows")
    p_run.add_argument("--data-dir", default=None, metavar="DIR",
                       help="the memmap data store's shard directory (a "
                       "verified set is reused, a broken one rebuilt)")
    args = parser.parse_args(argv)

    # --watchdog-rules: parsed and checked before any trial is built.
    watchdog = args.watchdog
    if args.watchdog_rules is not None:
        try:
            specs = json.loads(args.watchdog_rules)
        except json.JSONDecodeError as exc:
            parser.error(f"--watchdog-rules is not valid JSON: {exc}")
        if not isinstance(specs, list):
            parser.error("--watchdog-rules must be a JSON list of rule "
                         f"specs, got {type(specs).__name__}")
        from blades_tpu_torch.obs.watchdog import rules_from_config

        try:
            rules_from_config(specs)
        except (ValueError, TypeError) as exc:
            parser.error(f"--watchdog-rules: {exc}")
        watchdog = specs

    from blades_tpu_torch.tune import (
        load_experiments_from_file,
        run_experiments,
    )

    common_kw = dict(storage_path=args.storage_path, verbose=args.verbose,
                     metrics_every=args.metrics_every, device=args.device,
                     metrics_csv=args.metrics_csv, trace_dir=args.trace_dir,
                     watchdog=watchdog,
                     flightrec_rounds=args.flightrec_rounds)
    if args.cmd == "file":
        experiments = load_experiments_from_file(args.experiment_file)
        kw = dict(checkpoint_freq=args.checkpoint_freq,
                  checkpoint_at_end=args.checkpoint_at_end,
                  checkpoint_keep_num=args.checkpoint_keep_num,
                  checkpoint_score_attr=args.checkpoint_score_attr,
                  resume=args.resume, max_rounds_override=args.max_rounds,
                  max_failures=args.max_failures,
                  preempt_after=args.preempt_after,
                  lanes=not args.no_lanes, **common_kw)
    else:
        run_config = json.loads(args.config_json)
        if args.client_packing is not None:
            cp = args.client_packing
            run_config["client_packing"] = (cp if cp in ("auto", "off")
                                            else int(cp))
        for key, value in (("execution", args.execution),
                           ("state_store", args.state_store),
                           ("state_window", args.window),
                           ("data_store", args.data_store),
                           ("data_dir", args.data_dir)):
            if value is not None:
                run_config[key] = value
        if (args.topology is not None or args.mixing is not None
                or args.graph_seed is not None):
            topo = dict(run_config.get("topology_config") or {})
            for key, value in (("graph", args.topology),
                               ("mixing", args.mixing),
                               ("graph_seed", args.graph_seed)):
                if value is not None:
                    topo[key] = value
            run_config["topology_config"] = topo
        if args.arrivals_json is not None:
            run_config["async_config"] = json.loads(args.arrivals_json)
        experiments = {f"{args.algo.lower()}_run": {
            "run": args.algo,
            "stop": {"training_iteration": args.rounds},
            "config": run_config,
        }}
        kw = common_kw
    if args.trace:
        from blades_tpu_torch.obs.trace import trace

        with trace(args.trace):
            summaries = run_experiments(experiments, **kw)
    else:
        summaries = run_experiments(experiments, **kw)
    best = max((s for s in summaries if s["evaluated"]),
               key=lambda s: s["best_test_acc"], default=None)
    if best:
        print(f"best trial: {best['trial']} "
              f"test_acc={best['best_test_acc']:.4f}")
    elif summaries:
        print("best trial: no trial evaluated")
    return 0

if __name__ == "__main__":
    sys.exit(main())
