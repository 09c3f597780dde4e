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
    python -m blades_tpu_torch.train file grid.yaml --autotune \
        --plan-cache-dir /tmp/plans --compile-cache /tmp/kernels
    python -m blades_tpu_torch.train file grid.yaml --autotune reassociating
    python -m blades_tpu_torch.train file grid.yaml --coordinator H:P \\
        --num-processes 4 --process-id 0      # one command per rank
    torchrun --nproc-per-node 4 -m blades_tpu_torch.train file grid.yaml
    torchrun --nproc-per-node 4 -m blades_tpu_torch.train run FEDAVG \\
        --execution hier --mesh-shape 2x2 --bucket-size 2 \\
        --config-json '{"num_devices": 4}'

``file`` runs every trial of an experiment file's grids (each eligible
group of trials that differ only in seed, learning rates, DP epsilon or
clip or IPM's scale as the lanes of one program, unless ``--no-lanes``),
``run`` one
algorithm with flat or nested config overrides (as the experiment
``<algo>_run``); both go through
:func:`~blades_tpu_torch.tune.sweep.run_experiments`, on the card unless
``--device cpu`` is given.  Each trial writes ``params.json``,
``result.json`` (one JSON row per round, or per dispatch of a trial that pins
``rounds_per_dispatch``) and ``metrics.jsonl`` (the
rows, schema-validated; ``--metrics-csv`` adds ``metrics.csv``) under
``<storage-path>/<experiment>/<trial>/``; the best trial's test accuracy is
printed last.  ``--trace-dir`` exports each trial's span tree as Chrome
trace JSON, ``--trace`` captures a ``torch.profiler`` trace around the
whole command, ``--watchdog`` / ``--watchdog-rules`` arm the anomaly
watchdog and ``--flightrec-rounds`` sizes the flight recorder.
``--scan-window`` caps the rounds per dispatch of eligible trials (one
row per round still; ``auto`` by default, 1 disables), ``--autotune``
arms the execution autotuner (``reassociating`` adds the opt-in tier),
``--plan-cache-dir`` moves its plan cache, ``--compile-cache`` names the
directory the CUDA kernels build into and load from, and
``--no-cost-analysis`` drops the summaries' counted ``cost``.
``--coordinator`` / ``--num-processes`` / ``--process-id`` (``file``)
join this process to a ``torch.distributed`` group before anything else
runs (without them torchrun's ``MASTER_ADDR`` / ``RANK`` /
``WORLD_SIZE`` are read, and a lone process joins nothing); a trial with
``num_devices`` then runs on the group's ranks, rank 0 writing its files.
``run`` joins a group from torchrun's environment alone;
``--mesh-shape CxD``, ``--preagg`` and ``--bucket-size`` (``run``) set the
ranks' grid and the hierarchical round's pre-aggregation.
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
    common.add_argument("--no-cost-analysis", action="store_true",
                        help="skip the per-trial cost analysis (one extra "
                        "dispatch on a copy of the state, counted)")
    common.add_argument("--scan-window", default="auto", metavar="W",
                        help="run eligible trials W rounds per dispatch at "
                        "most while keeping one result row per round; "
                        "'auto' (default) picks the largest safe window, 1 "
                        "disables")
    common.add_argument("--compile-cache", default=None, metavar="DIR",
                        help="build the CUDA kernels into DIR and load them "
                        "from there (default build/; also "
                        "$BLADES_TPU_TORCH_COMPILE_CACHE_DIR)")
    common.add_argument("--autotune", nargs="?", const="on", default=None,
                        choices=("on", "reassociating"),
                        help="execution autotuner: time the legal execution "
                        "plans on the card (the ranked heuristic on the "
                        "CPU) and cache the winner.  Bare --autotune tunes "
                        "the bit-exact default tier; 'reassociating' also "
                        "offers dense<->streamed and lane-packing.  "
                        "Explicit knobs are never varied")
    common.add_argument("--plan-cache-dir", default=None, metavar="DIR",
                        help="plan cache of --autotune (default "
                        "$BLADES_TPU_TORCH_PLAN_CACHE_DIR or "
                        "~/.cache/blades_tpu_torch/plans); inspect with "
                        "python -m blades_tpu_torch.tools.show_plan")
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
    p_file.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="join a torch.distributed process group at "
                        "this rendezvous (tcp://HOST:PORT; a URL such as "
                        "file:///path is taken as it is) before anything "
                        "else; without it torchrun's MASTER_ADDR / RANK / "
                        "WORLD_SIZE are read")
    p_file.add_argument("--num-processes", type=int, default=None)
    p_file.add_argument("--process-id", type=int, default=None)
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
                                "gossip", "hier"),
                       help="execution path; 'hier' runs the hierarchical "
                       "round on the ranks of num_devices; 'async' runs "
                       "buffered-async "
                       "cycles (a Poisson arrival process, clients training "
                       "against the version they pulled, staleness-weighted "
                       "aggregation every K buffered arrivals); 'gossip' "
                       "runs the decentralized per-node round over a peer "
                       "graph (--topology)")
    p_run.add_argument("--mesh-shape", default=None, metavar="CxD",
                       help="the ranks' (clients, d) grid for multi-rank "
                       "runs, e.g. '2x2'; must tile num_devices exactly")
    p_run.add_argument("--preagg", default=None, choices=("bucket", "nnm"),
                       help="the hierarchical round's per-rank "
                       "pre-aggregation (--execution hier): 'bucket' "
                       "averages disjoint buckets, 'nnm' mixes each update "
                       "with its nearest neighbors")
    p_run.add_argument("--bucket-size", type=int, default=None, metavar="B",
                       help="pre-aggregation bucket size for --execution "
                       "hier; 1 (default) is the identity: the dense "
                       "round's result")
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
    scan_window = (args.scan_window if args.scan_window == "auto"
                   else int(args.scan_window))

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
                     flightrec_rounds=args.flightrec_rounds,
                     cost_analysis=not args.no_cost_analysis,
                     scan_window=scan_window,
                     compile_cache_dir=args.compile_cache,
                     autotune=args.autotune,
                     plan_cache_dir=args.plan_cache_dir)
    if args.cmd == "file":
        if args.coordinator and (args.num_processes is None
                                 or args.process_id is None):
            parser.error("--coordinator needs --num-processes and "
                         "--process-id")
        # Before anything else touches the devices; a lone process (no
        # coordinator, no torchrun environment) joins nothing.
        from blades_tpu_torch import parallel

        parallel.init_distributed(args.coordinator, args.num_processes,
                                  args.process_id)
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
        # One process is one rank here: under torchrun's environment a
        # `run` joins its group too (no flags; a lone process joins none).
        from blades_tpu_torch import parallel

        parallel.init_distributed()
        run_config = json.loads(args.config_json)
        if args.client_packing is not None:
            cp = args.client_packing
            run_config["client_packing"] = (cp if cp in ("auto", "off")
                                            else int(cp))
        if args.mesh_shape is not None:
            try:
                c, dd = args.mesh_shape.lower().split("x")
                run_config["mesh_shape"] = (int(c), int(dd))
            except ValueError:
                parser.error("--mesh-shape must look like '4x2' "
                             f"(got {args.mesh_shape!r})")
        for key, value in (("execution", args.execution),
                           ("preagg", args.preagg),
                           ("bucket_size", args.bucket_size),
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
