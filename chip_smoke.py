#!/usr/bin/env python3
# blades-lint: disable-file=streamed-pass-discipline — each kernel is held against its plain version, and timed, on purpose
"""Chip smoke of the PyTorch/CUDA port (``blades_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, as a check runs it
    python3 chip_smoke.py --phases build,small   # a short compile-and-check

Phases, each printing its lines before the last:

1. ``build``: the card's name and power limit (``nvidia-smi``), then the
   CUDA kernels built from ``blades_tpu_torch/csrc/`` with ``nvcc`` for
   ``sm_90a`` into ``build/``.
2. ``small``: every kernel wrapper against its plain PyTorch version on a
   grid of forges x aggregators x storage types x sanitize, with a NaN row
   confined to one 512-column stripe -- the two fused finishes on their
   three routes (rows of 3000 columns on the radix route under bf16 and
   the ring route under f32, of 2999 on the bit-serial one; the route of
   every call checked) and on tie-heavy matrices (a few bf16 levels,
   signed zeros and all-equal columns, exponents spread over 2**+-40);
   the ring route's plan against ``_cuda.ring_finish_plan`` at 1 to 8,000
   rows of both dtypes and its edges (bf16 1,318 and 7,473 rows, f32 40,
   1,001 and 4,874) full and compact -- the column
   selects on their radix route (``select:radix``) at 1 to 6,000 rows
   (the 64-row group and the last resident row count, each +-1) and 3000,
   3002 and 2999 columns (16-, 8- and 4-byte copies; the route and copy
   width of every call checked, two launches bit-identical; the median
   bit-exact, the trimmed mean at cut 1 and (n-1)//2 within ``TRIM_TOL``)
   on matrices with ties, NaN of both signs, +-inf, all-equal columns and
   columns whose middle falls among NaNs -- ``row_stats_bundle`` on a grid of
   dtypes x bundles x ragged shapes on both row-statistics routes (the
   ring for 16-byte-aligned rows, 6,000 rows among them, the slab kernel
   for the rest; every call's route checked, two launches bit-identical,
   a shared weight vector bit-identical to two) and the Gram on each of its routes
   (TMA + wgmma for bf16 and int8 rows that are 16-byte aligned, ragged
   edges, a zero-padded buffer and int8 rows whose exact products pass
   2**31 included; its plan against ``_cuda.gram_plan``), and the
   BatchNorm-backward kernels
   (each pass alone and the composite ``bn_bwd``) on a grid of f32/bf16 x
   four physical layouts (the folded and the grouped vmap layouts, each
   NCHW and channels-last) x ragged shapes and the main round's stage
   shapes, each checking the thread map it must take; then a vmapped
   ResNet-10 client block over two local steps with every BN-backward
   launch audited against the plain versions on its real strides (12
   launches of each kernel per step); then small MLP rounds
   on the card against the same rounds on the CPU (Median, and each of
   the seven row-geometry aggregators under ALIE).
3. ``kernels``: each kernel against its plain version at the main path's
   shapes, with its time, the plain version's time and its bound; for the
   two finishes the padded ``(750, d_alloc)`` and ``(1000, d_alloc)``
   buffers on the radix route, with the bit-serial route on the unpadded
   matrices beside them in the same call; for the column selects the
   ``(1000, 1 << 20)`` f32 matrix and the dense ResNet-10 trial's
   ``(60, 4,903,242)`` one on ``select:radix``, each beside the bit-serial
   ``finish_kernel`` and ``torch.quantile`` on the same matrix, with the
   radix route's loads alone, passes alone and streaming plan; for
   ``row_stats_bundle`` the bundles of the row-geometry round on its
   padded ``(1000, d_alloc)`` buffer (the Multikrum Gram, with the old
   route on the unpadded matrix and ``torch.mm`` on both beside it, and
   the Gram at three more shapes; the wire's int8 Gram on a synthetic
   ``(1000, 4,903,248)`` payload on ``gram:wgmma`` and ``gram:mma`` in
   turns, bit-exact, beside ``torch._int_mm``, and at three more shapes;
   GeoMed's weighted sum + Gram-vector
   product, the weighted sum alone, sign counts and dots on the ring
   route, each beside the slab route on the unpadded matrix, and the
   ring's time by part of its work); for the
   BN pair the four stage layers of ResNet-10 at G = 50, B = 32, bf16,
   channels-last, beside ``native_batch_norm_backward``.  Every time is
   device-only (:func:`timed`); the host us per call are printed apart.
4. ``main``: the headline round -- ResNet-10, 1000 clients of CIFAR-10
   shapes, the first 250 running ALIE, exact coordinate-wise Median, bf16
   compute and storage, ``client_block=50``, ``malicious_prefix=250`` --
   one warm-up round and 3 timed rounds through the compact fused finish
   on its ``(750, d_alloc)`` buffer, on the radix route;
   180 launches of each BN kernel per round, all on the vector map.
4b. ``wide``: ``main``'s protocol where the radix route cannot hold the
   compact buffer -- (a) 2,000 clients, bf16 (1,500 rows), (b) 1,000
   clients, f32 updates (750 rows) -- one warm-up and 2 timed rounds, each
   on ``finish:ring`` once, every launch held against the plain version
   and against the bit-serial ``finish_kernel`` on the round's buffer, the
   two kernels timed there in turns (parent, change, change, parent);
   then the same rounds with every finish sent to ``finish_kernel`` (the
   parent's routing): rounds/s and peak of both.
5. ``full``: one ResNet-10 round at 200 clients with no malicious prefix,
   through the full fused finish on a ``(200, d_alloc)`` buffer, on the
   radix route.
6. ``aggregators``: the ``Median`` and ``Trimmedmean`` aggregators on a
   ``(1000, 1 << 20)`` f32 matrix, each through ``select:radix`` once.
7. ``rowgeom``: the row-geometry round -- the ``main`` configuration with
   ``Multikrum(num_byzantine=250)`` in place of Median, one warm-up and 2
   timed rounds, then one round of ``GeoMed()`` -- through the pass
   planner's ``row_stats_bundle`` calls, on a ``(1000, d_alloc)`` buffer,
   the Multikrum Gram once per round on the TMA + wgmma route, the row
   statistics on the ring route (once per Multikrum round, 1 + iterations
   per GeoMed round, never the slab route); and the
   average-linkage
   clustering loop at 1000 clients, timed.
8. ``fedavg``: the Fedavg driver through ``FedavgConfig``: the dense
   ResNet-10 trial of ``fedavg_cifar10_resnet_noniid.yaml`` (60 clients,
   Dirichlet 0.1, 15 SignFlip then 15 LabelFlip, Median, f32, two local
   steps, 3 rounds and an evaluation; the Median on ``select:radix``
   once a round), the 1000-client streamed trial of
   ``fedavg_cifar10_1000clients.yaml`` (ALIE, Median, bf16, 2 rounds and
   an evaluation), the same trial with client momentum 0.9 (still
   ``finish:radix`` once a round; the 250 elided lanes' traces stay zero,
   every trained lane's move; round 1's ``agg_norm`` equal to the
   momentum-free run's, round 2's not), and the MLP accuracy check (test
   accuracy >= 0.9 after 3 rounds); each prints rounds/s, losses,
   accuracy and peak memory.
9. ``chunked``: the streamed round's chunked finish and its route gate:
   the gate's Python plan mirrors against ``bt_finish_plan`` on both sides
   of each cap (radix bf16 1,317 rows; bit-serial f32 4,874, bf16 7,473);
   through ``FedavgConfig`` / ``FedavgDPConfig`` -> ``Fedavg.train()``, the
   1000-client streamed trial with 250 ``Noise`` clients (elided) and the
   same trial under DP (ALIE, epsilon 10), 2 rounds each, each round on
   ``finish:chunked`` over the full ``(1000, d_alloc)`` buffer with
   ``select:radix`` once per column chunk (38 a round) and the first round
   bit-exact against the plain chunked finish; ``fedavg_dp.yaml``'s dense
   MLP trial (60 clients, Mean, 3 rounds); an f32 streamed MLP round at
   6,000 clients (above the old 4,874-row cap) on ``finish:chunked``,
   bit-exact against its plain version; then, device-only, the chunked
   finish's ms on the main buffer beside the fused full and compact
   finishes, and one chunk's ``select:radix`` beside its plain version
   and ``torch.quantile``.
10. ``sweep``: the ``file`` entry point, ``blades_tpu_torch.train.main(
   ["file", fedavg_cifar10_1000clients.yaml, "--max-rounds", "2", ...])``
   (the YAML read as a data file): three trials (Mean, Median,
   Trimmedmean) of 1000 clients, 250 ALIE elided, bf16, streamed, each on
   ``finish:radix`` once a round, finite losses, ``round_ok``, the rows
   verified and the device memory back near its baseline after each
   trial's ``stop()``; ``local20_cnn_fashion_mnist.yaml`` for 2 rounds (20
   clipped local steps, the dense Median on ``select:radix``); then the
   Median point again through ``run_experiments`` with a checkpoint every
   round and a preemption after round 2 (one retry): the parameters
   restored from round 1's checkpoint bit-identical to those saved, the
   rows without gap or duplicate, round 2's ``train_loss`` and
   ``agg_norm`` equal to the straight run's.  Every finish and select of
   these runs, and the grid's first-round BN launches, are held against
   the plain versions on their own operands as the path runs
   (``_PathAudit``, ``_BnAudit``).
11. ``resnet34``: the DnC point of ``fedavg_cifar100_resnet34.yaml``
   through ``run_experiments``, one dispatch of 3 rounds (the file's
   ``rounds_per_dispatch`` of 10 cut to 3 to keep the script near half
   its time limit): ResNet-34 x 1000 clients of CIFAR-100 shapes,
   200 Adaptive elided, f32 compute, the bf16 ``(1000, 21,328,384)``
   buffer, ``client_block`` 50 (25 only if 50 runs out of memory), with
   peak memory, rounds/s and the launches a round (DnC's weighted sum on
   ``rowstats:ring``, every one held against the plain version over
   column slices of the buffer; the BN pair, the first round's launches
   audited); then one dense round of ResNet-50 at 20 clients of CIFAR-10
   shapes in bf16, every BN-backward launch at its Bottleneck shapes and
   the Median's select audited against the plain versions, the BN
   launches on the vector map.  The audits' seconds are taken out of the
   rounds/s and their allocations out of the peaks these phases report.
12. ``cct``: ``blades_tpu_torch.train.main(["file",
   fedavg_cct_cifar10.yaml, "--max-rounds", "3", ...])`` on a copy of the
   file whose evaluation runs at round 3 and whose health check is on:
   its six points (Mean, Median, Clippedclustering x ALIE, IPM(100)), the
   catalog's ``cct_2_3x2_32`` (d = 284,491) x 60 clients of CIFAR-10
   shapes, 12 malicious, train_bs 64, the dense f32 round; each trial's
   rows verified, finite losses, ``round_ok``, a finite test accuracy,
   ``select:radix`` once a Median round on the (60, 284,491) matrix and
   no kernel in the others, rounds/s, setup seconds and peak memory; then
   one dense Median round (60 clients, 12 ALIE) of ``cct_7_3x1_32_c100``
   on CIFAR-100 shapes (d = 3,788,645, blocks of 10) and of
   ``cvt_7_4_32`` (d = 3,721,995).  Every select of the phase is held
   bit-exact against the plain version on the path's own operands
   (``_PathAudit``).
13. ``wire``: the update codecs, the wire domain and the fault
   injector through ``FedavgConfig`` -> ``Fedavg.train()``: the dense
   round at ``fedavg_cifar10_1000clients.yaml``'s widths (ResNet-10 x
   1000 clients of CIFAR-10 shapes, 250 ALIE, bf16 compute) under quant
   int8 on the wire, Multikrum and Median for 2 rounds, GeoMed for 1:
   every int8 bundle of the planner (the Gram on ``gram:wgmma``, the rest
   on ``rowstats:ring``, never ``rowstats:slab``) and every select of the
   Median's decoded chunks (38 a round) held against the plain version,
   each round's aggregate against the port's decode-then-f32 aggregate of
   the same payload, the peak memory; the same round at 500 clients in
   the wire and the f32 domain, in turns (rounds/s); the dense 60-client
   ResNet-10 trial of ``fedavg_cifar10_resnet_noniid.yaml`` under top-k
   1% + error feedback, killed after round 2 and resumed (residual,
   parameters and rows bit-identical to the straight run), and under the
   fault injector with the health check (round 1 at full participation,
   rounds 2-3 with dropout, each Median on ``select:radix``); the MLP
   flow's test accuracy >= 0.9 under top-k 2% (round 6) and quant int8
   on the wire (round 3).
14. ``async``: buffered-async execution through ``FedavgConfig`` ->
   ``Fedavg.train()`` at ResNet-10 x 1000 registered clients of CIFAR-10
   shapes (``fedavg_cifar10_1000clients.yaml``'s partition, batch 32, one
   local step, bf16 compute, 250 malicious, events in blocks of 25):
   K = 100 events a cycle from a buffer of 200, ring depth 8, polynomial
   staleness weights, rate 0.05 with the slowest fifth at a quarter of
   it.  Three trials: ALIE + Median for 4 cycles, then killed after cycle
   2 and resumed from its checkpoint (cycles 3-4, parameters, the params
   ring and the engine's host state equal to the straight run's);
   DiurnalALIE (8-tick days) + Trimmedmean with dropout 0.3 from the tick
   that ended the first cycle, 3 cycles; Lazy replay + Mean, 2 cycles, its
   malicious events reading ring row 8.  Every select (``select:radix`` on
   the staleness-scaled ``(100, 4,903,242)`` rows, once a Median or
   Trimmedmean cycle) and every BN launch (per-lane parameters from step
   0, 48 of each kernel a cycle) held against the plain versions; cycles/s,
   ``updates_per_sec``, staleness histograms and peak memory printed.
15. ``window``: the participation window through ``Fedavg.train()``:
   ResNet-10, 1000 registered clients, cohorts of 100, client momentum
   0.9, ALIE + Median, 3 rounds on the ``host`` store (19.6 GB of
   momentum rows in pinned host memory) and 3 on the ``resident`` store,
   in turns, their parameters equal bit for bit (cuDNN deterministic in
   this phase); then 200 registered clients on the ``disk`` store and the
   ``memmap`` data store, evaluation in chunks of 64, killed after round 2
   and resumed from the 3.9 GB shard checkpoint, round 3 equal to a
   straight run's.  Every select and BN launch held against the plain
   versions; ``state_stage_ms``, ``state_bytes_staged``,
   ``state_peak_hbm_bytes``, rounds/s and peak memory printed.
16. ``obs``: forensics, the metrics streams, spans, the watchdog, the
   flight recorder, the client ledger and the control plane at full
   width, cuDNN deterministic.  (a) ``train.main(["file", ...])`` on a
   copy of ``fedavg_cifar10_resnet_noniid.yaml`` written to
   ``chiprun_out/obs/`` with ``forensics: true``, cut to its Trimmedmean
   and Multikrum points under ALIE (15 of 60, alpha 0.1) and 3 rounds,
   with ``--trace-dir``, ``--watchdog``, ``--metrics-csv`` and
   ``--flightrec-rounds 4``: each trial's ``metrics.jsonl`` and trace
   validated; then the Trimmedmean point with forensics on and off, 2
   rounds each in turns, parameters equal bit for bit (rounds/s of both).
   (b) the ``async`` phase's configuration under DiurnalALIE +
   Trimmedmean with forensics, the resident ledger and the default
   control policy (the watchdog's ``fpr_collapse`` ceiling at 0, so the
   quarantine fires in cycle 1) beside a forensics-off twin, 4 cycles in
   turns (cycles/s of both); then killed after cycle 2 and resumed:
   cycles 3-4 equal to the straight run's (parameters, ring, host state,
   forensics, ledger fields, control actions, the quarantine set).  (c)
   cohorts of 100 of 1000, Median, forensics and the ``disk`` ledger, 2
   rounds; its shard checkpoint validated.  (d) the MLP trial under the
   fault injector's NaN corruption, the health check off:
   ``nan_aggregate`` fires and ``flightrec.json`` validates.  Every
   select (``column_trimmed_mean:obs``, ``column_median:obs``, the
   launches of (a)-(c) together) and BN launch held against the plain
   versions, the BN pair recorded per path (``bn_bwd_reduce:obs`` and
   ``bn_bwd_dx:obs`` for (a), ``...:obs-async`` for (b),
   ``...:obs-window`` for (c)); the ledger's ``host_bytes`` printed.
17. ``gossip``: decentralized gossip through ``FedavgConfig`` ->
   ``Fedavg.train()`` and ``train.main``, cuDNN deterministic, at
   ResNet-10 x 64 nodes of CIFAR-10 shapes (bench.py's gossip protocol:
   ALIE on a quarter, Median, batch 32, one local step, f32, blocks of
   32 lanes each from its own replica): (a) kregular k = 4 (k1 = 5),
   Metropolis mixing, one warm-up round and 3 timed, one
   ``select:radix`` launch a round over the ``(5, 64 * d)`` slot-major
   matrices, the recorder's collectives reconciled with
   ``gossip_round_volumes`` on a ring of one (``gossip_ici_bytes`` 0),
   node 0's test accuracy; (b) the ring under ``TopologyAttack`` wrapping
   ALIE with ``eclipse_target=0``, every slot of every receiver's matrix
   held against the victim-only poisoning; (c) Multikrum(f = 1) on
   kregular, 2 rounds; (d) (a) under edge dropout 0.2 through
   ``train.main(["file", ...])`` for 4 rounds (preempted after round 4,
   so the flight recorder dumps), 2 rounds, a checkpoint, a fresh driver
   and 2 more, equal to the trial's rounds 3-4 bit for bit, then
   ``python -m blades_tpu_torch.tools.replay_round`` on the dump in its
   own process (exit 0) and the port's ``validate_metrics`` on the
   trial's files; (e) bench.py's A/B: 32 nodes, the CNN, centralized
   dense against ring against kregular, in turns, rounds/s after a
   warm-up.  Every select (``column_median:gossip``,
   ``column_median:gossip-ab``) and BN launch (``bn_bwd_reduce:gossip``,
   ``bn_bwd_dx:gossip``) held against the plain versions.
18. ``lanes``: trial lanes and client lane-packing: (a)
   ``fedavg_dp.yaml``'s 15 trials as one lane group beside seed 121's
   three one by one; (b) the ResNet-10 point over 4 seeds laned and
   sequential, bit for bit; (c) the packed ResNet-10 and CNN rounds.
19. ``autotune``: the execution autotuner, cuDNN deterministic.  (a) The
   ``fedavg`` phase's 1000-client streamed ResNet-10 trial (ALIE, Median)
   with ``autotune=True``: the plan space, each candidate's median
   seconds a round and peak memory (each candidate a driver of its own,
   stopped before the next), the winner; its 2 rounds equal an untuned
   run's bit for bit; a second build is served from the plan cache
   (``cache_hit``, no candidate timed); ``show_plan list``.  (b) The
   Fashion-MNIST CNN at 5,000 f32 clients (100 ALIE), whose round takes
   the chunked finish: the ``d_chunk`` ladder timed, and each candidate's
   round (parameters and rows) equal to the untuned round bit for bit;
   then the chunked finish alone on random (5,000 and 1,237 rows, d_alloc)
   f32 buffers, Median / Trimmedmean / Mean x ALIE / IPM, parameters and
   row metrics equal across the ladder bit for bit.  (c) The dense ResNet-10
   x 60 trial through ``train.main(["file", ..., "--autotune",
   "reassociating"])`` (dense / streamed, pack 1 / 2 / 4, prefetch on /
   off), preempted after round 2 and resumed: the resumed trial pins the
   plan its checkpoint recorded.  (d) The headline dispatch's
   ``cost_analysis()``, a 2-round ``accuracy_curves`` grid and a 2-round
   ``gossip_curves`` run on the synthetic fallback.  (e) The default
   tier's other knobs on the dense ResNet-10 x 60 trial: prefetch on and
   off, and a 3-round scan window through ``file`` against
   ``--scan-window 1``, each pair bit for bit.
20. ``mesh``: the rounds on the ranks of a ``torch.distributed`` group,
   one process a rank started by this script (``--mesh-part``), every
   rank on ``cuda:0`` (one card: NCCL takes one rank a card, so the
   multi-rank groups run over gloo, which stages each collective through
   the host), cuDNN deterministic.  On the ``fedavg`` phase's dense
   ResNet-10 x 60 trial under ALIE + Median in client blocks of 30:
   (a) ``num_devices=2``, the client-sharded round, one round, then
   the one-process dense round on rank 0 (the other rank waiting), bit
   for bit; launches per rank, rounds/s of both, the gather's bytes and
   ms; (b) ``execution="hier"`` on a (2, 2) mesh of 4 ranks: at
   ``bucket_size=1`` the dense round bit for bit, bucket and nnm at 2
   with ``ici_bytes`` = ``hier_wire_bytes(hier_round_volumes(...))``,
   and both pre-aggregations timed alone on a rank's block; (c) one NCCL rank
   through ``sharded_step``, the dense round bit for bit.  Then the
   ``gossip`` phase's headline trial (64 nodes, 2 rounds): (d)
   ``num_devices=2``, each rank's 32 nodes one block, then the
   one-process stacked round on rank 0, bit for bit, one ``select:radix``
   a rank a round, ``gossip_ici_bytes`` = 1,255,230,208 a rank a round
   (``gossip_round_volumes`` for (2, 1)), the gathers timed; (e)
   ``gossip_step`` on a group of one NCCL rank, the stacked driver bit
   for bit.  (f) the execution autotuner on 2 gloo ranks: ResNet-10 x 32,
   ALIE + Median, ``autotune="reassociating"`` over a fresh plan cache,
   5 candidates (the flat round and the hierarchical round on (2, 1))
   built and timed in lockstep; both ranks on rank 0's winner and
   provenance, its rounds equal to the ``tuned_plan`` run's bit for bit,
   the second build a cache hit on both ranks with no candidate built,
   only rank 0's cache directory written.  (a) runs beside (e), (b)
   alone, (f) beside (c), then (d) alone.  Every select (``column_median:mesh``,
   ``column_median:mesh-gossip``) and BN launch (``bn_bwd_reduce:mesh``,
   ``bn_bwd_dx:mesh``, ``...:mesh-gossip``) of (a), (b) at 2, (c), (d),
   (e) and (f) held against the plain versions.  A rank that fails fails
   the phase.
21. ``dsharded``: the width-sharded round (``execution="dsharded"``) on
   ranks started as in ``mesh``, cuDNN deterministic: (a)
   ``fedavg_cifar10_1000clients_mesh.yaml``'s three points (Median,
   Multikrum, Signguard), read with the port's YAML reader, at full
   ResNet-18 width (d = 11,173,962) cut to 64 clients (16 ALIE, 8 elided a
   rank), client blocks of 8, the health check, one dispatch of 2 rounds
   on 2 gloo ranks sharing ``cuda:0``, each in turns with the one-process
   dense round on rank 0 over the elision-ordered federation: Median bit
   for bit or within ``RTOL`` / ``ATOL`` (the phase prints which),
   Multikrum the same selected clients, Signguard the same mask, each
   round-1 aggregate within ``RTOL`` / ``ATOL``; the all-to-all's bytes
   and ms a rank (timed in the rounds), peak memory a rank, rounds/s of
   both; (b) a group of one NCCL rank, the script's own process, through
   ``dsharded_step`` at 256 clients (64 elided) under Median, the dense
   round bit for bit, peak memory.  Every
   select (``column_median:dsharded``, ``column_median:dsharded-nccl``)
   and BN launch (``bn_bwd_reduce:dsharded``, ``bn_bwd_dx:dsharded``, and
   ``...:dsharded-nccl``) of (a)'s Median turn and of (b) held against
   the plain versions; the launches per rank and round derived from the
   model (its BN layers x trained client blocks, one select a Median
   round), a missing or extra one failing the run.  Each point's
   collectives, counted on the step's recorder, equal
   ``dsharded_round_volumes`` as a multiset; a projection of 8 cards
   (``project_multichip_rounds_per_sec`` from (b)'s measured rate at the
   H100 data-sheet NVLink figure) is printed, labelled as a model.
22. ``profile`` (only when named): one more main-path round, one
   Multikrum round of phase 7 and one GeoMed round, under
   ``torch.profiler``; device time by kernel goes to
   ``chiprun_out/profile_main.txt``, ``profile_rowgeom.txt`` and
   ``profile_geomed.txt``.
23. ``bnstages`` (only when named): the BN kernels alone at the four stage
   shapes, device-only, beside the profiler's kernel durations and the
   host us per call.  With ``--port DIR`` every phase drives the package
   in DIR (another tree's), so one call can time two versions.
24. ``ringsweep`` (only when named): the row-statistics ring across
   geometries (slab bytes, group rows, groups in flight) for the four
   bundles the planner issues on the row-geometry round's buffer; the
   table goes to
   ``chiprun_out/ringsweep.txt``.

Launch counts are set to 0 just before each of phases 4-21 (and before
each round of phase 7, each trial of phases 8 to 17 and each driver of
phases 20 and 21, in every rank) and read just
after; each path's count goes to its own record (``column_median:local20``,
``column_median:cct``,
``row_stats_bundle:wsum:resnet34``, ``bn_bwd_reduce:resnet50``,
``row_stats_bundle:gram:int8:wire``, ``column_median:async``,
``bn_bwd_dx:window``, ``column_trimmed_mean:obs``,
``column_median:gossip``, ...),
timed at that path's operands; a
kernel of the phase that did not launch, or launched another number of
times than its path must, fails the run.  The last
three lines are the card (``nvidia-smi``), one JSON object with every
kernel's numbers, and ``{"ok": true, "device": ...}``.  Any failure exits
non-zero before those lines.  Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import functools
import importlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "small", "kernels", "main", "wide", "full", "aggregators",
          "rowgeom", "fedavg", "chunked", "sweep", "resnet34", "cct",
          "wire", "async", "window", "obs", "gossip", "lanes", "autotune",
          "mesh", "dsharded")
EXTRA_PHASES = ("profile", "bnstages", "ringsweep")  # run only when named

# H100 SXM peaks (NVIDIA's data sheet): device-memory rate, and the f32
# rate outside the tensor cores, which is where these kernels' arithmetic
# (sums, compares) runs.  A kernel's bound counts each input byte it must
# read once and each output byte once, and the operations the function
# needs per element (statistics, row norms, at least one compare per
# element for a selection).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12  # the Gram's bf16 products on the tensor cores

# Tolerances of a kernel against its plain version on the same inputs.
# Order statistics, counts and flags are exact.  Values computed from the
# benign mean/variance (the forged row and what the aggregate takes from
# it) are f32 sums in another order: rtol 1e-5 / atol 1e-6 under f32
# storage; under bf16 storage the forged row is rounded to bf16, so a
# last-ulp f32 difference can move it by one bf16 ulp (at most 2**-7 of
# it).  Row norms are f32 sums over up to 4.9M terms in another order:
# rtol 1e-4.  Trimmed means are f32 sums over the kept values in another
# order: rtol 1e-5, atol 1e-5 (inputs of unit scale).
RTOL, ATOL = 1e-5, 1e-6
SQ_RTOL = 1e-4
TRIM_TOL = 1e-5
# Row statistics (sums over up to 4.9M terms, the kernel's split and order
# against the plain chunk loop's): within 1e-4 of the magnitude of the
# summands, |X| in place of X.
ROW_RTOL = 1e-4

# ResNet-10's width, and the streamed round's buffer width (both the fused
# finish's and the row-geometry round's): padded to 512-column stripes, as
# the JAX package allocates it.
RESNET10_D = 4_903_242
RESNET10_D_ALLOC = -(-RESNET10_D // 512) * 512

TIMED_ROUNDS = 3  # main-path rounds timed after one warm-up round
# BN-backward launches of each kernel per headline round: 750 trained
# clients / 50 per block x 12 BN layers x 1 local step.
BN_PER_ROUND = 15 * 12
ROWGEOM_ROUNDS = 2  # Multikrum rounds timed after one warm-up round
REPS = 5          # timed launches per kernel, after one warm-up launch
BN_REPS = 50      # the same for the sub-millisecond BN kernels
# torch.cuda._sleep spins for a number of clock cycles: at least this many
# per millisecond (the H100's highest SM clock, 1.98 GHz).
SLEEP_CYCLES_PER_MS = 2.0e6


# The whole log also goes to chiprun_out/chip_smoke.log (main() opens
# it), beside the phases' other output files, for runs whose output is
# read from its end only.
LOG_FILE = []


def log(msg: str) -> None:
    print(msg, flush=True)
    for fh in LOG_FILE:
        fh.write(msg + "\n")
        fh.flush()


class Failure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Comparisons
# --------------------------------------------------------------------------

def max_err(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = (a - b).abs().masked_fill(both_nan, 0.0)
    return float(d.max()) if d.numel() else 0.0


def same(a, b, what: str) -> float:
    import torch

    if not a.is_floating_point():
        ok = torch.equal(a, b)
    else:
        ok = torch.equal(a.isnan(), b.isnan()) and torch.equal(
            a.masked_fill(a.isnan(), 0), b.masked_fill(b.isnan(), 0))
    check(ok, f"{what}: not bit-exact (max err {max_err(a, b)})")
    return 0.0


def close(a, b, what: str, rtol=RTOL, atol=ATOL, forged=None,
          bf16=False) -> float:
    """``|a - b| <= atol + rtol |b|`` (equal infinities agree); with
    ``forged`` under bf16 storage the slack grows by one bf16 ulp of the
    forged value, per column."""
    import torch

    a, b = a.double(), b.double()
    slack = atol + rtol * b.abs()
    if bf16 and forged is not None:
        slack = slack + 2.0 ** -7 * forged.double().abs() + 2.0 ** -6 * b.abs()
    bad = ~((a - b).abs() <= slack) & ~(a.isnan() & b.isnan()) & ~(a == b)
    if bool(bad.any()):
        i = torch.nonzero(bad).flatten()[:5].tolist()
        raise Failure(f"{what}: {int(bad.sum())} values out of tolerance, "
                      f"e.g. at {i}: {a.flatten()[i].tolist()} vs "
                      f"{b.flatten()[i].tolist()}")
    return max_err(a, b)


def timed(fn, reps: int, syncs: bool = False):
    """``(device ms, host us)`` per run of ``fn`` over ``reps`` runs, after
    one warm-up run.

    Device-only: the runs are enqueued behind a ``torch.cuda._sleep`` long
    enough for the host to enqueue them all, so the CUDA events bracket
    device work alone, not the host's dispatch between launches.  That
    holds when the start event is still pending once the host has
    enqueued the end event; the sleep grows until it does.  Host us: the
    host's seconds to enqueue one run (dispatch, wrapper, launch), from a
    first pass without the sleep.  ``syncs``: ``fn`` synchronizes inside
    (an ``.item()``), so nothing can be queued ahead of the device; its
    events then include the host's gaps between runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_ms = 2.0 * host_s * 1e3 + 2.0
    for _ in range(4):
        if not syncs:
            torch.cuda._sleep(int(sleep_ms * SLEEP_CYCLES_PER_MS))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead or syncs:
            return start.elapsed_time(end) / reps, host_s / reps * 1e6
        sleep_ms *= 4
    raise Failure("timed: the host never got ahead of the device")


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_build():
    from blades_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    lib = _cuda.build()
    _cuda.library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    ptxas = lib.parent / f"{lib.stem}.ptxas.txt"
    if ptxas.exists():
        # The whole report goes to chiprun_out/ptxas.txt; the log names the
        # kernel count and every kernel that spills.
        text = ptxas.read_text()
        out = os.path.join(HERE, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "ptxas.txt"), "w") as fh:
            fh.write(text)
        entry, kernels = None, 0
        for line in text.splitlines():
            if "entry function" in line:
                entry, kernels = line.split("'")[1], kernels + 1
            elif "spill" in line and not line.strip().startswith("0 bytes"):
                log(f"  ptxas: {entry}: {line.strip()}")
        log(f"  ptxas: {kernels} kernels (report in chiprun_out/ptxas.txt)")


# Matrices of the finish's small cases: unit-scale draws, and tie-heavy
# ones -- a few bf16 levels (long runs of equal keys across both trimmed
# cuts), +0 / -0 mixed with all-equal columns (where ALIE's forged value
# equals every key, so the forged key is the k-th key), and exponents
# spread over 2**-40..2**40 with infinities and NaNs of both signs, some
# columns mostly NaN or -inf (the no-forge median only:
# sums at that spread cancel, so only order statistics compare exactly).
SMALL_KINDS = ("randn", "levels", "zeros", "spread")


def _small_matrix(gen, kind, rows, d, dtype, poison):
    import torch

    dev = "cuda"
    if kind == "randn":
        x = torch.randn((rows, d), generator=gen, device=dev) * 0.05
    elif kind == "levels":
        lv = torch.tensor([-0.5, -0.125, 0.0, 0.125, 0.25], device=dev)
        x = lv[torch.randint(0, 5, (rows, d), generator=gen, device=dev)]
    elif kind == "zeros":
        x = torch.zeros((rows, d), device=dev)
        x[torch.rand((rows, d), generator=gen, device=dev) < 0.5] = -0.0
        x[:, 1::3] = 0.375
    else:
        e = torch.randint(-40, 40, (rows, d), generator=gen, device=dev)
        x = torch.randn((rows, d), generator=gen, device=dev) * torch.exp2(
            e.float())
        x[0, 3] = float("inf")
        x[1, 4] = -float("inf")
        # NaN of both signs, and columns whose middle falls among NaNs of
        # either sign or among -infs (the digit buckets NaN shares).
        h = rows // 2 + 2
        x[6, 20], x[7, 21] = float("nan"), -float("nan")
        x[:h, 22] = -float("nan")
        x[:h, 23] = float("nan")
        x[:h, 24] = -float("inf")
        x[:, 25] = -float("nan")
    if poison:
        x[2, 600] = float("nan")      # stripe 1 only
        x[5, 7] = float("inf")        # stripe 0 only
        x[rows - 1, d - 1] = -float("nan")  # the ragged last stripe
    return x.to(dtype).contiguous()


def _finish_routes() -> dict:
    """The finish launches so far, by (wrapper name, route)."""
    from blades_tpu_torch.ops import _cuda

    return {k: v for k, v in _cuda.MAPS.items() if k[1].startswith("finish:")}


def _took_route(before: dict, name: str, route: str, what: str) -> None:
    took = {k: v - before.get(k, 0) for k, v in _finish_routes().items()
            if v != before.get(k, 0)}
    check(took == {(name, "finish:" + route): 1},
          f"{what}: finish routes {took}, expected {route} once")


# (dtype, d) of the finish's small cases and the route each must take:
# rows of 3000 columns are 16-byte aligned (bf16 radix, f32 ring), of 2999
# not (bit-serial).
SMALL_FINISH = (("float32", 3000, "ring"), ("float32", 2999, "bitserial"),
                ("bfloat16", 3000, "radix"), ("bfloat16", 2999, "bitserial"))


def _small_finish(gen) -> int:
    """Both finishes against their plain versions on every forge x
    aggregator x sanitize x rows case of :data:`SMALL_FINISH` and
    :data:`SMALL_KINDS`: bad flags and the no-forge median bit-exact,
    the rest within :func:`close`; each call's route checked."""
    import torch

    forges = [None, ("alie", 0.7), ("ipm", 1.5), ("adaptive", 2.0)]
    aggs = [("mean",), ("median",), ("trimmed", 3)]
    cases = 0
    for kind in SMALL_KINDS:
        for dt, d, route in SMALL_FINISH:
            dtype = getattr(torch, dt)
            bf16 = dtype == torch.bfloat16
            for sanitize in (False, True):
                for rows in (37, 40):
                    x = _small_matrix(gen, kind, rows, d, dtype, sanitize)
                    noise = torch.rand((d,), generator=gen, device="cuda")
                    mal = torch.rand((rows,), generator=gen,
                                     device="cuda") < 0.3
                    for forge in forges:
                        for agg in aggs:
                            if kind == "spread" and (
                                    forge is not None or agg[0] != "median"):
                                continue  # exact medians only
                            cases += _small_finish_case(
                                x, mal, noise, forge, agg, sanitize, bf16,
                                route, f"{kind} {dt} d={d} rows={rows} "
                                f"san={sanitize} forge={forge} agg={agg}")
    return cases


# The ring route's edges in the small phase: (dtype, rows, route) on
# aligned (rows, 1024) matrices -- radix's last bf16 row count and the
# ring above it (resident), bf16 at the fused finish's cap (streaming), f32
# at 40 rows, at an odd count and at the cap (streaming) -- each on every
# kind of ``RING_EDGE_KINDS``.
RING_EDGE_KINDS = ("randn", "levels", "spread")
RING_PLAN_ROWS = 8000  # bt_finish_plan vs ring_finish_plan, rows 1 to this


def _small_finish_rows(gen) -> int:
    """The finish's row capacities and the ring route's edges.
    ``_cuda.radix_smem``'s count of the rows that fit (1,317) agrees with
    the radix kernel's launch plan; ``_cuda.ring_finish_plan`` agrees with
    the ring kernel's (``bt_finish_plan``: geometry and shared memory) at
    every row count up to :data:`RING_PLAN_ROWS` in both dtypes.  Aligned
    bf16 matrices of 1,317 rows take ``finish:radix``, of 1,318 and 7,473
    ``finish:ring``; aligned f32 ones of 40, 1,001 and 4,874 rows
    ``finish:ring``; unaligned ones of 1,400 bf16 and 1,001 f32 rows
    ``finish:bitserial``.  Each is held against its plain version on
    unit-scale, tie-heavy and spread (NaN, inf) matrices, full and compact
    (ALIE under Median and Trimmedmean, sanitize on; the no-forge median
    bit-exact on the spread ones)."""
    import ctypes

    import torch

    from blades_tpu_torch.ops import _cuda

    cap = max(r for r in range(1, 4096)
              if _cuda.radix_smem(r, 2) <= _cuda.RADIX_SMEM_CAP)
    lib = _cuda.library()
    outs = [ctypes.c_int() for _ in range(3)]
    for rows, fits in ((cap, True), (cap + 1, False)):
        err = lib.bt_finish_plan(1, _cuda.FINISH_ROUTES["radix"], rows, 1024,
                                 *[ctypes.byref(o) for o in outs])
        check((err == 0) == fits, f"radix plan for {rows} rows: error {err}, "
              f"radix_smem says {'fits' if fits else 'does not fit'}")
    for dt, esize in ((1, 2), (0, 4)):
        for rows in range(1, RING_PLAN_ROWS + 1):
            err = lib.bt_finish_plan(dt, _cuda.FINISH_ROUTES["ring"], rows,
                                     1024, *[ctypes.byref(o) for o in outs])
            plan = _cuda.ring_finish_plan(rows, esize)
            check(err == 0 and (outs[0].value, outs[1].value)
                  == (plan.geom, plan.smem),
                  f"ring plan for {rows} rows of {esize} bytes: error {err}, "
                  f"geometry {outs[0].value:#x} in {outs[1].value} B on the "
                  f"card, {plan} in Python")
    cases = 0
    edges = ((torch.bfloat16, 1024, cap, "radix"),
             (torch.bfloat16, 1024, cap + 1, "ring"),
             (torch.bfloat16, 1024, 7473, "ring"),
             (torch.bfloat16, 1020, 1400, "bitserial"),
             (torch.float32, 1024, 40, "ring"),
             (torch.float32, 1024, 1001, "ring"),
             (torch.float32, 1024, 4874, "ring"),
             (torch.float32, 1023, 1001, "bitserial"))
    for dtype, d, rows, route in edges:
        bf16 = dtype == torch.bfloat16
        for kind in RING_EDGE_KINDS:
            x = _small_matrix(gen, kind, rows, d, dtype, True)
            mal = torch.rand((rows,), generator=gen, device="cuda") < 0.3
            tag = f"{dtype} d={d} rows={rows} {kind}"
            if kind == "spread":  # exact medians only
                cases += _small_finish_case(x, mal, None, None, ("median",),
                                            True, bf16, route, tag)
                continue
            for agg in (("median",), ("trimmed", rows // 5)):
                cases += _small_finish_case(
                    x, mal, None, ("alie", 0.7), agg, True, bf16, route,
                    f"{tag} agg={agg}")
    log(f"small: the radix route fits {cap} rows, as its launch plan does; "
        f"ring_finish_plan equals the ring kernel's plan at 1-"
        f"{RING_PLAN_ROWS} rows of both dtypes; {cap} aligned bf16 rows take "
        f"finish:radix, {cap + 1} and 7473 finish:ring, aligned f32 rows "
        "40 / 1001 / 4874 finish:ring, unaligned ones finish:bitserial, all "
        "agreeing with the plain version (randn, levels, spread)")
    return cases


def _small_finish_case(x, mal, noise, forge, agg, sanitize, bf16, route,
                       tag) -> int:
    from blades_tpu_torch.ops import fused_finish as ff

    nz = noise if forge and forge[0] == "adaptive" else None
    before = _finish_routes()
    got = ff.fused_finish(x, mal, nz, forge=forge, agg=agg, sanitize=sanitize)
    _took_route(before, "fused_finish", route, f"full {tag}")
    want = ff.fused_finish_plain(x, mal, nz, forge=forge, agg=agg,
                                 sanitize=sanitize)
    same(got[2], want[2], f"full bad {tag}")
    fw = None
    if forge is not None:
        fw = ff.fused_finish_compact_plain(
            x[~mal], nz, forged_mult=1, forge=forge, agg=("mean",),
            sanitize=sanitize)[3]
    if forge is None and agg[0] == "median":
        same(got[0], want[0], f"full agg {tag}")
    else:
        close(got[0], want[0], f"full agg {tag}", forged=fw, bf16=bf16)
    close(got[1], want[1], f"full sq {tag}", rtol=SQ_RTOL,
          forged=None if fw is None else fw.square().sum().reshape(1),
          bf16=bf16)
    if forge is None:
        return 1
    mult = 9
    before = _finish_routes()
    got = ff.fused_finish_compact(x, nz, forged_mult=mult, forge=forge,
                                  agg=agg, sanitize=sanitize)
    _took_route(before, "fused_finish_compact", route, f"compact {tag}")
    want = ff.fused_finish_compact_plain(x, nz, forged_mult=mult, forge=forge,
                                         agg=agg, sanitize=sanitize)
    same(got[2], want[2], f"compact bad {tag}")
    close(got[3], want[3], f"compact forged {tag}", forged=want[3], bf16=bf16)
    close(got[0], want[0], f"compact agg {tag}", forged=want[3], bf16=bf16)
    close(got[1], want[1], f"compact sq {tag}", rtol=SQ_RTOL)
    return 2


# (d, bytes per copy) of the column selects' small cases: f32 rows of 3000
# columns are 16-byte aligned, of 3002 (d % 4 == 2, as the dense ResNet-10
# trial's) 8-byte aligned, of 2999 only 4-byte aligned.
SMALL_SELECT_D = ((3000, 16), (3002, 8), (2999, 4))


def _select_rows():
    """Row counts of the column selects' small cases: tiny, odd and even,
    the 64-row group boundary +-1, the last row count the resident plan
    takes and one more (the streaming plan), 1000, and 6,000 (above the
    bit-serial kernel's cap of about 4,870)."""
    from blades_tpu_torch.ops import _cuda

    gh = _cuda.SELECT_GH
    res = max(r for r in range(1, 4096)
              if _cuda.select_plan(r, 8, 0).resident)
    return (1, 2, 33, 34, gh - 1, gh, gh + 1, res, res + 1, 1000, 6000)


def _select_matrix(gen, rows, d):
    """Unit-scale draws in the first half of the columns, half-integer
    levels (long duplicate runs across both cuts) in the second; NaN of
    both signs and +-inf in a few rows, all-equal columns, a signed-zero
    column, and columns whose middle falls among NaNs of either sign or
    among -infs."""
    import torch

    x = torch.randn((rows, d), generator=gen, device="cuda")
    x[:, d // 2:] = torch.round(x[:, d // 2:] * 2) / 2
    h = rows // 2 + 1
    nan = float("nan")
    x[1 % rows, :40] = nan
    x[3 % rows, 20:60] = -nan
    x[4 % rows, 100:110] = float("inf")
    x[0, 110:120] = -float("inf")
    x[:, 130] = 0.375
    x[:, 131] = -0.0
    x[:h, 132] = 0.0
    x[:h, 140] = -nan
    x[:h, 141] = nan
    x[:h, 142] = -float("inf")
    x[:, 143] = -nan
    x[:, d - 1] = 1.5  # the ragged last slab
    return x.contiguous()


def _select_took(before: dict, name: str, x, vec: int, what: str) -> None:
    """The select launches since ``before``: ``select:radix`` once, on the
    plan of ``vec``-byte copies for ``x``."""
    from blades_tpu_torch.ops import _cuda

    took = {k: v - before.get(k, 0) for k, v in _cuda.MAPS.items()
            if v != before.get(k, 0)}
    check(took == {(name, "select:radix"): 1},
          f"{what}: select routes {took}, expected select:radix once")
    plan = _cuda.select_plan(*x.shape, x.data_ptr())
    check(plan.vec == vec, f"{what}: {plan.vec}-byte copies, expected {vec}")


def _small_select(gen) -> int:
    """Both column selects on ``select:radix`` against their plain
    versions at every row count of :func:`_select_rows` and every width of
    :data:`SMALL_SELECT_D`: the median bit-exact, the trimmed mean (cut 1
    and ``(n-1)//2``) within ``TRIM_TOL``; each call's route and copy
    width checked, and a second launch bit-identical to the first."""
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.ops import column_select as cs

    cases = 0
    for rows in _select_rows():
        for d, vec in SMALL_SELECT_D:
            x = _select_matrix(gen, rows, d)
            calls = [("column_median", cs.column_median,
                      cs.column_median_plain)]
            for k in sorted({1, (rows - 1) // 2}):
                if 1 <= k and rows > 2 * k:
                    calls.append((
                        "column_trimmed_mean",
                        lambda a, k=k: cs.column_trimmed_mean(a, k),
                        lambda a, k=k: cs.column_trimmed_mean_plain(a, k)))
            for name, fn, plain in calls:
                tag = f"{name} rows={rows} d={d}"
                before = dict(_cuda.MAPS)
                got = fn(x)
                _select_took(before, name, x, vec, tag)
                same(fn(x), got, f"{tag}: two launches")
                want = plain(x)
                if name == "column_median":
                    same(got, want, tag)
                else:
                    close(got, want, tag, rtol=TRIM_TOL, atol=TRIM_TOL)
                cases += 1
    log(f"small: {cases} column-select cases on select:radix (rows "
        f"{_select_rows()}, d {[d for d, _ in SMALL_SELECT_D]}) agree with "
        "the plain versions; two launches bit-identical")
    return cases


def phase_small():
    """Every wrapper against its plain version on small shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = _small_finish(gen) + _small_finish_rows(gen) + _small_select(gen)
    torch.cuda.synchronize()
    log(f"small: {cases} kernel-vs-plain cases agree")
    _small_rowstats(gen)
    _small_gram_routes(gen)
    _small_bn(gen)
    _small_bn_vmap()
    _small_round()


def _abs_scales(x, kw):
    """Per-entry magnitudes of each statistic's summands: the same bundle
    over |X|, |v|, |w|, |g|.  An f32 sum in another order differs by a
    small multiple of the rounding unit times these.  int8 -128 counts as
    127 (its abs wraps to -128 in int8), a magnitude 1/128 below its own."""
    import torch

    from blades_tpu_torch.ops import rowstats as rs

    akw = {k: v.abs() if torch.is_tensor(v) else v for k, v in kw.items()}
    xa = x.clamp_min(-127).abs() if x.dtype == torch.int8 else x.abs()
    return rs.row_stats_bundle_plain(xa, **akw)


def rowstats_agree(got, want, x, kw, what, rtol=ROW_RTOL) -> float:
    """Kernel vs plain: sign counts and int8 self-contractions exact, every
    f32 sum within ``rtol`` of its summands' magnitude."""
    import torch

    check(set(got) == set(want), f"{what}: keys {sorted(got)} vs "
          f"{sorted(want)}")
    scales = None
    err = 0.0
    for k in want:
        a, b = got[k], want[k]
        check(a.shape == b.shape and a.dtype == torch.float32,
              f"{what} {k}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)}")
        if k == "signs" or (x.dtype == torch.int8 and k in ("sq", "gram")):
            same(a, b, f"{what} {k}")
            continue
        if scales is None:
            scales = _abs_scales(x, kw)
        diff = (a.double() - b.double()).abs()
        bad = ~(diff <= rtol * scales[k].double() + 1e-6)
        if bool(bad.any()):
            i = torch.nonzero(bad).flatten()[:4].tolist()
            raise Failure(f"{what} {k}: {int(bad.sum())} entries out of "
                          f"tolerance, e.g. {a.flatten()[i].tolist()} vs "
                          f"{b.flatten()[i].tolist()}")
        err = max(err, max_err(a, b))
    return err


ROWSTAT_BUNDLES = {
    "sq+gram+signs": dict(sq=True, gram=True, signs=True),
    "dots": dict(dots=True),
    "wsum": dict(weights=True),
    "gram_dot": dict(gram_dot=True),
    "all": dict(sq=True, gram=True, signs=True, dots=True, weights=True,
                gram_dot=True),
}


def _rowstats_routes() -> dict:
    """``row_stats_bundle``'s row-statistics launches so far, by route."""
    from blades_tpu_torch.ops import _cuda

    return {k[1]: v for k, v in _cuda.MAPS.items()
            if k[0] == "row_stats_bundle" and k[1].startswith("rowstats:")}


def _rowstats_took(before: dict, route: str, what: str) -> None:
    took = {k: v - before.get(k, 0) for k, v in _rowstats_routes().items()
            if v != before.get(k, 0)}
    check(took == {route: 1}, f"{what}: row-statistics routes {took}, "
          f"expected {{{route!r}: 1}}")


def _aligned16(x) -> bool:
    """The ring route's condition, written out: rows of a whole number of
    16-byte quads on a 16-byte-aligned base."""
    return (x.shape[1] * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0


def _same_outputs(a, b, what):
    check(set(a) == set(b), f"{what}: keys {sorted(a)} vs {sorted(b)}")
    for k in a:
        same(a[k], b[k], f"{what} {k}")


# (rows, d) of row_stats_bundle's small cases: widths whose rows are not
# 16-byte aligned at any dtype (1001: element by element; 300_002: 4-byte
# loads), and aligned ones (1000 x f32 / bf16, 1024 and 300_016 at every
# dtype), so every dtype meets both routes.  ROWSTATS_TALL: above the slab
# route's cap of about 4,820 rows.
ROWSTATS_SHAPES = ((9, 1001), (77, 1001), (1000, 1000), (77, 300_002),
                   (1000, 1024), (77, 300_016))
ROWSTATS_TALL = (6000, 1024)


def _rowstats_inputs(gen, dtype, rows, d):
    import torch

    if dtype == torch.int8:
        x = torch.randint(-127, 128, (rows, d), generator=gen,
                          device="cuda", dtype=torch.int8)
    else:
        x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
    x[:, ::5] = 0
    v = torch.randn((2, d), generator=gen, device="cuda")
    w = torch.rand((2, rows), generator=gen, device="cuda") + 0.1
    g = torch.rand((2, rows), generator=gen, device="cuda") + 0.1
    return x, v, w, g


def _small_rowstats(gen):
    """``row_stats_bundle`` against its plain version: dtype x bundle x
    ragged rows on both of its routes (``rowstats:ring`` for rows that are
    16-byte aligned, ``rowstats:slab`` for the rest; the route of every
    call checked), each bundle launched twice and the two launches
    bit-identical; a 6,000-row bf16 matrix on the ring route; a shared
    weight vector (``gram_dot_shared``) against the same values passed as
    two vectors, bit-identical; and the slab route's cap, which must raise
    naming its cause."""
    import torch

    from blades_tpu_torch.ops import rowstats as rs

    cases = {"ring": 0, "slab": 0}
    shapes = [(dt, rows, d) for dt in (torch.float32, torch.bfloat16,
                                       torch.int8)
              for rows, d in ROWSTATS_SHAPES]
    shapes.append((torch.bfloat16,) + ROWSTATS_TALL)
    for dtype, rows, d in shapes:
        x, v, w, g = _rowstats_inputs(gen, dtype, rows, d)
        route = "rowstats:ring" if _aligned16(x) else "rowstats:slab"
        for bname, flags in ROWSTAT_BUNDLES.items():
            kw = dict(sq=flags.get("sq", False),
                      gram=flags.get("gram", False),
                      signs=flags.get("signs", False),
                      dots=v if flags.get("dots") else None,
                      weights=w if flags.get("weights") else None,
                      gram_dot=g if flags.get("gram_dot") else None)
            what = f"row_stats_bundle {dtype} ({rows}, {d}) {bname}"
            before = _rowstats_routes()
            got = rs.row_stats_bundle(x, **kw)
            _rowstats_took(before, route, what)
            want = rs.row_stats_bundle_plain(x, **kw)
            rowstats_agree(got, want, x, kw, what)
            _same_outputs(got, rs.row_stats_bundle(x, **kw), f"{what}: two "
                          "launches")
            cases[route.split(":")[1]] += 1
        if route == "rowstats:ring":
            # GeoMed's bundle: one vector for wsum and gram_dot, the second
            # gram_dot vector its own.
            shared = rs.row_stats_bundle(x, weights=w, gram_dot=w,
                                         gram_dot_shared=(0, 1))
            apart = rs.row_stats_bundle(x, weights=w, gram_dot=w.clone())
            _same_outputs(shared, apart, f"row_stats_bundle {dtype} ({rows}, "
                          f"{d}): shared weight vectors against two passes")
            mixed = rs.row_stats_bundle(x, sq=True, weights=w[:1],
                                        gram_dot=torch.cat([w[:1], g[1:]]),
                                        gram_dot_shared=(0, -1))
            kw = dict(sq=True, weights=w[:1],
                      gram_dot=torch.cat([w[:1], g[1:]]))
            rowstats_agree(mixed, rs.row_stats_bundle_plain(x, **kw), x, kw,
                           f"row_stats_bundle {dtype} ({rows}, {d}) one "
                           "shared, one own gram_dot vector")
        del x
    # Unaligned rows above the slab route's cap raise, naming the cause.
    x, _, w, _ = _rowstats_inputs(gen, torch.bfloat16, ROWSTATS_TALL[0], 1001)
    try:
        rs.row_stats_bundle(x, weights=w)
        raise Failure("row_stats_bundle: 6000 unaligned rows did not raise")
    except ValueError as e:
        check("16-byte aligned" in str(e), f"slab cap message: {e}")
    del x
    torch.cuda.synchronize()
    log(f"small: {cases['ring']} row_stats_bundle cases on rowstats:ring "
        f"(including {ROWSTATS_TALL}) and {cases['slab']} on rowstats:slab "
        "agree with the plain version (signs and int8 sq/gram exact), each "
        "bit-identical over two launches; shared weight vectors "
        "bit-identical to two passes; 6000 unaligned rows raise")


def _gram_routes() -> dict:
    """``row_stats_bundle``'s Gram launches so far, by route."""
    from blades_tpu_torch.ops import _cuda

    return {k[1]: v for k, v in _cuda.MAPS.items()
            if k[0] == "row_stats_bundle" and k[1].startswith("gram:")}


def _gram_routes_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in _gram_routes().items()
            if v != before.get(k, 0)}


# bf16 shapes for the TMA + wgmma Gram: rows not a multiple of 128 and
# widths not a multiple of 64, so TMA's zero fill covers both edges.
GRAM_WGMMA_SHAPES = ((9, 1008), (77, 1000), (1000, 1000), (77, 300_008),
                     (130, 4104))
# int8 shapes for it (the wire payload's route): a partial tile row, across
# a tile row, several splits with a column tail inside a TMA box; then
# GRAM8_WORST's worst-case rows, and the wire round's width for the plan.
GRAM8_WGMMA_SHAPES = ((77, 1040), (130, 4096), (1000, 200_016))
GRAM8_WORST = (136, 131_088)
GRAM8_WIRE = (1000, 4_903_248)  # (n, wire_width(ResNet-10's d))


def _int8_worst_rows(gen, rows, d):
    """int8 rows in -128..127 from ``gen`` with rows 0 and 128 all -128,
    row 1 all +127 and rows 2, 3 alternating -128 / +127: their exact
    products (d x 128^2 = 2,147,745,792 at d = 131,088, in a diagonal and
    an off-diagonal tile) pass 2**31, and the random rows' pass 2**24."""
    import torch

    x = torch.randint(-128, 128, (rows, d), generator=gen, device="cuda",
                      dtype=torch.int8)
    alt = torch.arange(d, device="cuda") % 2 == 0
    x[0] = -128
    x[1] = 127
    x[2] = torch.where(alt, 127, -128).to(torch.int8)
    x[3] = torch.where(alt, -128, 127).to(torch.int8)
    x[128] = -128
    return x


def _gram_plans_agree(shapes):
    """``_cuda.gram_plan`` (the Python mirror, one CTA a SM on this card's
    SMs) against ``bt_gram_plan`` on the ``wgmma`` route, and every int8
    span within the int32-exact ``_cuda.INT8_SPAN`` columns."""
    import torch

    from blades_tpu_torch.ops import _cuda

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, rows, d in shapes:
        want = _cuda.card_gram_plan(dtype, "wgmma", rows, d)
        got = _cuda.gram_plan(dtype, "wgmma", rows, d, per_sm=1, sms=sms)
        check(got == want, f"gram plan ({rows}, {d}) {dtype}: gram_plan "
              f"{got}, bt_gram_plan {want}")
        check(dtype != torch.int8 or (want.span <= _cuda.INT8_SPAN
                                      and want.span % 128 == 0),
              f"gram plan ({rows}, {d}) int8: span {want.span}")
    return sms


def _small_gram_routes(gen):
    """The Gram's routes against the plain version: ``gram:wgmma`` on bf16
    rows that are 16-byte aligned (the shapes above, and a zero-padded
    ``(n, d_alloc)`` buffer read with ``d_true < d_alloc`` as the
    row-geometry round reads its buffer) and on int8 rows that are (the
    wire payload's route: the int8 shapes above and the worst-case rows,
    the int8 Gram bit-exact), and ``gram:mma`` on an aligned bf16 width
    at a 2-byte offset and an aligned int8 width at a 4-byte offset (the
    4-byte ``cp.async`` loads).  Each case's Gram must take its route once
    and the other never.  The ``wgmma`` plan of every shape, and of the
    wire round's, against its Python mirror."""
    import torch

    from blades_tpu_torch.ops import rowstats as rs

    cases = []
    for rows, d in GRAM_WGMMA_SHAPES:
        x = torch.randn((rows, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        x[:, ::5] = 0
        cases.append((f"({rows}, {d})", x, d, "gram:wgmma"))
    n, d_true = 130, 4000
    xp = torch.zeros((n, -(-d_true // 512) * 512), dtype=torch.bfloat16,
                     device="cuda")
    xp[:, :d_true] = torch.randn((n, d_true), generator=gen, device="cuda")
    cases.append((f"padded {tuple(xp.shape)}, d_true {d_true}", xp, d_true,
                  "gram:wgmma"))
    flat = torch.randn((77 * 1000 + 1,), generator=gen, device="cuda").to(
        torch.bfloat16)
    cases.append(("(77, 1000) at a 2-byte offset", flat[1:].view(77, 1000),
                  1000, "gram:mma"))
    for rows, d in GRAM8_WGMMA_SHAPES:
        x = torch.randint(-127, 128, (rows, d), generator=gen, device="cuda",
                          dtype=torch.int8)
        x[:, ::5] = 0
        cases.append((f"int8 ({rows}, {d})", x, d, "gram:wgmma"))
    cases.append((f"int8 worst-case rows {GRAM8_WORST}",
                  _int8_worst_rows(gen, *GRAM8_WORST), GRAM8_WORST[1],
                  "gram:wgmma"))
    flat8 = torch.randint(-127, 128, (77 * 1040 + 16,), generator=gen,
                          device="cuda", dtype=torch.int8)
    x8 = flat8[4:4 + 77 * 1040].view(77, 1040)
    check(x8.data_ptr() % 16 == 4, f"int8 offset case at {x8.data_ptr()}")
    cases.append(("int8 (77, 1040) at a 4-byte offset", x8, 1040,
                  "gram:mma"))
    sms = _gram_plans_agree(
        [(x.dtype,) + tuple(x.shape) for _, x, _, r in cases
         if r == "gram:wgmma"] + [(torch.int8,) + GRAM8_WIRE])
    count = 0
    for what, x, d_true, route in cases:
        rows, d = x.shape
        v = torch.randn((2, d), generator=gen, device="cuda")
        v[:, d_true:] = 0
        w = torch.rand((2, rows), generator=gen, device="cuda") + 0.1
        for bname in ("sq+gram+signs", "all"):
            flags = ROWSTAT_BUNDLES[bname]
            kw = dict(sq=True, gram=True, signs=True,
                      dots=v if flags.get("dots") else None,
                      weights=w if flags.get("weights") else None,
                      gram_dot=w if flags.get("gram_dot") else None,
                      d_true=d_true)
            before = _gram_routes()
            got = rs.row_stats_bundle(x, **kw)
            took = _gram_routes_since(before)
            check(took == {route: 1}, f"gram route {what} {bname}: took "
                  f"{took}, expected {{{route!r}: 1}}")
            if "wsum" in got:
                check(got["wsum"].shape == (2, d_true),
                      f"gram route {what}: wsum {tuple(got['wsum'].shape)}")
            rowstats_agree(got, rs.row_stats_bundle_plain(x, **kw), x, kw,
                           f"gram route {what} {bname}")
            count += 1
    torch.cuda.synchronize()
    log(f"small: {count} Gram route cases agree with the plain version "
        f"({len(GRAM_WGMMA_SHAPES) + 1} bf16 and "
        f"{len(GRAM8_WGMMA_SHAPES) + 1} int8 shapes on gram:wgmma, the "
        "int8 Gram bit-exact with worst-case rows past 2**31; one bf16 and "
        "one int8 shape on gram:mma); gram_plan equals bt_gram_plan at "
        f"every wgmma shape and {GRAM8_WIRE} int8 ({sms} SMs)")


def _small_round():
    """Small MLP rounds (f32 compute and storage) on the card against the
    same rounds on the CPU: Median through both fused finishes, then each
    of the seven row-geometry aggregators under ALIE through the planner
    (GeoMed at ``maxiter=5``: its early stop compares f32 objectives
    exactly, which reassociation can move by an iteration).  DnC and
    FLTrust draw from each device's own generator, so for those two only
    finiteness and the planned traversals are compared."""
    import torch

    from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
    from blades_tpu_torch.core import FedRound, Server, TaskSpec
    from blades_tpu_torch.parallel.streamed import streamed_step

    n, f, shape = 16, 4, (8, 8, 1)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((n, 8) + shape, generator=gen)
    y = torch.randint(0, 10, (n, 8), generator=gen)
    lengths = torch.full((n,), 8)
    idx = torch.randint(0, 8, (n, 1, 4), generator=gen)
    tx = torch.randn((16,) + shape, generator=gen)
    ty = torch.randint(0, 10, (16,), generator=gen)
    mal = make_malicious_mask(n, f)
    task = TaskSpec(model="mlp", input_shape=shape, lr=0.1).build()
    masks = tuple(torch.rand((n, 1, 4, w), generator=gen) >= 0.2
                  for w in task.model.dropout_widths)
    runs = [("Median", f), ("Median", None)] + [
        (name, f) for name in ("Multikrum", {"type": "GeoMed", "maxiter": 5},
                               "Signguard", "Centeredclipping",
                               "Clippedclustering", "DnC", "FLTrust")]
    for agg, prefix in runs:
        name = agg if isinstance(agg, str) else agg["type"]
        fr = FedRound(task=task,
                      server=Server.from_config(agg, num_byzantine=f, lr=0.5),
                      adversary=get_adversary("ALIE", num_clients=n,
                                              num_byzantine=f),
                      batch_size=4,
                      trusted_data=(tx, ty) if name == "FLTrust" else None)
        out = {}
        for dev in ("cpu", "cuda"):
            state = fr.init(0, n, device=dev)
            step = streamed_step(fr, client_block=4,
                                 update_dtype=torch.float32,
                                 malicious_prefix=prefix, device=dev)
            state, m = step(state, x.to(dev), y.to(dev), lengths, mal, 0,
                            batch_idx=idx, dropout_masks=masks)
            out[dev] = (state.server.params, m)
        for k, v in out["cuda"][0].items():
            check(bool(torch.isfinite(v).all()), f"small round {name} {k}")
            if name not in ("DnC", "FLTrust"):
                close(v.cpu(), out["cpu"][0][k], f"small round {name} "
                      f"param {k}", rtol=1e-4, atol=1e-5)
        keys = ("train_loss", "agg_norm", "update_norm_mean")
        if name in ("DnC", "FLTrust"):
            keys = ("train_loss",)
        for k in keys:
            close(out["cuda"][1][k].cpu().reshape(1),
                  out["cpu"][1][k].reshape(1), f"small round {name} {k}",
                  rtol=1e-4, atol=1e-5)
        for k in ("hbm_passes", "hbm_passes_unfused"):
            check(out["cuda"][1].get(k) == out["cpu"][1].get(k),
                  f"small round {name} {k}: {out['cuda'][1].get(k)} vs "
                  f"{out['cpu'][1].get(k)}")
    log("small: MLP rounds on the card match the CPU rounds (Median on "
        "the compact and full branches; GeoMed, DnC, Multikrum, "
        "Centeredclipping, Signguard, Clippedclustering, FLTrust under ALIE)")


# --------------------------------------------------------------------------
# The BatchNorm-backward pair
# --------------------------------------------------------------------------

BN_SRC = "blades_tpu_torch/csrc/bn_backward.cu"
BN_TPU = {"bn_bwd_reduce": "artifacts/perf_r4/time_bn_pallas.py:56",
          "bn_bwd_dx": "artifacts/perf_r4/time_bn_pallas.py:76"}
# The per-channel sums are f32 sums in another order than the plain
# version's: within 1e-5 of the sum of their terms' magnitudes.
BN_SUM_RTOL = 1e-5
# ResNet-10's four stages in the main round: (C, H = W), G = 50, B = 32.
BN_STAGES = ((64, 32), (128, 16), (256, 8), (512, 4))
BN_LAYOUTS = ("fold", "grouped", "fold-cl", "grouped-cl")


def _bn_operands(gen, layout, dtype, g, b, c, h, w, device="cuda"):
    """``x``, ``dy`` as the ``(G, B, C, S)`` views of one physical layout
    of a client block's activations -- ``fold``: (G*B, C, H, W) as
    functorch makes it while the parameters are unbatched; ``grouped``:
    (B, G*C, H, W), the grouped convolution's, once they are; ``-cl``:
    channels-last strides -- and per-(client, channel) ``mean``, ``r`` and
    ``scale`` values of the dtype."""
    import torch

    def phys():
        shape = (g * b, c, h, w) if layout.startswith("fold") else (b, g * c, h, w)
        t = (torch.randn(shape, generator=gen, device=device) * 1.5
             + 0.3).to(dtype)
        if layout.endswith("-cl"):
            t = t.contiguous(memory_format=torch.channels_last)
        if layout.startswith("fold"):
            return t.view(g, b, c, h * w)
        return t.view(b, g, c, h * w).transpose(0, 1)

    x, dy = phys(), phys()
    xf = x.float()
    mean = xf.mean((1, 3))
    var = (xf - mean[:, None, :, None]).square().mean((1, 3))
    r = torch.rsqrt(var + 1e-5)
    scale = 1.0 + 0.2 * torch.randn((g, c), generator=gen, device=device)
    return x, dy, mean.to(dtype), r.to(dtype), scale.to(dtype)


def _bn_coefs(sums, scale, n):
    """``mean_dxhat`` and ``mean_dxhat_xhat`` in the compute dtype, as
    ``BNApply.backward`` forms them from the sums (written out here so the
    ``bnstages`` phase also runs on a port without ``bn_coefs``)."""
    _, s_scale, s_dxhat = sums
    dt = scale.dtype
    return s_dxhat.to(dt) / n, s_scale.to(dt) * scale / n


def _bn_sums_agree(got, want, x, dy, mean, r, scale, what):
    """The kernel's three sums against the plain version's: within
    ``BN_SUM_RTOL`` of the sums of their terms' magnitudes (the terms
    rounded as the plain version rounds them)."""
    import torch

    xhat = (x - mean[:, None, :, None]) * r[:, None, :, None]
    mags = (dy.float().abs().sum((1, 3)), (dy * xhat).float().abs().sum((1, 3)),
            (dy * scale[:, None, :, None]).float().abs().sum((1, 3)))
    err = 0.0
    for k, (a, b, m) in enumerate(zip(got, want, mags)):
        check(a.dtype == torch.float32 and a.shape == b.shape,
              f"{what}: sum {k} {a.dtype} {tuple(a.shape)}")
        bad = ~((a.double() - b.double()).abs() <= BN_SUM_RTOL * m.double())
        if bool(bad.any()):
            i = torch.nonzero(bad).flatten()[:4].tolist()
            raise Failure(f"{what}: sum {k}: {int(bad.sum())} out of "
                          f"tolerance, e.g. {a.flatten()[i].tolist()} vs "
                          f"{b.flatten()[i].tolist()}")
        err = max(err, max_err(a, b))
    return err


def _bn_bwd_agree(x, dy, mean, r, scale, out, what):
    """One composite launch, ``_cuda.launch_bn_bwd``'s ``(dx, dscale,
    dbias, scratch)`` with the sums and coefficients read out of
    ``scratch``, in three parts: the raw sums within
    ``BN_SUM_RTOL`` of the plain sums' magnitudes; ``dscale``, ``dbias``
    and both coefficients bit for bit against ``bn_coefs`` -- the PyTorch
    ops ``_compose`` runs -- on the card on the kernel's own sums; dx bit
    for bit against ``bn_bwd_dx_plain`` fed the kernel's own
    coefficients."""
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.ops import bn_backward as bn

    dx, dscale, dbias, scratch = out
    sums, coefs = _cuda.bn_scratch_parts(scratch, x)
    err = _bn_sums_agree(tuple(sums), bn.bn_bwd_reduce_plain(
        x, dy, mean, r, scale), x, dy, mean, r, scale, f"{what} bwd")
    want = bn.bn_coefs(tuple(sums), scale, x.shape[1] * x.shape[3])
    for k, a, b in zip(("dscale", "dbias", "mean_dxhat", "mean_dxhat_xhat"),
                       (dscale, dbias, coefs[0], coefs[1]), want):
        check(a.dtype == b.dtype == x.dtype, f"{what} bwd {k}: {a.dtype}")
        same(a, b, f"{what} bwd {k}")
    same(dx, bn.bn_bwd_dx_plain(x, dy, mean, r, scale, coefs[0], coefs[1]),
         f"{what} bwd dx")
    return err


def _bn_agree(x, dy, mean, r, scale, what, want_map=None):
    """The kernels against the plain versions on the same operands: the
    single reduction's sums by :func:`_bn_sums_agree`; the single dx pass,
    fed the same coefficients, bit for bit in the layout of ``x``; the
    composite by :func:`_bn_bwd_agree`.  With ``want_map``, every launch
    must have taken that thread map."""
    import torch

    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.ops import bn_backward as bn

    n = x.shape[1] * x.shape[3]
    before = dict(_cuda.MAPS)
    want = bn.bn_bwd_reduce_plain(x, dy, mean, r, scale)
    err = _bn_sums_agree(bn.bn_bwd_reduce(x, dy, mean, r, scale), want, x,
                         dy, mean, r, scale, what)
    md, mdx = _bn_coefs(want, scale, n)
    dx = bn.bn_bwd_dx(x, dy, mean, r, scale, md, mdx)
    # dx takes x's strides where x is dense (empty_like's layout).
    check(dx.stride() == torch.empty_like(x).stride(),
          f"{what}: dx strides {dx.stride()} vs x {x.stride()}")
    same(dx, bn.bn_bwd_dx_plain(x, dy, mean, r, scale, md, mdx), f"{what} dx")
    err = max(err, _bn_bwd_agree(x, dy, mean, r, scale,
                                 _cuda.launch_bn_bwd(x, dy, mean, r, scale),
                                 what))
    if want_map is not None:
        took = {k: v - before.get(k, 0) for k, v in _cuda.MAPS.items()
                if v != before.get(k, 0)}
        check(took == {("bn_bwd_reduce", want_map): 2,
                       ("bn_bwd_dx", want_map): 2},
              f"{what}: thread maps {took}, expected {want_map}")
    return err


def _small_bn(gen):
    """The BatchNorm-backward kernels against their plain versions: f32
    and bf16 x the four physical layouts x ragged shapes (a pair's
    elements in one or several splits with a ragged last one, odd spatial
    sizes, S = 1, C of 8, 24 and 40 -- the vector map at widths that are
    not a multiple of 32 -- and one client of 32 x 32 x 32 positions) and
    the main round's four stage shapes; then a base pointer one element
    off alignment.  The NCHW stage shapes take the spatial-inner map, the
    channels-last ones and C of 8, 24, 40 the vector map, the offset view
    the scalar channel-inner map."""
    import torch

    from blades_tpu_torch.ops import _cuda

    _cuda.reset_launches()
    shapes = [(3, 5, 7, 5, 5), (2, 9, 4, 33, 33), (4, 16, 3, 1, 1),
              (50, 32, 8, 4, 4), (3, 4, 24, 5, 5), (4, 2, 40, 6, 6),
              (1, 32, 64, 32, 32)]
    stages = [(50, 32, c, hw, hw) for c, hw in BN_STAGES]
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for layout in BN_LAYOUTS:
            cl = layout.endswith("-cl")
            for shp in shapes + stages:
                g, b, c, h, w = shp
                want_map = None
                if shp in stages:
                    want_map = "vector" if cl else "spatial"
                elif c in (8, 24, 40) and cl:
                    want_map = "vector"
                ops = _bn_operands(gen, layout, dtype, *shp)
                _bn_agree(*ops, f"bn {dtype} {layout} {shp}", want_map)
                cases += 1
                del ops
        # x[..., 1:, :]: channel 1 onward, 2 or 4 bytes off alignment.
        x, dy, mean, r, scale = _bn_operands(gen, "fold-cl", dtype, 4, 8, 33,
                                             6, 6)
        cut = [v[:, 1:].contiguous() for v in (mean, r, scale)]
        _bn_agree(x[..., 1:, :], dy[..., 1:, :], *cut,
                  f"bn {dtype} offset view", "scalar")
        cases += 1
    torch.cuda.synchronize()
    log(f"small: {cases} BatchNorm-backward kernel-vs-plain cases agree "
        "(single passes and the composite: dx, dscale, dbias and the "
        "coefficients bit-exact, sums within f32 reassociation); launches "
        f"by thread map {dict(sorted(_cuda.MAPS.items()))}")


# Seconds spent in audits inside a path's run, and the path's peak device
# memory up to the last audit: a phase takes the one out of its rounds/s
# and keeps the audits' own allocations out of the peak it reports.
AUDIT = {"s": 0.0, "peak": 0}


@contextlib.contextmanager
def _aside():
    """An audit's work inside a path's run, set aside from the path: the
    launch counts and routes restored to what they were before it (its
    own launches, made to compare or to time, count for nothing), its
    seconds added to ``AUDIT["s"]``, and the allocator's peak kept in
    ``AUDIT["peak"]`` before it and reset after it.  Run the work in a
    function called inside the block, so its tensors are freed before the
    reset."""
    import torch

    from blades_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    AUDIT["peak"] = max(AUDIT["peak"], torch.cuda.max_memory_allocated())
    launches, maps = dict(_cuda.LAUNCHES), dict(_cuda.MAPS)
    try:
        yield
    finally:
        torch.cuda.synchronize()
        _cuda.LAUNCHES.clear()
        _cuda.LAUNCHES.update(launches)
        _cuda.MAPS.clear()
        _cuda.MAPS.update(maps)
        torch.cuda.reset_peak_memory_stats()
        AUDIT["s"] += time.perf_counter() - t0


def _reset_peak():
    import torch

    torch.cuda.reset_peak_memory_stats()
    AUDIT["peak"] = 0


def _peak():
    """The path's peak device memory since :func:`_reset_peak`, the
    audits' allocations left out."""
    import torch

    return max(AUDIT["peak"], torch.cuda.max_memory_allocated())


def _keep_view(t):
    """A host copy of the storage span that ``t`` views, with its size,
    strides, device and offset modulo 128 elements: :func:`_view_on_card`
    rebuilds the same layout, alignment included, on the card."""
    import torch

    lo = t.storage_offset()
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    flat = torch.as_strided(t, (span,), (1,), lo)
    return (flat.cpu(), tuple(t.shape), tuple(t.stride()), lo % 128,
            t.device)


def _view_on_card(kept):
    import torch

    flat, size, stride, pad, device = kept
    base = torch.empty((pad + flat.numel(),), dtype=flat.dtype,
                       device=device)
    base[pad:].copy_(flat)
    return torch.as_strided(base, size, stride, pad)


class _BnAudit:
    """Wraps the three launchers while a vmapped block trains on the card:
    every launch is also held against the plain versions on the same
    physical operands (the layouts functorch and cuDNN really hand over),
    the composite's by :func:`_bn_bwd_agree`; the strides seen are kept.
    ``calls`` counts the kernel launches audited (two per composite):
    with ``limit``, the first ``limit`` of them, the later ones pass
    through unaudited.  With ``key``, the first launch at each operand
    layout also times the single kernels, the plain versions and the
    library's backward on its operands, and :meth:`records` turns the
    audited launches into the path's records.  With ``defer`` those
    operands are kept on the host, in their layouts (:func:`_keep_view`),
    and timed by :meth:`time_deferred` when the caller has the card to
    itself.  The audit's own work is set aside (:func:`_aside`)."""

    def __init__(self, limit=None, key=None, defer=False):
        from blades_tpu_torch.ops import _cuda

        self._cuda = _cuda
        self.layouts = set()
        self.err = 0.0
        self.calls = 0
        self.limit, self.key, self.defer = limit, key, defer
        self.tally, self.times, self._pending = {}, {}, {}

    def _due(self, n):
        return self.limit is None or self.calls + n <= self.limit

    def _note(self, x, dy, mean, r, scale, kernels):
        """Tally the launch's layout for the records; time it the first
        time it is seen."""
        lay = (x.dtype, tuple(x.shape), x.stride())
        self.layouts.add(lay)
        if self.key is None:
            return
        for k in kernels:
            self.tally[k, lay] = self.tally.get((k, lay), 0) + 1
        if lay in self.times or lay in self._pending:
            return
        if self.defer:
            self._pending[lay] = [_keep_view(t)
                                  for t in (x, dy, mean, r, scale)]
        else:
            self.times[lay] = _bn_launch_times(self._saved, x, dy, mean, r,
                                               scale)

    def time_deferred(self):
        """Time each layout set aside at its first launch (``defer``), on
        its operands back on the card in their own layouts."""
        for lay, kept in self._pending.items():
            self.times[lay] = _bn_launch_times(
                self._saved, *(_view_on_card(k) for k in kept))
        self._pending.clear()

    def __enter__(self):
        from blades_tpu_torch.ops import bn_backward as bn

        cu = self._cuda
        self._saved = cu.launch_bn_reduce, cu.launch_bn_dx, cu.launch_bn_bwd
        red, dxl, bwdl = self._saved

        def reduce(name, x, dy, mean, r, scale):
            out = red(name, x, dy, mean, r, scale)
            if self._due(1):
                def audit():
                    self._note(x, dy, mean, r, scale, ("bn_bwd_reduce",))
                    self.err = max(self.err, _bn_sums_agree(
                        out, bn.bn_bwd_reduce_plain(x, dy, mean, r, scale),
                        x, dy, mean, r, scale,
                        f"audit {tuple(x.shape)} {x.stride()}"))
                with _aside():
                    audit()
                self.calls += 1
            return out

        def dx(name, x, dy, *vecs):
            out = dxl(name, x, dy, *vecs)
            if self._due(1):
                def audit():
                    self._note(x, dy, *vecs[:3], ("bn_bwd_dx",))
                    same(out, bn.bn_bwd_dx_plain(x, dy, *vecs),
                         f"audit dx {tuple(x.shape)} {x.stride()}")
                with _aside():
                    audit()
                self.calls += 1
            return out

        def bwd(x, dy, mean, r, scale):
            out = bwdl(x, dy, mean, r, scale)
            if self._due(2):
                def audit():
                    self._note(x, dy, mean, r, scale,
                               ("bn_bwd_reduce", "bn_bwd_dx"))
                    self.err = max(self.err, _bn_bwd_agree(
                        x, dy, mean, r, scale, out,
                        f"audit {tuple(x.shape)} {x.stride()}"))
                with _aside():
                    audit()
                self.calls += 2
            return out

        cu.launch_bn_reduce, cu.launch_bn_dx, cu.launch_bn_bwd = reduce, dx, bwd
        return self

    def __exit__(self, *exc):
        cu = self._cuda
        cu.launch_bn_reduce, cu.launch_bn_dx, cu.launch_bn_bwd = self._saved

    def records(self, rounds):
        """Each kernel's record on the path, from the launches audited over
        ``rounds`` rounds: every time, byte and operation count is a round's
        -- each layout's single-launch figure times its audited launches,
        over ``rounds`` -- as the kernel's launches on this path add up."""
        out = {}
        for k in BN_TPU:
            tot = dict(ms=0.0, plain=0.0, lib=0.0, bytes=0.0, ops=0.0)
            for (kk, lay), n in self.tally.items():
                if kk != k:
                    continue
                for f, v in self.times[lay][k].items():
                    tot[f] += n * v / rounds
            out[f"{k}:{self.key}"] = _record(
                f"{k}:{self.key}", BN_SRC, BN_TPU[k], tot["ms"], tot["plain"],
                tot["bytes"], tot["ops"],
                self.err if k == "bn_bwd_reduce" else 0.0, tot["lib"])
        return out


def _bn_launch_times(launchers, x, dy, mean, r, scale):
    """One launch's figures at a layout a path hands the kernels, on its
    own operands (``x``, ``dy`` the ``(G, B, C, S)`` views): device-only
    ms of the single reduction and dx pass (``launchers``: the unwrapped
    ones), the plain versions' ms, and the library's batch-norm backward
    on a channels-last ``(B, G*C, H, W)`` copy -- dscale/dbias beside the
    reduction, the full backward beside dx -- with the bytes and
    operations of :func:`_bn_records`."""
    import torch

    from blades_tpu_torch.ops import bn_backward as bn

    red, dxl, _ = launchers
    g, b, c, s = x.shape
    n, elems, isz = b * s, x.numel(), x.element_size()
    md, mdx = _bn_coefs(red("bn_bwd_reduce", x, dy, mean, r, scale), scale,
                        n)
    t = {"bn_bwd_reduce": dict(
            ms=timed(lambda: red("bn_bwd_reduce", x, dy, mean, r, scale),
                     BN_REPS)[0],
            plain=timed(lambda: bn.bn_bwd_reduce_plain(x, dy, mean, r, scale),
                        REPS)[0],
            bytes=elems * 2 * isz + 3 * g * c * 4, ops=7 * elems),
         "bn_bwd_dx": dict(
            ms=timed(lambda: dxl("bn_bwd_dx", x, dy, mean, r, scale, md, mdx),
                     BN_REPS)[0],
            plain=timed(lambda: bn.bn_bwd_dx_plain(x, dy, mean, r, scale, md,
                                                   mdx), REPS)[0],
            bytes=elems * 3 * isz + 5 * g * c * 4, ops=7 * elems)}
    hw = int(round(s ** 0.5))
    cl = torch.channels_last
    xg = x.transpose(0, 1).reshape(b, g * c, hw, hw).contiguous(
        memory_format=cl)
    dyg = dy.transpose(0, 1).reshape(b, g * c, hw, hw).contiguous(
        memory_format=cl)
    sm, si, wt = mean.float().flatten(), r.float().flatten(), scale.flatten()

    def lib(mask):
        return torch.ops.aten.native_batch_norm_backward(
            dyg, xg, wt, None, None, sm, si, True, 1e-5, mask)

    t["bn_bwd_reduce"]["lib"] = timed(lambda: lib([False, True, True]),
                                      BN_REPS)[0]
    t["bn_bwd_dx"]["lib"] = timed(lambda: lib([True, True, True]),
                                  BN_REPS)[0]
    return t


def _small_bn_vmap():
    """Two local steps of a small ResNet-10 client block on the card --
    step 0 with unbatched parameters, step 1 with batched ones, so both
    physical layouts reach the ops through their vmap rule.  Every launch
    is audited against the plain version on its own operands; each BN
    layer must launch each kernel exactly once per step (a per-client loop
    would launch G times); the updates are compared with the same block
    with the plain ops in the kernels' place (on the card, cuDNN set
    deterministic) and with the CPU's."""
    import torch

    from blades_tpu_torch.core import TaskSpec
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.ops import bn_backward as bn

    g, nb, b = 3, 2, 8
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((g, nb, b, 32, 32, 3), generator=gen)
    y = torch.randint(0, 10, (g, nb, b), generator=gen)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for cd in ("float32", "bfloat16"):
            task = TaskSpec(model="resnet", input_shape=(32, 32, 3), lr=0.1,
                            compute_dtype=cd).build()
            params = task.init_params(torch.Generator().manual_seed(0))
            out = {}
            for run in ("cuda", "cuda-plain", "cpu"):
                dev = run.split("-")[0]
                saved = bn._bn_bwd_impl
                if run.endswith("plain"):
                    bn._bn_bwd_impl = bn.bn_bwd_plain
                try:
                    _cuda.reset_launches()
                    p = {k: v.to(dev) for k, v in params.items()}
                    if run == "cuda":
                        with _BnAudit() as audit:
                            upd, _, _ = task.local_round_batched(
                                p, x.to(dev), y.to(dev))
                            torch.cuda.synchronize()
                    else:
                        upd, _, _ = task.local_round_batched(
                            p, x.to(dev), y.to(dev))
                finally:
                    bn._bn_bwd_impl = saved
                out[run] = (upd.cpu(), dict(_cuda.LAUNCHES),
                            dict(_cuda.MAPS))
            want = {"bn_bwd_reduce": 12 * nb, "bn_bwd_dx": 12 * nb}
            check(out["cuda"][1] == want, f"bn vmap {cd}: launches "
                  f"{out['cuda'][1]}, expected {want} (one per BN layer and "
                  "step)")
            check(out["cpu"][1] == {} and out["cuda-plain"][1] == {},
                  "bn vmap: a plain path launched kernels")
            check(audit.calls == 2 * 12 * nb, f"bn vmap {cd}: audited "
                  f"{audit.calls} launches")
            a = out["cuda"][0]
            check(bool(torch.isfinite(a).all()), f"bn vmap {cd}: non-finite")
            rel = {ref: float((a - out[ref][0]).norm() / out[ref][0].norm())
                   for ref in ("cuda-plain", "cpu")}
            # Two SGD steps of a freshly initialised ResNet amplify sums
            # taken in another order (f32 about 1e-3 of the update's norm
            # measured on the card, bf16 about 6e-2): a loose sanity guard
            # only; the per-launch audit is the check.
            check(rel["cuda-plain"] < 0.25, f"bn vmap {cd}: updates differ "
                  f"from the plain ops' by {rel['cuda-plain']:.3g}")
            strides = sorted({(s[2], s[1]) for s in audit.layouts})
            log(f"small: ResNet-10 block (G={g}, 2 local steps, {cd}) on the "
                f"card: 12 launches of each BN kernel per step, all "
                f"{audit.calls} audited against the plain version (dx, "
                f"dscale, dbias and the coefficients bit-exact, sums max err "
                f"{audit.err:.3g}); thread maps {out['cuda'][2]}; updates "
                f"differ from the plain ops' on the card by "
                f"{rel['cuda-plain']:.3g} and from the CPU's by "
                f"{rel['cpu']:.3g} of their norm; (G, N, C, S) strides seen: "
                f"{strides}")
    finally:
        torch.backends.cudnn.deterministic = det


def _bn_stage_times(x, dy, mean, r, scale, reps=BN_REPS):
    """Device-only ms and host us per call (:func:`timed`) at one stage
    shape (``x``, ``dy`` the ``(G, B, C, S)`` channels-last view of the
    one-step layout): the single reduction and dx pass, the composite
    ``bn_bwd`` called directly and through ``torch.func.vmap`` as
    ``BNApply.backward`` calls it in a client block, the same kernels on
    NCHW copies (the spatial-inner map), and the library's batch-norm
    backward on the channels-last (B, G*C, H, W) view -- dscale/dbias
    alone and the full backward -- with saved mean / invstd in f32 (its
    own layout: the operands copied once, untimed).  Uses only what every
    version of the port has, so the ``bnstages`` phase times a parent
    tree's kernels the same way."""
    import torch
    from torch.func import vmap

    from blades_tpu_torch.ops import bn_backward as bn

    g, b, c, s = x.shape
    n = b * s
    md, mdx = _bn_coefs(bn.bn_bwd_reduce(x, dy, mean, r, scale), scale, n)
    t = {}
    t["reduce"] = timed(lambda: bn.bn_bwd_reduce(x, dy, mean, r, scale), reps)
    t["dx"] = timed(lambda: bn.bn_bwd_dx(x, dy, mean, r, scale, md, mdx),
                    reps)
    t["bwd"] = timed(lambda: bn.bn_bwd(x, dy, mean, r, scale), reps)
    s1 = scale[:1]
    vfn = vmap(lambda a, d, m, rr: bn.bn_bwd(a, d, m, rr, s1))
    vargs = (x[:, None], dy[:, None], mean[:, None], r[:, None])
    t["bwd_vmap"] = timed(lambda: vfn(*vargs), reps)
    xn, dyn = (u.contiguous() for u in (x, dy))
    t["nchw_reduce"] = timed(lambda: bn.bn_bwd_reduce(xn, dyn, mean, r,
                                                      scale), reps)
    t["nchw_dx"] = timed(lambda: bn.bn_bwd_dx(xn, dyn, mean, r, scale, md,
                                              mdx), reps)
    del xn, dyn
    hw = int(round(s ** 0.5))
    cl = torch.channels_last
    xg = x.transpose(0, 1).reshape(b, g * c, hw, hw).contiguous(
        memory_format=cl)
    dyg = dy.transpose(0, 1).reshape(b, g * c, hw, hw).contiguous(
        memory_format=cl)
    sm, si = mean.float().flatten(), r.float().flatten()
    wt = scale.flatten()

    def lib(mask):
        return torch.ops.aten.native_batch_norm_backward(
            dyg, xg, wt, None, None, sm, si, True, 1e-5, mask)

    t["lib_reduce"] = timed(lambda: lib([False, True, True]), reps)
    t["lib_full"] = timed(lambda: lib([True, True, True]), reps)
    return t


def _bn_profiled(x, dy, mean, r, scale, reps=20):
    """Device us per call of the single reduction and dx pass by
    ``torch.profiler``'s kernel records (every kernel whose name holds
    ``bn_reduce`` / ``bn_dx``), the cross-check of :func:`timed`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from blades_tpu_torch.ops import bn_backward as bn

    n = x.shape[1] * x.shape[3]
    md, mdx = _bn_coefs(bn.bn_bwd_reduce(x, dy, mean, r, scale), scale, n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            bn.bn_bwd_reduce(x, dy, mean, r, scale)
        for _ in range(reps):
            bn.bn_bwd_dx(x, dy, mean, r, scale, md, mdx)
        torch.cuda.synchronize()
    us = {"reduce": 0.0, "dx": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        k = e.key.lower()
        if "bn_reduce" in k:
            us["reduce"] += t
        elif "bn_dx" in k:
            us["dx"] += t
    return {k: v / reps for k, v in us.items()}


def _bn_stage_line(c, hw, t, prof_us=None, plain=None):
    """One stage's log line from :func:`_bn_stage_times`."""
    bound_red = 50 * 32 * hw * hw * c * 4 / HBM_BYTES_PER_S * 1e3
    line = (f"kernel bn stage C={c} {hw}x{hw}: device-only reduce "
            f"{t['reduce'][0]:.4f} ms, dx {t['dx'][0]:.4f} ms (bounds "
            f"{bound_red:.4f} / {1.5 * bound_red:.4f}), composite bn_bwd "
            f"{t['bwd'][0]:.4f} ms; library dscale/dbias "
            f"{t['lib_reduce'][0]:.4f}, full backward {t['lib_full'][0]:.4f}; "
            f"NCHW reduce {t['nchw_reduce'][0]:.4f}, dx {t['nchw_dx'][0]:.4f}; "
            f"host us per call: reduce {t['reduce'][1]:.1f}, dx "
            f"{t['dx'][1]:.1f}, bn_bwd {t['bwd'][1]:.1f}, vmapped bn_bwd "
            f"(one BN layer of a block) {t['bwd_vmap'][1]:.1f}, library "
            f"{t['lib_full'][1]:.1f}")
    if prof_us is not None:
        line += (f"; profiler device us per call: reduce "
                 f"{prof_us['reduce']:.2f}, dx {prof_us['dx']:.2f}")
    if plain is not None:
        line += f"; plain reduce {plain[0]:.3f} ms, dx {plain[1]:.3f} ms"
    return line


def phase_bnstages():
    """The BN kernels alone at the main round's four stage shapes (G = 50,
    B = 32, bf16, channels-last), device-only, with the profiler's kernel
    durations beside the event times and the host us per call; run it
    with ``--port`` on another tree's package to compare two versions of
    the kernels in one call."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    tot = {}
    for c, hw in BN_STAGES:
        ops = _bn_operands(gen, "fold-cl", torch.bfloat16, 50, 32, c, hw, hw)
        t = _bn_stage_times(*ops)
        log(_bn_stage_line(c, hw, t, _bn_profiled(*ops)))
        for k, v in t.items():
            tot[k] = tot.get(k, 0.0) + v[0]
        del ops
        torch.cuda.empty_cache()
    log("bnstages: device-only ms summed over the four stages: " + ", ".join(
        f"{k} {v:.4f}" for k, v in tot.items()))


def _bn_records(gen):
    """The BN kernels at the main round's four stage shapes (G = 50,
    B = 32, bf16, the one-step layout (G*B, C, H, W) channels-last, as
    cuDNN hands bf16 activations over): each checked against the plain
    versions, then timed device-only beside the plain versions, the
    library's backward and the bound.  The records hold the sums over the
    four stages (one BN layer each); the rest is logged per stage."""
    import torch

    from blades_tpu_torch.ops import bn_backward as bn

    g, b = 50, 32
    tot = {k: dict(ms=0.0, plain=0.0, lib=0.0, bytes=0.0, ops=0.0, err=0.0)
           for k in ("bn_bwd_reduce", "bn_bwd_dx")}
    pair = lib_full = 0.0
    for c, hw in BN_STAGES:
        x, dy, mean, r, scale = ops = _bn_operands(
            gen, "fold-cl", torch.bfloat16, g, b, c, hw, hw)
        n = b * hw * hw
        elems = g * n * c
        err = _bn_agree(*ops, f"bn stage C={c}", "vector")
        md, mdx = _bn_coefs(bn.bn_bwd_reduce_plain(*ops), scale, n)
        p_red = timed(lambda: bn.bn_bwd_reduce_plain(*ops), REPS)[0]
        p_dx = timed(lambda: bn.bn_bwd_dx_plain(*ops, md, mdx), REPS)[0]
        t = _bn_stage_times(*ops)
        log(_bn_stage_line(c, hw, t, plain=(p_red, p_dx)))
        pair += t["bwd"][0]
        lib_full += t["lib_full"][0]
        # Reduce: read x and dy (2 B each), write 3 (G, C) f32 sums; per
        # element a subtract, 3 multiplies, 3 adds.  dx: read x and dy,
        # write dx; a subtract, 4 multiplies, 2 subtracts.
        for k, tk, pt, lk, nbytes, nops in (
                ("bn_bwd_reduce", "reduce", p_red, "lib_reduce",
                 elems * 4 + 3 * g * c * 4, 7 * elems),
                ("bn_bwd_dx", "dx", p_dx, "lib_full",
                 elems * 6 + 5 * g * c * 4, 7 * elems)):
            a = tot[k]
            a["ms"] += t[tk][0]
            a["plain"] += pt
            a["lib"] += t[lk][0]
            a["bytes"] += nbytes
            a["ops"] += nops
            a["err"] = max(a["err"], err if k == "bn_bwd_reduce" else 0.0)
        del x, dy, ops
        torch.cuda.empty_cache()
    log(f"kernel bn: the composite bn_bwd over the four stages {pair:.4f} ms "
        f"device-only against native_batch_norm_backward's full backward "
        f"{lib_full:.4f} ms")
    return {k: _record(k, BN_SRC, BN_TPU[k], a["ms"], a["plain"], a["bytes"],
                       a["ops"], a["err"], a["lib"])
            for k, a in tot.items()}


def _record(name, source, replaces, ms, plain_ms, bytes_moved, ops, err,
            library_ms=None, ops_per_s=F32_OPS_PER_S):
    """One kernel's line.  ``library_ms`` is the time of one PyTorch call
    computing the same function on the same inputs, or null where there
    is none (no call forges or sanitizes, and ``torch.median`` returns the
    lower middle value)."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


SRC = "blades_tpu_torch/csrc/fused_finish.cu"
COMPACT_TPU = "blades_tpu/ops/pallas_round.py:502"


def _padded_rows(gen, rows, d):
    """A ``(rows, d_alloc)`` bf16 matrix as the streamed round allocates
    it: random updates of scale 1e-3 in the first ``d`` columns (drawn a
    block of rows at a time), zero past them."""
    import torch

    x = torch.zeros((rows, -(-d // 512) * 512), dtype=torch.bfloat16,
                    device="cuda")
    for r0 in range(0, rows, 100):
        x[r0:r0 + 100, :d] = (torch.randn((min(100, rows - r0), d),
                                          generator=gen, device="cuda")
                              * 1e-3).to(x.dtype)
    return x


def _finish_agree(got, want, name, what, fw=None):
    """A finish against its plain version at the main shape: bad flags
    bit-exact, the aggregate within one bf16 ulp of the forged row, the
    row norms within ``SQ_RTOL``; returns the aggregate's max abs err."""
    same(got[2], want[2], f"{name} bad ({what})")
    if name == "fused_finish_compact":
        fw = want[3]
        close(got[3], want[3], f"{name} forged ({what})", forged=fw,
              bf16=True)
    err = close(got[0], want[0], f"{name} agg ({what})", forged=fw,
                bf16=True)
    close(got[1], want[1], f"{name} sq ({what})", rtol=SQ_RTOL,
          forged=None if name == "fused_finish_compact"
          else fw.square().sum().reshape(1), bf16=True)
    return err


def _finish_record(name, x, d, forge, fn, plain, replaces, small_bytes,
                   benign=0):
    """One finish at the main path's shape: ``fn`` on the padded buffer
    ``x`` must take the radix route once and agree with ``plain``; then,
    in the same call, the bit-serial route on the unpadded ``x[:, :d]``
    (checked against the plain version too, and logged beside it).  The
    bound counts the rows the function reads (``benign``: the forged rows
    it skips), each once, and its outputs at the padded width."""
    import torch

    from blades_tpu_torch.ops import fused_finish as ff

    rows, d_alloc = x.shape
    before = _finish_routes()
    got = fn(x)
    _took_route(before, name, "radix", f"{name} (main shape)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain(x)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    fw = None
    if name == "fused_finish":  # the forged row of the benign rows
        fw = ff.fused_finish_compact_plain(
            x[benign:], forged_mult=benign, forge=forge, agg=("mean",))[3]
    err = _finish_agree(got, want, name, "radix, padded", fw)
    del got
    ms = timed(lambda: fn(x), REPS)[0]
    xu = x[:, :d].contiguous()
    before = _finish_routes()
    old = fn(xu)
    _took_route(before, name, "bitserial", f"{name} unpadded")
    cut = tuple(w[:d] if w is not None and w.shape[0] == d_alloc else w
                for w in want)
    old_err = _finish_agree(old, cut, name, "bitserial, unpadded",
                            None if fw is None else fw[:d])
    del old
    old_ms = timed(lambda: fn(xu), REPS)[0]
    del xu
    read = (rows - benign) * d_alloc * 2
    log(f"kernel {name}: finish:radix on ({rows}, {d_alloc}) {ms:.3f} ms "
        f"({read / ms / 1e9:.2f} TB/s of rows read); finish:bitserial on the "
        f"unpadded ({rows}, {d}) {old_ms:.3f} ms (max_abs_err {old_err:.3g} "
        f"vs plain); plain {plain_ms:.1f} ms")
    # Per element: mean 1, variance 3, row norm 2, selection 1.
    return _record(name, SRC, replaces, ms, plain_ms, read + small_bytes,
                   7 * (rows - benign) * d_alloc, err)


def _finish_phases(x, forge):
    """Where the radix route's time goes, on the main path's (750, d_alloc)
    buffer: device-only ms with parts of the work switched off through the
    launcher's options -- Mean without row norms (the load and sum pass
    alone, whose rate bounds the slab loop's streaming), Mean with them,
    Median without and with them (the digit select), and the compact finish
    under ALIE with Median and with Trimmedmean (250 cut)."""
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.ops import fused_finish as ff

    name = "finish:radix phases"
    cases = {
        "mean": lambda: _cuda.launch_finish(name, x, agg=("mean",),
                                            want_sq=False),
        "mean+norms": lambda: _cuda.launch_finish(name, x, agg=("mean",)),
        "median": lambda: _cuda.launch_finish(name, x, agg=("median",),
                                              want_sq=False),
        "median+norms": lambda: _cuda.launch_finish(name, x,
                                                    agg=("median",)),
        "alie+median": lambda: ff.fused_finish_compact(
            x, forged_mult=250, forge=forge, agg=("median",)),
        "alie+trimmed": lambda: ff.fused_finish_compact(
            x, forged_mult=250, forge=forge, agg=("trimmed", 250)),
    }
    ms = {k: timed(fn, REPS)[0] for k, fn in cases.items()}
    rate = x.numel() * 2 / ms["mean"] / 1e9
    log(f"kernel {name} on {tuple(x.shape)}: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + f"; the mean pass reads the rows at {rate:.2f} TB/s")


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from blades_tpu_torch.adversaries import ALIEAdversary
    from blades_tpu_torch.ops import fused_finish as ff

    d = RESNET10_D
    z = ALIEAdversary(num_clients=1000, num_byzantine=250).z_max
    forge, agg = ("alie", z), ("median",)
    gen = torch.Generator(device="cuda").manual_seed(2)
    records = {}

    # 1. The compact finish over the benign rows, as the main path calls it:
    # the (750, d_alloc) buffer, zero past d, on the radix route; beside it
    # the bit-serial route on the unpadded (750, d) matrix, whose rows are
    # not 16-byte aligned.
    x = _padded_rows(gen, 750, d)
    records["fused_finish_compact"] = _finish_record(
        "fused_finish_compact", x, d, forge, lambda m: ff.fused_finish_compact(
            m, forged_mult=250, forge=forge, agg=agg),
        lambda m: ff.fused_finish_compact_plain(
            m, forged_mult=250, forge=forge, agg=agg),
        COMPACT_TPU, 750 * 5 + 2 * x.shape[1] * 4)
    _finish_phases(x, forge)
    del x
    torch.cuda.empty_cache()

    # 2. The full finish over all 1000 rows of the padded buffer, the
    # first 250 forged; the wrapper does not wait for the device.
    x = _padded_rows(gen, 1000, d)
    mal = torch.arange(1000, device="cuda") < 250
    records["fused_finish"] = _finish_record(
        "fused_finish", x, d, forge,
        lambda m: ff.fused_finish(m, mal, forge=forge, agg=agg),
        lambda m: ff.fused_finish_plain(m, mal, forge=forge, agg=agg),
        "blades_tpu/ops/pallas_round.py:628",
        1000 + 1000 * 5 + x.shape[1] * 4, benign=250)
    del x
    torch.cuda.empty_cache()

    # 3-4. The column selects on a (1000, 1 << 20) f32 matrix (rows 16-byte
    # aligned) and on the dense ResNet-10 trial's (60, 4,903,242) update
    # matrix (d % 4 == 2: 8-byte copies).
    records.update(_select_records(gen, 1000, 1 << 20, 16, ""))
    records.update(_select_records(gen, 60, d, 8, ":dense_trial"))
    records.update(_bundle_records(gen, d))
    _gram_shapes()
    _int8_gram_turns(gen)
    records.update(_bn_records(gen))
    for r in records.values():
        lib = r["library_ms"]
        log(f"kernel {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.1f}"
            f" ms, bound {r['bound_ms']:.3f} ms, library "
            f"{'none' if lib is None else f'{lib:.3f} ms'}), max_abs_err "
            f"{r['max_abs_err']:.3g} vs plain")
    return records


SELECT_SRC = "blades_tpu_torch/csrc/column_select.cu"
SELECT_TPU = {"column_median": "blades_tpu/ops/pallas_select.py:206",
              "column_trimmed_mean": "blades_tpu/ops/pallas_select.py:220"}


def _select_records(gen, rows, d, vec, suffix):
    """Both column selects on a ``(rows, d)`` f32 matrix: ``select:radix``
    (``vec``-byte copies) against the plain version, timed beside the
    bit-serial ``finish_kernel`` on the same matrix (checked too) and, for
    the median, ``torch.quantile``; then the new kernel's time by part of
    its work (``probe=1`` the loads alone, ``probe=2`` the passes alone)
    and on the streaming plan where the resident one runs.  Returns the
    records, named with ``suffix``, of the functions the main path runs
    at this shape: both at (1000, 1 << 20), the median at the dense
    trial's shape."""
    import torch

    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.ops import column_select as cs

    x = torch.randn((rows, d), generator=gen, device="cuda")
    nbytes = rows * d * 4 + d * 4
    k = rows // 4
    out = {}
    for name, agg, fn, plain in (
            ("column_median", ("median",), cs.column_median,
             cs.column_median_plain),
            ("column_trimmed_mean", ("trimmed", k),
             lambda a: cs.column_trimmed_mean(a, k),
             lambda a: cs.column_trimmed_mean_plain(a, k))):
        tag = f"{name} ({rows}, {d})"
        before = dict(_cuda.MAPS)
        got = fn(x)
        _select_took(before, name, x, vec, tag)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(x)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bits_fn = lambda: _cuda.launch_finish(  # noqa: E731
            "finish:bitserial select", x, agg=agg, want_sq=False,
            route="bitserial")[0]
        old = bits_fn()
        if name == "column_median":
            err = same(got, want, tag)
            same(old, want, f"{tag}, bit-serial")
        else:
            err = close(got, want, tag, rtol=TRIM_TOL, atol=TRIM_TOL)
            close(old, want, f"{tag}, bit-serial", rtol=TRIM_TOL,
                  atol=TRIM_TOL)
        del want, old
        ms = timed(lambda: fn(x), REPS)[0]
        old_ms = timed(bits_fn, REPS)[0]
        lib_ms = None
        if name == "column_median":
            # On NaN-free columns the midpoint median is the 0.5 quantile
            # with linear interpolation: one PyTorch call, the yardstick.
            lib_ms = timed(lambda: torch.quantile(x, 0.5, dim=0), REPS)[0]
        plan = _cuda.select_plan(rows, d, x.data_ptr())
        part = {p: timed(lambda p=p: _cuda.launch_select(
            "select:radix phases", x, agg, probe=p), REPS)[0] for p in (1, 2)}
        alt = ""
        if plan.resident:
            alt_ms = timed(lambda: _cuda.launch_select(
                "select:radix phases", x, agg,
                geometry=dict(resident=False)), REPS)[0]
            alt = f", streaming plan {alt_ms:.3f} ms"
        # Per element: at least one compare for the median, a compare and
        # an add for the trimmed mean.
        rec = _record(name + suffix, SELECT_SRC, SELECT_TPU[name], ms,
                      plain_ms, nbytes, (1 if name == "column_median" else 2)
                      * rows * d, err, lib_ms)
        log(f"kernel {tag}: select:radix {ms:.3f} ms ({plan}), bit-serial "
            f"{old_ms:.3f} ms, torch.quantile "
            f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
            f"{rec['bound_ms']:.3f} ms; select:radix phases: loads alone "
            f"{part[1]:.3f} ms ({rows * d * 4 / part[1] / 1e9:.2f} TB/s), "
            f"passes alone {part[2]:.3f} ms{alt}")
        if suffix == "" or name == "column_median":
            out[name + suffix] = rec
    del x
    torch.cuda.empty_cache()
    return out


ROWSTATS_SRC = "blades_tpu_torch/csrc/rowstats.cu"
ROWSTATS_TPU = "blades_tpu/ops/pallas_rowstats.py:98"
GRAM_RECORD = "row_stats_bundle:gram"
GEOMED_RECORD = "row_stats_bundle:wsum+gram_dot"
WSUM_RECORD = "row_stats_bundle:wsum"


def _mm_ms(a):
    """Device ms of ``torch.mm(a, a.t(), out_dtype=float32)`` (X X^T of bf16
    rows with f32 output), or None where torch takes no ``out_dtype``."""
    import torch

    try:
        torch.mm(a[:2, :8], a[:2, :8].t(), out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        log(f"kernel {GRAM_RECORD}: library_ms null: torch.mm takes no "
            f"out_dtype here ({type(e).__name__}: {e})")
        return None
    return timed(lambda: torch.mm(a, a.t(), out_dtype=torch.float32),
                 REPS)[0]


def _round_buffer(gen, d):
    """The row-geometry round's operand: the ``(1000, d_alloc)`` bf16
    buffer, zero past ``d``, random updates of scale 1e-3 before it."""
    import torch

    n, d_alloc = 1000, -(-d // 512) * 512
    x = torch.zeros((n, d_alloc), dtype=torch.bfloat16, device="cuda")
    for r0 in range(0, n, 100):  # f32 draws a block of rows at a time
        x[r0:r0 + 100, :d] = (torch.randn((100, d), generator=gen,
                                          device="cuda") * 1e-3).to(x.dtype)
    return x


def _ring_bundles(x, d, gen):
    """The four bundles the planner issues on the round's buffer, as
    ``name -> (kwargs on x, kwargs on x[:, :d], operations, bytes)``:
    GeoMed's / Centeredclipping's weighted sum + Gram-vector product of
    one vector (the planner marks it shared), every defense's last
    weighted sum, Signguard's sign counts and FLTrust's / Centeredclipping's
    dots.  The operations are those of the function on the true width
    (w^T X once for both, X t: 2 n d each; two compares a sign count; a
    product and an add a dot); the bytes read X once, the vectors once,
    and write the outputs."""
    import torch

    n = x.shape[0]
    w = torch.rand((1, n), generator=gen, device="cuda") + 0.5
    w = w / w.sum()
    v = torch.zeros((1, x.shape[1]), device="cuda")
    v[:, :d] = torch.randn((1, d), generator=gen, device="cuda") * 1e-3
    vu = v[:, :d].contiguous()
    xb = n * d * 2
    return {
        GEOMED_RECORD: (dict(weights=w, gram_dot=w, gram_dot_shared=(0,),
                             d_true=d),
                        dict(weights=w, gram_dot=w), 4 * n * d,
                        xb + n * 4 + d * 4 + n * 4),
        WSUM_RECORD: (dict(weights=w, d_true=d), dict(weights=w), 2 * n * d,
                      xb + n * 4 + d * 4),
        "row_stats_bundle:signs": (dict(signs=True, d_true=d),
                                   dict(signs=True), 2 * n * d,
                                   xb + n * 12),
        "row_stats_bundle:dots": (dict(dots=v, d_true=d), dict(dots=vu),
                                  2 * n * d, xb + d * 4 + n * 4),
    }


def _bundle_library_ms(name, x, kw):
    """``(ms, text)`` of the one PyTorch call computing a bundle, where
    there is one: the weighted sum ``w @ X`` and the dots ``X @ v`` as
    ``torch.mm`` of bf16 operands with f32 output (the f32 vector rounded
    to bf16, as the matrix product takes one dtype); ``(None, why)`` for
    the others."""
    import torch

    if name == WSUM_RECORD:
        a, b, what = kw["weights"].to(x.dtype), x, "w @ X"
    elif name == "row_stats_bundle:dots":
        a, b, what = x, kw["dots"].to(x.dtype).t(), "X @ v"
    else:
        return None, "library_ms null: no one PyTorch call computes this " \
            "bundle"
    try:
        torch.mm(a[:1, :8], b[:8, :1], out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        return None, (f"library_ms null: torch.mm takes no out_dtype here "
                      f"({type(e).__name__})")
    ms = timed(lambda: torch.mm(a, b, out_dtype=torch.float32), REPS)[0]
    return ms, f"library {ms:.3f} ms (torch.mm {what}, bf16, f32 out)"


def _bundle_records(gen, d):
    """``row_stats_bundle`` at the row-geometry round's operand: the
    ``(1000, d_alloc)`` bf16 buffer, zero past ``d``, read with ``d_true =
    d``.  Multikrum's Gram bundle (its norms come from the round's in-place
    pass; the TMA + wgmma route), beside its old route on the unpadded
    ``(1000, d)`` matrix (``gram:mma``, the rows 4- but not 16-byte
    aligned) and ``torch.mm`` on both operands; then the four row-statistic
    bundles the planner issues on ``rowstats:ring``, each beside
    ``rowstats:slab`` on the unpadded matrix in the same call, and where
    the ring's time goes (:func:`_ring_phases`)."""
    import torch

    from blades_tpu_torch.ops import rowstats as rs

    n = 1000
    x = _round_buffer(gen, d)
    d_alloc = x.shape[1]
    xu = x[:, :d].contiguous()
    records = {}
    kw = dict(gram=True, d_true=d)
    before = _gram_routes()
    got = rs.row_stats_bundle(x, **kw)
    took = _gram_routes_since(before)
    check(took == {"gram:wgmma": 1}, f"{GRAM_RECORD} (main shape): Gram "
          f"routes {took}, expected {{'gram:wgmma': 1}}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rs.row_stats_bundle_plain(x, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = rowstats_agree(got, want, x, kw, f"{GRAM_RECORD} (main shape)")
    del got
    ms = timed(lambda: rs.row_stats_bundle(x, **kw), REPS)[0]
    lib_ms = _mm_ms(x)
    before = _gram_routes()
    old = rs.row_stats_bundle(xu, gram=True)
    took = _gram_routes_since(before)
    check(took == {"gram:mma": 1}, f"{GRAM_RECORD} unpadded: Gram routes "
          f"{took}, expected {{'gram:mma': 1}}")
    old_err = rowstats_agree(old, want, x, kw,
                             f"{GRAM_RECORD} old route (unpadded)")
    del old, want
    old_ms = timed(lambda: rs.row_stats_bundle(xu, gram=True), REPS)[0]
    lib_old = _mm_ms(xu)
    log(f"kernel {GRAM_RECORD}: gram:wgmma on ({n}, {d_alloc}) {ms:.3f} ms "
        f"({_gram_rates(n, d_alloc, ms)}), torch.mm {lib_ms} ms; "
        f"gram:mma on the unpadded ({n}, {d}) "
        f"{old_ms:.3f} ms (max_abs_err {old_err:.3g}), torch.mm "
        f"{lib_old} ms")
    records[GRAM_RECORD] = _record(
        GRAM_RECORD, ROWSTATS_SRC, ROWSTATS_TPU, ms, plain_ms,
        n * d * 2 + n * n * 4, n * (n + 1) // 2 * d * 2, err, lib_ms,
        ops_per_s=BF16_TENSOR_OPS_PER_S)

    for name, (kw, kwu, ops, nbytes) in _ring_bundles(x, d, gen).items():
        before = _rowstats_routes()
        got = rs.row_stats_bundle(x, **kw)
        _rowstats_took(before, "rowstats:ring", f"{name} (main shape)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = rs.row_stats_bundle_plain(x, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = rowstats_agree(got, want, x, kw, f"{name} (main shape)")
        _same_outputs(got, rs.row_stats_bundle(x, **kw),
                      f"{name} (main shape): two launches")
        del got
        ms = timed(lambda: rs.row_stats_bundle(x, **kw), REPS)[0]
        before = _rowstats_routes()
        old = rs.row_stats_bundle(xu, **kwu)
        _rowstats_took(before, "rowstats:slab", f"{name} unpadded")
        old_err = rowstats_agree(old, want, xu, kwu,
                                 f"{name} old route (unpadded)")
        del old, want
        old_ms = timed(lambda: rs.row_stats_bundle(xu, **kwu), REPS)[0]
        lib_ms, lib = _bundle_library_ms(name, x, kw)
        rec = _record(name, ROWSTATS_SRC, ROWSTATS_TPU, ms, plain_ms, nbytes,
                      ops, err, lib_ms)
        log(f"kernel {name}: rowstats:ring on ({n}, {d_alloc}) {ms:.3f} ms "
            f"({n * d_alloc * 2 / ms / 1e9:.2f} TB/s of rows read; bound "
            f"{rec['bound_ms']:.3f} ms); rowstats:slab on the unpadded "
            f"({n}, {d}) {old_ms:.3f} ms (max_abs_err {old_err:.3g}); "
            f"plain {plain_ms:.1f} ms; {lib}")
        if name in (GEOMED_RECORD, WSUM_RECORD):
            records[name] = rec
    del xu
    torch.cuda.empty_cache()
    _ring_phases(x, d, gen)
    del x
    torch.cuda.empty_cache()
    return records


def _ring_phases(x, d, gen):
    """Where ``rowstats:ring``'s time goes on the round's buffer: device-only
    ms of the ring's loads alone (one sweep, then GeoMed's two), the
    weighted sum (the loads and the column pass) and GeoMed's bundle (and
    its gram_dot sweep), each of those two also with its passes alone (on
    whatever the ring holds, no loads)."""
    from blades_tpu_torch.ops import _cuda

    name = "rowstats:ring phases"
    kws = _ring_bundles(x, d, gen)
    wsum, geomed = kws[WSUM_RECORD][0], kws[GEOMED_RECORD][0]
    cases = {
        "loads": (wsum, 1),
        "wsum passes": (wsum, 2),
        "wsum": (wsum, 0),
        "geomed loads": (geomed, 1),
        "geomed passes": (geomed, 2),
        "geomed": (geomed, 0),
    }
    ms = {k: timed(lambda kw=kw, p=p: _cuda.launch_rowstats(
        name, x, probe=p, **kw), REPS)[0] for k, (kw, p) in cases.items()}
    rate = x.numel() * 2 / ms["loads"] / 1e9
    log(f"kernel {name} on {tuple(x.shape)}: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + f"; the loads alone read the rows at {rate:.2f} TB/s; geometry "
        f"{_cuda.ring_plan(x.dtype, x.shape[0], 0, 1, 1, 1, False)}")


# Geometries the ``ringsweep`` phase times: bytes a slab row, rows a group,
# groups in flight.
RING_SWEEP = dict(rowb=(128, 256, 512), gh=(64, 128, 256, 512),
                  ahead=(1, 2, 3, 4))


def phase_ringsweep(out_dir: str):
    """``rowstats:ring`` across geometries on the round's buffer: the four
    bundles of :func:`_ring_bundles`, each checked against the plain
    version and timed device-only; the table goes to
    ``out_dir/ringsweep.txt``, the fastest three of each bundle and the
    default geometry's time to the log."""
    import itertools

    import torch

    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.ops import rowstats as rs

    gen = torch.Generator(device="cuda").manual_seed(6)
    d = RESNET10_D
    x = _round_buffer(gen, d)
    lines = []
    # (R, U, G, KF, integer partials) of each bundle, for its plans.
    shapes = {GEOMED_RECORD: (0, 1, 1, 1, False), WSUM_RECORD: (0, 1, 0, 0, False),
              "row_stats_bundle:signs": (0, 0, 0, 0, True),
              "row_stats_bundle:dots": (1, 0, 0, 1, False)}
    for name, (kw, _, _, _) in _ring_bundles(x, d, gen).items():
        want = rs.row_stats_bundle_plain(x, **kw)
        rows, seen = [], set()
        for rowb, gh, ahead in itertools.product(*RING_SWEEP.values()):
            try:
                plan = _cuda.ring_plan(x.dtype, x.shape[0], *shapes[name],
                                       rowb=rowb, gh=gh, ahead=ahead)
            except ValueError:  # two groups of this size do not fit
                continue
            if plan in seen:
                continue
            seen.add(plan)
            geo = dict(rowb=rowb, gh=gh, ahead=ahead)
            got = _cuda.launch_rowstats("ringsweep", x, geometry=geo, **kw)
            rowstats_agree(got, want, x, kw, f"ringsweep {name} {plan}")
            del got
            ms = timed(lambda: _cuda.launch_rowstats(
                "ringsweep", x, geometry=geo, **kw), REPS)[0]
            rows.append((ms, plan))
        rows.sort(key=lambda r: r[0])
        for ms, plan in rows:
            lines.append(f"{name} {ms:.4f} ms {plan}")
        default = timed(lambda: rs.row_stats_bundle(x, **kw), REPS)[0]
        log(f"ringsweep {name}: default geometry {default:.4f} ms; fastest "
            + "; ".join(f"{ms:.4f} ms ({x.numel() * 2 / ms / 1e9:.2f} TB/s) "
                        f"{plan}" for ms, plan in rows[:3]))
        del want
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ringsweep.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    log(f"ringsweep: {len(lines)} geometries, table in "
        f"{os.path.join(out_dir, 'ringsweep.txt')}")


# (rows, d) beside the round's operand for the Gram's TMA + wgmma route:
# one tile row, so every tile is diagonal and loads one operand box a
# stage (half the bytes per operation); a fifth of the width; and an
# operand that fits the 50 MB L2.
GRAM_SHAPES = ((128, RESNET10_D_ALLOC), (1000, 1 << 20), (1000, 16_384))


def _gram_rates(rows, d, ms, esize=2) -> str:
    """The rates of a ``(rows, d)`` Gram of ``esize``-byte elements on a
    128 x 128-tile route taking ``ms``: the operations of its whole tiles
    (TFLOP/s for bf16, TOP/s for int8), and the bytes they load into
    shared memory (a diagonal tile one 128-row box a stage, another tile
    two)."""
    nt = -(-rows // 128)
    npairs = nt * (nt + 1) // 2
    ops = npairs * 128 * 128 * 2 * d
    fill = (nt + 2 * (npairs - nt)) * 128 * d * esize
    unit = "TFLOP/s" if esize == 2 else "TOP/s"
    return (f"{ops / ms / 1e9:.1f} {unit} over the whole tiles, "
            f"{fill / ms / 1e9:.2f} TB/s into shared memory")


def _gram_shapes():
    """The Gram's TMA + wgmma route alone at :data:`GRAM_SHAPES`, beside
    ``torch.mm``: the rate of the whole tiles' operations and of the bytes
    the tiles move into shared memory, to place the kernel's limit against
    the round's operand (the ``row_stats_bundle:gram`` record)."""
    import torch

    from blades_tpu_torch.ops import rowstats as rs

    gen = torch.Generator(device="cuda").manual_seed(5)
    for rows, d in GRAM_SHAPES:
        x = torch.empty((rows, d), dtype=torch.bfloat16, device="cuda")
        for r0 in range(0, rows, 100):
            x[r0:r0 + 100] = (torch.randn((min(100, rows - r0), d),
                                          generator=gen, device="cuda")
                              * 1e-3).to(x.dtype)
        before = _gram_routes()
        ms = timed(lambda: rs.row_stats_bundle(x, gram=True), 4 * REPS)[0]
        took = _gram_routes_since(before)
        check(set(took) == {"gram:wgmma"}, f"gram shape ({rows}, {d}): "
              f"routes {took}")
        log(f"kernel gram shape ({rows}, {d}), {rows * d * 2 / 1e6:.0f} MB: "
            f"gram:wgmma {ms:.4f} ms, {_gram_rates(rows, d, ms)}; torch.mm "
            f"{_mm_ms(x)} ms")
        del x
        torch.cuda.empty_cache()


# The int8 Gram's sweep beside the wire payload (GRAM_SHAPES' counterpart):
# one tile row (every tile diagonal), a fifth and two fifths of the width
# (the same 128 x 128 tiles and at most 512 stages a CTA, over fewer
# columns), and an operand that fits the 50 MB L2.
GRAM8_SHAPES = ((128, GRAM8_WIRE[1]), (1000, 1 << 20), (1000, 2 << 20),
                (1000, 16_384))
GRAM8_FORGED = 250  # the wire round's identical forged rows


def _int8_payload(gen, rows, dp, d, forged=0):
    """A ``(rows, dp)`` int8 matrix that looks like the wire payload:
    values in -127..127 from ``gen`` (drawn a block of rows at a time),
    zero past ``d``, the first ``forged`` rows identical."""
    import torch

    x = torch.empty((rows, dp), dtype=torch.int8, device="cuda")
    for r0 in range(0, rows, 100):
        x[r0:r0 + 100] = torch.randint(-127, 128, (min(100, rows - r0), dp),
                                       generator=gen, device="cuda",
                                       dtype=torch.int8)
    x[:, d:] = 0
    if forged > 1:
        x[1:forged] = x[0]
    return x


def _int8_gram(x, route, what):
    """``row_stats_bundle(x, gram=True)``'s Gram, checked to take
    ``route`` once."""
    from blades_tpu_torch.ops import rowstats as rs

    before = _gram_routes()
    g = rs.row_stats_bundle(x, gram=True)["gram"]
    took = _gram_routes_since(before)
    check(took == {route: 1}, f"{what}: Gram routes {took}, expected "
          f"{{{route!r}: 1}}")
    return g


def _int_mm(x, want):
    """``torch._int_mm(x, x.T)`` (int32 sums) against the exact Gram
    ``want`` (f32): its device ms where it equals ``want`` once rounded to
    f32 (the same function: its sums did not wrap), else None; and a line
    that says which, with its time."""
    import torch

    try:
        g = torch._int_mm(x, x.t())
    except RuntimeError as e:
        return None, f"torch._int_mm does not take {tuple(x.shape)}: {e}"
    exact = torch.equal(g.float(), want)
    ms = timed(lambda: torch._int_mm(x, x.t()), REPS)[0]
    return ms if exact else None, (
        f"torch._int_mm(q, q.T) {ms:.3f} ms, "
        f"{'equal to' if exact else 'NOT equal to (int32 wraps)'} the "
        "exact Gram")


def _int8_gram_turns(gen):
    """The wire payload's int8 Gram on its two routes in turns, on the same
    bytes: a synthetic ``(1000, 4,903,248)`` payload (:func:`_int8_payload`
    with 250 identical forged rows, zero past ResNet-10's d) on
    ``gram:wgmma``, and a copy at a base 4- but not 16-byte aligned on
    ``gram:mma`` (``gram_mma_kernel``'s 4-byte ``cp.async`` loads): mma,
    wgmma, wgmma, mma, each bit-exact against the
    other and the plain version; ``torch._int_mm`` beside them; then the
    TMA route alone at :data:`GRAM8_SHAPES`, bit-exact, with its rates."""
    import torch

    from blades_tpu_torch.ops import rowstats as rs

    n, dp = GRAM8_WIRE
    x = _int8_payload(gen, n, dp, RESNET10_D, GRAM8_FORGED)
    flat = torch.empty((n * dp + 16,), dtype=torch.int8, device="cuda")
    xo = flat[4:4 + n * dp].view(n, dp)
    xo.copy_(x)
    check(xo.data_ptr() % 16 == 4, f"gram8: offset copy at {xo.data_ptr()}")
    got = _int8_gram(x, "gram:wgmma", "gram8 payload")
    old = _int8_gram(xo, "gram:mma", "gram8 payload, offset copy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rs.row_stats_bundle_plain(x, gram=True)["gram"]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same(got, want, "gram8 payload: gram:wgmma vs plain")
    same(old, got, "gram8 payload: gram:mma vs gram:wgmma")
    del got, old
    turns = []
    for xi in (xo, x, x, xo):
        turns.append(timed(lambda: rs.row_stats_bundle(xi, gram=True),
                           REPS)[0])
    lib_text = _int_mm(x, want)[1]
    peak = float(want.diagonal().max())
    bound = n * (n + 1) // 2 * dp * 2 / INT8_TENSOR_OPS_PER_S * 1e3
    log(f"kernel gram8 ({n}, {dp}) int8, {GRAM8_FORGED} identical rows: "
        f"gram:mma {turns[0]:.3f} ms, gram:wgmma {turns[1]:.3f} / "
        f"{turns[2]:.3f} ms, gram:mma {turns[3]:.3f} ms (in turns, "
        f"bit-exact); wgmma {_gram_rates(n, dp, turns[1], 1)}; mma "
        f"{_gram_rates(n, dp, turns[0], 1)}; bound {bound:.3f} ms "
        f"(operations, the symmetric half); plain {plain_ms:.1f} ms; "
        f"{lib_text} (int32 {'wraps' if peak > 2 ** 31 - 1 else 'holds'}: "
        f"largest exact entry {peak:.6g})")
    del x, xo, flat, want
    torch.cuda.empty_cache()
    for rows, d in GRAM8_SHAPES:
        x = _int8_payload(gen, rows, d, d)
        got = _int8_gram(x, "gram:wgmma", f"gram8 shape ({rows}, {d})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = rs.row_stats_bundle_plain(x, gram=True)["gram"]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        same(got, want, f"gram8 shape ({rows}, {d}): gram:wgmma vs plain")
        ms = timed(lambda: rs.row_stats_bundle(x, gram=True), 4 * REPS)[0]
        lib_text = _int_mm(x, want)[1]
        bound = max(rows * (rows + 1) // 2 * d * 2 / INT8_TENSOR_OPS_PER_S,
                    (rows * d + rows * rows * 4) / HBM_BYTES_PER_S) * 1e3
        log(f"kernel gram8 shape ({rows}, {d}), {rows * d / 1e6:.0f} MB: "
            f"gram:wgmma {ms:.4f} ms, {_gram_rates(rows, d, ms, 1)}, "
            f"bit-exact; bound {bound:.4f} ms; plain {plain_ms:.1f} ms; "
            f"{lib_text}")
        del x, got, want
        torch.cuda.empty_cache()


def _headline_round(n, f, prefix, rounds, block=50, hw=32, device=None,
                    profile_to=None, aggregator="Median", tag=None,
                    update_dtype=None):
    """Build the headline configuration at ``n`` clients (with
    ``aggregator`` in place of Median, ``update_dtype`` in place of bf16
    storage) and run ``rounds`` rounds; return the per-round losses,
    seconds, last metrics and the step.
    ``block``, ``hw`` and ``device`` shrink it for a rehearsal.  With
    ``profile_to`` (a directory) the last round runs under
    ``torch.profiler`` and its kernel table is written there as
    ``profile_<tag>.txt``."""
    import torch

    from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
    from blades_tpu_torch.core import FedRound, Server, TaskSpec
    from blades_tpu_torch.parallel.streamed import streamed_step

    shard, batch = 32, 32
    dev = device or "cuda"
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    fr = FedRound(
        task=TaskSpec(model="resnet", input_shape=(hw, hw, 3),
                      num_classes=10, lr=0.1,
                      compute_dtype="bfloat16").build(),
        server=Server.from_config(aggregator, num_byzantine=f, lr=0.5),
        adversary=get_adversary("ALIE", num_clients=n, num_byzantine=f),
        batch_size=batch, num_batches_per_round=1)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, shard, hw, hw, 3), generator=gen, device=dev)
    y = torch.randint(0, 10, (n, shard), generator=gen, device=dev)
    lengths = torch.full((n,), shard, device=dev)
    mal = make_malicious_mask(n, f, device=dev)
    state = fr.init(0, n, device=device)
    step = streamed_step(fr, client_block=block, malicious_prefix=prefix,
                         update_dtype=update_dtype or torch.bfloat16,
                         device=device)
    losses, secs = [], []
    for r in range(rounds):
        prof = None
        if profile_to and r == rounds - 1:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        sync()
        t0 = time.perf_counter()
        state, m = step(state, x, y, lengths, mal, r)
        sync()
        secs.append(time.perf_counter() - t0)
        if prof is not None:
            prof.__exit__(None, None, None)
            _write_profile(prof, secs[-1], profile_to, tag)
        losses.append(float(m["train_loss"]))
        check(math.isfinite(losses[-1]), f"round {r}: loss {losses[-1]}")
        check(math.isfinite(float(m["agg_norm"])),
              f"round {r}: agg_norm {float(m['agg_norm'])}")
    for k, v in state.server.params.items():
        check(bool(torch.isfinite(v).all()), f"non-finite parameter {k}")
    return losses, secs, m, step


def _busy_us(prof) -> float:
    """Device busy time of a profile: the union of the device events'
    intervals (events on different streams may overlap, so their sum can
    exceed the wall)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, cur_start, cur_end = 0.0, None, None
    for a, b in spans:
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    return busy_us


def _write_profile(prof, wall_s, out_dir, tag):
    """Device time by kernel over one profiled round: the table goes to
    ``out_dir/profile_<tag>.txt``; the device's busy share and the time by
    kind of kernel are printed."""
    from torch.autograd import DeviceType

    events = []
    for e in prof.key_averages():
        # Device-side events only (kernels, memcpy, memset): the host ops
        # that launched them carry the same time again.
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            events.append((us, e.count, e.key))
    events.sort(reverse=True)
    kernel_us = sum(us for us, _, _ in events)
    busy_us = _busy_us(prof)
    kinds = {}
    for us, _, key in events:
        k = key.lower()
        if "rowstats" in k or "gram_" in k:
            kind = "row statistics"
        elif "bn_reduce" in k or "bn_dx" in k:
            kind = "bn backward"
        elif ("finish_kernel" in k or "radix_kernel" in k
              or "finalize_kernel" in k):
            kind = "fused finish"
        elif any(w in k for w in ("conv", "cudnn", "xmma", "gemm", "cutlass",
                                  "wgrad", "dgrad", "sm90")):
            kind = "convolution / matmul"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + us
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"profile_{tag}.txt")
    with open(path, "w") as fh:
        fh.write(f"round wall {wall_s * 1e3:.1f} ms under the profiler, "
                 f"device busy {busy_us / 1e3:.1f} ms, kernel time summed "
                 f"{kernel_us / 1e3:.1f} ms\n")
        for us, count, key in events:
            fh.write(f"{us / 1e3:10.3f} ms {count:7d}x  {key}\n")
    log(f"profile {tag}: round {wall_s * 1e3:.1f} ms under the profiler, device "
        f"busy {busy_us / 1e3:.1f} ms ({100 * busy_us / 1e3 / (wall_s * 1e3):.1f}"
        f"% of the wall), kernel time summed {kernel_us / 1e3:.1f} ms; by "
        f"kind: " + ", ".join(
            f"{k} {v / 1e3:.1f} ms" for k, v in sorted(
                kinds.items(), key=lambda kv: -kv[1])))
    for us, count, key in events[:8]:
        log(f"profile {tag}:   {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
    log(f"profile {tag}: table in {path}")


def phase_profile(out_dir: str):
    """One warm-up and one profiled round of the main path, then of the
    row-geometry round (Multikrum), then of a GeoMed round."""
    _headline_round(1000, 250, 250, 2, profile_to=out_dir, tag="main")
    _headline_round(1000, 250, 250, 2, profile_to=out_dir,
                    aggregator={"type": "Multikrum", "num_byzantine": 250},
                    tag="rowgeom")
    _headline_round(1000, 250, 250, 2, profile_to=out_dir,
                    aggregator="GeoMed", tag="geomed")


def phase_main():
    import torch

    from blades_tpu_torch.ops import _cuda

    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    with _FinishSpy() as spy:
        losses, secs, m, _ = _headline_round(1000, 250, 250,
                                             1 + TIMED_ROUNDS)
    counts = dict(_cuda.LAUNCHES)
    rounds = 1 + TIMED_ROUNDS
    want_buf = [("fused_finish_compact", (750, RESNET10_D_ALLOC))] * rounds
    check(spy.seen == want_buf, f"main: finish buffers {spy.seen}, "
          f"expected {want_buf} (padded to 512-column stripes)")
    want = {"fused_finish_compact": rounds,
            **{k: BN_PER_ROUND * rounds for k in BN_TPU}}
    check(counts == want, f"main: launches {counts} over {rounds} rounds, "
          f"expected {want}")
    maps = dict(_cuda.MAPS)
    want_maps = {("fused_finish_compact", "finish:radix"): rounds,
                 **{(k, "vector"): BN_PER_ROUND * rounds for k in BN_TPU}}
    check(maps == want_maps, f"main: launches by route and thread map "
          f"{maps}, expected {want_maps} (the finish on the radix route, "
          "the BN kernels all on the vector map)")
    check(int(m["elided_lanes"]) == 250, "main: elision did not engage")
    rps = TIMED_ROUNDS / sum(secs[1:])
    log(f"main: ResNet-10 x 1000 clients (250 ALIE), Median, bf16; "
        f"{TIMED_ROUNDS} timed rounds at {rps:.4f} rounds/s "
        f"(round seconds {[round(s, 3) for s in secs]}, first is warm-up)")
    log(f"main: train_loss per round {losses}; compact finish launches "
        f"{counts['fused_finish_compact']} (all finish:radix), BN backward "
        f"launches "
        f"{counts['bn_bwd_reduce']} + {counts['bn_bwd_dx']}, all on the "
        f"vector map; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, rps


# The ``wide`` phase: ``main``'s protocol in the two configurations whose
# compact buffers the radix route cannot hold, (tag, clients, dtype).
WIDE_CONFIGS = (("a", 2000, "bfloat16"), ("b", 1000, "float32"))
WIDE_ROUNDS = 2  # timed after one warm-up round
WIDE_REPS = 3    # timed launches of each finish, after one warm-up launch


def _ring_agrees(got, old, want, fw, median, tag, bf16, full=False):
    """A ring launch against the plain version's ``want`` and
    ``finish_kernel``'s ``old`` on the same buffer (``(agg, sq, bad,
    forged)`` each; ``fw`` the plain forged row): flags bit for bit; the
    median bit for bit in every column whose two forged values are equal;
    the forged row, the aggregate and the row norms within :func:`close`
    (``full``: the forged rows' norms are the forged row's).  Returns the
    aggregate's max abs err against the plain version and the share of
    columns whose forged values are equal."""
    fsq = fw.square().sum().reshape(1) if full else None
    same(got[2], want[2], f"{tag}: bad vs plain")
    err = close(got[0], want[0], f"{tag}: agg vs plain", forged=fw,
                bf16=bf16)
    close(got[1], want[1], f"{tag}: sq vs plain", rtol=SQ_RTOL, forged=fsq,
          bf16=bf16)
    same(got[2], old[2], f"{tag}: bad vs finish_kernel")
    close(got[3], fw, f"{tag}: forged vs plain", forged=fw, bf16=bf16)
    close(got[3], old[3], f"{tag}: forged vs finish_kernel", forged=fw,
          bf16=bf16)
    eq = got[3] == old[3]
    if median:
        same(got[0][eq], old[0][eq],
             f"{tag}: median vs finish_kernel where the forged rows agree")
    close(got[0], old[0], f"{tag}: agg vs finish_kernel", forged=fw,
          bf16=bf16)
    close(got[1], old[1], f"{tag}: sq vs finish_kernel", rtol=SQ_RTOL,
          forged=fsq, bf16=bf16)
    return err, float(eq.float().mean())


class _RingAudit:
    """Wraps the streamed round's compact finish while ``wide`` runs: each
    launch must take ``finish:ring`` once and is held, set aside
    (:func:`_aside`), against the plain version and against
    ``finish_kernel`` on the same buffer (:func:`_ring_agrees`).  At the
    first launch both kernels are timed device-only on that buffer in
    turns (bit-serial, ring, ring, bit-serial), the plain version once,
    the ring with parts of its work switched off, and the full finish on
    the same buffer with its first quarter malicious (held and timed the
    same way)."""

    def __init__(self):
        self.launches = 0
        self.times = None
        self.aside_s = []  # each launch's audit seconds, inside its round

    def _audit(self, buf, noise, kw, got):
        import torch

        from blades_tpu_torch.ops import _cuda
        from blades_tpu_torch.ops import fused_finish as ff

        bf16 = buf.dtype == torch.bfloat16
        median = kw["agg"][0] == "median"
        tag = f"wide {tuple(buf.shape)} {buf.dtype}"
        opts = dict(noise=noise, forge=kw["forge"], agg=kw["agg"],
                    sanitize=kw["sanitize"], want_forged=True)

        def old_fn():
            return _cuda.launch_finish(
                "finish:bitserial wide", buf, mult=kw["forged_mult"],
                compact=True, route="bitserial", **opts)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ff.fused_finish_compact_plain(buf, noise, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, eq = _ring_agrees(got, old_fn(), want, want[3], median, tag,
                               bf16)
        del want
        if self.times is not None:
            return
        rows, d_alloc = buf.shape

        def ring_fn():
            return ff.fused_finish_compact(buf, noise, **kw)

        turns = [timed(fn, WIDE_REPS)[0]
                 for fn in (old_fn, ring_fn, ring_fn, old_fn)]
        # Where the ring's time goes: parts of its work switched off.
        alie = dict(mult=kw["forged_mult"], forge=kw["forge"],
                    agg=kw["agg"], compact=True)
        parts = {"mean": dict(agg=("mean",), want_sq=False),
                 "mean+norms": dict(agg=("mean",)),
                 "median": dict(agg=("median",), want_sq=False),
                 "alie+median": alie,
                 "alie+median+sanitize": dict(alie, sanitize=True)}
        phase_ms = {k: timed(lambda o=o: _cuda.launch_finish(
            "finish:ring phases", buf, **o), WIDE_REPS)[0]
            for k, o in parts.items()}
        # The full finish over the same buffer, the first quarter forged.
        mal = torch.arange(rows, device=buf.device) < rows // 4
        full = {r: (lambda r=r: _cuda.launch_finish(
            f"finish:{r} wide full", buf, active=~mal, route=r, **opts))
            for r in ("ring", "bitserial")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ff.fused_finish_plain(buf, mal, noise, forge=kw["forge"],
                                     agg=kw["agg"], sanitize=kw["sanitize"])
        torch.cuda.synchronize()
        full_plain_ms = (time.perf_counter() - t0) * 1e3
        fw = ff.fused_finish_compact_plain(
            buf[rows // 4:], noise, forged_mult=1, forge=kw["forge"],
            agg=("mean",), sanitize=kw["sanitize"])[3]
        full_err, _ = _ring_agrees(full["ring"](), full["bitserial"](),
                                   want, fw, median, f"{tag} full", bf16,
                                   full=True)
        del want, fw
        full_turns = [timed(full[r], WIDE_REPS)[0]
                      for r in ("bitserial", "ring", "ring", "bitserial")]
        self.times = dict(bits=(turns[0], turns[3]),
                          ring=(turns[1], turns[2]), plain=plain_ms,
                          err=err, eq=eq,
                          read=rows * d_alloc * buf.element_size(),
                          small=rows * 5 + 2 * d_alloc * 4,
                          ops=7 * rows * d_alloc, shape=(rows, d_alloc),
                          phases=phase_ms, full=full_turns,
                          full_plain=full_plain_ms, full_err=full_err)

    def __enter__(self):
        from blades_tpu_torch.parallel import streamed

        self.mod, self.real = streamed, streamed.fused_finish_compact

        def wrapped(buf, noise=None, **kw):
            before = _finish_routes()
            got = self.real(buf, noise, **kw)
            _took_route(before, "fused_finish_compact", "ring",
                        f"wide {tuple(buf.shape)} {buf.dtype}")
            self.launches += 1
            t0 = time.perf_counter()
            with _aside():
                self._audit(buf, noise, kw, got)
            self.aside_s.append(time.perf_counter() - t0)
            return got

        streamed.fused_finish_compact = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.fused_finish_compact = self.real


def _wide_rounds(n, dtype, route=None):
    """``main``'s protocol at ``n`` clients, a quarter ALIE and elided,
    ``dtype`` storage: one warm-up and :data:`WIDE_ROUNDS` timed rounds;
    with ``route`` every finish is sent to that route (the parent's
    routing), unaudited.  Returns rounds/s, the peak, the audit and the
    launch counts by route."""
    import torch

    from blades_tpu_torch.ops import _cuda

    rounds = 1 + WIDE_ROUNDS
    _reset_peak()
    _cuda.reset_launches()
    real_route = _cuda.finish_route
    audit = _RingAudit()
    try:
        if route is not None:
            _cuda.finish_route = lambda *a: route
            ctx = contextlib.nullcontext()
        else:
            ctx = audit
        with _FinishSpy() as spy, ctx:
            losses, secs, m, step = _headline_round(
                n, n // 4, n // 4, rounds, update_dtype=getattr(torch, dtype))
    finally:
        _cuda.finish_route = real_route
    rows = n - n // 4
    want_buf = [("fused_finish_compact", (rows, RESNET10_D_ALLOC))] * rounds
    check(spy.seen == want_buf, f"wide: finish buffers {spy.seen}, expected "
          f"{want_buf}")
    check(dict(step.routes) == {"fused_compact": rounds},
          f"wide: rounds by finish {dict(step.routes)}, expected "
          f"fused_compact x {rounds}")
    check(int(m["elided_lanes"]) == n // 4, "wide: elision did not engage")
    took = _finish_routes()
    want = {("fused_finish_compact", "finish:" + (route or "ring")): rounds}
    check(took == want, f"wide: finish routes {took}, expected {want}")
    if route is None:
        check(audit.launches == rounds, f"wide: {audit.launches} audited "
              f"launches, expected {rounds}")
        # Each round's audit, set aside, comes out of its seconds.
        secs = [t - a for t, a in zip(secs, audit.aside_s)]
    rps = WIDE_ROUNDS / sum(secs[1:])
    return rps, _peak(), audit, losses, dict(_cuda.MAPS)


def phase_wide(card):
    """``main``'s protocol where the radix route cannot take the compact
    buffer: (a) 2,000 clients, bf16 (1,500 benign rows); (b) 1,000 clients,
    f32 updates (750 rows).  Each runs first on the ring route, every
    launch audited (:class:`_RingAudit`), then with every finish sent to
    the bit-serial ``finish_kernel`` (the parent's routing), and prints
    rounds/s and the peak of both, the two kernels' device-only ms on the
    round's own buffer (parent, change, change, parent) and the bound."""
    counts, records = {}, {}
    for tag, n, dtype in WIDE_CONFIGS:
        rps, peak, audit, losses, maps = _wide_rounds(n, dtype)
        name = "finish:ring" if dtype == "bfloat16" else "finish:ring:f32"
        counts[name] = maps[("fused_finish_compact", "finish:ring")]
        old_rps, old_peak, _, _, _ = _wide_rounds(n, dtype, route="bitserial")
        t = audit.times
        rec = _record(name, SRC, COMPACT_TPU, sum(t["ring"]) / 2, t["plain"],
                      t["read"] + t["small"], t["ops"], t["err"])
        records[name] = rec
        log(f"wide ({tag}): ResNet-10 x {n} clients ({n // 4} ALIE, elided), "
            f"Median, {dtype} updates: compact finish on {t['shape']}; ring "
            f"{WIDE_ROUNDS} timed rounds at {rps:.4f} rounds/s (losses "
            f"{losses}), peak {peak / 2**30:.2f} GiB; bit-serial routing "
            f"{old_rps:.4f} rounds/s, peak {old_peak / 2**30:.2f} GiB [{card}]")
        log(f"wide ({tag}): device-only ms on the round's buffer, parent, "
            f"change, change, parent: finish_kernel {t['bits'][0]:.3f}, ring "
            f"{t['ring'][0]:.3f}, ring {t['ring'][1]:.3f}, finish_kernel "
            f"{t['bits'][1]:.3f}; bound {rec['bound_ms']:.3f} "
            f"({rec['bound_by']}); plain {t['plain']:.1f}; "
            f"{100 * t['eq']:.2f}% of columns with equal forged values "
            f"(the median bit for bit there) [{card}]")
        f = t["full"]
        log(f"wide ({tag}): the full finish on the same buffer, the first "
            f"quarter forged, device-only ms, parent, change, change, "
            f"parent: finish_kernel {f[0]:.3f}, ring {f[1]:.3f}, ring "
            f"{f[2]:.3f}, finish_kernel {f[3]:.3f}; plain "
            f"{t['full_plain']:.1f}; max_abs_err {t['full_err']:.3g} vs "
            f"plain [{card}]")
        rate = t["read"] / t["phases"]["mean"] / 1e9
        log(f"wide ({tag}): finish:ring phases on {t['shape']}: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in t["phases"].items())
            + f"; the mean pass reads the rows at {rate:.2f} TB/s [{card}]")
    return counts, records


def phase_full():
    from blades_tpu_torch.ops import _cuda

    _cuda.reset_launches()
    with _FinishSpy() as spy:
        losses, secs, m, _ = _headline_round(200, 50, None, 1)
    counts = dict(_cuda.LAUNCHES)
    want_buf = [("fused_finish", (200, RESNET10_D_ALLOC))]
    check(spy.seen == want_buf, f"full: finish buffers {spy.seen}, "
          f"expected {want_buf}")
    # 200 clients, none elided: 4 blocks of 50, 12 BN layers each.
    want = {"fused_finish": 1, **{k: 4 * 12 for k in BN_TPU}}
    check(counts == want, f"full: launches {counts}, expected {want}")
    routes = _finish_routes()
    check(routes == {("fused_finish", "finish:radix"): 1},
          f"full: finish routes {routes}, expected radix once")
    check("elided_lanes" not in m, "full: elision engaged without a prefix")
    log(f"full: ResNet-10 x 200 clients, no prefix: loss {losses[0]}, "
        f"{secs[0]:.3f} s, full finish launches {counts['fused_finish']}")
    return {"fused_finish": counts["fused_finish"]}


def phase_aggregators():
    """The dense aggregator path: ``Median`` and ``Trimmedmean`` on a CUDA
    update matrix go through the column-select kernels."""
    import torch

    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.ops.aggregators import get_aggregator

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((1000, 1 << 20), generator=gen, device="cuda")
    _cuda.reset_launches()
    med, _ = get_aggregator("Median")(x)
    tm, _ = get_aggregator("Trimmedmean", num_byzantine=250)(x)
    torch.cuda.synchronize()
    counts = dict(_cuda.LAUNCHES)
    check(counts == {"column_median": 1, "column_trimmed_mean": 1},
          f"aggregators: launches {counts}")
    routes = dict(_cuda.MAPS)
    check(routes == {("column_median", "select:radix"): 1,
                     ("column_trimmed_mean", "select:radix"): 1},
          f"aggregators: routes {routes}, expected select:radix each once")
    check(bool(torch.isfinite(med).all() and torch.isfinite(tm).all()),
          "aggregators: non-finite aggregate")
    log(f"aggregators: Median and Trimmedmean launches {counts}")
    return counts


class _FinishSpy:
    """Records ``(wrapper name, buf.shape)`` of every buffer the streamed
    round hands its fused finish."""

    NAMES = ("fused_finish", "fused_finish_compact")

    def __enter__(self):
        from blades_tpu_torch.parallel import streamed

        self.mod = streamed
        self.real = {k: getattr(streamed, k) for k in self.NAMES}
        self.seen = []

        def spy(name):
            def wrapped(buf, *args, **kw):
                self.seen.append((name, tuple(buf.shape)))
                return self.real[name](buf, *args, **kw)
            return wrapped

        for k in self.NAMES:
            setattr(streamed, k, spy(k))
        return self

    def __exit__(self, *exc):
        for k, v in self.real.items():
            setattr(self.mod, k, v)


class _BufferSpy:
    """Records ``(buf.shape, d)`` of every buffer the streamed round hands
    its row-geometry aggregator."""

    def __enter__(self):
        from blades_tpu_torch.parallel import streamed

        self.mod, self.real = streamed, streamed.aggregate_streamed
        self.seen = []

        def spy(agg, buf, *args, **kw):
            self.seen.append((tuple(buf.shape), kw.get("d")))
            return self.real(agg, buf, *args, **kw)

        streamed.aggregate_streamed = spy
        return self

    def __exit__(self, *exc):
        self.mod.aggregate_streamed = self.real


def phase_rowgeom():
    """The row-geometry round at 1000 clients: Multikrum (1 warm-up + 2
    timed rounds), then one GeoMed round.  Each bundle of the planner's is
    one ``row_stats_bundle`` launch: Multikrum's Gram and its weighted sum
    per round; GeoMed's first bundle and one per Weiszfeld iteration.  The
    buffer is ``(1000, d_alloc)``, and Multikrum's Gram takes the TMA +
    wgmma route once per round."""
    import torch

    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.ops.clustering import agglomerative_majority

    counts = {}
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    rounds = 1 + ROWGEOM_ROUNDS
    with _BufferSpy() as spy:
        losses, secs, m, step = _headline_round(
            1000, 250, 250, rounds,
            aggregator={"type": "Multikrum", "num_byzantine": 250})
    launches = dict(_cuda.LAUNCHES)
    routes = _gram_routes()
    rs_routes = _rowstats_routes()
    want_buf = [((1000, RESNET10_D_ALLOC), RESNET10_D)] * rounds
    check(spy.seen == want_buf, f"rowgeom: Multikrum buffers (shape, d) "
          f"{spy.seen}, expected {want_buf}")
    check(routes == {"gram:wgmma": rounds}, f"rowgeom: Multikrum Gram "
          f"routes {routes} over {rounds} rounds, expected "
          f"{{'gram:wgmma': {rounds}}}")
    check(rs_routes == {"rowstats:ring": rounds}, f"rowgeom: Multikrum "
          f"row-statistics routes {rs_routes} over {rounds} rounds, expected "
          f"{{'rowstats:ring': {rounds}}} (the weighted sum; the Gram "
          "bundle holds no row statistic)")
    check(step.passes.kernel_bundles == 2,
          f"rowgeom: Multikrum served {step.passes.kernel_bundles} bundles "
          "by the kernel, expected 2 (Gram, weighted sum)")
    want = {"row_stats_bundle": 2 * rounds,
            **{k: BN_PER_ROUND * rounds for k in BN_TPU}}
    check(launches == want, f"rowgeom: Multikrum launches {launches} over "
          f"{rounds} rounds, expected {want}")
    # As the CPU tests pin against the JAX round: the in-place pass, the
    # Gram bundle, the weighted-sum bundle.
    check(int(m["hbm_passes"]) == 3 and int(m["hbm_passes_unfused"]) == 3,
          f"rowgeom: hbm_passes {m['hbm_passes']} / "
          f"{m['hbm_passes_unfused']}, expected 3 / 3")
    check(int(m["elided_lanes"]) == 250, "rowgeom: elision did not engage")
    counts[GRAM_RECORD] = routes["gram:wgmma"]
    counts[WSUM_RECORD] = rs_routes["rowstats:ring"]
    rps = ROWGEOM_ROUNDS / sum(secs[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"rowgeom: Multikrum(250), ALIE, bf16, 1000 clients: "
        f"{ROWGEOM_ROUNDS} timed rounds at {rps:.4f} rounds/s (round "
        f"seconds {[round(t, 3) for t in secs]}, first is warm-up); "
        f"train_loss {losses}; row_stats_bundle launches "
        f"{launches['row_stats_bundle']} ({step.passes.kernel_bundles} per "
        f"round; Gram {routes}, row statistics {rs_routes}), buffer "
        f"{spy.seen[0][0]}, BN backward "
        f"launches {launches['bn_bwd_reduce']} + {launches['bn_bwd_dx']}; "
        f"hbm_passes {int(m['hbm_passes'])}; peak memory {peak:.2f} GiB")

    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    losses, secs, m, step = _headline_round(1000, 250, 250, 1,
                                            aggregator="GeoMed")
    launches = dict(_cuda.LAUNCHES)
    iters = step.passes.loop_iters
    want = {"row_stats_bundle": 1 + iters,
            **{k: BN_PER_ROUND for k in BN_TPU}}
    check(launches == want, f"rowgeom: GeoMed launches {launches}, expected "
          f"{want} (1 + {iters} Weiszfeld iterations)")
    check(_gram_routes() == {}, f"rowgeom: GeoMed launched a Gram "
          f"{_gram_routes()}")
    rs_routes = _rowstats_routes()
    check(rs_routes == {"rowstats:ring": 1 + iters}, f"rowgeom: GeoMed "
          f"row-statistics routes {rs_routes}, expected {{'rowstats:ring': "
          f"{1 + iters}}} (1 + {iters} Weiszfeld iterations)")
    check(int(m["hbm_passes"]) == 102 and int(m["hbm_passes_unfused"]) == 203,
          f"rowgeom: GeoMed hbm_passes {m['hbm_passes']} / "
          f"{m['hbm_passes_unfused']}, expected 102 / 203")
    counts[GEOMED_RECORD] = rs_routes["rowstats:ring"]
    log(f"rowgeom: GeoMed, ALIE, bf16, 1000 clients: one round "
        f"{secs[0]:.3f} s ({1 / secs[0]:.4f} rounds/s), {iters} Weiszfeld "
        f"iterations, row_stats_bundle launches "
        f"{launches['row_stats_bundle']} ({rs_routes}); train_loss "
        f"{losses}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # The exact average-linkage loop (Clippedclustering) at 1000 clients:
    # n - 2 sequential steps in eager torch, not a kernel.
    gen = torch.Generator(device="cuda").manual_seed(4)
    u = torch.randn((1000, 64), generator=gen, device="cuda")
    u = u / (u * u).sum(1, keepdim=True).sqrt()
    dist = 1.0 - (u @ u.T).clamp(-1.0, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maj = agglomerative_majority(dist, linkage="average")
    torch.cuda.synchronize()
    log(f"rowgeom: average-linkage clustering at 1000 clients "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms (majority "
        f"{int(maj.sum())})")
    return counts


# The fedavg phase's trials: the reference's configuration files at one
# point each, through FedavgConfig / Fedavg.train() / Fedavg.evaluate().
# From blades_tpu/tuned_examples/fedavg_cifar10_resnet_noniid.yaml, with
# num_batch_per_round 2 (so the second local step's grouped-convolution
# layout runs at full width) and 3 rounds then one evaluation.
DENSE_TRIAL = {
    "dataset_config": {"type": "cifar10", "num_clients": 60, "iid": False,
                       "alpha": 0.1, "train_bs": 64},
    "global_model": "resnet10",
    "client_config": {"lr": 1.0, "num_batch_per_round": 2},
    "server_config": {"lr": 0.1, "aggregator": {"type": "Median"},
                      "lr_schedule": [[0, 0.1], [1500, 0.1], [2000, 0.01]]},
    "num_malicious_clients": 15,
    "evaluation_interval": 3,
}
# From blades_tpu/tuned_examples/fedavg_cifar10_1000clients.yaml at its
# Median point: 2 rounds, one evaluation on 10 test rows per client.
STREAMED_TRIAL = {
    "dataset_config": {"type": "cifar10", "num_clients": 1000, "iid": False,
                       "alpha": 0.1, "train_bs": 32, "seed": 122},
    "global_model": "resnet10", "compute_dtype": "bfloat16",
    "execution": "streamed", "client_block": 25, "d_chunk": 131072,
    "update_dtype": "bfloat16", "health_check": True,
    "num_malicious_clients": 250, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 0.5, "aggregator": {"type": "Median"}},
    "client_config": {"lr": 0.1, "num_batch_per_round": 1},
    "evaluation_interval": 2, "evaluation_num_samples": 10,
}
# The verification flow of .claude/skills/verify/SKILL.md: synthetic MNIST,
# MLP, 6 clients, 2 running ALIE, Median, 3 rounds.
MLP_TRIAL = {
    "dataset_config": {"type": "mnist", "num_clients": 6, "train_bs": 8},
    "global_model": "mlp", "evaluation_interval": 3,
    "num_malicious_clients": 2, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 1.0, "aggregator": {"type": "Median"}},
}
MLP_MIN_ACC = 0.9


def _fedavg_trial(name, overrides, rounds, config_cls=None, on_build=None,
                  on_done=None):
    """Build ``Fedavg`` from ``overrides`` (through ``config_cls``, default
    ``FedavgConfig``), hand it to ``on_build`` before its first round, run
    ``rounds`` rounds (the last one evaluates), hand the driver and its
    rows to ``on_done`` before ``stop()``, print rounds/s, losses,
    accuracy and peak memory, and return the last row."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    algo = (config_cls or FedavgConfig)().update_from_dict(overrides).build()
    setup_s = time.perf_counter() - t0
    if on_build is not None:
        on_build(algo)
    rows, secs = [], []
    try:
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows.append(algo.train())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        streamed = algo.streamed
        if on_done is not None:
            on_done(algo, rows)
    finally:
        algo.stop()
    last = rows[-1]
    losses = [r["train_loss"] for r in rows]
    check(all(math.isfinite(v) for v in losses),
          f"fedavg {name}: train losses {losses}")
    for k in ("test_loss", "test_acc", "test_acc_top3"):
        check(k in last and math.isfinite(last[k]),
              f"fedavg {name}: no finite {k} in the last row {sorted(last)}")
    # The last round includes the evaluation; rounds/s counts the rounds
    # before it, after the first (warm-up).
    train_s = [r["timers"]["training_step"]["total_s"] for r in rows[-1:]][0]
    rps = ((rounds - 1) / (train_s - rows[0]["timers"]["training_step"]
                           ["total_s"]) if rounds > 1 else float("nan"))
    log(f"fedavg {name}: {'streamed' if streamed else 'dense'} round, setup "
        f"{setup_s:.1f} s, {rps:.4f} rounds/s over rounds 2-{rounds} "
        f"(wall per train() incl. evaluation {[round(t, 3) for t in secs]}); "
        f"train_loss {losses}; test_loss {last['test_loss']:.4f}, test_acc "
        f"{last['test_acc']:.4f}, top-3 {last['test_acc_top3']:.4f}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return last, streamed


def phase_fedavg():
    """The Fedavg driver on the card: the dense ResNet-10 trial under
    SignFlip and under LabelFlip, the 1000-client streamed trial, and the
    MLP accuracy check."""
    from blades_tpu_torch.ops import _cuda

    dense = 0
    for adv in ("SignFlip", "LabelFlip"):
        _cuda.reset_launches()
        _, streamed = _fedavg_trial(
            f"ResNet-10 x 60 {adv} Median f32",
            {**DENSE_TRIAL, "adversary_config": {"type": adv}}, 3)
        counts = dict(_cuda.LAUNCHES)
        # 60 clients in blocks of 50 and 10, 12 BN layers, 2 local steps,
        # 3 rounds; the dense Median goes through the column select.
        want = {"column_median": 3,
                **{k: 3 * 2 * 2 * 12 for k in BN_TPU}}
        check(not streamed and counts == want,
              f"fedavg {adv}: launches {counts}, expected {want} on the "
              "dense round")
        selects = {k: v for k, v in _cuda.MAPS.items()
                   if k[0] == "column_median"}
        check(selects == {("column_median", "select:radix"): 3},
              f"fedavg {adv}: column_median routes {selects}, expected "
              "select:radix 3 times")
        dense += 3
        log(f"fedavg {adv}: BN launches by thread map "
            f"{dict(_cuda.MAPS)}")
    _cuda.reset_launches()
    plain = []
    _, streamed = _fedavg_trial("ResNet-10 x 1000 ALIE Median bf16",
                                STREAMED_TRIAL, 2,
                                on_done=lambda a, rows: plain.extend(rows))
    counts = dict(_cuda.LAUNCHES)
    # 750 trained clients in blocks of 25, 12 BN layers, 2 rounds.
    want = {"fused_finish_compact": 2, **{k: 2 * 30 * 12 for k in BN_TPU}}
    check(streamed and counts == want,
          f"fedavg streamed: launches {counts}, expected {want}")
    routes = _finish_routes()
    check(routes == {("fused_finish_compact", "finish:radix"): 2},
          f"fedavg streamed: finish routes {routes}, expected radix twice")
    _momentum_trial(plain, want)
    last, _ = _fedavg_trial("MLP x 6 ALIE Median", MLP_TRIAL, 3)
    check(last["test_acc"] >= MLP_MIN_ACC,
          f"fedavg MLP: test accuracy {last['test_acc']} < {MLP_MIN_ACC}")
    return {"column_median:dense_trial": dense}


def _momentum_trial(plain, want):
    """The streamed trial again with client momentum 0.9: the same launches
    and ``finish:radix`` once a round, the elided lanes' traces still zero
    and every trained lane's moved, round 1 equal to the momentum-free
    run's (the traces start at zero; one local step) and round 2 not."""
    import torch

    from blades_tpu_torch.ops import _cuda

    seen = {}

    def done(algo, rows):
        opt = algo.state.client_opt
        f = rows[-1]["elided_lanes"]
        seen["elided"] = f
        seen["zero"] = all(not bool(v[:f].any()) for v in opt.values())
        moved = torch.zeros(opt[next(iter(opt))].shape[0] - f,
                            dtype=torch.bool, device=algo.device)
        for v in opt.values():
            moved |= (v[f:].flatten(1) != 0).any(1)
        seen["moved"] = bool(moved.all())
        seen["bytes"] = sum(v.numel() * v.element_size()
                            for v in opt.values())
        seen["rows"] = rows
        seen["peak"] = torch.cuda.max_memory_allocated()

    _cuda.reset_launches()
    overrides = {**STREAMED_TRIAL, "client_config": {
        **STREAMED_TRIAL["client_config"], "momentum": 0.9}}
    _, streamed = _fedavg_trial("ResNet-10 x 1000 ALIE Median bf16 client "
                                "momentum 0.9", overrides, 2, on_done=done)
    counts = dict(_cuda.LAUNCHES)
    check(streamed and counts == want,
          f"fedavg momentum: launches {counts}, expected {want}")
    routes = _finish_routes()
    check(routes == {("fused_finish_compact", "finish:radix"): 2},
          f"fedavg momentum: finish routes {routes}, expected radix twice")
    check(seen["zero"] and seen["moved"],
          f"fedavg momentum: the {seen['elided']} elided lanes' traces zero "
          f"{seen['zero']}, every trained lane's moved {seen['moved']}")
    a = [r["agg_norm"] for r in seen["rows"]]
    b = [r["agg_norm"] for r in plain]
    check(abs(a[0] - b[0]) <= 1e-5 * abs(b[0])
          and abs(a[1] - b[1]) > 1e-3 * abs(b[1]),
          f"fedavg momentum: agg_norm {a} against the momentum-free {b}: "
          "round 1 must agree, round 2 must not")
    log(f"fedavg momentum: streamed, finish:radix once a round; traces "
        f"{seen['bytes'] / 1e9:.2f} GB f32 (the {seen['elided']} elided "
        f"lanes' zero, every trained lane's moved); agg_norm {a} against "
        f"the momentum-free run's {b}; peak {seen['peak'] / 2**30:.2f} GiB")


# The chunked finish's trials: fedavg_cifar10_1000clients.yaml's Median
# point with the Noise forge of fedavg_cifar10_resnet_noniid.yaml:43
# (elided, as ALIE is), and fedavg_dp.yaml's budget (epsilon 10, its middle
# grid point) on the same 1000-client streamed configuration under ALIE.
NOISE_TRIAL = {**STREAMED_TRIAL, "adversary_config": {"type": "Noise"}}
DP_STREAMED_TRIAL = {**STREAMED_TRIAL, "dp_epsilon": 10.0, "dp_delta": 1e-6,
                     "dp_clip_threshold": 1.0}
# fedavg_dp.yaml at its epsilon-10, seed-121 point: MNIST, 60 clients, the
# MLP, Mean, 3 rounds (its evaluation at round 3).
DENSE_DP_TRIAL = {
    "dataset_config": {"type": "mnist", "num_clients": 60, "seed": 121},
    "global_model": "mlp", "evaluation_interval": 3, "dp_epsilon": 10.0,
    "dp_delta": 1e-6, "dp_clip_threshold": 1.0,
    "server_config": {"lr": 1.0, "aggregator": {"type": "Mean"}},
}
RESNET10_CHUNKS = -(-RESNET10_D // 131_072)  # 38 column chunks a round
OLD_CAP_CLIENTS = 6_000  # f32 rows; the bit-serial finish takes 4,874


class _ChunkedSpy:
    """Wraps a streamed step's chunked finish (``step.finish``): records
    each buffer's shape, hands every call a replayable draws provider
    (chunk ``i``'s draws from a generator seeded by its kind and ``i``),
    and keeps the first call's inputs and result for :meth:`check_plain`."""

    KINDS = {"dp": 1, "noise": 2, "adaptive": 3}

    def __init__(self, step):
        self.step, self.real = step, step.finish
        self.shapes, self.first = [], None
        step.finish = self

    def draws(self, kind, i, shape):
        import torch

        g = torch.Generator(device="cuda").manual_seed(
            1000 * self.KINDS[kind] + i)
        fn = torch.rand if kind == "adaptive" else torch.randn
        return fn(shape, generator=g, device="cuda")

    def __call__(self, server_state, buf, malicious, losses, row_norms=None,
                 *, d=None, draws=None):
        self.shapes.append(tuple(buf.shape))
        out = self.real(server_state, buf, malicious, losses, row_norms,
                        d=d, draws=self.draws)
        if self.first is None:
            self.first = ((server_state, buf, malicious, losses, row_norms),
                          d, out)
        return out

    def check_plain(self, what):
        """The first round's finish again on its buffer with the Median's
        plain version in place of ``select:radix``: the server parameters
        (``params + agg``) bit-exact, the metrics within ``RTOL``.  Returns
        the seconds the plain finish took."""
        import torch

        from blades_tpu_torch.ops import aggregators
        from blades_tpu_torch.ops.column_select import column_median_plain

        args, d, (server, m) = self.first
        kernel = aggregators.column_median
        aggregators.column_median = column_median_plain
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pserver, pm = self.real(*args, d=d, draws=self.draws)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        finally:
            aggregators.column_median = kernel
        for k, v in server.params.items():
            same(v, pserver.params[k], f"{what}: parameter {k} against the "
                 "plain chunked finish")
        for k in ("update_norm_mean", "agg_norm"):
            close(m[k].reshape(1), pm[k].reshape(1), f"{what}: {k}")
        self.first = None
        return plain_s


def _gate_vs_plan():
    """The streamed round's route gate (``_cuda.finish_fits`` and its
    Python mirrors of the two plans) against ``bt_finish_plan`` on both
    sides of each cap: the radix route's 1,317 bf16 rows, the bit-serial
    route's 4,874 f32 and 7,473 bf16 rows (slab width and shared memory
    equal too)."""
    import ctypes

    import torch

    from blades_tpu_torch.ops import _cuda

    lib = _cuda.library()
    cases = ([(torch.bfloat16, "radix", r) for r in (1316, 1317, 1318)]
             + [(torch.float32, "bitserial", r)
                for r in (4873, 4874, 4875, OLD_CAP_CLIENTS)]
             + [(torch.bfloat16, "bitserial", r) for r in (7472, 7473, 7474)])
    for dtype, route, rows in cases:
        esize = 2 if dtype == torch.bfloat16 else 4
        geom, smem, grid = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = lib.bt_finish_plan(int(esize == 2), _cuda.FINISH_ROUTES[route],
                                 rows, RESNET10_D_ALLOC, ctypes.byref(geom),
                                 ctypes.byref(smem), ctypes.byref(grid))
        if route == "radix":
            fits = _cuda.radix_smem(rows, 2) <= _cuda.RADIX_SMEM_CAP
        else:
            cols = _cuda.bitserial_plan(rows, esize)
            fits = cols > 0
            if err == 0:
                check(geom.value == cols and smem.value
                      == _cuda.bitserial_smem(rows, cols, esize),
                      f"gate: bit-serial plan at {rows} rows of {dtype}: "
                      f"{geom.value} columns, {smem.value} B on the card, "
                      f"{cols} / {_cuda.bitserial_smem(rows, cols, esize)} "
                      "in Python")
        check((err == 0) == fits, f"gate: {route} plan at {rows} rows of "
              f"{dtype}: the card says {'fits' if err == 0 else 'no'} "
              f"(error {err}), Python {'fits' if fits else 'no'}")
        # The padded buffer's rows are aligned: above radix's cap the fused
        # finish launches the ring route, whose plan must agree too.
        want = "radix" if route == "radix" and fits else "ring"
        took = _cuda.finish_route(dtype, RESNET10_D_ALLOC, 0, rows)
        check(took == want, f"gate: {rows} aligned rows of {dtype} route to "
              f"{took}, expected {want}")
        if took == "ring":
            err = lib.bt_finish_plan(int(esize == 2), _cuda.FINISH_ROUTES[
                "ring"], rows, RESNET10_D_ALLOC, ctypes.byref(geom),
                ctypes.byref(smem), ctypes.byref(grid))
            plan = _cuda.ring_finish_plan(rows, esize)
            check(err == 0 and (geom.value, smem.value)
                  == (plan.geom, plan.smem), f"gate: ring plan at {rows} "
                  f"rows of {dtype}: error {err}, {geom.value:#x} / "
                  f"{smem.value} B on the card, {plan} in Python")
    for dtype, last in ((torch.float32, 4874), (torch.bfloat16, 7473)):
        check(_cuda.finish_fits(dtype, last)
              and not _cuda.finish_fits(dtype, last + 1),
              f"gate: finish_fits({dtype}) flips elsewhere than {last}")
    log(f"chunked: the gate agrees with bt_finish_plan at {len(cases)} row "
        "counts around the caps (radix bf16 1,317; bit-serial f32 4,874, "
        "bf16 7,473); the aligned rows above radix's cap take finish:ring, "
        "whose plan agrees too")


def _chunked_counts(what, rounds, chunks, trained_blocks, bn_layers=12):
    """The launches of ``rounds`` chunked rounds: ``select:radix`` once per
    chunk, the BN pair per trained block and layer, no fused finish."""
    from blades_tpu_torch.ops import _cuda

    counts = dict(_cuda.LAUNCHES)
    want = {"column_median": rounds * chunks}
    if trained_blocks:
        want.update({k: rounds * trained_blocks * bn_layers for k in BN_TPU})
    check(counts == want, f"{what}: launches {counts}, expected {want}")
    routes = {k: v for k, v in _cuda.MAPS.items()
              if k[0] == "column_median"}
    check(routes == {("column_median", "select:radix"): rounds * chunks},
          f"{what}: column_median routes {routes}, expected select:radix "
          f"{rounds * chunks} times")
    return counts["column_median"]


def _chunked_trial(name, overrides, config_cls=None):
    """One 1000-client ResNet-10 trial through ``Fedavg.train()``: 2
    rounds, each on the chunked finish over the full (1000, d_alloc)
    buffer, the first held against the plain chunked finish."""
    from blades_tpu_torch.ops import _cuda

    spies = []
    _cuda.reset_launches()
    _fedavg_trial(name, overrides, 2, config_cls,
                  on_build=lambda algo: spies.append(
                      (algo._step, _ChunkedSpy(algo._step))))
    step, spy = spies[0]
    # 750 trained clients in blocks of 25, 12 BN layers, 2 rounds.
    n = _chunked_counts(f"chunked {name}", 2, RESNET10_CHUNKS, 30)
    check(step.routes == {"chunked": 2},
          f"chunked {name}: routes {dict(step.routes)}")
    want = [(1000, RESNET10_D_ALLOC)] * 2
    check(spy.shapes == want, f"chunked {name}: finish buffers "
          f"{spy.shapes}, expected {want}")
    plain_s = spy.check_plain(f"chunked {name}")
    log(f"chunked {name}: finish:chunked twice, select:radix {n} launches "
        f"({RESNET10_CHUNKS} a round); round 1 bit-exact against the plain "
        f"chunked finish ({plain_s:.2f} s)")
    return n


def _old_cap_round():
    """An f32 streamed round of 6,000 MLP clients (ALIE, Median, no
    malicious prefix, so the buffer holds all 6,000 rows): above the
    bit-serial finish's 4,874 f32 rows, where the round raised; it takes
    the chunked finish and agrees with its plain version."""
    import torch

    from blades_tpu_torch.adversaries import get_adversary, make_malicious_mask
    from blades_tpu_torch.core import FedRound, Server, TaskSpec
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.parallel.streamed import streamed_step
    from blades_tpu_torch.utils.tree import FlatLayout

    n, f = OLD_CAP_CLIENTS, OLD_CAP_CLIENTS // 4
    fr = FedRound(
        task=TaskSpec(model="mlp", input_shape=(28, 28, 1)).build(),
        server=Server.from_config("Median", num_byzantine=f, lr=1.0),
        adversary=get_adversary("ALIE", num_clients=n, num_byzantine=f),
        batch_size=8)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((n, 8, 28, 28, 1), generator=gen, device="cuda")
    y = torch.randint(0, 10, (n, 8), generator=gen, device="cuda")
    state = fr.init(0, n)
    d = FlatLayout(state.server.params).d
    chunks = -(-d // 131_072)
    step = streamed_step(fr, client_block=500, update_dtype=torch.float32,
                         d_chunk=131_072)
    spy = _ChunkedSpy(step)
    check(not _cuda.finish_fits(torch.float32, n), "chunked: the gate "
          f"takes {n} f32 rows on the fused kernel")
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, x, y, torch.full((n,), 8, device="cuda"),
                    make_malicious_mask(n, f, device="cuda"), 0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _chunked_counts("chunked old cap", 1, chunks, 0)
    check(step.routes == {"chunked": 1} and spy.shapes == [
        (n, -(-d // 512) * 512)], f"chunked old cap: routes "
        f"{dict(step.routes)}, buffers {spy.shapes}")
    check(math.isfinite(float(m["agg_norm"])), "chunked old cap: agg_norm "
          f"{float(m['agg_norm'])}")
    spy.check_plain("chunked old cap")
    log(f"chunked: f32 MLP round at {n} clients (d = {d}, {chunks} chunks) "
        f"on finish:chunked in {secs:.2f} s, select:radix {launches} "
        "launches, bit-exact against the plain chunked finish")
    return launches


def _busy_ms(fn, reps: int = 3) -> float:
    """Device busy ms per call of ``fn``, from ``torch.profiler`` over
    ``reps`` calls after a warm-up call (for a function of more launches
    than the launch queue holds, which :func:`timed` cannot put behind a
    sleep)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = _busy_us(prof) / 1e3 / reps
    check(busy > 0, "busy_ms: the profiler saw no device time")
    return busy


def _chunked_times(card):
    """Device-only ms of the chunked finish beside the fused finishes on
    the main path's buffer, and of one chunk's ``select:radix``; returns
    the record of the per-chunk select."""
    import torch

    from blades_tpu_torch.adversaries import get_adversary
    from blades_tpu_torch.core import FedRound, Server, TaskSpec
    from blades_tpu_torch.ops import column_select as cs
    from blades_tpu_torch.ops import fused_finish as ff
    from blades_tpu_torch.parallel.streamed import (
        generator_draws,
        streamed_step,
    )

    d, n, f = RESNET10_D, 1000, 250
    gen = torch.Generator(device="cuda").manual_seed(6)
    buf = _padded_rows(gen, n, d)
    mal = torch.arange(n, device="cuda") < f
    losses = torch.ones((n,), device="cuda")
    task = TaskSpec(model="resnet", input_shape=(32, 32, 3),
                    compute_dtype="bfloat16").build()
    ms = {}
    for adv in ("ALIE", "Noise"):
        fr = FedRound(task=task, server=Server.from_config(
            "Median", num_byzantine=f, lr=0.5),
            adversary=get_adversary(adv, num_clients=n, num_byzantine=f))
        state = fr.init(0, n)
        step = streamed_step(fr, client_block=50, d_chunk=131_072)
        draws = generator_draws(gen)

        def fn(step=step, state=state, draws=draws):
            return step.finish(state.server, buf, mal, losses, d=d,
                               draws=draws)
        ms[f"chunked {adv}"] = _busy_ms(fn)
        ms[f"chunked {adv} (events, host gaps included)"] = timed(
            fn, 3, syncs=True)[0]
    z = get_adversary("ALIE", num_clients=n, num_byzantine=f).z_max
    forge = ("alie", z)
    ms["fused full ALIE"] = timed(lambda: ff.fused_finish(
        buf, mal, forge=forge, agg=("median",)), REPS)[0]
    ms["fused compact ALIE (750 rows)"] = timed(
        lambda: ff.fused_finish_compact(buf[f:], forged_mult=f, forge=forge,
                                        agg=("median",)), REPS)[0]
    log(f"chunked: finish ms per round on the (1000, {RESNET10_D_ALLOC}) "
        "bf16 buffer, Median, device-only (the chunked finish: device busy "
        "under torch.profiler, its ~1,000 launches a call outrun the launch "
        "queue that timed() needs; the fused finishes: timed()): " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items()) + f" [{card}]")
    # One chunk as the chunked finish hands it to the Median: a contiguous
    # f32 (1000, 131072) copy.
    chunk = torch.empty((n, 131_072), dtype=torch.float32, device="cuda")
    chunk.copy_(buf[:, :131_072])
    del buf
    torch.cuda.empty_cache()
    got = cs.column_median(chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = cs.column_median_plain(chunk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = same(got, want, "chunked: column_median of one chunk")
    sel_ms = timed(lambda: cs.column_median(chunk), REPS)[0]
    lib_ms = timed(lambda: torch.quantile(chunk, 0.5, dim=0), REPS)[0]
    rec = _record("column_median:chunked", SELECT_SRC,
                  SELECT_TPU["column_median"], sel_ms, plain_ms,
                  chunk.numel() * 4 + chunk.shape[1] * 4, chunk.numel(), err,
                  lib_ms)
    log(f"chunked: select:radix on one (1000, 131072) f32 chunk "
        f"{sel_ms:.3f} ms (x {RESNET10_CHUNKS} = "
        f"{sel_ms * RESNET10_CHUNKS:.1f} ms a round), plain {plain_ms:.1f} "
        f"ms, torch.quantile {lib_ms:.3f} ms, bound {rec['bound_ms']:.3f} ms"
        f" [{card}]")
    return rec


def phase_chunked(card):
    """The chunked finish (``step.finish``) and its route gate: the Noise
    and DP trials at full width through ``Fedavg.train()``, the dense
    FEDAVG_DP trial, the f32 round above the old row cap, the gate against
    the card's plan, and the times."""
    from blades_tpu_torch.algorithms import FedavgDPConfig
    from blades_tpu_torch.ops import _cuda

    _gate_vs_plan()
    launches = _chunked_trial("ResNet-10 x 1000 Noise Median bf16",
                              NOISE_TRIAL)
    launches += _chunked_trial("ResNet-10 x 1000 ALIE Median bf16 DP eps 10",
                               DP_STREAMED_TRIAL, FedavgDPConfig)
    _cuda.reset_launches()
    _, streamed = _fedavg_trial("FEDAVG_DP MLP x 60 Mean eps 10",
                                DENSE_DP_TRIAL, 3, FedavgDPConfig)
    check(not streamed and dict(_cuda.LAUNCHES) == {},
          f"chunked dense DP: streamed={streamed}, launches "
          f"{dict(_cuda.LAUNCHES)} (the MLP's Mean launches none)")
    launches += _old_cap_round()
    rec = _chunked_times(card)
    return {"column_median:chunked": launches}, {rec["name"]: rec}


# The sweep phase's experiment files, read as data (nothing is imported
# from the JAX package): the 1000-client streamed grid (Mean, Median,
# Trimmedmean), the 20-local-step CNN with benign clipping and a dense
# Median, and the ResNet-34 grid (DnC, FLTrust) of 1000 clients.
TUNED = os.path.join(HERE, "blades_tpu", "tuned_examples")
SWEEP_YAML = os.path.join(TUNED, "fedavg_cifar10_1000clients.yaml")
LOCAL20_YAML = os.path.join(TUNED, "local20_cnn_fashion_mnist.yaml")
RESNET34_YAML = os.path.join(TUNED, "fedavg_cifar100_resnet34.yaml")
SWEEP_ROUNDS = 2
# One dispatch of 2 rounds: the file's rounds_per_dispatch (10) cut to 2
# to keep the whole script near half its time limit.
RESNET34_ROUNDS = 2
# client_block values the resnet34 phase tries, in order: the file's
# default first; a smaller one only when the larger runs out of memory.
RESNET34_BLOCKS = (50, 25)
# BatchStatsNorm layers of a client's local step: ResNet-34 (stem, 16
# blocks x 2, 3 projection shortcuts), ResNet-50 (stem, 16 Bottlenecks x
# 3, 4 shortcuts).
RESNET34_BN_LAYERS = 36
RESNET50_BN_LAYERS = 53
# The sweep grid's trials: 750 trained clients in blocks of 25, 12 BN
# layers a step; the BN launches of its first round are audited.
SWEEP_BN_ROUND = 30 * 12
SWEEP_BN_AUDIT = 2 * SWEEP_BN_ROUND
# Columns of the ResNet-34 buffer the weighted-sum audit takes at a time.
WSUM_SLICE = 1 << 20
# Round 2 of the kill-and-resume rerun against the straight run's round 2:
# equal (cuDNN's algorithms are left as the driver picks them).
RESUME_TOL = 0.0


def _work_dir(name):
    """A fresh directory under the git-ignored ``build/`` for a phase's
    trial files (checkpoints are too large to keep beside the logs)."""
    import shutil

    d = os.path.join(HERE, "build", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


class _TrialSpy:
    """Records each ``Fedavg`` trial the sweep runner builds: launches
    by kernel and by route from its build to its ``stop()``, its rounds,
    whether it streamed and its finish routes, the peak device memory
    (:func:`_peak`), the seconds of audits inside it, and the memory still
    allocated after ``stop()``; keeps a host copy of the server parameters
    each checkpoint saved and each restore loaded."""

    def __init__(self):
        self.trials, self.saved, self.loaded = [], {}, []

    def __enter__(self):
        import torch

        from blades_tpu_torch.algorithms import fedavg
        from blades_tpu_torch.ops import _cuda

        cls = fedavg.Fedavg
        self._cls = cls
        self._orig = cls.__init__, cls.stop, cls.save_checkpoint, \
            cls.load_checkpoint
        init, stop, save, load = self._orig
        spy = self

        def host_params(algo):
            return {k: v.detach().cpu().clone()
                    for k, v in algo.state.server.params.items()}

        def _init(algo, *a, **kw):
            torch.cuda.synchronize()
            _reset_peak()
            t0 = time.perf_counter()
            init(algo, *a, **kw)
            torch.cuda.synchronize()
            algo._spy_setup = time.perf_counter() - t0
            _cuda.reset_launches()
            algo._spy_t0 = time.perf_counter()
            algo._spy_audit = AUDIT["s"]

        def _stop(algo):
            if getattr(algo, "_spy_t0", None) is not None:
                torch.cuda.synchronize()
                spy.trials.append(dict(
                    rounds=algo.iteration, streamed=algo.streamed,
                    routes=dict(getattr(algo._step, "routes", {}) or {}),
                    passes=getattr(getattr(algo._step, "passes", None),
                                   "kernel_bundles", None),
                    launches=dict(_cuda.LAUNCHES), maps=dict(_cuda.MAPS),
                    peak=_peak(), timers=algo.timers.summary(),
                    audit_s=AUDIT["s"] - algo._spy_audit,
                    setup=algo._spy_setup,
                    wall=time.perf_counter() - algo._spy_t0))
                algo._spy_t0 = None
                stop(algo)
                spy.trials[-1]["after_stop"] = torch.cuda.memory_allocated()
            else:
                stop(algo)

        def _save(algo, path):
            spy.saved[algo.iteration] = host_params(algo)
            return save(algo, path)

        def _load(algo, path):
            load(algo, path)
            spy.loaded.append((algo.iteration, host_params(algo)))

        cls.__init__, cls.stop = _init, _stop
        cls.save_checkpoint, cls.load_checkpoint = _save, _load
        return self

    def __exit__(self, *exc):
        cls = self._cls
        (cls.__init__, cls.stop, cls.save_checkpoint,
         cls.load_checkpoint) = self._orig


def _train_rps(what, t):
    """``(rounds/s, text)`` of a trial over its training steps, the audits'
    seconds inside them taken out."""
    train_s = t["timers"]["training_step"]["total_s"]
    net = train_s - t["audit_s"]
    check(net > 0, f"{what}: training steps {train_s:.3f} s, audits "
          f"{t['audit_s']:.3f} s")
    rps = t["rounds"] / net
    return rps, (f"{rps:.4f} rounds/s over its training steps ({train_s:.2f}"
                 f" s, of which {t['audit_s']:.2f} s of audits taken out)")


class _PathAudit:
    """Holds a kernel against its plain version at every launch a path
    makes, on the path's own operands, while the path runs: wraps the
    wrapper where the path's module bound it -- ``finish``: the streamed
    round's ``fused_finish_compact``; ``select``: the dense aggregators'
    ``column_median``; ``wsum``: the row-geometry planner's
    ``row_stats_bundle`` (weighted-sum bundles).  The tolerances are those
    of the kernels phase.  The first launch under each key
    (``key()``, read at the call) is also timed -- the kernel, the plain
    version and the library call on the same operands -- into that key's
    record (a round's times: each of these paths launches the kernel once
    a round).  ``timing``: ``"launch"`` (then), ``"deferred"`` (the
    select's operands kept on the host, timed by :meth:`time_deferred`
    when the caller has the card to itself) or ``None`` (checked, not
    timed).  All of it is set aside (:func:`_aside`)."""

    TARGETS = {
        "finish": ("blades_tpu_torch.parallel.streamed",
                   "fused_finish_compact"),
        "select": ("blades_tpu_torch.ops.aggregators", "column_median"),
        "trim": ("blades_tpu_torch.ops.aggregators", "column_trimmed_mean"),
        "wsum": ("blades_tpu_torch.parallel.streamed_geometry",
                 "row_stats_bundle"),
    }

    def __init__(self, kind, key, timing="launch"):
        check(timing in ("launch", "deferred", None)
              and (timing != "deferred" or kind == "select"),
              f"_PathAudit({kind!r}): timing {timing!r}")
        self.kind, self.timing = kind, timing
        self.key = key if callable(key) else (lambda: key)
        self.records, self.calls, self.shapes = {}, 0, set()
        self._pending = {}

    def __enter__(self):
        modname, attr = self.TARGETS[self.kind]
        self._mod = importlib.import_module(modname)
        self._attr = attr
        self._orig = orig = getattr(self._mod, attr)
        check_fn = getattr(self, "_" + self.kind)

        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            key = self.key()
            with _aside():
                check_fn(key, orig, out, a, kw)
            self.calls += 1
            return out

        setattr(self._mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self._attr, self._orig)

    def _keep(self, key, err, rec):
        """The key's record: made at its first launch, its error the
        largest over every launch (untimed: the error alone)."""
        if key not in self.records:
            self.records[key] = (rec() if self.timing == "launch"
                                 else {"max_abs_err": err})
        r = self.records[key]
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def _finish(self, key, orig, out, a, kw):
        import torch

        from blades_tpu_torch.ops import fused_finish as ff

        x = a[0]
        noise = a[1] if len(a) > 1 else kw.get("forge_noise")
        self.shapes.add((tuple(x.shape), x.dtype))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ff.fused_finish_compact_plain(*a, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = _finish_agree(out, want, "fused_finish_compact",
                            f"{key}, launch {self.calls + 1}")
        del want
        rows, d_alloc = x.shape
        # As the kernels phase counts the compact finish: the rows read
        # once, the row norms and flags, the aggregate and the forged row
        # written, the noise read; per element 7 operations.
        nbytes = (rows * d_alloc * x.element_size() + rows * 5
                  + 2 * d_alloc * 4 + (0 if noise is None
                                       else noise.numel() * 4))
        self._keep(key, err, lambda: _record(
            key, SRC, COMPACT_TPU, timed(lambda: orig(*a, **kw), REPS)[0],
            plain_ms, nbytes, 7 * rows * d_alloc, err))

    def _select(self, key, orig, out, a, kw):
        import torch

        from blades_tpu_torch.ops import column_select as cs

        x = a[0]
        self.shapes.add((tuple(x.shape), x.dtype))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cs.column_median_plain(x)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = same(out, want, f"{key} {tuple(x.shape)}, launch "
                   f"{self.calls + 1}")
        del want
        if self.timing == "deferred" and key not in self._pending:
            self._pending[key] = (orig, _keep_view(x))
        self._keep(key, err,
                   lambda: self._select_record(key, orig, x, plain_ms, err))

    def _select_record(self, key, orig, x, plain_ms, err):
        import torch

        rows, d = x.shape
        # On NaN-free columns the midpoint median is the 0.5 quantile with
        # linear interpolation: one PyTorch call, where it takes the
        # operand.
        xf = x.float()
        try:
            lib = timed(lambda: torch.quantile(xf, 0.5, dim=0), REPS)[0]
        except RuntimeError as exc:
            log(f"{key}: torch.quantile refuses {tuple(x.shape)}: "
                f"{str(exc).splitlines()[0]}; library_ms null")
            lib = None
        del xf
        return _record(
            key, SELECT_SRC, SELECT_TPU["column_median"],
            timed(lambda: orig(x), REPS)[0], plain_ms,
            rows * d * x.element_size() + d * 4, rows * d, err, lib)

    def time_deferred(self):
        """Time each key's first operand set aside (``timing="deferred"``)
        back on the card: the kernel, the plain version (one run, as at a
        launch) and ``torch.quantile``, into the key's record (its error
        the largest over every launch)."""
        import torch

        from blades_tpu_torch.ops import column_select as cs

        for key, (orig, kept) in self._pending.items():
            x = _view_on_card(kept)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs.column_median_plain(x)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = self.records[key]["max_abs_err"]
            self.records[key] = self._select_record(key, orig, x, plain_ms,
                                                    err)
            del x
        self._pending.clear()

    def _trim(self, key, orig, out, a, kw):
        """The trimmed means, within ``TRIM_TOL`` (f32 sums of the kept
        values in another order); no single PyTorch call computes one."""
        import torch

        from blades_tpu_torch.ops import column_select as cs

        x, k = a[0], a[1]
        self.shapes.add((tuple(x.shape), x.dtype))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cs.column_trimmed_mean_plain(x, k)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = close(out, want, f"{key} {tuple(x.shape)} k={k}, launch "
                    f"{self.calls + 1}", rtol=TRIM_TOL, atol=TRIM_TOL)
        del want
        rows, d = x.shape
        self._keep(key, err, lambda: _record(
            key, SELECT_SRC, SELECT_TPU["column_trimmed_mean"],
            timed(lambda: orig(x, k), REPS)[0], plain_ms,
            rows * d * x.element_size() + d * 4, rows * d, err))

    def _wsum(self, key, orig, out, a, kw):
        """The weighted sums over column slices of the buffer: a weighted
        sum is computed column by column, so the plain version on each
        slice is the plain version on the whole, without its whole-buffer
        temporaries (the buffer is tens of GB)."""
        import torch

        from blades_tpu_torch.ops import rowstats as rs

        x = a[0]
        w = kw.get("weights")
        asked = {k for k, v in kw.items()
                 if k != "d_true" and v is not None and v is not False}
        check(asked == {"weights"}, f"{key}: the audit takes weighted-sum "
              f"bundles, got {sorted(asked)}")
        d = kw.get("d_true") or x.shape[1]
        self.shapes.add((tuple(x.shape), x.dtype))
        got = out["wsum"]
        check(tuple(got.shape) == (w.shape[0], d), f"{key}: wsum "
              f"{tuple(got.shape)}")
        err, plain_s = 0.0, 0.0
        for c0 in range(0, d, WSUM_SLICE):
            c1 = min(c0 + WSUM_SLICE, d)
            xs = x[:, c0:c1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = rs.row_stats_bundle_plain(xs, weights=w)
            torch.cuda.synchronize()
            plain_s += time.perf_counter() - t0
            err = max(err, rowstats_agree(
                {"wsum": got[:, c0:c1]}, want, xs, {"weights": w},
                f"{key} columns {c0}:{c1}, launch {self.calls + 1}"))
        n = x.shape[0]

        def rec():
            lib_ms, _ = _bundle_library_ms(WSUM_RECORD, x, kw)
            return _record(key, ROWSTATS_SRC, ROWSTATS_TPU,
                           timed(lambda: orig(*a, **kw), REPS)[0],
                           plain_s * 1e3, n * d * x.element_size() + n * 4
                           + d * 4, 2 * n * d, err, lib_ms)

        self._keep(key, err, rec)


def _rows(storage, exp, idx):
    """A trial's result rows, after ``verify_result_rounds``."""
    from blades_tpu_torch.tune.sweep import verify_result_rounds

    path = os.path.join(storage, exp, f"{exp}_{idx:05d}", "result.json")
    its = verify_result_rounds(path)
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    check([r["training_iteration"] for r in rows] == its, f"{path}: rows")
    return rows


def _trial_checks(what, trial, rows, rounds, baseline):
    """Finite losses, ``round_ok`` where the health check ran, the rounds,
    and the device memory back near ``baseline`` after stop (within 256
    MiB: the libraries' workspaces stay; a trial's state is gigabytes)."""
    losses = [r["train_loss"] for r in rows]
    check(trial["rounds"] == rounds and len(rows) >= 1,
          f"{what}: {trial['rounds']} rounds, {len(rows)} rows")
    check(all(math.isfinite(v) for v in losses),
          f"{what}: train losses {losses}")
    check(all(r.get("round_ok", True) for r in rows),
          f"{what}: round_ok {[r.get('round_ok') for r in rows]}")
    check(trial["after_stop"] <= baseline + (256 << 20),
          f"{what}: {trial['after_stop'] / 2**30:.2f} GiB still allocated "
          f"after stop() (baseline {baseline / 2**30:.2f} GiB)")
    return losses


def _sweep_main(storage, baseline):
    """``train.main(["file", fedavg_cifar10_1000clients.yaml, ...])``:
    three trials of 2 rounds, each on ``finish:radix`` once a round, every
    finish held against the plain version and the first round's BN
    launches audited."""
    from blades_tpu_torch import train

    aggs = ("Mean", "Median", "Trimmedmean")
    with _TrialSpy() as spy, _PathAudit(
            "finish", lambda: f"fused_finish_compact:sweep_"
            f"{aggs[len(spy.trials)].lower()}") as fin, _BnAudit(
                limit=SWEEP_BN_AUDIT, key="sweep") as bn_audit:
        t0 = time.perf_counter()
        rc = train.main(["file", SWEEP_YAML, "--max-rounds",
                         str(SWEEP_ROUNDS), "--storage-path", storage,
                         "--no-cost-analysis"])
        secs = time.perf_counter() - t0
    check(rc == 0 and len(spy.trials) == 3,
          f"sweep: rc {rc}, {len(spy.trials)} trials")
    check(fin.calls == 3 * SWEEP_ROUNDS and bn_audit.calls == SWEEP_BN_AUDIT,
          f"sweep: {fin.calls} finishes and {bn_audit.calls} BN launches "
          "audited")
    counts, out = {}, {}
    for i, (agg, t) in enumerate(zip(aggs, spy.trials)):
        what = f"sweep {agg}"
        rows = _rows(storage, "fedavg_cifar10_1000clients", i)
        losses = _trial_checks(what, t, rows, SWEEP_ROUNDS, baseline)
        want = {"fused_finish_compact": SWEEP_ROUNDS,
                **{k: SWEEP_ROUNDS * SWEEP_BN_ROUND for k in BN_TPU}}
        check(t["streamed"] and t["launches"] == want,
              f"{what}: launches {t['launches']}, expected {want}")
        routes = {k: v for k, v in t["maps"].items()
                  if k[0] == "fused_finish_compact"}
        check(routes == {("fused_finish_compact", "finish:radix"):
                         SWEEP_ROUNDS} and t["routes"] == {
                             "fused_compact": SWEEP_ROUNDS},
              f"{what}: finish routes {routes}, {t['routes']}")
        key = f"fused_finish_compact:sweep_{agg.lower()}"
        counts[key] = t["launches"]["fused_finish_compact"]
        for k in BN_TPU:
            counts[f"{k}:sweep"] = (counts.get(f"{k}:sweep", 0)
                                    + t["launches"][k])
        log(f"sweep {agg}: streamed, finish:radix {SWEEP_ROUNDS} launches "
            f"(once a round), each against the plain version (max_abs_err "
            f"{fin.records[key]['max_abs_err']:.3g}); train_loss {losses}, "
            f"agg_norm {[r['agg_norm'] for r in rows]}, round_ok "
            f"{[r['round_ok'] for r in rows]}; {_train_rps(what, t)[1]}, "
            f"trial wall {t['wall']:.1f} s, peak {t['peak'] / 2**30:.2f} GiB,"
            f" {t['after_stop'] / 2**20:.0f} MiB allocated after stop()")
        out[agg] = rows
    log(f"sweep: file fedavg_cifar10_1000clients.yaml --max-rounds "
        f"{SWEEP_ROUNDS}: 3 trials in {secs:.1f} s, result rows verified; "
        f"finish operands {sorted(fin.shapes)}; the first round's "
        f"{bn_audit.calls} BN launches audited (dx bit-exact, sums max err "
        f"{bn_audit.err:.3g}, layouts {len(bn_audit.layouts)})")
    return out, counts, {**fin.records, **bn_audit.records(1)}


def _sweep_local20(storage, baseline):
    """``local20_cnn_fashion_mnist.yaml`` for 2 rounds: 20 clipped local
    steps of the CNN, then the dense Median on ``select:radix``, each
    select bit-exact against the plain version."""
    from blades_tpu_torch import train
    from blades_tpu_torch.core import callbacks

    calls = [0]
    clip = callbacks.ClippingCallback.on_backward_end

    def counted(self, grads, malicious):
        calls[0] += 1
        return clip(self, grads, malicious)

    key = "column_median:local20"
    callbacks.ClippingCallback.on_backward_end = counted
    try:
        with _TrialSpy() as spy, _PathAudit("select", key) as sel:
            rc = train.main(["file", LOCAL20_YAML, "--max-rounds",
                             str(SWEEP_ROUNDS), "--storage-path", storage,
                             "--no-cost-analysis"])
    finally:
        callbacks.ClippingCallback.on_backward_end = clip
    check(rc == 0 and len(spy.trials) == 1,
          f"sweep local20: rc {rc}, {len(spy.trials)} trials")
    t = spy.trials[0]
    rows = _rows(storage, "local20_cnn_fashion_mnist", 0)
    losses = _trial_checks("sweep local20", t, rows, SWEEP_ROUNDS, baseline)
    want = {"column_median": SWEEP_ROUNDS}
    check(not t["streamed"] and t["launches"] == want and t["maps"] == {
        ("column_median", "select:radix"): SWEEP_ROUNDS}
        and sel.calls == SWEEP_ROUNDS,
        f"sweep local20: launches {t['launches']} by route {t['maps']}, "
        f"{sel.calls} audited, expected select:radix {SWEEP_ROUNDS} times")
    # 60 clients in blocks of 50 and 10, 20 local steps, 2 rounds.
    check(calls[0] == SWEEP_ROUNDS * 2 * 20,
          f"sweep local20: the clipping callback ran {calls[0]} times")
    log(f"sweep local20: dense CNN x 60, 20 clipped local steps a round "
        f"({calls[0]} block calls of the clipping callback), Median on "
        f"select:radix once a round on {sorted(sel.shapes)}, bit-exact "
        f"against the plain version each time; train_loss {losses}; "
        f"{_train_rps('sweep local20', t)[1]}, peak "
        f"{t['peak'] / 2**30:.2f} GiB")
    return {key: t["launches"]["column_median"]}, sel.records


def _sweep_resume(storage, straight):
    """The Median point again through ``run_experiments`` with a
    checkpoint every round and a preemption after round 2 (one retry): the
    retry restores round 1's checkpoint and reruns round 2."""
    import torch

    from blades_tpu_torch.tune import load_experiments_from_file
    from blades_tpu_torch.tune.sweep import run_experiments

    key = "fused_finish_compact:resume"
    exps = load_experiments_from_file(SWEEP_YAML)
    exps["fedavg_cifar10_1000clients"]["config"]["server_config"][
        "aggregator"] = {"type": "Median"}
    with _TrialSpy() as spy, _PathAudit("finish", key) as fin:
        (summary,) = run_experiments(
            exps, storage_path=storage, verbose=0, checkpoint_freq=1,
            preempt_after=SWEEP_ROUNDS, max_failures=1,
            retry_backoff_base=0.0, max_rounds_override=SWEEP_ROUNDS,
            cost_analysis=False)
    check("status" not in summary and summary["rounds"] == SWEEP_ROUNDS,
          f"sweep resume: summary {summary}")
    rows = _rows(storage, "fedavg_cifar10_1000clients", 0)
    check([r["training_iteration"] for r in rows] == [1, 2],
          f"sweep resume: rounds {[r['training_iteration'] for r in rows]}")
    err = open(os.path.join(summary["dir"], "error.txt")).read()
    check("SimulatedPreemption" in err, "sweep resume: no preemption logged")
    check(len(spy.trials) == 2 and len(spy.loaded) == 1
          and spy.loaded[0][0] == 1,
          f"sweep resume: {len(spy.trials)} builds, restores "
          f"{[it for it, _ in spy.loaded]}")
    saved, restored = spy.saved[1], spy.loaded[0][1]
    for k, v in saved.items():
        check(torch.equal(v, restored[k]),
              f"sweep resume: parameter {k} restored from ckpt_000001 "
              "differs from the one saved")
    launches = sum(tr["launches"].get("fused_finish_compact", 0)
                   for tr in spy.trials)
    # Rounds 1 and 2, then round 2 again after the restore.
    check(launches == SWEEP_ROUNDS + 1 and fin.calls == launches,
          f"sweep resume: {launches} finishes, {fin.calls} audited")
    diffs = {k: abs(rows[1][k] - straight[1][k])
             for k in ("train_loss", "agg_norm")}
    log(f"sweep resume: preempted after round 2, restored round 1's "
        f"checkpoint ({len(saved)} parameters bit-identical to those "
        f"saved), reran round 2: rows [1, 2] verified; {launches} finishes "
        f"on finish:radix, each against the plain version; round 2 "
        f"train_loss {rows[1]['train_loss']!r} / agg_norm "
        f"{rows[1]['agg_norm']!r} against the straight run's "
        f"{straight[1]['train_loss']!r} / {straight[1]['agg_norm']!r} "
        f"(difference {diffs})")
    check(all(v <= RESUME_TOL * max(1.0, abs(straight[1][k]))
              for k, v in diffs.items()),
          f"sweep resume: round 2 differs from the straight run by {diffs}")
    return {key: launches}, fin.records


def phase_sweep(card):
    """The ``file`` entry point on the card: the 1000-client grid, the
    clipped CNN, and kill-and-resume of the Median point.  Returns the
    launches and records of each path, under its own key."""
    import torch

    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    counts, records = {}, {}
    rows, c, r = _sweep_main(_work_dir("sweep_file"), baseline)
    counts.update(c)
    records.update(r)
    for c, r in (_sweep_local20(_work_dir("sweep_local20"), baseline),
                 _sweep_resume(_work_dir("sweep_resume"), rows["Median"])):
        counts.update(c)
        records.update(r)
    log(f"sweep: [{card}]")
    return counts, records


def _resnet34_trial(storage, block):
    """The DnC point of ``fedavg_cifar100_resnet34.yaml`` through
    ``run_experiments``: one dispatch of ``RESNET34_ROUNDS`` rounds at
    ``client_block``,
    every weighted sum held against the plain version and the first
    round's BN launches audited."""
    from blades_tpu_torch.tune import load_experiments_from_file
    from blades_tpu_torch.tune.sweep import run_experiments

    exps = load_experiments_from_file(RESNET34_YAML)
    cfg = exps["fedavg_cifar100_resnet34"]["config"]
    cfg["server_config"]["aggregator"] = {"type": "DnC"}
    cfg["client_block"] = block
    cfg["rounds_per_dispatch"] = RESNET34_ROUNDS
    trained = (1000 - 200) // block
    with _TrialSpy() as spy, _PathAudit(
            "wsum", "row_stats_bundle:wsum:resnet34") as ws, _BnAudit(
                limit=2 * trained * RESNET34_BN_LAYERS,
                key="resnet34") as bn_audit:
        (summary,) = run_experiments(
            exps, storage_path=storage, verbose=0,
            max_rounds_override=RESNET34_ROUNDS, cost_analysis=False)
    return summary, spy.trials[0], ws, bn_audit


def _resnet50_round(card):
    """One dense round of ResNet-50 at 20 clients of CIFAR-10 shapes in
    bf16, every BN-backward launch and the Median's select audited against
    the plain versions."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda

    cfg = FedavgConfig().update_from_dict({
        "dataset_config": {"type": "cifar10", "num_clients": 20,
                           "train_bs": 32},
        "global_model": "resnet50", "compute_dtype": "bfloat16",
        "execution": "dense", "evaluation_interval": 1,
        "server_config": {"lr": 0.1, "aggregator": {"type": "Median"}}})
    _reset_peak()
    algo = cfg.build()
    try:
        _cuda.reset_launches()
        audit0 = AUDIT["s"]
        with _BnAudit(key="resnet50") as audit, _PathAudit(
                "select", "column_median:resnet50") as sel:
            t0 = time.perf_counter()
            row = algo.train()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        audit_s = AUDIT["s"] - audit0
    finally:
        algo.stop()
    launches, maps = dict(_cuda.LAUNCHES), dict(_cuda.MAPS)
    want = {"column_median": 1,
            **{k: RESNET50_BN_LAYERS for k in BN_TPU}}
    check(launches == want, f"resnet50: launches {launches}, expected {want}")
    bn_maps = {k: v for k, v in maps.items() if k[0] in BN_TPU}
    check(bn_maps == {(k, "vector"): RESNET50_BN_LAYERS for k in BN_TPU},
          f"resnet50: BN launches by thread map {bn_maps}, expected all "
          "on the vector map")
    check(audit.calls == 2 * RESNET50_BN_LAYERS and sel.calls == 1,
          f"resnet50: audited {audit.calls} BN launches, {sel.calls} "
          "selects")
    check(math.isfinite(row["train_loss"]) and math.isfinite(
        row["test_acc"]), f"resnet50: row {row}")
    chans = sorted({s[1][2] for s in audit.layouts})
    log(f"resnet50: one dense round, 20 clients, bf16: {secs - audit_s:.2f} "
        f"s (evaluation included; {audit_s:.2f} s of audits taken out), "
        f"train_loss {row['train_loss']:.4f}, test_acc "
        f"{row['test_acc']:.4f}; BN launches {launches['bn_bwd_reduce']} + "
        f"{launches['bn_bwd_dx']} ({RESNET50_BN_LAYERS} layers, channels "
        f"{chans}), all on the vector map, every launch audited (dx "
        f"bit-exact, sums max err {audit.err:.3g}); Median on select:radix "
        f"once on {sorted(sel.shapes)}, bit-exact against the plain "
        f"version; peak {_peak() / 2**30:.2f} GiB [{card}]")
    counts = {f"{k}:resnet50": launches[k] for k in BN_TPU}
    counts["column_median:resnet50"] = launches["column_median"]
    return counts, {**audit.records(1), **sel.records}


def phase_resnet34(card):
    """The ResNet-34 grid's DnC point at full size for one dispatch of 10
    rounds, then one dense ResNet-50 round.  Returns the launches and
    records of each path, under its own key."""
    storage = _work_dir("resnet34")
    tried = []
    for block in RESNET34_BLOCKS:
        summary, t, ws, bn_audit = _resnet34_trial(storage, block)
        tried.append((block, t["peak"], summary.get("error")))
        if "status" not in summary:
            break
        check("OutOfMemoryError" in summary["error"],
              f"resnet34: block {block} failed: {summary['error']}")
        log(f"resnet34: client_block {block} ran out of device memory "
            f"(peak {t['peak'] / 2**30:.2f} GiB before the failure)")
    check("status" not in summary,
          f"resnet34: no client_block of {RESNET34_BLOCKS} fit: {tried}")
    rows = _rows(storage, "fedavg_cifar100_resnet34", 0)
    check([r["training_iteration"] for r in rows] == [RESNET34_ROUNDS],
          f"resnet34: rows {[r['training_iteration'] for r in rows]}, "
          "expected one row at round 10")
    losses = [r["train_loss"] for r in rows]
    check(all(math.isfinite(v) for v in losses)
          and math.isfinite(rows[0]["agg_norm"]),
          f"resnet34: row {rows[0]}")
    trained = (1000 - 200) // block
    want = {"row_stats_bundle": RESNET34_ROUNDS,
            **{k: RESNET34_ROUNDS * trained * RESNET34_BN_LAYERS
               for k in BN_TPU}}
    check(t["streamed"] and t["launches"] == want and t["passes"] == 1,
          f"resnet34: launches {t['launches']} (bundles a round "
          f"{t['passes']}), expected {want}")
    rs_routes = {k: v for k, v in t["maps"].items()
                 if k[0] == "row_stats_bundle"}
    check(rs_routes == {("row_stats_bundle", "rowstats:ring"):
                        RESNET34_ROUNDS},
          f"resnet34: row-statistics routes {rs_routes}")
    check(ws.calls == RESNET34_ROUNDS
          and bn_audit.calls == 2 * trained * RESNET34_BN_LAYERS,
          f"resnet34: {ws.calls} weighted sums and {bn_audit.calls} BN "
          "launches audited")
    bn_maps = {k: v for k, v in t["maps"].items() if k[0] in BN_TPU}
    wkey = "row_stats_bundle:wsum:resnet34"
    rps, rps_text = _train_rps("resnet34", t)
    log(f"resnet34: fedavg_cifar100_resnet34.yaml DnC point, ResNet-34 x "
        f"1000 clients (200 Adaptive, elided), CIFAR-100 shapes, f32 "
        f"compute, bf16 buffer {sorted(ws.shapes)}, client_block {block}, "
        f"rounds_per_dispatch {RESNET34_ROUNDS}: one dispatch of "
        f"{RESNET34_ROUNDS} rounds, "
        f"{rps_text} (trial wall {t['wall']:.1f} s); peak memory "
        f"{t['peak'] / 2**30:.2f} GiB; blocks tried (block, peak GiB): "
        f"{[(b, round(p / 2**30, 2)) for b, p, _ in tried]}; train_loss "
        f"{losses}, agg_norm {rows[0]['agg_norm']}; launches a round: "
        f"row_stats_bundle {t['launches']['row_stats_bundle'] // RESNET34_ROUNDS}"
        f" (rowstats:ring, DnC's weighted sum; all {ws.calls} against the "
        f"plain version, max_abs_err {ws.records[wkey]['max_abs_err']:.3g}),"
        f" BN {t['launches']['bn_bwd_reduce'] // RESNET34_ROUNDS} + "
        f"{t['launches']['bn_bwd_dx'] // RESNET34_ROUNDS} (thread maps "
        f"{bn_maps}; the first round's {bn_audit.calls} audited: dx "
        f"bit-exact, sums max err {bn_audit.err:.3g}, layouts "
        f"{len(bn_audit.layouts)}) [{card}]")
    counts = {wkey: t["launches"]["row_stats_bundle"],
              **{f"{k}:resnet34": t["launches"][k] for k in BN_TPU}}
    records = {**ws.records, **bn_audit.records(1)}
    c, r = _resnet50_round(card)
    counts.update(c)
    records.update(r)
    return counts, records


# The cct phase: fedavg_cct_cifar10.yaml (the catalog's "cct", i.e.
# cct_2_3x2_32, d = 284,491; 60 clients of CIFAR-10 shapes, 12 malicious,
# train_bs 64, the dense f32 round) at its six points, 3 rounds each, its
# evaluation moved from round 50 to round 3 and the health check on (so
# each row carries round_ok); then one dense Median round of each of two
# deeper zoo members at full width: (name, dataset, d, client_block).
# cct_7_3x1_32's one tokenizer stage leaves 256 tokens: its attention
# weights are 64 x 4 x 256 x 256 f32 a client and layer (64 MiB), so it
# trains 10 clients a block (the default 50 ran out of the 80 GB).
CCT_YAML = os.path.join(TUNED, "fedavg_cct_cifar10.yaml")
CCT_ROUNDS = 3
CCT_D = 284_491
CCT_ZOO = (("cct_7_3x1_32_c100", "cifar100", 3_788_645, 10),
           ("cvt_7_4_32", "cifar10", 3_721_995, 50))


def _cct_grid(storage, baseline):
    """``train.main(["file", fedavg_cct_cifar10.yaml, ...])``: six trials
    of 3 rounds; every Median select held bit-exact against the plain
    version on the path's own operands."""
    import torch

    from blades_tpu_torch import train
    from blades_tpu_torch.tune import expand_grid, load_experiments_from_file

    with open(CCT_YAML) as fh:
        text = fh.read()
    check(text.count("    evaluation_interval: 50\n") == 1,
          "cct: fedavg_cct_cifar10.yaml has no single evaluation_interval")
    path = os.path.join(storage, "fedavg_cct_cifar10.yaml")
    with open(path, "w") as fh:
        fh.write(text.replace(
            "    evaluation_interval: 50\n",
            f"    evaluation_interval: {CCT_ROUNDS}\n"
            "    health_check: true\n"))
    spec = load_experiments_from_file(path)["fedavg_cct_cifar10"]
    points = [(t["server_config"]["aggregator"]["type"],
               t["adversary_config"]["type"])
              for t in expand_grid(spec["config"])]
    check(len(points) == 6, f"cct: grid points {points}")
    key = "column_median:cct"
    with _TrialSpy() as spy, _PathAudit("select", key) as sel:
        t0 = time.perf_counter()
        rc = train.main(["file", path, "--max-rounds", str(CCT_ROUNDS),
                         "--storage-path", storage, "--no-cost-analysis"])
        secs = time.perf_counter() - t0
    check(rc == 0 and len(spy.trials) == 6,
          f"cct: rc {rc}, {len(spy.trials)} trials")
    medians = 0
    for i, ((agg, adv), t) in enumerate(zip(points, spy.trials)):
        what = f"cct {agg} {adv}"
        rows = _rows(storage, "fedavg_cct_cifar10", i)
        losses = _trial_checks(what, t, rows, CCT_ROUNDS, baseline)
        acc = rows[-1].get("test_acc", float("nan"))
        check(math.isfinite(acc) and all(r.get("round_ok") is True
                                         for r in rows),
              f"{what}: test_acc {acc}, round_ok "
              f"{[r.get('round_ok') for r in rows]}")
        n = CCT_ROUNDS if agg == "Median" else 0
        want = {"column_median": n} if n else {}
        maps = {("column_median", "select:radix"): n} if n else {}
        check(not t["streamed"] and t["launches"] == want
              and t["maps"] == maps,
              f"{what}: launches {t['launches']} by route {t['maps']}, "
              f"expected {maps} on the dense round")
        medians += n
        log(f"{what}: dense, select:radix {n} launches; train_loss "
            f"{losses}, round_ok {[r.get('round_ok') for r in rows]}, "
            f"test_acc {acc:.4f} at round {CCT_ROUNDS}; "
            f"{_train_rps(what, t)[1]}, setup {t['setup']:.2f} s, trial "
            f"wall {t['wall']:.1f} s, peak {t['peak'] / 2**30:.2f} GiB")
    check(sel.calls == medians
          and sel.shapes == {((60, CCT_D), torch.float32)},
          f"cct: {sel.calls} selects audited on {sorted(sel.shapes)}, "
          f"expected {medians} on (60, {CCT_D}) f32")
    log(f"cct: file fedavg_cct_cifar10.yaml --max-rounds {CCT_ROUNDS}: 6 "
        f"trials in {secs:.1f} s, result rows verified; {sel.calls} Median "
        f"selects, each bit-exact against the plain version")
    return {key: medians}, sel.records


def _cct_zoo_round(name, dataset, d, block, card):
    """One dense round of ``name`` at full width: 60 clients of
    ``dataset`` shapes in blocks of ``block``, 12 ALIE, Median on
    ``select:radix`` audited, and an evaluation."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.utils.tree import FlatLayout

    cfg = FedavgConfig().update_from_dict({
        "dataset_config": {"type": dataset, "num_clients": 60,
                           "train_bs": 64},
        "global_model": name, "execution": "dense", "client_block": block,
        "evaluation_interval": 1, "num_malicious_clients": 12,
        "adversary_config": {"type": "ALIE"},
        "server_config": {"lr": 0.1, "aggregator": {"type": "Median"}}})
    torch.cuda.synchronize()
    _reset_peak()
    t0 = time.perf_counter()
    algo = cfg.build()
    setup = time.perf_counter() - t0
    key = f"column_median:{name}"
    try:
        width = FlatLayout(algo.state.server.params).d
        _cuda.reset_launches()
        audit0 = AUDIT["s"]
        with _PathAudit("select", key) as sel:
            t0 = time.perf_counter()
            row = algo.train()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        audit_s = AUDIT["s"] - audit0
    finally:
        algo.stop()
    launches, maps = dict(_cuda.LAUNCHES), dict(_cuda.MAPS)
    check(width == d, f"{name}: d = {width}, expected {d}")
    check(launches == {"column_median": 1}
          and maps == {("column_median", "select:radix"): 1}
          and sel.calls == 1, f"{name}: launches {launches} by route "
          f"{maps}, {sel.calls} audited")
    check(math.isfinite(row["train_loss"]) and math.isfinite(
        row["test_acc"]), f"{name}: row {row}")
    log(f"cct {name}: one dense round, 60 clients of {dataset} shapes in "
        f"blocks of {block}, d = {width}: {secs - audit_s:.2f} s "
        f"(evaluation included; {audit_s:.2f} s of audits taken out), setup "
        f"{setup:.2f} s, "
        f"train_loss {row['train_loss']:.4f}, test_acc "
        f"{row['test_acc']:.4f}; Median on select:radix once on "
        f"{sorted(sel.shapes)}, bit-exact against the plain version; peak "
        f"{_peak() / 2**30:.2f} GiB [{card}]")
    return {key: launches["column_median"]}, sel.records


def phase_cct(card):
    """The CCT grid through ``file``, then one dense round of each deeper
    zoo member.  Returns the launches and records of each path."""
    import torch

    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    counts, records = _cct_grid(_work_dir("cct"), baseline)
    for name, dataset, d, block in CCT_ZOO:
        c, r = _cct_zoo_round(name, dataset, d, block, card)
        counts.update(c)
        records.update(r)
    log(f"cct: [{card}]")
    return counts, records


# The wire phase.  Part 1: the dense round at the widths of
# fedavg_cifar10_1000clients.yaml (ResNet-10, d = 4,903,242, x 1000 clients
# of CIFAR-10 shapes, 250 ALIE, bf16 compute, client_block 25, d_chunk
# 131,072) under the quant int8 codec on the wire, through
# FedavgConfig -> Fedavg.train(): Multikrum, Median and GeoMed for 1 round
# each (cut from 2, 2 and 1 to keep the whole script near half its time
# limit), the round evaluating 10 test rows a client.  The
# health check is off: the wire domain refuses it (as the JAX config does).
WIRE_TRIAL = {
    "dataset_config": {"type": "cifar10", "num_clients": 1000, "iid": False,
                       "alpha": 0.1, "train_bs": 32, "seed": 122},
    "global_model": "resnet10", "compute_dtype": "bfloat16",
    "execution": "dense", "client_block": 25, "d_chunk": 131072,
    "num_malicious_clients": 250, "adversary_config": {"type": "ALIE"},
    "client_config": {"lr": 0.1, "num_batch_per_round": 1},
    "evaluation_num_samples": 10,
    "codec_config": {"type": "quant", "bits": 8}, "agg_domain": "wire",
}
WIRE_AGGS = (("Multikrum", 1), ("Median", 1), ("GeoMed", 1))
WIRE_CHUNKS = -(-RESNET10_D // 131072)  # the Median's decoded chunks
WIRE_BN_ROUND = 1000 // 25 * 12  # every lane trains on the dense round
# The domain A/B: the same round at 500 clients (125 ALIE), where the f32
# domain's dense ALIE forge and Multikrum fit beside the (n, d) matrix
# (at 1000 clients their whole-matrix temporaries do not).
WIRE_AB_CLIENTS = 500
# Decode-then-f32 against the wire: f32 sums in another order (the scale
# algebra is exact on the int8 grid), as the JAX package's own wire tests
# hold them (WIRE_RTOL there).
WIRE_RTOL = 1e-4
# GeoMed replayed with the wire run's iteration count: when its median sits
# on the 250 identical forged rows, their distances to it come from the
# Gram algebra (sq - 2 gd / W + ...) by cancellation, so the 1/distance
# weights of two f32 orders differ at that noise and the medians by up to
# ~3e-4 of its scale (seen on the CPU at 20 MLP clients, 5 of them ALIE).
WIRE_GEOMED_RTOL = 1e-3
INT8_TENSOR_OPS_PER_S = 1979e12  # the int8 Gram's products
GRAM8_RECORD = "row_stats_bundle:gram:int8:wire"
WSUM8_RECORD = "row_stats_bundle:wsum:int8:wire"
GEOMED8_RECORD = "row_stats_bundle:wsum+gram_dot:int8:wire"
# Part 2: the dense trial of fedavg_cifar10_resnet_noniid.yaml (60 clients,
# f32) under ALIE: top-k 1% + error feedback, and the fault injector with
# the health check (full participation in round 1, dropout 0.3 from round
# 2 by its schedule).
WIRE_FAULTS = {"dropout_rate": 0.0, "dropout_schedule": [[1, 0.3]],
               "num_stragglers": 1, "staleness": 2, "corrupt_rate": 0.2,
               "corrupt_mode": "nan"}
# Part 3: the verification flow's MLP (MLP_TRIAL) under top-k 2% and under
# quant int8 on the wire.  Measured on the CPU (both packages, seeds 122, 1,
# 2, 3): quant int8 on the wire reaches 0.93-1.0 at round 3, top-k 2%
# 0.70-0.82 in the JAX package and 0.71-0.88 in the port at round 3, both
# >= 0.9 from round 5 or 6; so top-k is read at round 6.
WIRE_MLP = (("top-k 2%", {"codec_config": {"type": "topk",
                                           "topk_ratio": 0.02}}, 6),
            ("quant int8 wire", {"codec_config": {"type": "quant",
                                                  "bits": 8},
                                 "agg_domain": "wire"}, 3))


class _WireAudit:
    """While a wire trial runs: every ``row_stats_bundle`` launch of the
    planner (int8 payload) against the plain version on the same operands
    (sq, Gram and signs bit-exact, f32 sums within ``ROW_RTOL`` of their
    summands), its first launch of each kind timed into that kind's record
    (the Gram alone, the weighted sum alone, GeoMed's shared weighted sum
    + Gram-vector product); and every ``aggregate_wire`` against the
    port's decode-then-f32 aggregate of the same payload (into a padded f32
    buffer: Median exact, the rest within ``WIRE_RTOL``; GeoMed with the
    wire run's iteration count, its early stop off).  All of it set aside
    (:func:`_aside`)."""

    def __init__(self):
        self.records, self.calls, self.aggs, self.err = {}, 0, 0, 0.0
        self.agg_err = {}

    def __enter__(self):
        from blades_tpu_torch.parallel import streamed_geometry as sg

        self._sg = sg
        self._orig = sg.row_stats_bundle, sg.aggregate_wire
        rsb, agw = self._orig

        def bundle(*a, **kw):
            out = rsb(*a, **kw)
            with _aside():
                self._bundle(rsb, out, a, kw)
            self.calls += 1
            return out

        def aggregate(agg, q, scales, **kw):
            out = agw(agg, q, scales, **kw)
            with _aside():
                self._aggregate(agg, q, scales, out, kw)
            self.aggs += 1
            return out

        sg.row_stats_bundle, sg.aggregate_wire = bundle, aggregate
        return self

    def __exit__(self, *exc):
        self._sg.row_stats_bundle, self._sg.aggregate_wire = self._orig

    def _bundle(self, orig, out, a, kw):
        import torch

        from blades_tpu_torch.ops import rowstats as rs

        x = a[0]
        check(x.dtype == torch.int8 and x.shape[1] % 16 == 0,
              f"wire: a {x.dtype} {tuple(x.shape)} bundle on the wire")
        want = rs.row_stats_bundle_plain(x, **kw)
        asked = sorted(k for k, v in kw.items()
                       if k != "d_true" and v is not None and v is not False)
        err = rowstats_agree(out, want, x, kw, f"wire bundle {asked}, "
                             f"launch {self.calls + 1}")
        self.err = max(self.err, err)
        del want
        n, dp = x.shape
        d = kw.get("d_true") or dp
        w = kw.get("weights")
        if kw.get("gram"):
            name, call = GRAM8_RECORD, dict(gram=True, d_true=d)
        elif kw.get("gram_dot") is not None:
            name, call = GEOMED8_RECORD, dict(
                weights=w, gram_dot=w, gram_dot_shared=(0,), d_true=d)
        elif w is not None:
            name, call = WSUM8_RECORD, dict(weights=w, d_true=d)
        else:
            return
        if name in self.records:
            r = self.records[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            return
        ms = timed(lambda: orig(x, **call), REPS)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs.row_stats_bundle_plain(x, **call)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        lib = None
        if name == GRAM8_RECORD:
            lib, text = _int_mm(x, rs.row_stats_bundle_plain(
                x, gram=True)["gram"])
            log(f"wire: {text}")
            self.records[name] = _record(
                name, ROWSTATS_SRC, ROWSTATS_TPU, ms, plain_ms,
                n * dp + n * n * 4, n * (n + 1) // 2 * dp * 2, err, lib,
                ops_per_s=INT8_TENSOR_OPS_PER_S)
        else:
            k = 4 if name == GEOMED8_RECORD else 2
            self.records[name] = _record(
                name, ROWSTATS_SRC, ROWSTATS_TPU, ms, plain_ms,
                n * dp + d * 4 + n * 4 * (k // 2), k * n * d, err, None)
        log(f"wire: {name} {tuple(x.shape)} int8: {ms:.3f} ms (plain "
            f"{plain_ms:.1f} ms, bound {self.records[name]['bound_ms']:.3f}"
            f" ms by {self.records[name]['bound_by']})")

    def _aggregate(self, agg, q, scales, out, kw):
        """Runs with the planner's own ``row_stats_bundle`` and the
        select module's own ``column_median``, so that no audit sees the
        f32 reference's launches."""
        sg = self._sg
        wrapped, sg.row_stats_bundle = sg.row_stats_bundle, self._orig[0]
        try:
            self._decoded(sg, agg, q, scales, out, kw)
        finally:
            sg.row_stats_bundle = wrapped

    def _decoded(self, sg, agg, q, scales, out, kw):
        import torch

        from blades_tpu_torch.comm.codecs import dequantize
        from blades_tpu_torch.ops import aggregators as ta
        from blades_tpu_torch.ops import column_select as cs

        d, c = kw["d"], kw["d_chunk"]
        n = q.shape[0]
        dec = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for r0 in range(0, n, 100):
            dec[r0:r0 + 100, :d] = dequantize(q[r0:r0 + 100],
                                              scales[r0:r0 + 100], d)
        name = type(agg).__name__
        got, _, sq = out
        if isinstance(agg, ta.Median):
            want = torch.cat([cs.column_median(dec[:, c0:c0 + c][:, :max(
                0, d - c0)].contiguous()) for c0 in range(0, d, c)])
            self.agg_err[name] = same(got, want, "wire Median vs "
                                      "decode-then-f32")
            return
        rtol = WIRE_RTOL
        if isinstance(agg, ta.GeoMed):
            agg = ta.GeoMed(maxiter=kw["recorder"].loop_iters,
                            eps=agg.eps, ftol=-1.0)
            rtol = WIRE_GEOMED_RTOL
        want, _, want_sq = sg.aggregate_streamed(
            agg, dec, None, kw.get("state", ()), d_chunk=c, d=d)
        del dec
        err = float((got - want).abs().max()) / (
            float(want.abs().max()) + 1e-30)
        check(err <= rtol, f"wire {name}: the aggregate differs from "
              f"decode-then-f32 by {err:.3g} of its scale")
        sq_err = float(((sq - want_sq).abs() / want_sq.abs().clamp(
            min=1e-30)).max())
        check(sq_err <= ROW_RTOL, f"wire {name}: row norms differ by "
              f"{sq_err:.3g}")
        self.agg_err[name] = max(self.agg_err.get(name, 0.0), err)


#: A trial's rounds/s after its warm-up round (None with one round) and
#: the text that says it.
_Rate = collections.namedtuple("_Rate", "rps text")


def _wire_trial(what, overrides, rounds):
    """Build, run ``rounds`` rounds (the last evaluating), stop: ``(rows,
    launches, maps, peak bytes, setup s, rate)``, ``rate`` the text of the
    rounds/s over rounds 2.., or of the one round's seconds when there is
    only one; the audits' seconds are taken out of both, their
    allocations out of the peak."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    _reset_peak()
    t0 = time.perf_counter()
    algo = FedavgConfig().update_from_dict(
        {**overrides, "evaluation_interval": rounds}).build()
    setup = time.perf_counter() - t0
    _cuda.reset_launches()
    rows, audit_s = [], []
    try:
        for _ in range(rounds):
            a0 = AUDIT["s"]
            rows.append(algo.train())
            audit_s.append(AUDIT["s"] - a0)
        check(not algo.streamed, f"{what}: not the dense round")
    finally:
        algo.stop()
    launches, maps = dict(_cuda.LAUNCHES), dict(_cuda.MAPS)
    losses = [r["train_loss"] for r in rows]
    check(all(math.isfinite(v) for v in losses)
          and math.isfinite(rows[-1]["test_acc"]),
          f"{what}: train losses {losses}, test_acc "
          f"{rows[-1].get('test_acc')}")
    step = [r["timers"]["training_step"]["total_s"] for r in rows]
    if rounds > 1:  # round 1 warms up; the last one also evaluates
        rps = (rounds - 1) / (step[-1] - step[0] - sum(audit_s[1:]))
        text = f"{rps:.4f} rounds/s over rounds 2-{rounds}"
    else:
        rps = None
        text = (f"its one round {step[0] - audit_s[0]:.3f} s (a first "
                "round, warm-up included)")
    return rows, launches, maps, _peak(), setup, _Rate(rps, text)


def _wire_full(card):
    """Part 1: the 1000-client wire rounds, every int8 bundle, select and
    aggregate audited."""
    counts, records = {}, {}
    ring = {"Multikrum": 0, "GeoMed": 0}
    for agg, rounds in WIRE_AGGS:
        what = f"wire ResNet-10 x 1000 ALIE {agg} quant int8"
        with _WireAudit() as audit, _PathAudit(
                "select", "column_median:wire") as sel:
            rows, launches, maps, peak, setup, rate = _wire_trial(
                what, {**WIRE_TRIAL, "server_config": {
                    "lr": 0.5, "aggregator": {"type": agg}}}, rounds)
        bn = {k: rounds * WIRE_BN_ROUND for k in BN_TPU}
        rsb = {k[1]: v for k, v in maps.items()
               if k[0] == "row_stats_bundle"}
        if agg == "Median":
            want = {"column_median": rounds * WIRE_CHUNKS, **bn}
            check(launches == want and sel.calls == rounds * WIRE_CHUNKS
                  and maps.get(("column_median", "select:radix"))
                  == rounds * WIRE_CHUNKS,
                  f"{what}: launches {launches} by route {maps}, "
                  f"{sel.calls} selects audited; expected {want}")
            counts["column_median:wire"] = launches["column_median"]
            records.update(sel.records)
        else:
            per = 2 if agg == "Multikrum" else None
            check(set(launches) == {"row_stats_bundle", *BN_TPU}
                  and all(launches[k] == v for k, v in bn.items())
                  and (per is None
                       or launches["row_stats_bundle"] == per * rounds)
                  and rsb.get("rowstats:ring") == (
                      launches["row_stats_bundle"])
                  and rsb.get("gram:wgmma", 0) == (
                      rounds if agg == "Multikrum" else 0)
                  and "gram:mma" not in rsb
                  and "rowstats:slab" not in rsb
                  and audit.calls == launches["row_stats_bundle"],
                  f"{what}: launches {launches}, row statistics by route "
                  f"{rsb}, {audit.calls} bundles audited")
            ring[agg] = rsb["rowstats:ring"]
            if agg == "Multikrum":
                counts[GRAM8_RECORD] = rsb["gram:wgmma"]
        check(audit.aggs == rounds, f"{what}: {audit.aggs} aggregates "
              "held against decode-then-f32")
        records.update(audit.records)
        dq = [r["dequant_rows"] for r in rows]
        log(f"{what}: setup {setup:.1f} s, {rate.text} (audits out), "
            "train_loss "
            f"{[r['train_loss'] for r in rows]}, test_acc "
            f"{rows[-1]['test_acc']:.4f}; agg_domain_bits "
            f"{rows[-1]['agg_domain_bits']}, comm_bytes_up "
            f"{rows[-1]['comm_bytes_up']} (x{rows[-1]['comm_compression_ratio']}"
            f"), dequant_rows {dq}, hbm_passes {rows[-1]['hbm_passes']}; "
            f"launches {launches} by route {maps}; {audit.calls} int8 "
            f"bundles against the plain version (max err {audit.err:.3g}),"
            f" aggregate against decode-then-f32: {audit.agg_err}; peak "
            f"{peak / 2**30:.2f} GiB [{card}]")
    counts[WSUM8_RECORD] = ring["Multikrum"]
    counts[GEOMED8_RECORD] = ring["GeoMed"]
    return counts, records


def _wire_ab(card):
    """The wire and the f32 domain on one round configuration at
    ``WIRE_AB_CLIENTS`` clients, Multikrum: rounds/s, in turns."""
    n = WIRE_AB_CLIENTS
    base = {**WIRE_TRIAL,
            "dataset_config": {**WIRE_TRIAL["dataset_config"],
                               "num_clients": n},
            "num_malicious_clients": n // 4,
            "server_config": {"lr": 0.5, "aggregator": {"type": "Multikrum"}}}
    out = {}
    for domain in ("wire", "f32", "f32", "wire"):
        rows, _, _, peak, _, rate = _wire_trial(
            f"wire A/B {domain}", {**base, "agg_domain": domain}, 3)
        out.setdefault(domain, []).append((rate.rps, peak))
    log(f"wire A/B: ResNet-10 x {n} ({n // 4} ALIE), Multikrum, quant int8, "
        f"rounds/s over rounds 2-3 (in turns wire, f32, f32, wire): wire "
        f"{[round(r, 4) for r, _ in out['wire']]}, f32 "
        f"{[round(r, 4) for r, _ in out['f32']]}; peak GiB wire "
        f"{[round(p / 2**30, 2) for _, p in out['wire']]}, f32 "
        f"{[round(p / 2**30, 2) for _, p in out['f32']]} [{card}]")


def _wire_topk(storage, card):
    """Part 2a: top-k 1% + EF on the 60-client dense trial, 3 rounds
    straight; then a run checkpointed at round 1 and killed after round 2,
    resumed from the checkpoint by a fresh driver: parameters, residual
    and rows equal the straight run's bit for bit (cuDNN's deterministic
    algorithms asked for, for both)."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig

    cfg = {**DENSE_TRIAL, "adversary_config": {"type": "ALIE"},
           "codec_config": {"type": "topk", "topk_ratio": 0.01}}

    def build():
        return FedavgConfig().update_from_dict(cfg).build()

    def drop(r):
        return {k: v for k, v in r.items() if k != "timers"}

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ck = os.path.join(storage, "ckpt_topk")
    try:
        algo = build()
        straight = [drop(algo.train()) for _ in range(3)]
        params = {k: v.clone() for k, v in algo.state.server.params.items()}
        residual = algo.state.residual.clone()
        algo.stop()
        algo = build()
        algo.train()
        algo.save_checkpoint(ck)
        algo.train()  # round 2, then the trial 'dies'
        algo.stop()
        algo = build()
        algo.load_checkpoint(ck)
        resumed = [drop(algo.train()) for _ in range(2)]
        same_res = torch.equal(algo.state.residual, residual)
        same_par = all(torch.equal(algo.state.server.params[k], v)
                       for k, v in params.items())
        nz = int((residual != 0).sum())
        algo.stop()
    finally:
        torch.backends.cudnn.deterministic = det
    del params, residual
    check(all(math.isfinite(r["train_loss"]) for r in straight),
          f"wire top-k: rows {straight}")
    log(f"wire top-k 1% + EF, ResNet-10 x 60 ALIE Median f32: train_loss "
        f"{[r['train_loss'] for r in straight]}, test_acc "
        f"{straight[-1]['test_acc']:.4f}, comm_bytes_up "
        f"{straight[-1]['comm_bytes_up']} "
        f"(x{straight[-1]['comm_compression_ratio']}); residual nonzero "
        f"entries {nz}; killed after round 2 and resumed from round 1: "
        f"residual equal {same_res}, parameters equal {same_par}, rows 2-3 "
        f"equal {resumed == straight[1:]} [{card}]")
    check(same_res and same_par and resumed == straight[1:],
          "wire top-k: the resumed run differs from the straight one")


def _wire_faults(card):
    """Part 2b: the fault injector on the 60-client dense trial with the
    health check: round 1 at full participation (the dense Median on
    ``select:radix``), rounds 2-3 with dropout (the participants
    compacted, ``select:radix`` on them)."""
    key = "column_median:faults"
    with _PathAudit("select", key) as sel:
        rows, launches, maps, peak, setup, rate = _wire_trial(
            "wire faults", {**DENSE_TRIAL, "adversary_config":
                            {"type": "ALIE"}, "health_check": True,
                            "fault_config": WIRE_FAULTS}, 3)
    part = [r["num_participating"] for r in rows]
    check(part[0] == 60 and all(p < 60 for p in part[1:])
          and all(r["round_ok"] for r in rows),
          f"wire faults: participation {part}, round_ok "
          f"{[r['round_ok'] for r in rows]}")
    check(launches.get("column_median") == 3 and sel.calls == 3
          and maps.get(("column_median", "select:radix")) == 3,
          f"wire faults: launches {launches} by route {maps}")
    log(f"wire faults {WIRE_FAULTS}, ResNet-10 x 60 ALIE Median f32, "
        f"health check: participating {part}, dropped "
        f"{[r['num_dropped'] for r in rows]}, straggled "
        f"{[r['num_straggled'] for r in rows]}, unhealthy "
        f"{[r['num_unhealthy'] for r in rows]}, staleness_mean "
        f"{[r['staleness_mean'] for r in rows]}; selects on "
        f"{sorted(sel.shapes)}, each bit-exact against the plain version; "
        f"train_loss {[r['train_loss'] for r in rows]}, test_acc "
        f"{rows[-1]['test_acc']:.4f}; {rate.text}, peak "
        f"{peak / 2**30:.2f} GiB [{card}]")
    return {key: launches["column_median"]}, sel.records


def _wire_mlp():
    """Part 3: the verification flow's MLP under top-k and on the wire."""
    for what, extra, rounds in WIRE_MLP:
        rows, _, _, _, _, _ = _wire_trial(f"wire MLP {what}",
                                          {**MLP_TRIAL, **extra}, rounds)
        acc = rows[-1]["test_acc"]
        log(f"wire MLP x 6 ALIE Median {what}: test_acc {acc:.4f} at round "
            f"{rounds}")
        check(acc >= MLP_MIN_ACC, f"wire MLP {what}: test accuracy {acc} "
              f"< {MLP_MIN_ACC} at round {rounds}")


def phase_wire(card):
    """The update codecs, the wire domain and the fault injector on the
    card.  Returns the launches and records of each path."""
    import torch

    torch.cuda.empty_cache()
    counts, records = _wire_full(card)
    _wire_ab(card)
    _wire_topk(_work_dir("wire"), card)
    c, r = _wire_faults(card)
    counts.update(c)
    records.update(r)
    _wire_mlp()
    return counts, records

# The async phase's base configuration: ResNet-10 x 1000 registered
# clients of CIFAR-10 shapes, batch 32, one local step, bf16 compute, 250
# malicious (the prefix), blocks of 25 events; K = 100 events a cycle from
# a buffer of 200, ring depth H = 8, polynomial staleness weights (power
# 0.5), rate 0.05 with the slowest fifth at a quarter of it.
ASYNC_H = 8
ASYNC_K = 100
ASYNC_TRIAL = {
    "dataset_config": {"type": "cifar10", "num_clients": 1000, "iid": False,
                       "alpha": 0.1, "train_bs": 32, "seed": 122},
    "global_model": "resnet10", "compute_dtype": "bfloat16",
    "execution": "async", "client_block": 25,
    "async_config": {"rate": 0.05, "slow_fraction": 0.2, "slow_factor": 0.25,
                     "agg_every": ASYNC_K, "buffer_capacity": 200,
                     "staleness_cap": ASYNC_H,
                     "weight_schedule": "polynomial", "weight_power": 0.5},
    "num_malicious_clients": 250, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 0.5, "aggregator": {"type": "Median"}},
    "client_config": {"lr": 0.1, "num_batch_per_round": 1},
    "evaluation_interval": 0, "evaluation_num_samples": 10,
}
# BN-backward launches of each kernel a cycle: K events in blocks of 25,
# 12 BN layers, one local step (every event trains).
ASYNC_BN_CYCLE = ASYNC_K // 25 * 12
SHARED_DATASETS = 4  # datasets the whole script keeps built (main())


@contextlib.contextmanager
def _shared_datasets(keep=None):
    """The drivers share one build of each dataset (a 1000-client CIFAR-10
    partition takes ~7-10 s on the host; its arrays are never written, so
    the drivers' rounds are unchanged); with ``keep``, only the ``keep``
    datasets asked for last stay (the whole script's cache: each 1000-client
    partition holds ~2.2 GB of host memory)."""
    from blades_tpu_torch.data.datasets import DatasetCatalog

    orig, cache = (DatasetCatalog.__dict__["get_dataset"],
                   collections.OrderedDict())

    def get_dataset(spec, **overrides):
        key = json.dumps([spec, overrides], sort_keys=True, default=str)
        if key not in cache:
            cache[key] = orig.__func__(spec, **overrides)
            while keep is not None and len(cache) > keep:
                cache.popitem(last=False)
        cache.move_to_end(key)
        return cache[key]

    DatasetCatalog.get_dataset = staticmethod(get_dataset)
    try:
        yield
    finally:
        DatasetCatalog.get_dataset = orig


def _bn_layouts(audit):
    """One line per operand layout a BN audit timed: shape, strides, the
    launches of each kernel there, and the single launch's ms of the
    reduction and of dx beside the library's backward."""
    out = []
    for lay, t in sorted(audit.times.items(), key=lambda kv: str(kv[0])):
        dtype, shape, stride = lay
        n = audit.tally.get(("bn_bwd_reduce", lay), 0)
        out.append(
            f"{str(dtype).split('.')[-1]} {shape} strides {stride} x{n}: "
            f"reduce {t['bn_bwd_reduce']['ms']:.4f} ms (library "
            f"{t['bn_bwd_reduce']['lib']:.4f}), dx {t['bn_bwd_dx']['ms']:.4f}"
            f" ms (library full backward {t['bn_bwd_dx']['lib']:.4f})")
    return "; ".join(out)


def _async_driver(overrides):
    from blades_tpu_torch.algorithms import FedavgConfig

    return FedavgConfig().update_from_dict({**ASYNC_TRIAL,
                                            **overrides}).build()


def _host_state(algo):
    return ({k: v.detach().cpu().clone()
             for k, v in algo.state.server.params.items()},
            algo.state.arrivals.detach().cpu().clone(),
            algo._async.host_state())


def _cycles(algo, n):
    """``n`` cycles: their rows and the seconds of each, the audits'
    seconds inside them taken out."""
    import torch

    rows, secs = [], []
    for _ in range(n):
        a0 = AUDIT["s"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows.append(algo.train())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0 - (AUDIT["s"] - a0))
    return rows, secs


def _same_state(a, b, what):
    """Parameters, ring and host state equal bit for bit."""
    import torch

    for k, v in a[0].items():
        check(torch.equal(v, b[0][k]), f"{what}: parameter {k} differs")
    check(torch.equal(a[1], b[1]), f"{what}: the params ring differs")
    check(a[2] == b[2], f"{what}: host state {a[2]} vs {b[2]}")


def _warm_rate(secs, unit):
    """The first round's (or cycle's) seconds on their own, and the rate
    over the rest (PERF.md's rounds/s is taken after a warm-up round)."""
    text = f"first {unit} {secs[0]:.3f} s"
    if len(secs) > 1:
        text += (f", then {(len(secs) - 1) / sum(secs[1:]):.4f} {unit}s/s "
                 f"over {unit}s 2-{len(secs)}")
    return text


def _async_log(what, rows, secs, peak, card):
    log(f"async {what}: {_warm_rate(secs, 'cycle')} "
        f"({[round(t, 3) for t in secs]} s a cycle, audits out), "
        "updates_per_sec "
        f"{[r['updates_per_sec'] for r in rows]} (audits in), ticks "
        f"{[r['tick'] for r in rows]}, staleness_hist "
        f"{[r['staleness_hist'] for r in rows]}, staleness_mean "
        f"{[r['staleness_mean'] for r in rows]}, buffer_fill "
        f"{[r['buffer_fill'] for r in rows]}, overflow "
        f"{[r['buffer_overflow'] for r in rows]}, dropped "
        f"{[r['arrivals_dropped'] for r in rows]}; train_loss "
        f"{[r['train_loss'] for r in rows]}, agg_norm "
        f"{[r['agg_norm'] for r in rows]}; peak {peak / 2**30:.2f} GiB "
        f"[{card}]")
    check(all(math.isfinite(r["train_loss"]) and math.isfinite(r["agg_norm"])
              for r in rows), f"async {what}: non-finite losses")


def _async_median(card, work):
    """Trial 1: ALIE + Median, 4 cycles straight; then 2 cycles, a
    checkpoint, a fresh driver restored from it and 2 more: equal to the
    straight run's cycles 3-4, parameters, ring and host state."""
    import torch

    from blades_tpu_torch.ops import _cuda

    _reset_peak()
    algo = _async_driver({})
    _cuda.reset_launches()
    rows, secs = _cycles(algo, 4)
    ev = algo.evaluate()
    check(math.isfinite(ev["test_acc"]), f"async: test_acc {ev}")
    straight = _host_state(algo)
    peak = _peak()
    algo.stop()
    _async_log("ALIE + Median, straight", rows, secs, peak, card)
    log(f"async ALIE + Median: test_acc {ev['test_acc']:.4f} after 4 cycles")
    first = _async_driver({})
    _cycles(first, 2)
    first.save_checkpoint(os.path.join(work, "ckpt"))
    first.stop()
    resumed = _async_driver({})
    resumed.load_checkpoint(os.path.join(work, "ckpt"))
    again, _ = _cycles(resumed, 2)
    got = _host_state(resumed)
    resumed.stop()
    launches = dict(_cuda.LAUNCHES)
    _same_state(got, straight, "async kill-and-resume")
    for a, b in zip(again, rows[2:]):
        for k in ("train_loss", "agg_norm", "tick", "staleness_hist"):
            check(a[k] == b[k], f"async resume: cycle "
                  f"{a['training_iteration']} {k} {a[k]} vs {b[k]}")
    log(f"async kill-and-resume: killed after cycle 2, restored from its "
        f"checkpoint (ring {tuple(got[1].shape)} f32, host state "
        f"{len(got[2]['buffer'])} buffered events), cycles 3-4 equal to the "
        f"straight run's: parameters, ring and host state bit for bit, "
        f"train_loss {[r['train_loss'] for r in again]}")
    torch.cuda.empty_cache()
    return launches, rows[0]["tick"]


def _async_diurnal(card, first_tick):
    """Trial 2: DiurnalALIE (period 8 ticks) + Trimmedmean, dropout 0.3
    from the tick that ended trial 1's first cycle, 3 cycles."""
    from blades_tpu_torch.ops import _cuda

    _reset_peak()
    algo = _async_driver({
        "adversary_config": {"type": "DiurnalALIE", "period": 8},
        "server_config": {"lr": 0.5, "aggregator": {
            "type": "Trimmedmean", "num_byzantine": 25}},
        "fault_config": {"dropout_rate": 0.0,
                         "dropout_schedule": [[first_tick, 0.3]]}})
    _cuda.reset_launches()
    rows, secs = _cycles(algo, 3)
    peak = _peak()
    algo.stop()
    dropped = [r["arrivals_dropped"] for r in rows]
    check(dropped[0] == 0 and dropped[-1] > 0,
          f"async DiurnalALIE: arrivals dropped {dropped} (dropout from "
          f"tick {first_tick})")
    _async_log(f"DiurnalALIE + Trimmedmean(k=26), dropout 0.3 from tick "
               f"{first_tick}", rows, secs, peak, card)
    return dict(_cuda.LAUNCHES)


def _async_lazy(card):
    """Trial 3: Lazy replay + Mean, 2 cycles: malicious events train
    against ring row H."""
    from blades_tpu_torch.ops import _cuda

    _reset_peak()
    algo = _async_driver({
        "adversary_config": {"type": "Lazy", "mode": "replay"},
        "server_config": {"lr": 0.5, "aggregator": {"type": "Mean"}}})
    _cuda.reset_launches()
    read, rows, secs = [], [], []
    for _ in range(2):
        r, t = _cycles(algo, 1)
        rows += r
        secs += t
        eng = algo._async
        mal = algo._malicious_host[eng.last_clients]
        ring = eng._cycle.last_ring_rows
        check((ring[mal] == ASYNC_H).all() and (
            ring[~mal] == eng.last_staleness[~mal].clip(0, ASYNC_H)).all(),
              f"async Lazy: ring rows {ring.tolist()} for malicious "
              f"{mal.tolist()}")
        read.append((int(mal.sum()), sorted(set(ring[~mal].tolist()))))
    peak = _peak()
    algo.stop()
    _async_log("Lazy replay + Mean", rows, secs, peak, card)
    log(f"async Lazy replay: malicious events per cycle read ring row "
        f"{ASYNC_H}, the others their own version: (malicious events, rows "
        f"the benign ones read) {read}")
    return dict(_cuda.LAUNCHES)


def phase_async(card):
    """Buffered-async execution through ``Fedavg.train()`` at ResNet-10 x
    1000 registered clients: three trials, every select and BN launch
    held against the plain versions as the path runs."""
    import torch

    torch.cuda.empty_cache()
    work = _work_dir("async")
    counts = {}
    with _shared_datasets(), _BnAudit(key="async") as bn_audit:
        with _PathAudit("select", "column_median:async") as sel:
            launches, first_tick = _async_median(card, work)
        cycles = 8  # 4 straight, 2 before the kill, 2 after the restore
        want = {"column_median": cycles,
                **{k: cycles * ASYNC_BN_CYCLE for k in BN_TPU}}
        check(launches == want and sel.calls == cycles,
              f"async Median: launches {launches}, {sel.calls} audited, "
              f"expected {want}")
        counts["column_median:async"] = launches["column_median"]
        with _PathAudit("trim", "column_trimmed_mean:async") as trim:
            launches = _async_diurnal(card, first_tick)
        want = {"column_trimmed_mean": 3,
                **{k: 3 * ASYNC_BN_CYCLE for k in BN_TPU}}
        check(launches == want and trim.calls == 3,
              f"async DiurnalALIE: launches {launches}, expected {want}")
        counts["column_trimmed_mean:async"] = launches["column_trimmed_mean"]
        launches = _async_lazy(card)
        want = {k: 2 * ASYNC_BN_CYCLE for k in BN_TPU}
        check(launches == want, f"async Lazy: launches {launches}, expected "
              f"{want}")
    total = cycles + 3 + 2
    for k in BN_TPU:
        counts[f"{k}:async"] = total * ASYNC_BN_CYCLE
    check(bn_audit.calls == 2 * total * ASYNC_BN_CYCLE,
          f"async: {bn_audit.calls} BN launches audited")
    log(f"async: selects on {sorted(sel.shapes | trim.shapes)}, each "
        f"against the plain version (median bit-exact, trimmed mean max err "
        f"{trim.records['column_trimmed_mean:async']['max_abs_err']:.3g}); "
        f"{bn_audit.calls} BN launches with per-lane parameters from step 0 "
        f"audited (dx bit-exact, sums max err {bn_audit.err:.3g}, layouts "
        f"{len(bn_audit.layouts)}) [{card}]")
    log(f"async BN layouts: {_bn_layouts(bn_audit)}")
    return counts, {**sel.records, **trim.records,
                    **bn_audit.records(total)}


WINDOW_TRIAL = {
    "dataset_config": {"type": "cifar10", "num_clients": 1000, "iid": False,
                       "alpha": 0.1, "train_bs": 32, "seed": 122},
    "global_model": "resnet10", "compute_dtype": "bfloat16",
    "client_block": 25, "state_window": 100,
    "num_malicious_clients": 250, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 0.5, "aggregator": {"type": "Median"}},
    "client_config": {"lr": 0.1, "momentum": 0.9, "num_batch_per_round": 1},
    "evaluation_interval": 0,
}
WINDOW_ROUNDS = 3
WINDOW_BN_ROUND = 100 // 25 * 12


def _window_driver(overrides):
    from blades_tpu_torch.algorithms import FedavgConfig

    return FedavgConfig().update_from_dict({**WINDOW_TRIAL,
                                            **overrides}).build()


def _window_log(what, rows, secs, peak, card):
    log(f"window {what}: {_warm_rate(secs, 'round')} "
        f"({[round(t, 3) for t in secs]} s a round, audits out); "
        f"state_stage_ms {[r['state_stage_ms'] for r in rows]}, "
        f"state_bytes_staged {[r['state_bytes_staged'] for r in rows]}, "
        f"state_peak_hbm_bytes {rows[-1]['state_peak_hbm_bytes']}, "
        f"data_stage_ms {[r['data_stage_ms'] for r in rows]}; train_loss "
        f"{[r['train_loss'] for r in rows]}; peak {peak / 2**30:.2f} GiB "
        f"[{card}]")
    check(all(math.isfinite(r["train_loss"]) for r in rows),
          f"window {what}: non-finite losses")


def _window_pair(card):
    """The host store and the resident store, in turns, 3 rounds each:
    their parameters equal bit for bit."""
    import torch

    from blades_tpu_torch.ops import _cuda

    _reset_peak()
    host = _window_driver({"state_store": "host"})
    resident = _window_driver({"state_store": "resident"})
    _cuda.reset_launches()
    out = {"host": ([], []), "resident": ([], [])}
    for _ in range(WINDOW_ROUNDS):
        for name, algo in (("host", host), ("resident", resident)):
            rows, secs = _cycles(algo, 1)
            out[name][0].extend(rows)
            out[name][1].extend(secs)
    peak = _peak()
    launches = dict(_cuda.LAUNCHES)
    for k, v in host.state.server.params.items():
        check(torch.equal(v, resident.state.server.params[k]),
              f"window: parameter {k} differs between the host and the "
              "resident store")
    pinned = host._state_store.total_bytes()
    host.stop()
    resident.stop()
    for name in ("host", "resident"):
        _window_log(f"{name} store", *out[name], peak, card)
    log(f"window: host store ({pinned / 1e9:.2f} GB of momentum rows in "
        f"pinned host memory) and resident store, in turns: parameters "
        f"equal bit for bit after {WINDOW_ROUNDS} rounds")
    torch.cuda.empty_cache()
    return launches


def _window_disk(card, work):
    """200 registered clients, the disk store, the memmap data store,
    evaluation in chunks of 64: killed after round 2 and resumed from the
    shard checkpoint, round 3 equal to a straight run's."""
    import shutil

    import torch

    from blades_tpu_torch.ops import _cuda

    def build(tag):
        return _window_driver({
            "dataset_config": {**WINDOW_TRIAL["dataset_config"],
                               "num_clients": 200},
            "num_malicious_clients": 50, "state_store": "disk",
            "state_dir": os.path.join(work, tag), "data_store": "memmap",
            "data_dir": os.path.join(work, "shards"),
            "eval_chunk_clients": 64, "evaluation_interval": WINDOW_ROUNDS})

    _reset_peak()
    _cuda.reset_launches()
    straight = build("live_a")
    rows, secs = _cycles(straight, WINDOW_ROUNDS)
    want = {k: v.detach().cpu().clone()
            for k, v in straight.state.server.params.items()}
    peak = _peak()
    straight.stop()
    shutil.rmtree(os.path.join(work, "live_a"), ignore_errors=True)
    _window_log("disk store x 200, memmap data, straight", rows, secs, peak,
                card)
    check(rows[-1]["eval_chunks"] == 4
          and math.isfinite(rows[-1]["test_acc"]),
          f"window disk: eval_chunks {rows[-1].get('eval_chunks')}, test_acc "
          f"{rows[-1].get('test_acc')}")
    first = build("live_b")
    _cycles(first, 2)
    t0 = time.perf_counter()
    first.save_checkpoint(os.path.join(work, "ckpt"))
    save_s = time.perf_counter() - t0
    first.stop()
    shutil.rmtree(os.path.join(work, "live_b"), ignore_errors=True)
    shards = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
                 os.walk(os.path.join(work, "ckpt", "client_state"))
                 for f in fs)
    resumed = build("live_c")
    t0 = time.perf_counter()
    resumed.load_checkpoint(os.path.join(work, "ckpt"))
    load_s = time.perf_counter() - t0
    (last,), _ = _cycles(resumed, 1)
    for k, v in resumed.state.server.params.items():
        check(torch.equal(v.cpu(), want[k]),
              f"window disk resume: parameter {k} differs from the straight "
              "run's")
    check(last["train_loss"] == rows[-1]["train_loss"]
          and last["test_acc"] == rows[-1]["test_acc"],
          f"window disk resume: round 3 {last['train_loss']} / "
          f"{last['test_acc']} vs {rows[-1]['train_loss']} / "
          f"{rows[-1]['test_acc']}")
    resumed.stop()
    log(f"window disk: killed after round 2, {shards / 1e9:.2f} GB of shard "
        f"checkpoint written in {save_s:.1f} s and restored in {load_s:.1f} "
        f"s; round 3 equal to the straight run's (parameters bit for bit, "
        f"train_loss {last['train_loss']!r}, test_acc {last['test_acc']!r}, "
        f"evaluated in {last['eval_chunks']} chunks)")
    return dict(_cuda.LAUNCHES)


def phase_window(card):
    """The participation window through ``Fedavg.train()``: ResNet-10 x
    1000 registered clients, cohorts of 100, client momentum, ALIE +
    Median, every select and BN launch held against the plain versions.
    cuDNN runs deterministic algorithms here, so two runs can be compared
    bit for bit."""
    import torch

    torch.cuda.empty_cache()
    work = _work_dir("window")
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        with _shared_datasets(), \
                _PathAudit("select", "column_median:window") as sel, \
                _BnAudit(key="window") as bn_audit:
            pair = _window_pair(card)
            disk = _window_disk(card, work)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            saved)
    rounds = 2 * WINDOW_ROUNDS
    want = {"column_median": rounds,
            **{k: rounds * WINDOW_BN_ROUND for k in BN_TPU}}
    check(pair == want, f"window pair: launches {pair}, expected {want}")
    want_disk = {"column_median": 2 * WINDOW_ROUNDS,
                 **{k: 2 * WINDOW_ROUNDS * WINDOW_BN_ROUND for k in BN_TPU}}
    check(disk == want_disk, f"window disk: launches {disk}, expected "
          f"{want_disk}")
    total = rounds + 2 * WINDOW_ROUNDS
    check(sel.calls == total and bn_audit.calls == 2 * total
          * WINDOW_BN_ROUND, f"window: {sel.calls} selects and "
          f"{bn_audit.calls} BN launches audited")
    log(f"window: selects on {sorted(sel.shapes)}, each bit-exact against "
        f"the plain version; {bn_audit.calls} BN launches audited (dx "
        f"bit-exact, sums max err {bn_audit.err:.3g}) [{card}]")
    log(f"window BN layouts: {_bn_layouts(bn_audit)}")
    counts = {"column_median:window": total,
              **{f"{k}:window": total * WINDOW_BN_ROUND for k in BN_TPU}}
    return counts, {**sel.records, **bn_audit.records(total)}


# The obs phase.  Part (a): a copy of fedavg_cifar10_resnet_noniid.yaml
# with forensics on, cut to its Trimmedmean and Multikrum points under ALIE
# with 15 malicious of 60 clients (alpha 0.1) and 2 rounds (cut from 3),
# evaluated at round 2, through train.main(["file", ...]) with spans, the
# watchdog, the CSV sink and a 4-round flight recorder.
OBS_YAML = os.path.join(TUNED, "fedavg_cifar10_resnet_noniid.yaml")
OBS_ROUNDS = 2
OBS_DENSE_BN_ROUND = 2 * 12  # 60 clients in blocks of 50 and 10
OBS_TURNS = 2                # forensics-on / -off rounds, in turns
# Part (b): the async phase's configuration with DiurnalALIE +
# Trimmedmean, forensics, the resident ledger and the default control
# policy; the watchdog's fpr_collapse ceiling at 0 so that the quarantine
# fires in cycle 1 (its release, round 9, lies past the run).
OBS_ASYNC = {
    "adversary_config": {"type": "DiurnalALIE", "period": 8},
    "server_config": {"lr": 0.5, "aggregator": {
        "type": "Trimmedmean", "num_byzantine": 25}},
}
OBS_CONTROL = {
    "forensics": True, "ledger": True, "control_config": {"enabled": True},
}
OBS_CYCLES = 4


def _obs_yaml(out_dir):
    """The cut copy of the tuned example, written as JSON (a YAML flow
    document the port's reader takes) into ``out_dir``."""
    from blades_tpu_torch.tune import load_experiments_from_file

    (name, spec), = load_experiments_from_file(OBS_YAML).items()
    cfg = spec["config"]
    cfg["dataset_config"]["alpha"] = 0.1
    cfg["server_config"]["aggregator"] = {"grid_search": [
        {"type": "Trimmedmean"}, {"type": "Multikrum"}]}
    cfg["num_malicious_clients"] = 15
    cfg["adversary_config"] = {"type": "ALIE"}
    cfg["evaluation_interval"] = OBS_ROUNDS
    cfg["forensics"] = True
    spec["stop"] = {"training_iteration": OBS_ROUNDS}
    path = os.path.join(out_dir, "fedavg_cifar10_resnet_noniid_obs.yaml")
    with open(path, "w") as fh:
        json.dump({name: spec}, fh)  # one line: a YAML flow mapping
    return path, name, cfg


def _obs_dense(card, out_dir, baseline):
    """Part (a): the two file trials, their streams validated; then the
    Trimmedmean point with forensics on and off, 2 rounds each in turns,
    their parameters equal bit for bit.  Returns the launches."""
    import torch

    from blades_tpu_torch import train
    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.obs import validate_chrome_trace, validate_jsonl
    from blades_tpu_torch.ops import _cuda

    path, exp, cfg = _obs_yaml(out_dir)
    storage, spans = (os.path.join(out_dir, d) for d in ("trials", "spans"))
    with _TrialSpy() as spy:
        rc = train.main(["file", path, "--storage-path", storage,
                         "--trace-dir", spans, "--watchdog", "--metrics-csv",
                         "--flightrec-rounds", "4", "--no-cost-analysis"])
    check(rc == 0 and len(spy.trials) == 2,
          f"obs dense: rc {rc}, {len(spy.trials)} trials")
    launches = {}
    for i, (agg, t) in enumerate(zip(("Trimmedmean", "Multikrum"),
                                     spy.trials)):
        rows = _rows(storage, exp, i)
        _trial_checks(f"obs {agg}", t, rows, OBS_ROUNDS, baseline)
        tdir = os.path.join(storage, exp, f"{exp}_{i:05d}")
        n_ok, errors = validate_jsonl(os.path.join(tdir, "metrics.jsonl"))
        check(n_ok == OBS_ROUNDS and not errors,
              f"obs {agg}: metrics.jsonl {n_ok} valid, errors {errors}")
        n_spans, errors = validate_chrome_trace(
            os.path.join(spans, f"{exp}_{i:05d}.trace.json"))
        # trial, compile + round spans, training_step each, evaluate
        check(n_spans >= 2 * OBS_ROUNDS + 2 and not errors,
              f"obs {agg}: trace {n_spans} spans, errors {errors}")
        check(os.path.exists(os.path.join(tdir, "metrics.csv")),
              f"obs {agg}: no metrics.csv")
        last = rows[-1]
        lanes = last["lane_forensics"]
        check(len(lanes["benign_mask"]) == 60 and lanes["clients"]
              == list(range(60)) and math.isfinite(last["test_acc"]),
              f"obs {agg}: lanes {len(lanes['benign_mask'])}, test_acc "
              f"{last.get('test_acc')}")
        want = {k: OBS_ROUNDS * OBS_DENSE_BN_ROUND for k in BN_TPU}
        if agg == "Trimmedmean":
            want["column_trimmed_mean"] = OBS_ROUNDS
        check(t["launches"] == want, f"obs {agg}: launches "
              f"{t['launches']}, expected {want}")
        for k, v in t["launches"].items():
            launches[k] = launches.get(k, 0) + v
        log(f"obs {agg} x 60 ALIE (15) f32, forensics: byz_precision "
            f"{[r['byz_precision'] for r in rows]}, byz_recall "
            f"{[r['byz_recall'] for r in rows]}, byz_fpr "
            f"{[r['byz_fpr'] for r in rows]}, num_flagged "
            f"{[r['num_flagged'] for r in rows]}; watchdog events "
            f"{sum(len(r.get('watchdog_events', [])) for r in rows)}; "
            f"train_loss {[r['train_loss'] for r in rows]}, test_acc "
            f"{last['test_acc']:.4f}; {_train_rps(f'obs {agg}', t)[1]}; "
            f"{n_spans} spans; peak {t['peak'] / 2**30:.2f} GiB [{card}]")
    trial = {k: v for k, v in cfg.items()}
    trial["server_config"] = {**cfg["server_config"],
                              "aggregator": {"type": "Trimmedmean"}}
    trial["evaluation_interval"] = 0
    drivers = {on: FedavgConfig().update_from_dict(
        {**trial, "forensics": on}).build() for on in (True, False)}
    _cuda.reset_launches()
    secs = {True: [], False: []}
    for _ in range(OBS_TURNS):
        for on, algo in drivers.items():
            secs[on].extend(_cycles(algo, 1)[1])
    for k, v in drivers[True].state.server.params.items():
        check(torch.equal(v, drivers[False].state.server.params[k]),
              f"obs: parameter {k} differs between the forensics-on and "
              "-off rounds")
    turns = dict(_cuda.LAUNCHES)
    want = {"column_trimmed_mean": 2 * OBS_TURNS,
            **{k: 2 * OBS_TURNS * OBS_DENSE_BN_ROUND for k in BN_TPU}}
    check(turns == want, f"obs turns: launches {turns}, expected {want}")
    for algo in drivers.values():
        algo.stop()
    for k, v in turns.items():
        launches[k] = launches.get(k, 0) + v
    rps = {on: len(s) / sum(s) for on, s in secs.items()}
    log(f"obs dense Trimmedmean x 60, forensics on / off in turns: "
        f"{rps[True]:.4f} / {rps[False]:.4f} rounds/s (audits out; "
        f"{[round(x, 3) for x in secs[True]]} / "
        f"{[round(x, 3) for x in secs[False]]} s), parameters equal bit for "
        f"bit after {OBS_TURNS} rounds each [{card}]")
    torch.cuda.empty_cache()
    return launches, rps


def _obs_async(card, work):
    """Part (b): the async cycle with forensics, the resident ledger and
    control beside a forensics-off twin, in turns, 4 cycles; then 2
    cycles, a checkpoint and 2 more from a fresh driver: cycles 3-4 equal
    to the straight run's."""
    import torch

    from blades_tpu_torch.obs.watchdog import default_rules
    from blades_tpu_torch.ops import _cuda

    rules = [dict(name=r.name, kind=r.kind, field=r.field, window=r.window,
                  min_points=r.min_points, factor=r.factor,
                  threshold=0.0 if r.name == "fpr_collapse" else r.threshold)
             for r in default_rules()]
    armed = {**OBS_ASYNC, **OBS_CONTROL, "watchdog_rules": rules}
    _reset_peak()
    on, off = _async_driver(armed), _async_driver(OBS_ASYNC)
    _cuda.reset_launches()
    out = {True: ([], []), False: ([], [])}
    for _ in range(OBS_CYCLES):
        for flag, algo in ((True, on), (False, off)):
            rows, secs = _cycles(algo, 1)
            out[flag][0].extend(rows)
            out[flag][1].extend(secs)
    straight = _host_state(on)
    held = sorted(on._controller.quarantine)
    host_bytes = on.client_ledger.host_bytes()
    peak = _peak()
    off.stop()
    on.stop()
    first = _async_driver(armed)
    _cycles(first, 2)
    first.save_checkpoint(os.path.join(work, "ckpt"))
    first.stop()
    resumed = _async_driver(armed)
    resumed.load_checkpoint(os.path.join(work, "ckpt"))
    again, _ = _cycles(resumed, 2)
    got = _host_state(resumed)
    got_held = sorted(resumed._controller.quarantine)
    resumed.stop()
    launches = dict(_cuda.LAUNCHES)
    cycles = 2 * OBS_CYCLES + 4
    want = {"column_trimmed_mean": cycles,
            **{k: cycles * ASYNC_BN_CYCLE for k in BN_TPU}}
    check(launches == want, f"obs async: launches {launches}, expected "
          f"{want}")
    _same_state(got, straight, "obs async kill-and-resume")
    keys = ("train_loss", "agg_norm", "tick", "byz_precision", "byz_recall",
            "byz_fpr", "num_flagged", "lane_forensics",
            "suspected_fraction", "flagged_churn", "reputation_p10",
            "reputation_p50", "reputation_p90", "ledger_clients_seen",
            "ledger_top_suspects", "watchdog_events", "control_actions",
            "control_actions_total", "quarantine_size",
            "arrivals_quarantined")
    rows = out[True][0]
    for a, b in zip(again, rows[2:]):
        for k in keys:
            check(a[k] == b[k], f"obs async resume: cycle "
                  f"{a['training_iteration']} {k} {a[k]!r} vs {b[k]!r}")
    check(got_held == held and held and rows[0]["control_actions"],
          f"obs async: quarantine {got_held} vs {held}, actions "
          f"{rows[0]['control_actions']}")
    cps = {flag: len(s) / sum(s) for flag, (_, s) in out.items()}
    log(f"obs async DiurnalALIE + Trimmedmean x 1000, K = 100: forensics + "
        f"ledger + control on / off in turns {cps[True]:.4f} / "
        f"{cps[False]:.4f} cycles/s (audits out); actions "
        f"{[[a['actuator'] for a in r['control_actions']] for r in rows]}, "
        f"quarantine {held}, arrivals_quarantined "
        f"{[r['arrivals_quarantined'] for r in rows]}, num_flagged "
        f"{[r['num_flagged'] for r in rows]}, byz_recall "
        f"{[r['byz_recall'] for r in rows]}, ledger seen "
        f"{[r['ledger_clients_seen'] for r in rows]}, top suspects "
        f"{rows[-1]['ledger_top_suspects']}; ledger host_bytes {host_bytes};"
        f" peak {peak / 2**30:.2f} GiB [{card}]")
    log(f"obs async kill-and-resume: killed after cycle 2, cycles 3-4 equal "
        f"to the straight run's (parameters, ring and host state bit for "
        f"bit; forensics, ledger fields, watchdog events, control actions "
        f"and the quarantine set {held} equal)")
    torch.cuda.empty_cache()
    return launches, cps, host_bytes


def _obs_window(card, work):
    """Part (c): cohorts of 100 of 1000, Median, forensics and the disk
    ledger, 2 rounds; the ledger's shard checkpoint validated."""
    import torch

    from blades_tpu_torch.obs import validate_ledger_checkpoint
    from blades_tpu_torch.ops import _cuda

    _cuda.reset_launches()
    algo = _window_driver({"forensics": True, "ledger": "disk",
                           "ledger_dir": os.path.join(work, "ledger_live")})
    rows, secs = _cycles(algo, 2)
    algo.save_checkpoint(os.path.join(work, "wckpt"))
    host_bytes = algo.client_ledger.host_bytes()
    cohorts = [r["lane_forensics"]["clients"] for r in rows]
    algo.stop()
    launches = dict(_cuda.LAUNCHES)
    want = {"column_median": 2, **{k: 2 * WINDOW_BN_ROUND for k in BN_TPU}}
    check(launches == want, f"obs window: launches {launches}, expected "
          f"{want}")
    n_ok, errors = validate_ledger_checkpoint(
        os.path.join(work, "wckpt", "ledger"))
    check(n_ok > 0 and not errors, f"obs window: ledger checkpoint {n_ok} "
          f"files, errors {errors}")
    check(all(len(set(c)) == 100 for c in cohorts)
          and rows[-1]["ledger_clients_seen"] == len(set(sum(cohorts, []))),
          f"obs window: cohorts {[len(c) for c in cohorts]}, seen "
          f"{rows[-1]['ledger_clients_seen']}")
    log(f"obs window x 1000, cohorts of 100, Median, forensics + disk "
        f"ledger: {len(secs) / sum(secs):.4f} rounds/s (audits out), "
        f"num_flagged {[r['num_flagged'] for r in rows]}, ledger seen "
        f"{[r['ledger_clients_seen'] for r in rows]}; ledger host_bytes "
        f"{host_bytes}, its checkpoint {n_ok} shard files valid [{card}]")
    torch.cuda.empty_cache()
    return launches, host_bytes


def _obs_flightrec(out_dir):
    """Part (d): the MLP trial under the fault injector's NaN corruption,
    the health check off: nan_aggregate fires and the flight recorder's
    dump validates."""
    from blades_tpu_torch import train
    from blades_tpu_torch.obs import validate_flightrec

    grid = {"obs_nan": {"run": "FEDAVG", "stop": {"training_iteration": 2},
                        "config": {**MLP_TRIAL, "fault_config": {
                            "corrupt_rate": 1.0, "corrupt_mode": "nan"}}}}
    path = os.path.join(out_dir, "obs_nan.yaml")
    with open(path, "w") as fh:
        json.dump(grid, fh)
    storage = os.path.join(out_dir, "nan")
    rc = train.main(["file", path, "--storage-path", storage, "--watchdog",
                     "--flightrec-rounds", "4", "--no-cost-analysis"])
    rows = _rows(storage, "obs_nan", 0)
    rules = {e["rule"] for e in rows[0].get("watchdog_events", [])}
    dump = os.path.join(storage, "obs_nan", "obs_nan_00000",
                        "flightrec.json")
    n, errors = validate_flightrec(dump)
    check(rc == 0 and "nan_aggregate" in rules and n >= 1 and not errors,
          f"obs flightrec: rc {rc}, rules {rules}, dump {n} rounds, errors "
          f"{errors}")
    log(f"obs flightrec: MLP x 6 under NaN corruption, health check off: "
        f"watchdog {sorted(rules)} in round 1, flightrec.json with {n} "
        f"round(s) validated")


def phase_obs(card):
    """Forensics, the metrics streams, spans, the watchdog, the flight
    recorder, the client ledger and the control plane at full width, on
    the dense, async and windowed paths, every select and BN launch held
    against the plain versions.  cuDNN runs deterministic algorithms
    here, so forensics-on and -off rounds compare bit for bit."""
    import torch

    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    work = _work_dir("obs")
    out_dir = os.path.join(HERE, "chiprun_out", "obs")
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    audits = {path: _BnAudit(key=path)
              for path in ("obs", "obs-async", "obs-window")}
    try:
        with _shared_datasets(), \
                _PathAudit("trim", "column_trimmed_mean:obs") as trim, \
                _PathAudit("select", "column_median:obs") as sel:
            with audits["obs"]:
                dense, rps = _obs_dense(card, out_dir, baseline)
            with audits["obs-async"]:
                asyn, cps, ledger_res = _obs_async(card, work)
            with audits["obs-window"]:
                win, ledger_disk = _obs_window(card, work)
        _obs_flightrec(out_dir)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            saved)
    # The selects' launches add up over the three paths; the BN pair's
    # stay one record per path, as each path hands it its own layout
    # (f32 folded dense, bf16 per-lane async, bf16 windowed).
    counts = {}
    for path, launches in (("obs", dense), ("obs-async", asyn),
                           ("obs-window", win)):
        for k, v in launches.items():
            key = f"{k}:{path}" if k in BN_TPU else f"{k}:obs"
            counts[key] = counts.get(key, 0) + v
    rounds = {"obs": 2 * OBS_ROUNDS + 2 * OBS_TURNS,
              "obs-async": 2 * OBS_CYCLES + 4, "obs-window": 2}
    bn_calls = {p: a.calls for p, a in audits.items()}
    check(trim.calls == counts.get("column_trimmed_mean:obs")
          and sel.calls == counts.get("column_median:obs")
          and all(n == 2 * counts.get(f"bn_bwd_reduce:{p}", 0)
                  for p, n in bn_calls.items()),
          f"obs: audited {trim.calls} trimmed means, {sel.calls} medians, "
          f"BN launches {bn_calls} for launches {counts}")
    log(f"obs: trimmed means on {sorted(trim.shapes)} (max err "
        f"{trim.records['column_trimmed_mean:obs']['max_abs_err']:.3g}), "
        f"medians on {sorted(sel.shapes)} bit-exact, BN launches audited "
        f"{bn_calls} (dx bit-exact, sums max err "
        f"{max(a.err for a in audits.values()):.3g}) [{card}]")
    log(f"obs summary: dense rounds/s forensics on {rps[True]:.4f} / off "
        f"{rps[False]:.4f}; async cycles/s on {cps[True]:.4f} / off "
        f"{cps[False]:.4f}; ledger host_bytes resident {ledger_res}, disk "
        f"{ledger_disk}")
    records = {**trim.records, **sel.records}
    for path, audit in audits.items():
        log(f"{path} BN layouts: {_bn_layouts(audit)}")
        records.update(audit.records(rounds[path]))
    return counts, records


# The gossip phase: bench.py's gossip protocol (:1149-1166: ALIE on a
# quarter of the nodes, Median, server lr 0.5, client lr 0.1, batch 32, one
# local step) at ResNet-10's width, 64 nodes of CIFAR-10 shapes, f32,
# blocks of 32 lanes, each from its own replica.
GOSSIP_N = 64
GOSSIP_BLOCK = 32
GOSSIP_TRIAL = {
    "dataset_config": {"type": "cifar10", "num_clients": GOSSIP_N,
                       "train_bs": 32, "seed": 122},
    "global_model": "resnet10", "execution": "gossip",
    "client_block": GOSSIP_BLOCK,
    "topology_config": {"graph": "kregular", "k": 4,
                        "mixing": "metropolis"},
    "num_malicious_clients": GOSSIP_N // 4,
    "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 0.5, "aggregator": {"type": "Median"}},
    "client_config": {"lr": 0.1, "num_batch_per_round": 1},
    "evaluation_interval": 0, "evaluation_num_samples": 10,
}
GOSSIP_ROUNDS = 3  # headline rounds timed after one warm-up round
# BN-backward launches of each kernel a round: 64 lanes in blocks of 32,
# 12 BN layers, one local step.
GOSSIP_BN_ROUND = GOSSIP_N // GOSSIP_BLOCK * 12
GOSSIP_DROPOUT = {"dropout_rate": 0.2, "seed": 11}
GOSSIP_AB_N = 32  # bench.py's A/B (:1196-1216): the CNN, 32 nodes
GOSSIP_AB_ROUNDS = 3
GOSSIP_ARMS = (("centralized", {"execution": "dense",
                                "topology_config": None}),
               ("ring", {"topology_config": {"graph": "ring"}}),
               ("kregular", {"topology_config": {"graph": "kregular",
                                                 "k": 4}}))
GOSSIP_KEY = {"select": "column_median:gossip"}


def _gossip_driver(overrides):
    from blades_tpu_torch.algorithms import FedavgConfig

    return FedavgConfig().update_from_dict({**GOSSIP_TRIAL,
                                            **overrides}).build()


def _gossip_log(what, rows, secs, peak, card):
    log(f"gossip {what}: {_warm_rate(secs, 'round')} "
        f"({[round(t, 3) for t in secs]} s a round, audits out); "
        f"train_loss {[r['train_loss'] for r in rows]}, agg_norm "
        f"{[r['agg_norm'] for r in rows]}, consensus_dist "
        f"{[r['consensus_dist'] for r in rows]}, num_partitioned_nodes "
        f"{[r['num_partitioned_nodes'] for r in rows]}, gossip_ici_bytes "
        f"{[r['gossip_ici_bytes'] for r in rows]}, spectral_gap "
        f"{rows[-1]['spectral_gap']:.6f}; peak {peak / 2**30:.2f} GiB "
        f"[{card}]")
    check(all(math.isfinite(r["train_loss"]) and math.isfinite(r["agg_norm"])
              and math.isfinite(r["consensus_dist"]) for r in rows),
          f"gossip {what}: non-finite rows")


def _gossip_launches(rounds, selects_per_round=1):
    want = {k: rounds * GOSSIP_BN_ROUND for k in BN_TPU}
    if selects_per_round:
        want["column_median"] = rounds * selects_per_round
    return want


def _gossip_headline(card):
    """(a) 64 nodes on kregular k = 4 (k1 = 5), Metropolis, ALIE on 16,
    Median: one warm-up round and 3 timed; one ``select:radix`` launch a
    round over the (5, 64 * d) slot-major matrices; the recorder's events
    against ``gossip_round_volumes``."""
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.parallel.comm_model import (
        gossip_round_volumes,
        gossip_wire_bytes,
    )

    _reset_peak()
    algo = _gossip_driver({})
    _cuda.reset_launches()
    rows, secs = _cycles(algo, 1 + GOSSIP_ROUNDS)
    launches, maps = dict(_cuda.LAUNCHES), dict(_cuda.MAPS)
    ev = algo.evaluate()
    peak = _peak()
    rec, d = algo._gossip_recorder, algo._num_params
    vols = gossip_round_volumes(GOSSIP_N, d, (1,))
    model = sorted((v.label, v.kind, v.payload_bytes, k) for v, k in vols)
    check(sorted(rec.ici_events) == model
          and rec.ici_bytes == gossip_wire_bytes(vols) == 0
          and all(r["gossip_ici_bytes"] == 0 for r in rows),
          f"gossip: recorder {rec.ici_events} ({rec.ici_bytes} B) against "
          f"the comm model {model}")
    stacks = {tuple(v.shape[:1]) for v in algo.state.server.params.values()}
    algo.stop()
    rounds = 1 + GOSSIP_ROUNDS
    want = _gossip_launches(rounds)
    check(launches == want
          and maps.get(("column_median", "select:radix")) == rounds
          and stacks == {(GOSSIP_N,)} and math.isfinite(ev["test_acc"]),
          f"gossip headline: launches {launches} by route {maps}, expected "
          f"{want}; stacks {stacks}; test_acc {ev['test_acc']}")
    _gossip_log(f"(a) ResNet-10 x {GOSSIP_N} kregular k=4 metropolis, ALIE "
                f"on {GOSSIP_N // 4}, Median, f32", rows, secs, peak, card)
    log(f"gossip (a): d = {d}, select:radix launches per round "
        f"{launches.get('column_median', 0) / rounds:g} on the (5, "
        f"{GOSSIP_N * d}) "
        f"slot-major view; recorder events {[e[0] for e in rec.ici_events]} "
        f"each on a ring of 1, reconciled with gossip_round_volumes both "
        f"ways, gossip_ici_bytes 0; node 0's test_acc {ev['test_acc']:.4f} "
        f"after {rounds} rounds")
    return launches


class _EclipseAudit:
    """Wraps ``GossipStep._neighborhoods``: every slot of every receiver's
    matrix held, bit for bit, against the row it must hold -- the forged
    row of a malicious sender adjacent to the victim in the victim's
    neighborhood, the sender's clean row everywhere else -- derived from
    the graph and the malicious mask, not from the step's tables.  Set
    aside (:func:`_aside`)."""

    def __init__(self, victim, n, malicious):
        self.victim, self.n, self.mal = victim, n, malicious
        self.calls, self.forged_slots = 0, []

    def __enter__(self):
        from blades_tpu_torch.topology import gossip as G

        self._cls = G.GossipStep
        self._orig = orig = G.GossipStep._neighborhoods
        audit = self

        def wrapped(step, forged, clean, nbr, live):
            mat = orig(step, forged, clean, nbr, live)
            with _aside():
                audit._check(step, mat, forged, clean, nbr)
            audit.calls += 1
            return mat

        G.GossipStep._neighborhoods = wrapped
        return self

    def __exit__(self, *exc):
        self._cls._neighborhoods = self._orig

    def _check(self, step, mat, forged, clean, nbr):
        import numpy as np
        import torch

        adj = step.topo.adjacency()
        dev = mat.device
        hits = 0
        for s in range(mat.shape[0]):
            j = nbr[:, s]
            want = clean.index_select(0, torch.as_tensor(j, device=dev))
            bad = (np.arange(self.n) == self.victim) & adj[j, self.victim] \
                & self.mal[j]
            for i in np.flatnonzero(bad):
                want[i] = forged[j[i]]
                check(not torch.equal(forged[j[i]], clean[j[i]]),
                      f"gossip eclipse: sender {j[i]}'s forged row is its "
                      "clean row")
            hits += int(bad.sum())
            check(torch.equal(mat[s], want),
                  f"gossip eclipse: slot {s} of the neighborhood matrices "
                  "is not the victim-only poisoning")
            del want
        self.forged_slots.append(hits)


def _gossip_eclipse(card):
    """(b) the ring (k1 = 3) under TopologyAttack wrapping ALIE with
    eclipse_target = 0, 2 rounds: only the victim's matrix holds forged
    rows, audited slot by slot."""
    import numpy as np

    from blades_tpu_torch.ops import _cuda

    _reset_peak()
    algo = _gossip_driver({
        "topology_config": {"graph": "ring"},
        "adversary_config": {"type": "TopologyAttack", "base": "ALIE",
                             "eclipse_target": 0}})
    _cuda.reset_launches()
    with _EclipseAudit(0, GOSSIP_N, np.asarray(algo._malicious_host)) as ecl:
        rows, secs = _cycles(algo, 2)
    launches = dict(_cuda.LAUNCHES)
    peak = _peak()
    algo.stop()
    want = _gossip_launches(2)
    check(launches == want and ecl.calls == 2
          and ecl.forged_slots == [1, 1],
          f"gossip eclipse: launches {launches}, expected {want}; "
          f"{ecl.calls} matrices audited, forged slots {ecl.forged_slots}")
    _gossip_log("(b) ring, TopologyAttack(ALIE) eclipsing node 0", rows,
                secs, peak, card)
    log(f"gossip (b): every slot of the {GOSSIP_N} receivers' (3, d) "
        "matrices held bit for bit against the eclipse: node 0's slot of "
        "sender 1 "
        "(malicious, adjacent) forged, every other slot clean, both rounds")
    return launches


def _gossip_multikrum(card):
    """(c) Multikrum on kregular k = 4 with one malicious node (f = 1: the
    breakdown gate refuses f = 2 on k1 = 5), 2 rounds on the batched
    ``k1 x k1`` products; no column select."""
    from blades_tpu_torch.ops import _cuda

    _reset_peak()
    algo = _gossip_driver({"num_malicious_clients": 1, "server_config": {
        "lr": 0.5, "aggregator": {"type": "Multikrum"}}})
    _cuda.reset_launches()
    rows, secs = _cycles(algo, 2)
    launches = dict(_cuda.LAUNCHES)
    peak = _peak()
    algo.stop()
    want = _gossip_launches(2, selects_per_round=0)
    check(launches == want, f"gossip Multikrum: launches {launches}, "
          f"expected {want}")
    _gossip_log("(c) kregular k=4, Multikrum(f=1), ALIE on 1", rows, secs,
                peak, card)
    return launches


def _gossip_dropout(card, work, out_dir):
    """(d) the headline under edge dropout 0.2: the trial through
    ``train.main(["file", ...])`` for 4 rounds, preempted after round 4
    so the flight recorder dumps its ring; 2 rounds in a driver, a
    checkpoint, a fresh driver restored from it and 2 more, equal to the
    trial's rounds 3-4 bit for bit; then ``python -m
    blades_tpu_torch.tools.replay_round`` on the dump in its own process
    and the port's ``validate_metrics`` on the trial's files."""
    import torch

    import blades_tpu_torch
    from blades_tpu_torch import train
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.tools import validate_metrics

    cfg = {**GOSSIP_TRIAL, "fault_config": GOSSIP_DROPOUT}
    path = os.path.join(out_dir, "gossip_dropout.yaml")
    with open(path, "w") as fh:
        json.dump({"gossip_dropout": {"run": "FEDAVG", "stop": {
            "training_iteration": 4}, "config": cfg}}, fh)
    storage = os.path.join(out_dir, "trials")
    _reset_peak()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    a0 = AUDIT["s"]
    rc = train.main(["file", path, "--storage-path", storage,
                     "--preempt-after", "4", "--flightrec-rounds", "4",
                     "--no-cost-analysis"])
    trial_s = time.perf_counter() - t0 - (AUDIT["s"] - a0)
    rows = _rows(storage, "gossip_dropout", 0)
    check(rc == 0 and len(rows) == 4, f"gossip dropout trial: rc {rc}, "
          f"{len(rows)} rows")
    first = _gossip_driver({"fault_config": GOSSIP_DROPOUT})
    _cycles(first, 2)
    first.save_checkpoint(os.path.join(work, "ckpt"))
    first.stop()
    resumed = _gossip_driver({"fault_config": GOSSIP_DROPOUT})
    resumed.load_checkpoint(os.path.join(work, "ckpt"))
    again, secs = _cycles(resumed, 2)
    resumed.stop()
    launches = dict(_cuda.LAUNCHES)
    peak = _peak()
    for a, b in zip(again, rows[2:]):
        for k in ("train_loss", "agg_norm", "update_norm_mean",
                  "consensus_dist", "num_partitioned_nodes"):
            check(a[k] == b[k], f"gossip resume: round "
                  f"{a['training_iteration']} {k} {a[k]!r} vs the straight "
                  f"trial's {b[k]!r}")
    parts = [r["num_partitioned_nodes"] for r in rows]
    check(any(p > 0 for p in parts), f"gossip dropout: partitioned {parts}")
    want = _gossip_launches(8)
    check(launches == want, f"gossip dropout: launches {launches}, "
          f"expected {want}")
    tdir = os.path.join(storage, "gossip_dropout", "gossip_dropout_00000")
    dump = os.path.join(tdir, "flightrec.json")
    torch.cuda.empty_cache()
    port = os.path.dirname(os.path.dirname(os.path.abspath(
        blades_tpu_torch.__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (port, os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    rep = subprocess.run(
        [sys.executable, "-m", "blades_tpu_torch.tools.replay_round", dump],
        cwd=port, env=env, capture_output=True, text=True, timeout=600)
    replay_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "replay.txt"), "w") as fh:
        fh.write(rep.stdout + rep.stderr)
    check(rep.returncode == 0 and "bit-identical" in rep.stdout,
          f"gossip replay: exit {rep.returncode}: {rep.stdout[-2000:]} "
          f"{rep.stderr[-2000:]}")
    valid = [validate_metrics.main([os.path.join(tdir, "metrics.jsonl")]),
             validate_metrics.main(["--flightrec", dump])]
    check(valid == [0, 0], f"gossip validate_metrics: exit codes {valid}")
    _gossip_log("(d) kregular k=4 under edge dropout 0.2, resumed rounds "
                "3-4", again, secs, peak, card)
    log(f"gossip (d): the file trial's 4 rounds in {trial_s:.1f} s "
        f"(audits out), num_partitioned_nodes {parts}; killed after round "
        f"2 and resumed: rounds 3-4 equal to the trial's bit for bit "
        f"(train_loss {[r['train_loss'] for r in again]}); replay_round of "
        f"round {rows[-1]['training_iteration']} exited 0 in {replay_s:.1f} "
        f"s in its own process ({rep.stdout.strip().splitlines()[-1]}); "
        "validate_metrics exited 0 on metrics.jsonl and flightrec.json")
    return launches


def _gossip_ab(card):
    """(e) bench.py's A/B on the card: 32 nodes, the CNN on CIFAR-10
    shapes, centralized dense against ring against kregular, a warm-up
    round each, then 3 rounds each in turns."""
    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda

    base = {**GOSSIP_TRIAL, "global_model": "cnn",
            "dataset_config": {**GOSSIP_TRIAL["dataset_config"],
                               "num_clients": GOSSIP_AB_N},
            "num_malicious_clients": GOSSIP_AB_N // 4}
    _reset_peak()
    algos = {name: FedavgConfig().update_from_dict({**base, **o}).build()
             for name, o in GOSSIP_ARMS}
    _cuda.reset_launches()
    secs = {name: [] for name in algos}
    rows = {name: [] for name in algos}
    for _ in range(1 + GOSSIP_AB_ROUNDS):
        for name, algo in algos.items():
            r, t = _cycles(algo, 1)
            rows[name] += r
            secs[name] += t
    launches = dict(_cuda.LAUNCHES)
    peak = _peak()
    d = algos["ring"]._num_params
    for algo in algos.values():
        algo.stop()
    rounds = 1 + GOSSIP_AB_ROUNDS
    want = {"column_median": len(GOSSIP_ARMS) * rounds}
    check(launches == want, f"gossip A/B: launches {launches}, expected "
          f"{want}")
    rps = {n: GOSSIP_AB_ROUNDS / sum(s[1:]) for n, s in secs.items()}
    for name in algos:
        check(all(math.isfinite(r["train_loss"]) for r in rows[name]),
              f"gossip A/B {name}: non-finite losses")
    log(f"gossip (e) A/B: CNN (d = {d}) x {GOSSIP_AB_N} nodes, ALIE on "
        f"{GOSSIP_AB_N // 4}, Median, rounds/s over rounds 2-{rounds} in "
        f"turns (first rounds "
        f"{ {n: round(s[0], 3) for n, s in secs.items()} } s): "
        + ", ".join(f"{n} {v:.4f}" for n, v in rps.items())
        + f"; spectral_gap ring {rows['ring'][-1]['spectral_gap']:.6f}, "
        f"kregular {rows['kregular'][-1]['spectral_gap']:.6f}; peak "
        f"{peak / 2**30:.2f} GiB [{card}]")
    return launches


def phase_gossip(card):
    """Decentralized gossip through ``FedavgConfig`` -> ``Fedavg.train()``
    and ``train.main``: (a)-(d) at ResNet-10 x 64 nodes, (e) bench.py's
    A/B.  Every select (``select:radix`` over the slot-major matrices of
    all nodes, once a Median round) and every BN launch (per-lane
    parameters, 24 of each kernel a round) is held against the plain
    versions; cuDNN runs deterministic algorithms here, so resumed rounds
    and the replay compare bit for bit."""
    import torch

    torch.cuda.empty_cache()
    work = _work_dir("gossip")
    out_dir = os.path.join(HERE, "chiprun_out", "gossip")
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    resnet = {}
    try:
        with _shared_datasets(), \
                _PathAudit("select", lambda: GOSSIP_KEY["select"]) as sel:
            GOSSIP_KEY["select"] = "column_median:gossip"
            with _BnAudit(key="gossip") as bn_audit:
                for part in (_gossip_headline(card), _gossip_eclipse(card),
                             _gossip_multikrum(card),
                             _gossip_dropout(card, work, out_dir)):
                    for k, v in part.items():
                        resnet[k] = resnet.get(k, 0) + v
            GOSSIP_KEY["select"] = "column_median:gossip-ab"
            ab = _gossip_ab(card)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            saved)
    rounds = (1 + GOSSIP_ROUNDS) + 2 + 2 + 8
    check(resnet == {"column_median": rounds - 2,
                     **{k: rounds * GOSSIP_BN_ROUND for k in BN_TPU}}
          and sel.calls == rounds - 2 + ab["column_median"]
          and bn_audit.calls == 2 * rounds * GOSSIP_BN_ROUND,
          f"gossip: launches {resnet}, {sel.calls} selects and "
          f"{bn_audit.calls} BN launches audited over {rounds} rounds")
    log(f"gossip: selects on {sorted(sel.shapes)}, each bit-exact against "
        f"the plain version; {bn_audit.calls} BN launches with per-lane "
        f"parameters audited (dx bit-exact, sums max err "
        f"{bn_audit.err:.3g}, layouts {len(bn_audit.layouts)}) [{card}]")
    log(f"gossip BN layouts: {_bn_layouts(bn_audit)}")
    counts = {"column_median:gossip": resnet["column_median"],
              "column_median:gossip-ab": ab["column_median"],
              **{f"{k}:gossip": resnet[k] for k in BN_TPU}}
    return counts, {**sel.records, **bn_audit.records(rounds)}


# The lanes phase: trial lanes and client lane-packing through the entry
# points a user calls.  (a) fedavg_dp.yaml's 15 trials (MNIST MLP x 60,
# 5 seeds x 3 epsilons) as one lane group through train.main, beside the
# seed-121 epsilon trials run one by one; (b) a user repeating
# fedavg_cifar10_resnet_noniid.yaml's alpha-0.1 Median / ALIE-on-6 point
# (ResNet-10 x 60, f32) over 4 seeds, laned and one by one in turns;
# (c) the Fashion-MNIST CNN's ALIE point under client_packing "auto", and
# the ResNet-10 point packed by 2, killed after round 1 and resumed
# unpacked.
DP_YAML = os.path.join(TUNED, "fedavg_dp.yaml")
FASHION_YAML = os.path.join(TUNED, "fedavg_fashion_cnn_noniid.yaml")
LANES_ROUNDS = 2
LANES_SEEDS = (121, 122, 123, 124)
LANES_TURNS = 2  # laned / one-by-one turns of (b); the first audited
# BN-backward launches of each kernel per ResNet-10 round of one trial:
# 60 clients in blocks of 50 and 10, 12 BN layers, one local step.
LANES_BN_ROUND = 2 * 12
# A laned trial against its sequential trial: the same operations in the
# same order (cuDNN deterministic here), within f32 rounding of the
# select's laned view (none: order statistics are exact).
LANES_RTOL, LANES_ATOL = 1e-6, 1e-7
# Packed against unpacked: the grouped convolutions reassociate f32 sums;
# the JAX package's RTOL for the same comparison, as rtol and atol.
PACKED_TOL = 1e-4
LANES_KEY = {"select": "column_median:lanes"}


def _lanes_point(packing="off"):
    """fedavg_cifar10_resnet_noniid.yaml's point with alpha 0.1, Median,
    ALIE on 6 of 60 (ResNet-10, f32), as a trial dict."""
    from blades_tpu_torch.tune import load_experiments_from_file

    (_, spec), = load_experiments_from_file(OBS_YAML).items()
    cfg = spec["config"]
    cfg["dataset_config"]["alpha"] = 0.1
    cfg["server_config"]["aggregator"] = {"type": "Median"}
    cfg["num_malicious_clients"] = 6
    cfg["adversary_config"] = {"type": "ALIE"}
    cfg["client_packing"] = packing
    return cfg


def _host_params(params):
    return {k: v.detach().cpu().clone() for k, v in params.items()}


def _params_diff(a, b, rtol, atol):
    """Two parameter dicts: the largest absolute difference, whether every
    leaf is within ``atol + rtol * |b|``, and whether they are equal bit
    for bit."""
    import torch

    err = max(float((a[k] - b[k]).abs().max()) for k in a)
    return (err, all(torch.allclose(a[k], b[k], rtol=rtol, atol=atol)
                     for k in a),
            all(torch.equal(a[k], b[k]) for k in a))


def _rows_close(a, b, rtol, atol, what):
    for ra, rb in zip(a, b):
        for k in ("train_loss", "agg_norm", "update_norm_mean"):
            check(math.isfinite(ra[k]) and abs(ra[k] - rb[k])
                  <= atol + rtol * abs(rb[k]),
                  f"{what}: round {ra['training_iteration']} {k} {ra[k]} "
                  f"against {rb[k]}")


def _lanes_dp(card, work):
    """(a) ``train.main(["file", fedavg_dp.yaml, "--max-rounds", "2"])``:
    every trial in one lane group of 15; then the three epsilon trials of
    seed 121 with ``--no-lanes``; in turns.  Their rows equal the laned
    rows within ``LANES_RTOL``."""
    from blades_tpu_torch import train, tune
    from blades_tpu_torch.tune import load_experiments_from_file

    (name, _), = load_experiments_from_file(DP_YAML).items()
    with open(DP_YAML) as fh:
        text = fh.read()
    grid = "grid_search: [121, 122, 123, 124, 125]"
    check(text.count(grid) == 1, f"{DP_YAML}: no seed grid {grid!r}")
    one_seed = os.path.join(work, "fedavg_dp_seed121.yaml")
    with open(one_seed, "w") as fh:
        fh.write(text.replace("seed:\n        " + grid, "seed: 121"))
    got = []
    real = tune.run_experiments

    def spy(experiments, **kw):
        got.append(real(experiments, **kw))
        return got[-1]

    tune.run_experiments = spy
    rates = {"laned": [], "one by one": []}
    try:
        for turn in range(LANES_TURNS):
            for how, path, flags in (("laned", DP_YAML, []),
                                     ("one by one", one_seed,
                                      ["--no-lanes"])):
                storage = os.path.join(work, f"dp_{turn}_{len(flags)}")
                t0 = time.perf_counter()
                rc = train.main(["file", path, "--max-rounds",
                                 str(LANES_ROUNDS), "--storage-path",
                                 storage, "--no-cost-analysis"] + flags)
                wall = time.perf_counter() - t0
                summ = got[-1]
                want = 15 if how == "laned" else 3
                check(rc == 0 and len(summ) == want and all(
                    s.get("lanes") == (15 if how == "laned" else None)
                    and "status" not in s for s in summ),
                    f"lanes (a) {how}: rc {rc}, summaries "
                    f"{[(s['trial'], s.get('lanes')) for s in summ]}")
                # The whole command's seconds, set-up included on both
                # sides (a laned group builds its datasets inside its
                # span, a sequential trial before its own).
                rates[how].append(want * LANES_ROUNDS / wall)
                if how == "laned":
                    laned = [_rows(storage, name, i) for i in range(3)]
                else:
                    for i in range(3):
                        rows = _rows(storage, name, i)
                        check(len(rows) == LANES_ROUNDS
                              and laned[i][0]["seed"] == 121,
                              f"lanes (a): trial {i} rows")
                        _rows_close(laned[i], rows, LANES_RTOL, LANES_ATOL,
                                    f"lanes (a) epsilon trial {i}")
    finally:
        tune.run_experiments = real
    log(f"lanes (a) fedavg_dp.yaml (MLP x 60, Mean, DP): 15 trials as one "
        f"lane group, trials x rounds / s of the command "
        f"{[round(r, 3) for r in rates['laned']]}; seed 121's 3 epsilon "
        f"trials one by one {[round(r, 3) for r in rates['one by one']]} "
        f"(turns); their rows equal the laned rows within rtol "
        f"{LANES_RTOL} [{card}]")
    return rates


def _lanes_resnet(card, bn_audit):
    """(b) the ResNet-10 point over 4 seeds as one lane group (``run_lanes``)
    and as 4 sequential trials (``Fedavg.train()``), in turns: the laned
    trials' rows and parameters equal the sequential trials' within
    ``LANES_RTOL``; one ``select:radix`` launch a round over the (60, 4 *
    d) view.  The first turn runs under the audits (``bn_audit`` the laned
    BN launches); returns the launches of each part and the rates."""
    import copy

    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.obs.trace import Timers
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.tune.lanes import run_lanes

    point = _lanes_point()
    n = point["dataset_config"]["num_clients"]

    def builder():
        return FedavgConfig().update_from_dict(copy.deepcopy(point))

    overrides = [{"seed": s} for s in LANES_SEEDS]
    lanes_n = len(LANES_SEEDS)
    launches = {"lanes": {}, "seq": {}}
    rates = {"laned": [], "one by one": []}
    for turn in range(LANES_TURNS):
        LANES_KEY["select"] = "column_median:lanes"
        _reset_peak()
        _cuda.reset_launches()
        tracer = Timers(sync=True)
        a0 = AUDIT["s"]
        ctx = bn_audit if turn == 0 else contextlib.nullcontext()
        with ctx:
            rows, states = run_lanes(builder, overrides, LANES_ROUNDS,
                                     tracer=tracer, return_states=True)
        summ = tracer.summary()
        laned_s = (sum(summ[k]["total_s"] for k in ("compile", "round")
                       if k in summ) - (AUDIT["s"] - a0))
        peak = _peak()
        if turn == 0:
            launches["lanes"] = dict(_cuda.LAUNCHES)
            maps = dict(_cuda.MAPS)
        laned = [_host_params(st.server.params) for st in states]
        d = sum(v.numel() for v in laned[0].values())
        del states
        torch.cuda.empty_cache()
        LANES_KEY["select"] = "column_median:lanes-seq"
        seq_s, errs = 0.0, []
        _cuda.reset_launches()
        with _BnAudit() if turn == 0 else contextlib.nullcontext():
            for i, seed in enumerate(LANES_SEEDS):
                cfg = builder()
                cfg.seed = seed
                algo = cfg.build()
                seq_rows, secs = _cycles(algo, LANES_ROUNDS)
                seq_s += sum(secs)
                _rows_close(rows[i], seq_rows, LANES_RTOL, LANES_ATOL,
                            f"lanes (b) seed {seed}")
                err, ok, exact = _params_diff(
                    laned[i], _host_params(algo.state.server.params),
                    LANES_RTOL, LANES_ATOL)
                check(ok, f"lanes (b) seed {seed}: laned parameters "
                      f"{err:.3g} from the sequential trial's")
                errs.append((err, exact))
                algo.stop()
        if turn == 0:
            launches["seq"] = dict(_cuda.LAUNCHES)
        rates["laned"].append(LANES_ROUNDS * lanes_n / laned_s)
        rates["one by one"].append(LANES_ROUNDS * lanes_n / seq_s)
        log(f"lanes (b) turn {turn + 1}: {lanes_n} seeds laned "
            f"{rates['laned'][-1]:.4f} rounds x lanes / s ({laned_s:.3f} s "
            f"of rounds, audits out), one by one "
            f"{rates['one by one'][-1]:.4f} ({seq_s:.3f} s); laned "
            f"parameters against the sequential trials' max abs diff "
            f"{[e for e, _ in errs]} (bit for bit: "
            f"{[x for _, x in errs]}); train_loss "
            f"{[r[-1]['train_loss'] for r in rows]}; peak "
            f"{peak / 2**30:.2f} GiB (the laned matrix ({n}, {lanes_n}, "
            f"{d}) f32 alone {n * lanes_n * d * 4 / 2**30:.2f} GiB) [{card}]")
    want_l = {"column_median": LANES_ROUNDS,
              **{k: LANES_ROUNDS * lanes_n * LANES_BN_ROUND for k in BN_TPU}}
    want_s = {"column_median": LANES_ROUNDS * lanes_n,
              **{k: LANES_ROUNDS * lanes_n * LANES_BN_ROUND for k in BN_TPU}}
    check(launches["lanes"] == want_l and launches["seq"] == want_s
          and maps.get(("column_median", "select:radix")) == LANES_ROUNDS,
          f"lanes (b): laned launches {launches['lanes']} by route {maps}, "
          f"expected {want_l}; one by one {launches['seq']}, expected "
          f"{want_s}")
    return launches, rates


def _lanes_packed_cnn(card):
    """(c) fedavg_fashion_cnn_noniid.yaml's ALIE point, 6 malicious, under
    ``client_packing: auto``: it packs 2 and stamps ``pack_factor`` 2;
    its parameters after 2 rounds match the unpacked run's within
    ``PACKED_TOL``."""
    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.tune import load_experiments_from_file

    (_, spec), = load_experiments_from_file(FASHION_YAML).items()
    cfg = spec["config"]
    cfg["num_malicious_clients"] = 6
    cfg["adversary_config"] = {"type": "ALIE"}
    n = cfg["dataset_config"]["num_clients"]
    out = {}
    for packing in ("auto", "off"):
        algo = FedavgConfig().update_from_dict(
            {**cfg, "client_packing": packing}).build()
        rows, secs = _cycles(algo, LANES_ROUNDS)
        out[packing] = (rows, secs, _host_params(algo.state.server.params),
                        algo.packing_summary)
        algo.stop()
    rows, secs, params, dec = out["auto"]
    check(dec == {"requested": "auto", "pack_factor": 2,
                  "packed_lanes": n // 2, "fallback": None}
          and all(r.get("pack_factor") == 2 and r.get("packed_lanes")
                  == n // 2 for r in rows),
          f"lanes (c) CNN auto: decision {dec}, rows "
          f"{[(r.get('pack_factor'), r.get('packed_lanes')) for r in rows]}")
    err, ok, _ = _params_diff(params, out["off"][2], PACKED_TOL, PACKED_TOL)
    check(ok, f"lanes (c) CNN: packed parameters {err:.3g} from the "
          "unpacked run's")
    _rows_close(rows, out["off"][0], PACKED_TOL, PACKED_TOL, "lanes (c) CNN")
    log(f"lanes (c) Fashion-MNIST CNN x {n}, Signguard, ALIE on 6, "
        f"client_packing auto: pack_factor 2, {_warm_rate(secs, 'round')}; "
        f"unpacked {_warm_rate(out['off'][1], 'round')}; parameters after "
        f"{LANES_ROUNDS} rounds max abs diff {err:.3g} [{card}]")


def _lanes_packed_resnet(card, work, bn_audit):
    """(c) the ResNet-10 point (one seed) packed by 2: 2 straight rounds,
    and a run killed after round 1 (its checkpoint) resumed unpacked,
    equal to the straight run within ``PACKED_TOL``; the packed rounds'
    BN launches audited by ``bn_audit`` on the packed layout."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda

    LANES_KEY["select"] = "column_median:packed"
    point = _lanes_point(packing=2)
    _cuda.reset_launches()
    _reset_peak()
    with bn_audit:
        algo = FedavgConfig().update_from_dict(point).build()
        rows, secs = _cycles(algo, LANES_ROUNDS)
        straight = _host_params(algo.state.server.params)
        peak = _peak()
        algo.stop()
        killed = FedavgConfig().update_from_dict(point).build()
        _cycles(killed, 1)
        ckpt = killed.save_checkpoint(os.path.join(work, "packed_ckpt"))
        killed.stop()
    launches = dict(_cuda.LAUNCHES)
    rounds = LANES_ROUNDS + 1
    want = {"column_median": rounds,
            **{k: rounds * LANES_BN_ROUND for k in BN_TPU}}
    check(launches == want and all(r.get("pack_factor") == 2 for r in rows),
          f"lanes (c) packed ResNet: launches {launches}, expected {want}; "
          f"rows {[r.get('pack_factor') for r in rows]}")
    LANES_KEY["select"] = "column_median:lanes-seq"
    with _BnAudit():
        resumed = FedavgConfig().update_from_dict(
            {**point, "client_packing": "off"}).build()
        resumed.load_checkpoint(ckpt)
        rrows, _ = _cycles(resumed, LANES_ROUNDS - 1)
        err, ok, _ = _params_diff(_host_params(resumed.state.server.params),
                                  straight, PACKED_TOL, PACKED_TOL)
        resumed.stop()
    torch.cuda.empty_cache()
    check(ok and "pack_factor" not in rrows[-1],
          f"lanes (c) packed ResNet resumed unpacked: parameters {err:.3g} "
          "from the straight packed run's")
    _rows_close(rrows, rows[1:], PACKED_TOL, PACKED_TOL,
                "lanes (c) resumed unpacked")
    log(f"lanes (c) ResNet-10 x {point['dataset_config']['num_clients']} "
        f"Median ALIE on 6 packed by 2: "
        f"{_warm_rate(secs, 'round')}; killed after round 1, resumed "
        f"unpacked: parameters after round {LANES_ROUNDS} max abs diff "
        f"{err:.3g} from the straight packed run; peak {peak / 2**30:.2f} "
        f"GiB [{card}]")
    return launches, rounds


def phase_lanes(card):
    """Trial lanes and client lane-packing, (a)-(c) above.  Every select
    (``select:radix``, once a round over the laned (60, 4 * d) view on the
    laned path) and every BN launch (the laned trials' own blocks; the
    packed layout's 2 * C channels) is held against the plain versions.
    cuDNN runs deterministic algorithms here, so a laned trial compares
    with its sequential trial at ``LANES_RTOL``."""
    import torch

    torch.cuda.empty_cache()
    work = _work_dir("lanes")
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    bn_lanes, bn_packed = _BnAudit(key="lanes"), _BnAudit(key="packed")
    try:
        dp_rates = _lanes_dp(card, work)
        with _shared_datasets(), \
                _PathAudit("select", lambda: LANES_KEY["select"]) as sel:
            resnet, rates = _lanes_resnet(card, bn_lanes)
            packed, packed_rounds = _lanes_packed_resnet(card, work,
                                                         bn_packed)
            _lanes_packed_cnn(card)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            saved)
    counts = {"column_median:lanes": resnet["lanes"].get("column_median", 0),
              "column_median:lanes-seq": resnet["seq"].get("column_median",
                                                           0),
              "column_median:packed": packed.get("column_median", 0),
              **{f"{k}:lanes": resnet["lanes"].get(k, 0) for k in BN_TPU},
              **{f"{k}:packed": packed.get(k, 0) for k in BN_TPU}}
    check(bn_lanes.calls == 2 * counts["bn_bwd_reduce:lanes"]
          and bn_packed.calls == 2 * counts["bn_bwd_reduce:packed"],
          f"lanes: BN launches audited {bn_lanes.calls} / {bn_packed.calls}"
          f" for launches {counts}")
    log(f"lanes: selects on {sorted(sel.shapes)} ({sel.calls} audited, "
        f"each bit-exact against the plain version); BN launches audited "
        f"laned {bn_lanes.calls}, packed {bn_packed.calls} (dx bit-exact, "
        f"sums max err {max(bn_lanes.err, bn_packed.err):.3g}) [{card}]")
    log(f"lanes BN layouts: laned {_bn_layouts(bn_lanes)}; packed "
        f"{_bn_layouts(bn_packed)}")
    log(f"lanes summary: (a) trials x rounds / s laned "
        f"{[round(r, 3) for r in dp_rates['laned']]}, one by one "
        f"{[round(r, 3) for r in dp_rates['one by one']]}; (b) rounds x "
        f"lanes / s laned {[round(r, 4) for r in rates['laned']]}, one by "
        f"one {[round(r, 4) for r in rates['one by one']]} [{card}]")
    records = dict(sel.records)
    records.update(bn_lanes.records(LANES_ROUNDS))
    records.update(bn_packed.records(packed_rounds))
    return counts, records


# ---------------------------------------------------------------------------
# the execution autotuner
# ---------------------------------------------------------------------------

AUTOTUNE_ROUNDS = 2  # rounds of each untuned / winner run held bit for bit
# Timed train() calls per candidate, after one warm-up call: one (the
# autotuner's default is the median of 3), within the script's time limit.
# With evaluations every third round the timed call (round 2) is a
# training round.
AUTOTUNE_REPS = 1
AUTOTUNE_HEADLINE = {**STREAMED_TRIAL, "evaluation_interval": 3}
# (b): a repo model at full width whose round takes the chunked finish,
# the one route that reads d_chunk: the Fashion-MNIST CNN (1,475,146
# parameters) at 5,000 f32 clients, 100 of them ALIE (elided), so 4,900 or
# more f32 rows reach the finish, above the fused kernel's 4,874.
LADDER_TRIAL = {
    "dataset_config": {"type": "fashionmnist", "num_clients": 5000,
                       "iid": True, "train_bs": 32, "seed": 122},
    "global_model": "cnn", "execution": "streamed", "client_block": 100,
    "update_dtype": "float32",
    "num_malicious_clients": 100, "adversary_config": {"type": "ALIE"},
    "server_config": {"lr": 0.5, "aggregator": {"type": "Median"}},
    "client_config": {"lr": 0.01, "num_batch_per_round": 1},
    "evaluation_interval": 0,
}
LADDER_ROUNDS = 1
# (c): the dense ResNet-10 x 60 trial under ALIE, autotuned through the
# `file` entry point for 3 rounds, preempted after round 2 (checkpoint 1
# on disk) and resumed.
AUTOTUNE_DENSE = {**DENSE_TRIAL, "adversary_config": {"type": "ALIE"},
                  "evaluation_interval": 3}


def _at_run(overrides, rounds, cost=False):
    """Build a driver from ``overrides``, run ``rounds`` rounds and return
    its host parameters, rows, plan, provenance, the candidates' peak
    memory, the run's finish routes and launch counts (set to 0 after the
    build, whose candidates launch too), its peak memory and, with
    ``cost``, ``cost_analysis()``."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    algo = FedavgConfig().update_from_dict(overrides).build()
    build_s = time.perf_counter() - t0
    # The candidates' launches (during the build) are not the run's.
    _cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        rows = [algo.train() for _ in range(rounds)]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        out = {"params": {k: v.detach().cpu() for k, v in
                          algo.state.server.params.items()},
               "rows": rows, "plan": algo.plan, "prov": algo.plan_summary,
               "peaks": dict(getattr(algo, "candidate_peaks", {}) or {}),
               "routes": dict(getattr(algo._step, "routes", {}) or {}),
               "launches": dict(_cuda.LAUNCHES), "build_s": build_s,
               "run_s": run_s,
               "prefetched": getattr(algo, "_prefetcher", None) is not None,
               "peak": torch.cuda.max_memory_allocated()}
        if cost:
            t0 = time.perf_counter()
            out["cost"] = algo.cost_analysis()
            out["cost_s"] = time.perf_counter() - t0
            out["cost_by_op"] = dict(getattr(algo, "cost_by_op", {}))
    finally:
        algo.stop()
    return out


def _same_params(a, b, what):
    import torch

    diff = [k for k in a if not torch.equal(a[k], b[k])]
    check(a.keys() == b.keys() and not diff,
          f"{what}: parameters differ from the untuned run's at {diff[:4]}")


def _at_candidates(what, prov, peaks):
    """Log the plan space, each candidate's median and peak, the winner."""
    for c in prov["candidates"]:
        med = c["median_s"]
        peak = peaks.get(c["plan_id"])
        log(f"{what}: candidate {c['rank']} {c['plan_id']} ({c['tier']}) "
            f"median {'failed' if med is None else f'{med:.4f} s'} a round"
            + ("" if peak is None else f", peak {peak / 2**30:.2f} GiB"))
    log(f"{what}: winner {prov['winner_id']} (mode {prov['mode']}, "
        f"{len(prov['candidates'])} candidates, truncated "
        f"{prov['truncated']})")


def _autotune_headline(card, plans):
    """(a) the headline streamed round, default tier."""
    from blades_tpu_torch.perf import autotune as at
    from blades_tpu_torch.tools import show_plan

    base = _at_run(AUTOTUNE_HEADLINE, AUTOTUNE_ROUNDS)
    tuned_cfg = {**AUTOTUNE_HEADLINE, "autotune": True,
                 "autotune_cache_dir": plans}
    tuned = _at_run(tuned_cfg, AUTOTUNE_ROUNDS, cost=True)
    prov = tuned["prov"]
    check(prov["mode"] == "measured" and prov["timed"]
          and tuned["plan"].tier == "default"
          and all(c["median_s"] is not None for c in prov["candidates"]),
          f"autotune (a): provenance {prov}")
    _at_candidates(f"autotune (a) ResNet-10 x 1000 ALIE Median [{card}]",
                   prov, tuned["peaks"])
    check(tuned["launches"].get("fused_finish_compact") == AUTOTUNE_ROUNDS,
          f"autotune (a): the winner's launches {tuned['launches']}")
    _same_params(tuned["params"], base["params"], "autotune (a) winner")
    check([r["train_loss"] for r in tuned["rows"]]
          == [r["train_loss"] for r in base["rows"]],
          "autotune (a): the winner's losses differ from the untuned run's")
    log(f"autotune (a): the winner's {AUTOTUNE_ROUNDS} rounds equal the "
        f"untuned run's bit for bit; winner run {tuned['run_s']:.3f} s, "
        f"build (candidates timed) {tuned['build_s']:.1f} s, peak "
        f"{tuned['peak'] / 2**30:.2f} GiB, untuned peak "
        f"{base['peak'] / 2**30:.2f} GiB")
    cost = tuned["cost"]
    check(cost is not None and cost["flops"] > 0
          and cost["bytes_accessed"] > 0, f"autotune (d): cost {cost}")
    top = sorted(tuned["cost_by_op"].items(), key=lambda kv: -kv[1])[:6]
    log(f"autotune (d): cost_analysis() of one headline dispatch: "
        f"{cost['flops']:.6g} flops, {cost['bytes_accessed']:.6g} bytes "
        f"(counted in {tuned['cost_s']:.1f} s); flops by op {top}")
    timed = []
    real = at.timed_measure_fn

    def counting(*a, **kw):
        measure = real(*a, **kw)

        def m(plan):
            timed.append(plan.plan_id)
            return measure(plan)

        return m

    at.timed_measure_fn = counting
    try:
        again = _at_run(tuned_cfg, 0)
    finally:
        at.timed_measure_fn = real
    check(again["prov"]["mode"] == "cache" and again["prov"]["cache_hit"]
          and not timed and again["plan"] == tuned["plan"],
          f"autotune (a): second build {again['prov']['mode']}, "
          f"{len(timed)} candidates timed")
    log(f"autotune (a): the second build is served from the plan cache "
        f"(cache_hit true, no candidate timed, build "
        f"{again['build_s']:.1f} s)")
    buf = __import__("io").StringIO()
    with contextlib.redirect_stdout(buf):
        rc = show_plan.main(["--cache-dir", plans, "list"])
    for line in buf.getvalue().splitlines():
        log(f"autotune (a) show_plan: {line}")
    check(rc == 0 and tuned["plan"].plan_id in buf.getvalue(),
          "autotune (a): show_plan list")


def _autotune_ladder(card, plans):
    """(b) the d_chunk ladder on the chunked finish."""
    from blades_tpu_torch.perf.autotune import D_CHUNK_LADDER, Plan

    base = _at_run(LADDER_TRIAL, LADDER_ROUNDS)
    check(base["routes"] == {"chunked": LADDER_ROUNDS}
          and base["launches"].get("column_median", 0) > 0,
          f"autotune (b): untuned routes {base['routes']}, launches "
          f"{base['launches']}")
    tuned = _at_run({**LADDER_TRIAL, "autotune": True,
                     "autotune_cache_dir": plans}, 0)
    prov = tuned["prov"]
    ladder = [Plan(execution="streamed", d_chunk=c) for c in
              (LADDER_TRIAL.get("d_chunk", 1 << 17),
               *[c for c in D_CHUNK_LADDER if c != 1 << 17])]
    check([c["plan_id"] for c in prov["candidates"]]
          == [p.plan_id for p in ladder] and prov["timed"],
          f"autotune (b): candidates {prov['candidates']}")
    _at_candidates(f"autotune (b) CNN x 5000 f32 ALIE Median [{card}]",
                   prov, tuned["peaks"])
    # The first rung is the untuned run's own plan: the other rungs are
    # replayed pinned and held against it.
    for plan in ladder[1:]:
        got = _at_run({**LADDER_TRIAL, "autotune": True,
                       "tuned_plan": plan.as_dict(),
                       "autotune_cache_dir": plans}, LADDER_ROUNDS)
        check(got["routes"] == {"chunked": LADDER_ROUNDS},
              f"autotune (b) {plan.plan_id}: routes {got['routes']}")
        _same_params(got["params"], base["params"],
                     f"autotune (b) {plan.plan_id}")
        keys = ("train_loss", "agg_norm", "update_norm_mean")
        check([[r[k] for k in keys] for r in got["rows"]]
              == [[r[k] for k in keys] for r in base["rows"]],
              f"autotune (b) {plan.plan_id}: rows differ from the untuned "
              f"run's")
        log(f"autotune (b): {plan.plan_id} equals the untuned run bit for "
            f"bit, parameters and rows "
            f"({got['launches'].get('column_median', 0)} selects, "
            f"round {got['run_s']:.3f} s, peak {got['peak'] / 2**30:.2f} GiB)")


# An odd row count; the ladder trial above runs at 5,000 rows.
LADDER_GRID_ROWS = (1237,)


def _ladder_finish_grid(card):
    """(b), the finish alone: the chunked finish on random (rows, d_alloc)
    f32 buffers at the CNN's width, 100 malicious rows, at each of
    ``LADDER_GRID_ROWS``, for Median / Trimmedmean / Mean x ALIE / IPM at
    each ``d_chunk`` of the ladder: the server's parameters and the row
    metrics equal across the ladder bit for bit."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.parallel.streamed import streamed_step
    from blades_tpu_torch.perf.autotune import D_CHUNK_LADDER
    from blades_tpu_torch.utils.tree import FlatLayout

    f = LADDER_TRIAL["num_malicious_clients"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    t0 = time.perf_counter()
    done = []
    metric_keys = ("update_norm_mean", "agg_norm", "train_loss")
    for n in LADDER_GRID_ROWS:
        mal = torch.zeros((n,), dtype=torch.bool, device="cuda")
        mal[:f] = True
        losses = torch.rand((n,), generator=gen, device="cuda")
        buf = None
        for agg in ("Median", "Trimmedmean", "Mean"):
            for forge in ("ALIE", "IPM"):
                cfg = FedavgConfig().update_from_dict(
                    {**LADDER_TRIAL, "adversary_config": {"type": forge},
                     "server_config": {"lr": 0.5,
                                       "aggregator": {"type": agg}}})
                cfg.validate()
                fr = cfg.get_fed_round()
                state = fr.init(0, n, device="cuda")
                d = FlatLayout(state.server.params).d
                if buf is None:
                    buf = torch.randn((n, -(-d // 512) * 512), generator=gen,
                                      device="cuda") * 0.01
                outs, rows = [], []
                for c in D_CHUNK_LADDER:
                    step = streamed_step(fr, client_block=100,
                                         update_dtype=torch.float32,
                                         malicious_prefix=f, d_chunk=c,
                                         device="cuda")
                    server, metrics = step.finish(state.server, buf, mal,
                                                  losses, d=d)
                    outs.append({k: v.detach().cpu() for k, v in
                                 server.params.items()})
                    rows.append([float(metrics[k]) for k in metric_keys])
                for c, out, row in zip(D_CHUNK_LADDER[1:], outs[1:],
                                       rows[1:]):
                    what = (f"autotune (b) finish {n} rows {agg} {forge} "
                            f"d_chunk {c} vs {D_CHUNK_LADDER[0]}")
                    _same_params(out, outs[0], what)
                    check(row == rows[0], f"{what}: {metric_keys} {row} "
                          f"against {rows[0]}")
                done.append(f"{agg}/{forge}")
        del buf
        torch.cuda.empty_cache()
    log(f"autotune (b): the chunked finish on (rows, d_alloc) f32 buffers, "
        f"rows {list(LADDER_GRID_ROWS)}, equals itself bit for bit across "
        f"d_chunk {list(D_CHUNK_LADDER)} (parameters and {metric_keys}) for "
        f"{sorted(set(done))} ({time.perf_counter() - t0:.1f} s) [{card}]")


def _autotune_dense(card, work, plans):
    """(c) the dense trial through ``file --autotune reassociating``,
    preempted after round 2 and resumed from checkpoint 1 under the plan
    it recorded."""
    import torch

    from blades_tpu_torch import train, tune
    from blades_tpu_torch.perf.autotune import Plan

    path = os.path.join(work, "autotune_dense.yaml")
    with open(path, "w") as fh:
        json.dump({"at_dense": {"run": "FEDAVG",
                                "stop": {"training_iteration": 3},
                                "config": AUTOTUNE_DENSE}}, fh)
    storage = os.path.join(work, "dense")
    got = []
    real = tune.run_experiments

    def spy(experiments, **kw):
        got.append(real(experiments, **kw))
        return got[-1]

    flags = ["--storage-path", storage, "--autotune", "reassociating",
             "--plan-cache-dir", plans, "--checkpoint-freq", "1",
             "--no-cost-analysis"]
    tune.run_experiments = spy
    try:
        rc = train.main(["file", path, "--preempt-after", "2"] + flags)
        (first,) = got[-1]
        rc2 = train.main(["file", path, "--resume"] + flags)
        (second,) = got[-1]
    finally:
        tune.run_experiments = real
    prov = first["autotune"]
    ids = [c["plan_id"] for c in prov["candidates"]]
    check(rc == 0 and first.get("status") == "ERROR" and prov["timed"]
          and any(i.startswith("streamed|") for i in ids)
          and any("|p2|" in i for i in ids)
          and any(i.startswith("dense|") and "|p1|" in i for i in ids),
          f"autotune (c): rc {rc}, first run {first.get('status')}, "
          f"candidates {ids}")
    _at_candidates(f"autotune (c) ResNet-10 x 60 ALIE Median reassociating "
                   f"[{card}]", prov, {})
    tdir = os.path.join(storage, "at_dense", "at_dense_00000")
    saved = torch.load(os.path.join(tdir, "ckpt_000001",
                                    "algorithm_state.pkl"),
                       map_location="cpu", weights_only=False)["plan"]
    rows = _rows(storage, "at_dense", 0)
    pid = Plan.from_dict(saved).plan_id
    check(rc2 == 0 and "status" not in second
          and second["autotune"]["mode"] == "pinned"
          and second["autotune"]["winner"] == saved
          and pid == prov["winner_id"] and len(rows) == 3
          and all(r["plan_id"] == pid for r in rows)
          and all(math.isfinite(r["train_loss"]) for r in rows),
          f"autotune (c): resumed {second.get('autotune')}, rows "
          f"{[(r['training_iteration'], r.get('plan_id')) for r in rows]}")
    log(f"autotune (c): the resumed trial pinned the checkpoint's plan "
        f"{pid}; rows {[r['train_loss'] for r in rows]}, test_acc "
        f"{rows[-1].get('test_acc')}")


def _default_tier_dense(card, work):
    """The default tier's other knobs on the card: the dense ResNet-10 x 60
    trial with batch prefetch on and off, and through ``file`` with a scan
    window (3 rounds a dispatch) and with ``--scan-window 1``; each pair
    bit for bit."""
    from blades_tpu_torch.tune import run_experiments

    runs = {p: _at_run({**AUTOTUNE_DENSE, "prefetch": p}, AUTOTUNE_ROUNDS)
            for p in ("on", "off")}
    check(runs["on"]["prefetched"] and not runs["off"]["prefetched"],
          "autotune (e): the prefetch knob did not steer the dense pipeline")
    _same_params(runs["on"]["params"], runs["off"]["params"],
                 "autotune (e) prefetch on vs off")
    keys = ("train_loss", "agg_norm", "update_norm_mean")
    check([[r[k] for k in keys] for r in runs["on"]["rows"]]
          == [[r[k] for k in keys] for r in runs["off"]["rows"]],
          "autotune (e): prefetch on and off rows differ")
    log(f"autotune (e) ResNet-10 x 60 dense: prefetch on and off equal bit "
        f"for bit over {AUTOTUNE_ROUNDS} rounds (parameters, {keys}); "
        f"runs {runs['on']['run_s']:.3f} / {runs['off']['run_s']:.3f} s, "
        f"peaks {runs['on']['peak'] / 2**30:.2f} / "
        f"{runs['off']['peak'] / 2**30:.2f} GiB [{card}]")
    rounds = AUTOTUNE_DENSE["evaluation_interval"]
    exp = {"at_window": {"run": "FEDAVG",
                         "stop": {"training_iteration": rounds},
                         "config": AUTOTUNE_DENSE}}
    rows, windows, took = {}, {}, {}
    for w in (1, "auto"):
        storage = os.path.join(work, f"window_{w}")
        t0 = time.perf_counter()
        (summary,) = run_experiments(exp, storage_path=storage, verbose=0,
                                     scan_window=w, cost_analysis=False)
        took[w] = time.perf_counter() - t0
        windows[w] = summary.get("scan_window")
        rows[w] = _rows(storage, "at_window", 0)
    check(windows == {1: None, "auto": rounds},
          f"autotune (e): scan windows {windows}")
    keys = [k for k in ("train_loss", "agg_norm", "update_norm_mean",
                        "test_acc", "test_loss") if k in rows[1][-1]]
    got = {w: [[r.get(k) for k in keys] for r in rows[w]] for w in rows}
    check(len(rows[1]) == rounds and got["auto"] == got[1]
          and all(math.isfinite(r["train_loss"]) for r in rows[1]),
          f"autotune (e): windowed rows {got['auto']} against {got[1]}")
    log(f"autotune (e) ResNet-10 x 60 dense through file: a {rounds}-round "
        f"scan window's rows equal --scan-window 1's bit for bit ({keys}); "
        f"{took['auto']:.1f} s against {took[1]:.1f} s of sweep [{card}]")


def _autotune_curves(card, work):
    """(d) a 2-round accuracy-curve grid and a 2-round gossip-curve run on
    the synthetic fallback."""
    from blades_tpu_torch.benchmarks import accuracy_curves
    from blades_tpu_torch.tools import gossip_curves

    out = os.path.join(work, "curves")
    rc = accuracy_curves.main(
        ["--dataset", "mnist", "--rounds", "2", "--num-clients", "10",
         "--aggregators", "Mean", "Median", "--malicious", "0", "2",
         "--rounds-per-dispatch", "1", "--out", out])
    with open(os.path.join(out, "curves.json")) as fh:
        table = json.load(fh)
    check(rc == 0 and len(table["rows"]) == 4
          and all(math.isfinite(r["final_test_acc"]) for r in table["rows"]),
          f"autotune (d): accuracy curves rc {rc}, table {table}")
    log(f"autotune (d): accuracy_curves {table['source']}: "
        f"{[(r['aggregator'], r['num_malicious'], r['final_test_acc']) for r in table['rows']]}"
        f"; curves.png {'written' if os.path.exists(os.path.join(out, 'curves.png')) else 'not written'}")
    path = os.path.join(work, "gossip", "curves.json")
    rc = gossip_curves.main(["--rounds", "2", "--graphs", "ring",
                             "--out", path])
    with open(path) as fh:
        table = json.load(fh)
    check(rc == 0 and len(table["rows"]) == 4,
          f"autotune (d): gossip curves rc {rc}")
    log(f"autotune (d): gossip_curves "
        f"{[(r['path'], r['num_malicious'], r['final_test_acc']) for r in table['rows']]} "
        f"[{card}]")


def phase_autotune(card):
    """The execution autotuner, (a)-(e) above.  cuDNN runs deterministic
    algorithms here, so a winner's or a candidate's rounds compare with
    the untuned run's bit for bit."""
    import torch

    from blades_tpu_torch.perf import autotune as at

    torch.cuda.empty_cache()
    work = _work_dir("autotune")
    plans = os.path.join(work, "plans")
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    real = at.timed_measure_fn
    at.timed_measure_fn = functools.partial(real, reps=AUTOTUNE_REPS)
    took = []

    def part(name, fn, *a):
        t0 = time.perf_counter()
        fn(*a)
        torch.cuda.empty_cache()
        took.append(f"{name} {time.perf_counter() - t0:.1f}")

    try:
        with _shared_datasets():
            part("(a)", _autotune_headline, card, plans)
            part("(b)", _autotune_ladder, card, plans)
            part("(b) grid", _ladder_finish_grid, card)
            part("(c)", _autotune_dense, card, work, plans)
            part("(e)", _default_tier_dense, card, work)
        part("(d)", _autotune_curves, card, work)
    finally:
        at.timed_measure_fn = real
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            saved)
    log(f"autotune: seconds by part {', '.join(took)}; each candidate timed "
        f"on {AUTOTUNE_REPS} train() call after a warm-up")
    return {}, {}


# The mesh phase: the rounds on the ranks of a torch.distributed group, one
# process a rank, every rank on cuda:0 (the machine has one card, and NCCL
# takes one rank a card, so the multi-rank groups run over gloo, which
# stages each collective through the host).  The 60-client dense ResNet-10
# trial of the fedavg phase under ALIE + Median, in client blocks of 30, so
# that a rank's 30 lanes are one block of the one-process dense round too.
MESH_TRIAL = {**DENSE_TRIAL, "adversary_config": {"type": "ALIE"},
              "client_block": 30, "evaluation_interval": 2}
# (a)-(c), within the script's time limit: with (c) at 2 rounds beside
# (b)'s four ranks the card ran out of memory.  (d) and (e) run 2.
MESH_ROUNDS = 1
MESH_TURNS = 1  # dense / sharded turns of (a), the first audited
# BN-backward launches of each kernel per rank and round: 30 lanes in one
# block, 12 BN layers, 2 local steps.
MESH_BN_ROUND = 12 * 2
MESH_DEADLINE_S = 600
MESH_PORT = []  # --port, handed to the ranks
MESH_DEVICE = "cuda:0"  # every rank's device: the one card
MESH_T0 = [time.perf_counter()]  # a rank's start, for its setup seconds


def _mesh_run(cfg, turn_audit=None):
    """One driver of ``cfg`` on cuda:0, ``MESH_ROUNDS`` rounds, the launch
    counts set to 0 just before them and read just after; with
    ``turn_audit`` (``(select key, BN key)``) every select and BN launch
    held against the plain versions.  Returns the parameters on the host,
    the rows' scalars, the counts and routes, and the training seconds."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda

    algo = FedavgConfig().update_from_dict(cfg).build(device=MESH_DEVICE)
    audits = contextlib.ExitStack()
    sel = bn = None
    if turn_audit is not None:
        sel = audits.enter_context(_PathAudit("select", turn_audit[0]))
        bn = audits.enter_context(_BnAudit(key=turn_audit[1]))
    AUDIT["s"] = 0.0
    try:
        with audits:
            torch.cuda.synchronize()
            _cuda.reset_launches()
            rows = [algo.train() for _ in range(MESH_ROUNDS)]
            torch.cuda.synchronize()
            counts, maps = dict(_cuda.LAUNCHES), dict(_cuda.MAPS)
        train_s = rows[-1]["timers"]["training_step"]["total_s"] - AUDIT["s"]
        out = {"params": _host_params(algo.state.server.params),
               "rows": [{k: v for k, v in r.items()
                         if isinstance(v, (int, float, str))} for r in rows],
               "counts": counts,
               "maps": {"/".join(k): v for k, v in maps.items()},
               "train_s": train_s}
        if sel is not None:
            out["records"] = {**sel.records, **bn.records(MESH_ROUNDS)}
            out["audited"] = (sel.calls, bn.calls)
        return out
    finally:
        algo.stop()
        torch.cuda.empty_cache()  # for the other groups on the card


def _collective_ms(fn):
    """A collective ``fn()`` alone: every rank starting together, the ms
    of one run after a warm-up (a run moves gigabytes through the host
    and takes seconds)."""
    import torch
    import torch.distributed as dist

    for _ in range(2):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _mesh_gather_ms(mesh, d):
    """The sharded round's gather alone: each rank's (30, d) f32 rows into
    the (60, d) matrix on every rank, over the round's group."""
    import torch

    from blades_tpu_torch.parallel.mesh import all_gather_rows

    x = torch.randn((30, d), device=MESH_DEVICE)
    return _collective_ms(lambda: all_gather_rows(mesh, x))


def _mesh_sharded(rank, world):
    """(a) The sharded round on every rank, then dense on rank 0 (the
    others wait at a barrier), in turns: every rank's first rounds start
    together, and rank 0's dense rounds run warm.  The first sharded turn
    audited; rank 0 holds each sharded turn against the dense turn."""
    import torch.distributed as dist

    from blades_tpu_torch.parallel.mesh import params_digest

    sharded_cfg = {**MESH_TRIAL, "num_devices": world}
    out = {"dense_s": [], "sharded_s": [], "same": [], "err": []}
    dense = None
    for turn in range(MESH_TURNS):
        audit = (("column_median:mesh", "mesh") if turn == 0 else None)
        run = _mesh_run(sharded_cfg, audit)
        if rank == 0:
            dense = _mesh_run(MESH_TRIAL)
            out["dense_s"].append(dense["train_s"])
            out["dense_counts"] = dense["counts"]
        out["sharded_s"].append(run["train_s"])
        if turn == 0:
            out["records"] = run["records"]
            out["audited"] = run["audited"]
        out["counts"], out["maps"] = run["counts"], run["maps"]
        out["digest"] = params_digest(run["params"])
        out["rows"] = run["rows"]
        if rank == 0:
            err, _, same_bits = _params_diff(run["params"], dense["params"],
                                             RTOL, ATOL)
            out["same"].append(same_bits)
            out["err"].append(err)
            out["agg_norms"] = ([r["agg_norm"] for r in run["rows"]],
                                [r["agg_norm"] for r in dense["rows"]])
        dist.barrier()
    d = sum(v.numel() for v in run["params"].values())
    from blades_tpu_torch.parallel import make_mesh

    out["gather_ms"] = _mesh_gather_ms(make_mesh(world), d)
    out["d"] = d
    return out


def _preagg_ms(d):
    """Rank 0's pre-aggregation alone on a (30, d) f32 block (a rank's
    lanes), bucket and nnm at bucket_size 2: the median of 3 after a
    warm-up."""
    import torch

    from blades_tpu_torch.ops.preagg import (
        bucket_representatives,
        nnm_representatives,
    )

    x = torch.randn((30, d), device=MESH_DEVICE)
    real = torch.ones(30, dtype=torch.bool, device=MESH_DEVICE)
    out = {}
    for name, fn in (("bucket", bucket_representatives),
                     ("nnm", nnm_representatives)):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(x, real, 2)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = sorted(times[1:])[1]
    return out


def _mesh_hier(rank, world):
    """(b) On a (2, 2) mesh: dense on rank 0, then the hierarchical round
    at bucket_size 1 (rank 0 holds it against the dense round), and bucket
    and nnm at bucket_size 2 (their recorded wire bytes against the comm
    model's), the select and BN launches held against the plain versions;
    then rank 0 times the two pre-aggregations alone."""
    import torch.distributed as dist

    from blades_tpu_torch.parallel.comm_model import (
        hier_round_volumes,
        hier_wire_bytes,
    )
    from blades_tpu_torch.parallel.mesh import params_digest

    out, b1_params = {}, None
    for key, preagg, b in (("b1", "bucket", 1), ("b2", "bucket", 2),
                           ("nnm2", "nnm", 2)):
        cfg = {**MESH_TRIAL, "num_devices": world, "mesh_shape": (2, 2),
               "execution": "hier", "preagg": preagg, "bucket_size": b}
        # bucket_size 1 launches at (a)'s shapes; bucket 2 selects over
        # (30, d).
        run = _mesh_run(cfg, ("column_median:mesh-hier", "mesh-hier")
                        if key == "b2" else None)
        d = sum(v.numel() for v in run["params"].values())
        vols = hier_round_volumes(MESH_TRIAL["dataset_config"]["num_clients"],
                                  d, (2, 2), preagg=preagg, bucket_size=b)
        res = {"counts": run["counts"], "maps": run["maps"],
               "audited": run.get("audited"),
               "digest": params_digest(run["params"]),
               "ici_bytes": [r["ici_bytes"] for r in run["rows"]],
               "model_bytes": hier_wire_bytes(vols),
               "kept": [r["preagg_kept"] for r in run["rows"]],
               "losses": [r["train_loss"] for r in run["rows"]],
               "finite": all(bool(v.isfinite().all())
                             for v in run["params"].values()),
               "train_s": run["train_s"]}
        if key == "b1":
            b1_params = run["params"]
        out[key] = res
        dist.barrier()
    if rank == 0:
        # The dense round after the ranks' (warm on this rank).
        dense = _mesh_run(MESH_TRIAL)
        err, _, same_bits = _params_diff(b1_params, dense["params"], RTOL,
                                         ATOL)
        out["b1"]["same"], out["b1"]["err"] = same_bits, err
        out["preagg_ms"] = _preagg_ms(d)
    dist.barrier()
    return out


def _mesh_nccl(rank, world):
    """(c) One NCCL rank: the dense driver's rounds, then
    ``sharded_step`` from the same initial state over the driver's data
    and round seeds (its gathers one-rank NCCL collectives)."""
    import copy

    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.parallel import (
        make_mesh,
        shard_federation,
        sharded_step,
    )

    algo = FedavgConfig().update_from_dict(MESH_TRIAL).build(
        device=MESH_DEVICE)
    try:
        state0 = copy.deepcopy(algo.state)  # train() moves algo.state
        for _ in range(MESH_ROUNDS):
            algo.train()
        dense = _host_params(algo.state.server.params)
        mesh = make_mesh(1)
        state, data = shard_federation(mesh, state0, algo._train)
        step = sharded_step(algo.fed_round, mesh)
        _cuda.reset_launches()
        with _PathAudit("select", "column_median:mesh-nccl"), _BnAudit():
            for r in range(MESH_ROUNDS):
                state, m = step(state, *data, algo.malicious,
                                algo.round_seed(r))
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        err, _, same_bits = _params_diff(
            _host_params(state.server.params), dense, RTOL, ATOL)
        return {"same": same_bits, "err": err, "counts": counts,
                "backend": mesh.backend}
    finally:
        algo.stop()


# (f) the execution autotuner on the ranks: ResNet-10 at full width x 32
# clients, ALIE on 8, Median, 2 gloo ranks sharing cuda:0, autotune
# "reassociating" over a fresh plan cache (a directory a rank: only rank 0
# may write one).  Each rank's 16 lanes are one block.  The plan space
# (``Fedavg._plan_space`` on a mesh of 2): the flat client-sharded round
# with and without prefetch, the same on a pinned (2, 1) grid, and the
# hierarchical round on (2, 1); each candidate timed on AUTOTUNE_REPS
# train() call after a warm-up, in lockstep.
MESH_AUTOTUNE_TRIAL = {
    **MESH_TRIAL, "num_malicious_clients": 8, "client_block": 16,
    "dataset_config": {**DENSE_TRIAL["dataset_config"], "num_clients": 32},
    "evaluation_interval": 3}
MESH_AUTOTUNE_ROUNDS = 2  # the winner's rounds, held against tuned_plan's
MESH_AUTOTUNE_IDS = tuple(
    "dense|c131072|p1|mxu=off|w1|" + tail for tail in (
        "pre", "nopre", "pre|mesh=2x1", "nopre|mesh=2x1",
        "nopre|mesh=2x1|hier"))
MESH_OUT = []  # a rank's --mesh-out


def _at_mesh_run(cfg, rounds):
    """Build ``cfg`` on ``MESH_DEVICE`` (an autotuned build times its
    candidates, every select and BN launch held against the plain versions
    as the rounds' are) and run ``rounds`` rounds, the launch counts set to
    0 just before the build and read after the rounds.  Each candidate is
    timed on the rank's clock less its own audits' seconds, and peaks at
    the larger of its measured peak and the peak its audits saw.  Returns
    the plan, the provenance, the candidates this rank timed and its own
    medians and peaks, the parameters' digest and finiteness, the rows'
    scalars, the counts, routes, audited launches and seconds."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.parallel.mesh import params_digest
    from blades_tpu_torch.perf import autotune as at

    real = at.timed_measure_fn
    local, peaks = {}, {}

    def measure_fn(config, **kw):
        measure = real(config, reps=AUTOTUNE_REPS,
                       clock=lambda: time.perf_counter() - AUDIT["s"], **kw)

        def m(plan):
            AUDIT["peak"] = 0
            local[plan.plan_id] = measure(plan)
            peaks[plan.plan_id] = max(measure.peaks.get(plan.plan_id, 0),
                                      AUDIT["peak"])
            return local[plan.plan_id]

        return m

    at.timed_measure_fn = measure_fn
    AUDIT["s"] = 0.0
    sel = _PathAudit("select", "column_median:mesh-autotune", timing=None)
    try:
        with sel, _BnAudit() as bn:
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            algo = FedavgConfig().update_from_dict(cfg).build(
                device=MESH_DEVICE)
            build_s = time.perf_counter() - t0
            try:
                rows = [algo.train() for _ in range(rounds)]
                torch.cuda.synchronize()
                counts, maps = dict(_cuda.LAUNCHES), dict(_cuda.MAPS)
                params = algo.state.server.params
                out = {"plan": algo.plan.as_dict(),
                       "prov": algo.plan_summary,
                       "built": list(local), "local": local, "peaks": peaks,
                       "digest": params_digest(params),
                       "finite": all(bool(v.isfinite().all())
                                     for v in params.values()),
                       "hier": algo._hier_recorder is not None,
                       "rows": [{k: v for k, v in r.items()
                                 if isinstance(v, (int, float, str))}
                                for r in rows],
                       "counts": counts,
                       "maps": {"/".join(k): v for k, v in maps.items()},
                       "build_s": build_s,
                       "train_s": (rows[-1]["timers"]["training_step"]
                                   ["total_s"] if rows else 0.0)}
            finally:
                algo.stop()
                torch.cuda.empty_cache()
        out["audited"] = (sel.calls, bn.calls)
        out["errs"] = (max([r["max_abs_err"] for r in sel.records.values()],
                           default=0.0), bn.err)
        out["audit_s"] = AUDIT["s"]
        return out
    finally:
        at.timed_measure_fn = real


def _mesh_autotune(rank, world):
    """(f) The autotuned trial on every rank (its candidates built and timed
    in lockstep, rank 0 deciding), then the run pinned to its winner
    (``tuned_plan``), then the same autotuned config again (a cache hit on
    every rank, no candidate built).  Every rank keeps its own plan-cache
    directory: only rank 0's gets the file."""
    import torch.distributed as dist

    plans = os.path.join(os.path.dirname(MESH_OUT[0]), "plans", f"rank{rank}")
    cfg = {**MESH_AUTOTUNE_TRIAL, "num_devices": world,
           "autotune": "reassociating", "autotune_cache_dir": plans}
    tuned = _at_mesh_run(cfg, MESH_AUTOTUNE_ROUNDS)
    dist.barrier()
    pinned = _at_mesh_run({**cfg, "tuned_plan": tuned["plan"]},
                          MESH_AUTOTUNE_ROUNDS)
    dist.barrier()
    files = sorted(os.listdir(plans)) if os.path.isdir(plans) else []
    again = _at_mesh_run(cfg, 0)
    return {"tuned": tuned, "pinned": pinned, "again": again,
            "files": files}


# The mesh phase's gossip parts: the gossip phase's headline trial
# (_gossip_headline: 64 nodes, kregular k = 4 (k1 = 5), ALIE on 16, Median,
# f32) on the ranks of a process group, each rank's 32 nodes one block of
# the one-process round's blocks of 32, 2 rounds: (d) 2 gloo ranks sharing
# cuda:0, alone on the card, (e) a group of one NCCL rank, beside (a).
GOSSIP_MESH_ROUNDS = 2
# gossip_wire_bytes(gossip_round_volumes(64, 4,903,242, (2, 1))): a rank's
# wire bytes a round on 2 ranks.
GOSSIP_MESH_ICI = 1_255_230_208
GOSSIP_MESH_BN_ROUND = 12  # a rank's 32 lanes in one block, 12 BN layers


class _GatherTimer:
    """Times every all-gather the gossip round makes on a mesh (the name
    its module bound), the card synchronized before and after each and
    the ranks lined up at a barrier first (a rank's wait for the other's
    training is not the gather's): ``(rows shape, seconds)`` in call
    order.  Without a mesh (the stacked round) a gather is the identity
    and is not timed."""

    def __enter__(self):
        from blades_tpu_torch.topology import gossip as G

        self._mod, self._orig, self.s = G, G.all_gather_rows, []

        def gather(mesh, t, *a, **kw):
            import torch
            import torch.distributed as dist

            if mesh is None:
                return self._orig(mesh, t, *a, **kw)
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._orig(mesh, t, *a, **kw)
            torch.cuda.synchronize()
            self.s.append((list(t.shape), time.perf_counter() - t0))
            return out

        G.all_gather_rows = gather
        return self

    def __exit__(self, *exc):
        self._mod.all_gather_rows = self._orig


def _gossip_mesh_run(cfg, key=None, timed=False):
    """One gossip driver of ``cfg`` on cuda:0, ``GOSSIP_MESH_ROUNDS``
    rounds, the launch counts set to 0 just before them and read just
    after; with ``key`` every select and BN launch held against the plain
    versions, and with ``timed`` the first launches' operands kept for
    their records (the audits under ``"audits"``: :func:`_mesh_gossip`
    times them when the card is otherwise idle).  Returns every node's
    parameters (gathered on a mesh) on the host, the rows, the counts,
    the recorder, the gathers' seconds and each round's seconds (the
    audits' taken out)."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda

    algo = FedavgConfig().update_from_dict(cfg).build(device=MESH_DEVICE)
    audits = contextlib.ExitStack()
    sel = bn = None
    if key is not None:
        sel = audits.enter_context(_PathAudit(
            "select", f"column_median:{key}",
            timing="deferred" if timed else None))
        bn = audits.enter_context(_BnAudit(key=key if timed else None,
                                           defer=True))
    AUDIT["s"] = 0.0
    try:
        with audits, _GatherTimer() as gathers:
            torch.cuda.synchronize()
            _cuda.reset_launches()
            rows, secs = _cycles(algo, GOSSIP_MESH_ROUNDS)
            counts, maps = dict(_cuda.LAUNCHES), dict(_cuda.MAPS)
        state = (algo._gathered_state() if algo.mesh is not None
                 else algo.state)
        rec = algo._gossip_recorder
        out = {"params": _host_params(state.server.params),
               "rows": [{k: v for k, v in r.items()
                         if isinstance(v, (int, float, str))} for r in rows],
               "counts": counts,
               "maps": {"/".join(k): v for k, v in maps.items()},
               "events": [list(e) for e in rec.ici_events],
               "ici_bytes": rec.ici_bytes, "gathers": gathers.s,
               "train_s": secs, "d": algo._num_params}
        if sel is not None:
            out["audits"] = (sel, bn)
            out["audited"] = (sel.calls, bn.calls)
        return out
    finally:
        algo.stop()
        torch.cuda.empty_cache()


def _mesh_gossip(rank, world):
    """(d) The round on both ranks, every select and BN launch audited,
    then the one-process stacked gossip round on rank 0 (the other rank
    waiting; rank 0 warm); rank 0 holds the ranks' nodes against the
    stacked round's.  Then rank 0 times its first select and BN launches
    on their operands, the other rank waiting at a barrier: the card is
    otherwise idle ((e) ran beside (a)), so the records are the kernels'
    own times, not times shared with the other rank's training."""
    import torch.distributed as dist

    from blades_tpu_torch.parallel.mesh import params_digest

    run = _gossip_mesh_run({**GOSSIP_TRIAL, "num_devices": world},
                           "mesh-gossip", timed=rank == 0)
    out = {k: run[k] for k in ("counts", "maps", "events", "ici_bytes",
                               "gathers", "train_s", "rows", "d", "audited")}
    if rank == 0:
        stacked = _gossip_mesh_run(GOSSIP_TRIAL)
        out["stacked_counts"] = stacked["counts"]
        out["stacked_s"] = stacked["train_s"]
        out["stacked_rows"] = stacked["rows"]
        out["stacked_digest"] = params_digest(stacked["params"])
        err, _, same_bits = _params_diff(run["params"], stacked["params"],
                                         RTOL, ATOL)
        out["same"], out["err"] = same_bits, err
        del stacked
    dist.barrier()
    if rank == 0:
        sel, bn = run.pop("audits")
        t0 = time.perf_counter()
        sel.time_deferred()
        bn.time_deferred()
        out["records"] = {**sel.records, **bn.records(GOSSIP_MESH_ROUNDS)}
        out["timing_s"] = time.perf_counter() - t0
    run.pop("audits", None)
    dist.barrier()
    return out


def _gossip_nccl(rank, world):
    """(e) One NCCL rank: ``gossip_step`` on the group of one, 2 rounds
    from the stacked driver's initial state over its data and round
    seeds (its gathers one-rank NCCL collectives), every select and BN
    launch audited; its parameters' digest is held against (d)'s
    one-process stacked round (the same trial, the same rounds)."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.parallel import make_mesh
    from blades_tpu_torch.parallel.mesh import (
        params_digest,
        shard_gossip_state,
    )
    from blades_tpu_torch.topology import gossip_step

    algo = FedavgConfig().update_from_dict(GOSSIP_TRIAL).build(
        device=MESH_DEVICE)
    try:
        t0 = time.perf_counter()
        mesh = make_mesh(1)
        state, data = shard_gossip_state(mesh, algo.state, algo._train,
                                         GOSSIP_N)
        step, rec = gossip_step(algo.fed_round, algo._topology, mesh=mesh)
        _cuda.reset_launches()
        with _PathAudit("select", "column_median:mesh-gossip-nccl",
                        timing=None) as sel, _BnAudit() as bn:
            for r in range(GOSSIP_MESH_ROUNDS):
                state, m = step(state, *data, algo.malicious,
                                algo.round_seed(r))
        torch.cuda.synchronize()
        return {"digest": params_digest(_host_params(state.server.params)),
                "counts": dict(_cuda.LAUNCHES),
                "audited": (sel.calls, bn.calls), "backend": mesh.backend,
                "events": [list(e) for e in rec.ici_events],
                "ici": int(m["gossip_ici_bytes"]),
                "s": time.perf_counter() - t0}
    finally:
        algo.stop()


# The dsharded phase: the width-sharded round of
# fedavg_cifar10_1000clients_mesh.yaml at full ResNet-18 width (d =
# 11,173,962), cut to 64 clients (16 ALIE, 8 elided a rank) on 2 gloo ranks
# sharing cuda:0, client blocks of 8, 2 rounds in one dispatch; then a
# group of one NCCL rank, this process, at 256 clients (64 elided).
DSHARDED_YAML = os.path.join(HERE, "blades_tpu", "tuned_examples",
                             "fedavg_cifar10_1000clients_mesh.yaml")
DSHARDED_CUT = {"num_clients": 64, "num_malicious_clients": 16,
                "num_devices": 2, "rounds_per_dispatch": 2,
                "client_block": 8}
DSHARDED_NCCL_CUT = {"num_clients": 256, "num_malicious_clients": 64,
                     "num_devices": None, "rounds_per_dispatch": 1,
                     "client_block": 8}
DSHARDED_ROUNDS = 2  # (a)'s rounds, one dispatch
DSHARDED_AGGS = ("Median", "Multikrum", "Signguard")  # the example's grid


def _dsharded_trials(cut):
    """The mesh example's three points (Median, Multikrum, Signguard) read
    with the port's YAML reader, cut to ``cut``."""
    from blades_tpu_torch.tune import expand_grid, load_experiments_from_file

    (spec,) = load_experiments_from_file(DSHARDED_YAML).values()
    out = {}
    for trial in expand_grid(spec["config"]):
        cfg = copy.deepcopy(trial)
        cfg["dataset_config"]["num_clients"] = cut["num_clients"]
        for k in ("num_malicious_clients", "num_devices",
                  "rounds_per_dispatch", "client_block"):
            cfg[k] = cut[k]
        if cut["num_devices"] is None:
            cfg["execution"] = "dense"
        out[cfg["server_config"]["aggregator"]["type"]] = cfg
    return out


def _bn_layers(params):
    """The BatchNorm layers of a model, from its parameter names."""
    return sum(1 for k in params
               if "BatchStatsNorm" in k and k.endswith(".weight"))


class _MaskSpy:
    """Records the row mask of every ``masked.masked_mean`` call (the
    Multikrum selection, Signguard's survivors)."""

    def __enter__(self):
        from blades_tpu_torch.ops import masked

        self._mod, self._orig, self.masks = masked, masked.masked_mean, []

        def spy(x, mask):
            self.masks.append([bool(v) for v in mask.detach().cpu()])
            return self._orig(x, mask)

        masked.masked_mean = spy
        return self

    def __exit__(self, *exc):
        self._mod.masked_mean = self._orig


class _AggSpy:
    """Records, on the host, the ``(d,)`` aggregate of every
    ``Server.apply_aggregate`` call (one a round, on either path); the
    copies' seconds go to ``AUDIT["s"]``."""

    def __enter__(self):
        from blades_tpu_torch.core.server import Server

        self._cls, self._orig, self.aggs = Server, Server.apply_aggregate, []

        def spy(server, state, agg, agg_state=None):
            t0 = time.perf_counter()
            self.aggs.append(agg.detach().float().cpu())
            AUDIT["s"] += time.perf_counter() - t0
            return self._orig(server, state, agg, agg_state)

        Server.apply_aggregate = spy
        return self

    def __exit__(self, *exc):
        self._cls.apply_aggregate = self._orig


def _aggs_diff(mine, dense):
    """Round by round: (max abs err, within ``RTOL`` / ``ATOL``, bit for
    bit) of the width-sharded aggregates against the dense round's."""
    return [_params_diff({"agg": a}, {"agg": b}, RTOL, ATOL)
            for a, b in zip(mine, dense)]


def _dsharded_dense(cfg, order):
    """The one-process dense round of ``cfg`` on the elision-ordered
    federation (``order``), ``DSHARDED_ROUNDS`` rounds from the driver's
    round seeds: parameters, launches, seconds, peak memory, masks and
    each round's aggregate."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda

    algo = FedavgConfig().update_from_dict(
        {**cfg, "num_devices": None, "execution": "dense"}).build(
        device=MESH_DEVICE)
    try:
        idx = torch.as_tensor(order, device=algo.malicious.device)
        train = tuple(a[idx.to(a.device)] for a in algo._train)
        mal, state = algo.malicious[idx], algo.state
        torch.cuda.synchronize()
        _reset_peak()
        _cuda.reset_launches()
        AUDIT["s"] = 0.0
        t0 = time.perf_counter()
        with _MaskSpy() as spy, _AggSpy() as aggs:
            for r in range(DSHARDED_ROUNDS):
                state, m = algo.fed_round.step(state, *train, mal,
                                               algo.round_seed(r))
            torch.cuda.synchronize()
        return {"params": _host_params(state.server.params),
                "counts": dict(_cuda.LAUNCHES),
                "s": time.perf_counter() - t0 - AUDIT["s"],
                "peak": _peak(), "masks": spy.masks, "aggs": aggs.aggs,
                "agg_norm": float(m["agg_norm"])}
    finally:
        algo.stop()


class _SwapTimer:
    """Times each axis swap of the width-sharded rounds, in the round: the
    ranks line up at a barrier first, so a rank's wait for the other's
    training is not the swap's."""

    def __enter__(self):
        import torch
        import torch.distributed as dist

        from blades_tpu_torch.parallel import dsharded

        self._mod, self._orig, self.ms = (dsharded,
                                          dsharded.rows_to_width_shard, [])

        def timed(mesh, rows, **kw):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._orig(mesh, rows, **kw)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        dsharded.rows_to_width_shard = timed
        return self

    def __exit__(self, *exc):
        self._mod.rows_to_width_shard = self._orig


def _dsharded_gloo(rank, world):
    """(a) For each of the example's three aggregators: the one-process
    dense round on rank 0 (the other rank waiting), then the width-sharded
    driver on every rank, one dispatch of 2 rounds; the Median turn's
    select and BN launches audited."""
    import torch
    import torch.distributed as dist

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.parallel import elision_client_order
    from blades_tpu_torch.ops.layout import ShardInfo
    from blades_tpu_torch.parallel.mesh import params_digest

    cut = DSHARDED_CUT
    order = elision_client_order(cut["num_clients"],
                                 cut["num_malicious_clients"], world)
    out = {}
    for agg, cfg in _dsharded_trials(cut).items():
        res = {}
        if rank == 0:
            res["dense"] = _dsharded_dense(cfg, order)
        dist.barrier()
        algo = FedavgConfig().update_from_dict(cfg).build(device=MESH_DEVICE)
        audits = contextlib.ExitStack()
        sel = bn = swaps = None
        if agg == "Median":
            sel = audits.enter_context(_PathAudit("select",
                                                  "column_median:dsharded"))
            bn = audits.enter_context(_BnAudit(key="dsharded"))
            swaps = audits.enter_context(_SwapTimer())
        AUDIT["s"] = 0.0
        try:
            with audits, _MaskSpy() as spy, _AggSpy() as aggs:
                torch.cuda.synchronize()
                _reset_peak()
                _cuda.reset_launches()
                t0 = time.perf_counter()
                row = algo.train()
                torch.cuda.synchronize()
                res["s"] = time.perf_counter() - t0 - AUDIT["s"]
                res["counts"] = dict(_cuda.LAUNCHES)
                res["maps"] = {"/".join(k): v for k, v in _cuda.MAPS.items()}
            res["peak"] = _peak()
            res["masks"] = spy.masks
            res["aggs"] = aggs.aggs
            params = algo.state.server.params
            res["params"] = _host_params(params)
            res["digest"] = params_digest(params)
            res["row"] = {k: v for k, v in row.items()
                          if isinstance(v, (int, float, str))}
            res["order_ok"] = (algo._client_order is not None
                               and algo._client_order.tolist()
                               == order.tolist())
            res["bn_layers"] = _bn_layers(params)
            res["f_local"] = algo._step.f_local
            res["events"] = [list(e) for e in algo._step.recorder.ici_events]
            res["ici_bytes"] = algo._step.recorder.ici_bytes
            res["d"] = sum(v.numel() for v in params.values())
            if sel is not None:
                res["records"] = {**sel.records,
                                  **bn.records(DSHARDED_ROUNDS)}
                res["audited"] = (sel.calls, bn.calls)
                res["bn_lines"] = _bn_layouts(bn)
                d = sum(v.numel() for v in params.values())
                res["d"], res["d_pad"] = d, ShardInfo.of(d, world).d_pad
                res["swap_ms"] = swaps.ms
        finally:
            algo.stop()
        if rank == 0:
            dense = res["dense"]
            err, close_, same_bits = _params_diff(res["params"],
                                                  dense["params"], RTOL, ATOL)
            res["err"], res["close"], res["same"] = err, close_, same_bits
            res["agg_rounds"] = _aggs_diff(res["aggs"], dense["aggs"])
            del dense["params"], dense["aggs"]
        del res["params"], res["aggs"]
        out[agg] = res
        dist.barrier()
    return out


def _dsharded_nccl():
    """(b) A group of one NCCL rank, this process: the one-process dense
    Median round of the example at 256 clients, then ``dsharded_step`` with
    64 lanes elided from the same state over the same data and round seed,
    every select and BN launch audited."""
    import torch

    from blades_tpu_torch.algorithms import FedavgConfig
    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.parallel import (
        dsharded_step,
        make_mesh,
        shard_federation,
    )

    cut = DSHARDED_NCCL_CUT
    cfg = _dsharded_trials(cut)["Median"]
    algo = FedavgConfig().update_from_dict(cfg).build(device=MESH_DEVICE)
    try:
        state0 = copy.deepcopy(algo.state)
        torch.cuda.synchronize()
        _reset_peak()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        state, _ = algo.fed_round.step(copy.deepcopy(state0), *algo._train,
                                       algo.malicious, algo.round_seed(0))
        torch.cuda.synchronize()
        out = {"dense_s": time.perf_counter() - t0, "dense_peak": _peak(),
               "dense_counts": dict(_cuda.LAUNCHES)}
        dense = _host_params(state.server.params)
        del state
        mesh = make_mesh(1)
        state, data = shard_federation(mesh, state0, algo._train)
        step = dsharded_step(algo.fed_round, mesh,
                             malicious_prefix=cut["num_malicious_clients"])
        torch.cuda.synchronize()
        _reset_peak()
        _cuda.reset_launches()
        AUDIT["s"] = 0.0
        t0 = time.perf_counter()
        with _PathAudit("select", "column_median:dsharded-nccl") as sel, \
                _BnAudit(key="dsharded-nccl") as bn:
            state, m = step(state, *data, algo.malicious, algo.round_seed(0))
            torch.cuda.synchronize()
        out.update(
            s=time.perf_counter() - t0 - AUDIT["s"], peak=_peak(),
            counts=dict(_cuda.LAUNCHES), backend=mesh.backend,
            f_local=step.f_local, audited=(sel.calls, bn.calls),
            records={**sel.records, **bn.records(1)},
            elided=m.get("elided_lanes"),
            bn_layers=_bn_layers(state.server.params),
            events=[list(e) for e in step.recorder.ici_events])
        err, _, same_bits = _params_diff(_host_params(state.server.params),
                                         dense, RTOL, ATOL)
        out["same"], out["err"] = same_bits, err
        return out
    finally:
        algo.stop()


def _dsharded_here(work):
    """(b) in this process, warm from the phases before it: a group of one
    NCCL rank, cuDNN deterministic as in the ranks; the group closed and
    the flags restored after."""
    import torch
    import torch.distributed as dist

    from blades_tpu_torch.parallel import init_distributed

    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    init_distributed(f"file://{os.path.join(work, 'nccl-rendezvous')}", 1, 0,
                     backend="nccl")
    try:
        return _dsharded_nccl()
    finally:
        dist.destroy_process_group()
        cudnn.deterministic, cudnn.benchmark = flags


MESH_PARTS = {"sharded": _mesh_sharded, "hier": _mesh_hier,
              "nccl": _mesh_nccl, "autotune": _mesh_autotune,
              "gossip": _mesh_gossip,
              "gossip-nccl": _gossip_nccl, "dsharded": _dsharded_gloo}


def _mesh_rank_main(args) -> int:
    """One rank of the mesh phase (started by :func:`phase_mesh`): join the
    group, run the part, write its JSON beside the others."""
    import traceback

    import torch

    sys.path.insert(0, os.path.abspath(args.port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    out = args.mesh_out
    MESH_OUT.append(out)
    try:
        from blades_tpu_torch.parallel import init_distributed
        import torch.distributed as dist

        init_distributed(args.mesh_url, args.mesh_world, args.mesh_rank,
                         backend=args.mesh_backend)
        t0 = time.perf_counter()
        with _shared_datasets():
            res = MESH_PARTS[args.mesh_part](args.mesh_rank, args.mesh_world)
        # Seconds from the interpreter's start to the group, and the part.
        res["setup_s"] = t0 - MESH_T0[0]
        res["part_s"] = time.perf_counter() - t0
        with open(f"{out}{args.mesh_rank}.json", "w") as fh:
            json.dump(res, fh, default=str)
        dist.barrier()
        dist.destroy_process_group()
        return 0
    except BaseException:
        with open(f"{out}{args.mesh_rank}.err", "w") as fh:
            fh.write(traceback.format_exc())
        return 1


def _mesh_start(part, world, backend, work):
    """Start ``world`` ranks of ``part``: one process each, a ``file://``
    rendezvous in ``work``, each rank's output in chiprun_out/mesh/."""
    import subprocess

    gdir = os.path.join(work, part)
    os.makedirs(gdir, exist_ok=True)
    logs = os.path.join(HERE, "chiprun_out", "mesh")
    os.makedirs(logs, exist_ok=True)
    out = os.path.join(gdir, "out")
    procs = []
    for r in range(world):
        log_fh = open(os.path.join(logs, f"{part}{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-part", part,
             "--mesh-rank", str(r), "--mesh-world", str(world),
             "--mesh-url", f"file://{os.path.join(gdir, 'rendezvous')}",
             "--mesh-backend", backend, "--mesh-out", out,
             "--port", MESH_PORT[0]],
            stdout=log_fh, stderr=subprocess.STDOUT), log_fh))
    return part, out, procs


def _mesh_wait(group):
    """Every rank's JSON; a rank that fails, or a group still running at
    the deadline (every rank then killed), fails the phase."""
    import subprocess

    part, out, procs = group
    end = time.monotonic() + MESH_DEADLINE_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
            p.wait()
        raise Failure(f"mesh {part}: ranks still running after "
                      f"{MESH_DEADLINE_S} s")
    finally:
        for _, fh in procs:
            fh.close()
    failed = []
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            err = f"{out}{r}.err"
            why = (open(err).read() if os.path.exists(err)
                   else "no traceback (see chiprun_out/mesh)")
            failed.append(f"rank {r} exited {p.returncode}: {why[-3000:]}")
    if failed:
        raise Failure(f"mesh {part}: " + "\n".join(failed))
    res = []
    for r in range(len(procs)):
        with open(f"{out}{r}.json") as fh:
            res.append(json.load(fh))
    return res


def _mesh_wait_all(groups):
    """:func:`_mesh_wait` of groups started together; if one fails, the
    others' ranks are killed before the failure is raised."""
    res = []
    try:
        for grp in groups:
            res.append(_mesh_wait(grp))
    except BaseException:
        for _, _, procs in groups:
            for p, fh in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                fh.close()
        raise
    return res


def _mesh_gossip_checks(g, e0, card):
    """(d) and (e) held and logged: ``g`` the 2 gloo ranks' results, ``e0``
    the NCCL rank's; returns the path's launch counts and records."""
    from blades_tpu_torch.parallel.comm_model import (
        gossip_round_volumes,
        gossip_wire_bytes,
    )

    g0, rounds = g[0], GOSSIP_MESH_ROUNDS
    gd = g0["d"]
    vols = gossip_round_volumes(GOSSIP_N, gd, (2, 1))
    model = [[v.label, v.kind, v.payload_bytes, k] for v, k in vols]
    check(gossip_wire_bytes(vols) == GOSSIP_MESH_ICI, f"mesh (d): the comm "
          f"model's {gossip_wire_bytes(vols)} bytes at d = {gd}")
    want_rank = {"column_median": rounds,
                 **{k: rounds * GOSSIP_MESH_BN_ROUND for k in BN_TPU}}
    for r, res in enumerate(g):
        check(res["counts"] == want_rank
              and res["maps"].get("column_median/select:radix") == rounds,
              f"mesh (d) rank {r}: launches {res['counts']} by route "
              f"{res['maps']}, expected {want_rank}")
        check(list(res["audited"]) == [rounds,
                                       2 * rounds * GOSSIP_MESH_BN_ROUND],
              f"mesh (d) rank {r}: audited {res['audited']}")
        check(res["events"] == model and res["ici_bytes"] == GOSSIP_MESH_ICI
              and all(row["gossip_ici_bytes"] == GOSSIP_MESH_ICI
                      for row in res["rows"]),
              f"mesh (d) rank {r}: recorder {res['events']} "
              f"({res['ici_bytes']} B), rows' gossip_ici_bytes "
              f"{[row['gossip_ici_bytes'] for row in res['rows']]}, the "
              f"model {model}")
    want_stacked = {"column_median": rounds,
                    **{k: rounds * GOSSIP_BN_ROUND for k in BN_TPU}}
    check(g0["stacked_counts"] == want_stacked, f"mesh (d): the stacked "
          f"round's launches {g0['stacked_counts']}, expected {want_stacked}")
    keys = ("train_loss", "agg_norm", "update_norm_mean", "consensus_dist")
    rows_same = all(a[k] == s_[k] for a, s_ in zip(g0["rows"],
                                                   g0["stacked_rows"])
                    for k in keys)
    check(g0["same"] and rows_same, f"mesh (d): the rank round differs from "
          f"the stacked round (max abs err {g0['err']}; rows "
          f"{[[a[k] for k in keys] for a in g0['rows']]} vs "
          f"{[[a[k] for k in keys] for a in g0['stacked_rows']]})")
    check(g0.get("records", {}).get("column_median:mesh-gossip",
                                    {}).get("library_ms") is not None,
          f"mesh (d): the select's record {g0.get('records')}")
    big = [[round(t, 3) for shape, t in res["gathers"] if len(shape) == 2]
           for res in g]
    small = [[round(t * 1e3, 3) for shape, t in res["gathers"]
              if len(shape) == 1] for res in g]
    log(f"mesh (d): gossip ResNet-10 x {GOSSIP_N} (d = {gd:,}, kregular "
        f"k1 = 5, ALIE on {GOSSIP_N // 4}, Median, f32) on 2 gloo ranks "
        f"sharing cuda:0 equals the one-process stacked round bit for bit "
        f"(every node's parameters; train_loss, agg_norm, update_norm_mean, "
        f"consensus_dist of each round); launches per rank {g0['counts']} "
        f"(stacked {g0['stacked_counts']}); gossip_ici_bytes "
        f"{GOSSIP_MESH_ICI:,} a rank a round = gossip_wire_bytes("
        f"gossip_round_volumes(64, d, (2, 1))), recorder events "
        f"{[e[0] for e in g0['events']]} [{card}]")
    log(f"mesh (d): stacked {_warm_rate(g0['stacked_s'], 'round')}; on the "
        f"ranks {_warm_rate(g0['train_s'], 'round')} / "
        f"{_warm_rate(g[1]['train_s'], 'round')} (each a process's first "
        f"ResNet rounds); the (32, {gd:,}) f32 gathers (updates, parameters; 2 a round) "
        f"{big[0]} / {big[1]} s a rank, the (32,) ones (losses, aggregate "
        f"norms) {small[0]} / {small[1]} ms (gloo through the host, two "
        f"ranks on one card: not an NCCL or multi-GPU number); rank 0's "
        f"first select and BN launches timed after the rounds, the other "
        f"rank at a barrier ({g0['timing_s']:.1f} s) [{card}]")

    # (e) the gossip round on one NCCL rank.
    one = [[v.label, v.kind, v.payload_bytes, k]
           for v, k in gossip_round_volumes(GOSSIP_N, gd, (1, 1))]
    want_e = {"column_median": rounds,
              **{k: rounds * GOSSIP_BN_ROUND for k in BN_TPU}}
    check(e0["backend"] == "nccl" and e0["digest"] == g0["stacked_digest"],
          f"mesh (e): backend {e0['backend']}, the NCCL rank's gossip_step "
          f"differs from (d)'s stacked round (digests {e0['digest']} vs "
          f"{g0['stacked_digest']})")
    check(e0["counts"] == want_e and list(e0["audited"]) == [
        rounds, 2 * rounds * GOSSIP_BN_ROUND] and e0["events"] == one
        and e0["ici"] == 0, f"mesh (e): launches {e0['counts']} (expected "
          f"{want_e}), audited {e0['audited']}, recorder {e0['events']}, "
          f"gossip_ici_bytes {e0['ici']}")
    log(f"mesh (e): gossip_step on one NCCL rank equals (d)'s stacked "
        f"round bit for bit (parameter digests); launches {e0['counts']}, "
        f"every one audited; gossip_ici_bytes 0 (a ring of one); "
        f"{e0['s']:.1f} s, beside (a) on the card [{card}]")
    counts = {"column_median:mesh-gossip": g0["counts"]["column_median"],
              **{f"{k}:mesh-gossip": g0["counts"][k] for k in BN_TPU}}
    return counts, g0["records"]


def _mesh_autotune_checks(f, card):
    """(f) held and logged: ``f`` the 2 gloo ranks' results."""
    f0 = f[0]
    ids = list(MESH_AUTOTUNE_IDS)
    prov = f0["tuned"]["prov"]
    n = len(ids)
    rounds = MESH_AUTOTUNE_ROUNDS
    tuned_rounds = n * (1 + AUTOTUNE_REPS) + rounds
    for r, res in enumerate(f):
        t, p, g = res["tuned"], res["pinned"], res["again"]
        check(t["prov"] == prov and t["plan"] == f0["tuned"]["plan"],
              f"mesh (f) rank {r}: plan {t['prov']['winner_id']}, "
              f"provenance differs from rank 0's")
        check(t["built"] == ids and all(t["local"][i] is not None
                                        for i in ids),
              f"mesh (f) rank {r}: timed {t['local']}, expected {ids}")
        for res_, nr, what in ((t, tuned_rounds, "tuned"),
                               (p, rounds, "pinned")):
            want = {"column_median": nr,
                    **{k: nr * MESH_BN_ROUND for k in BN_TPU}}
            check(res_["counts"] == want
                  and res_["maps"].get("column_median/select:radix") == nr,
                  f"mesh (f) rank {r} {what}: launches {res_['counts']} by "
                  f"route {res_['maps']}, expected {want}")
            check(list(res_["audited"]) == [nr, 2 * nr * MESH_BN_ROUND],
                  f"mesh (f) rank {r} {what}: audited {res_['audited']}")
            check(res_["finite"] and all(math.isfinite(row["train_loss"])
                                         for row in res_["rows"]),
                  f"mesh (f) rank {r} {what}: parameters or losses not "
                  f"finite")
        keys = ("train_loss", "agg_norm", "update_norm_mean")
        check(p["prov"]["mode"] == "pinned" and p["plan"] == t["plan"]
              and p["digest"] == t["digest"]
              and [[x[k] for k in keys] for x in p["rows"]]
              == [[x[k] for k in keys] for x in t["rows"]]
              and p["hier"] is t["hier"],
              f"mesh (f) rank {r}: the winner's rounds differ from the "
              f"tuned_plan run's")
        check(g["prov"]["mode"] == "cache" and g["prov"]["cache_hit"]
              and g["built"] == [] and g["plan"] == t["plan"]
              and not g["counts"],
              f"mesh (f) rank {r}: second run {g['prov']['mode']}, timed "
              f"{g['built']}, launches {g['counts']}")
        check(res["tuned"]["digest"] == f0["tuned"]["digest"],
              f"mesh (f): rank {r}'s parameters differ from rank 0's")
    check([c["plan_id"] for c in prov["candidates"]] == ids
          and [c["median_s"] for c in prov["candidates"]]
          == [f0["tuned"]["local"][i] for i in ids]
          and prov["mode"] == "measured",
          f"mesh (f): provenance {prov}, rank 0's medians "
          f"{f0['tuned']['local']}")
    check(len(f0["files"]) == 1 and f[1]["files"] == [],
          f"mesh (f): plan-cache files by rank {[x['files'] for x in f]}")
    what = (f"mesh (f) ResNet-10 x 32 ALIE Median, 2 gloo ranks on cuda:0 "
            f"[{card}]")
    for c in prov["candidates"]:
        i = c["plan_id"]
        log(f"{what}: candidate {c['rank']} {i} ({c['tier']}) median "
            f"{c['median_s']:.4f} s a round (rank 1 timed "
            f"{f[1]['tuned']['local'][i]:.4f}), peak "
            f"{f0['tuned']['peaks'][i] / 2**30:.2f} / "
            f"{f[1]['tuned']['peaks'][i] / 2**30:.2f} GiB")
    t0 = f0["tuned"]
    log(f"{what}: winner {prov['winner_id']} on both ranks, rank 0's "
        f"medians and provenance on rank 1; its {rounds} rounds equal the "
        f"tuned_plan run's bit for bit (train_loss "
        f"{[x['train_loss'] for x in t0['rows']]}); build with the "
        f"candidates {t0['build_s']:.1f} / {f[1]['tuned']['build_s']:.1f} s; "
        f"launches a rank {t0['counts']}, every one audited (select max "
        f"abs err {t0['errs'][0]}, BN sums {t0['errs'][1]:.3g}); the second "
        f"build a cache hit on both ranks, no candidate built "
        f"({f0['again']['build_s']:.1f} s); only rank 0's cache directory "
        f"holds the entry")


def phase_mesh(card):
    """The rounds on the ranks of a process group, through ``FedavgConfig``
    -> ``Fedavg.train()`` (``num_devices``, ``mesh_shape``,
    ``execution="hier"`` / ``"gossip"``): (a) the client-sharded round on
    2 gloo ranks sharing cuda:0, 1 round, in turns with the one-process
    dense round (bit for bit: the ranks' 30-lane blocks are the dense
    round's blocks, cuDNN deterministic); (b) the hierarchical round on a
    (2, 2) mesh of 4 ranks, at bucket_size 1 the dense round bit for bit,
    bucket and nnm at 2 with ``ici_bytes`` the comm model's; (c) one NCCL
    rank through ``sharded_step``, the dense round bit for bit;
    (d) the gossip phase's headline trial on 2 gloo ranks sharing cuda:0,
    then the one-process stacked round on rank 0, bit for bit,
    ``gossip_ici_bytes`` the comm model's, the gathers timed; (e) the same
    round through ``gossip_step`` on a group of one NCCL rank, bit for bit
    with (d)'s stacked round; (f) the execution autotuner on 2 gloo ranks
    sharing cuda:0 (ResNet-10 x 32, ``autotune="reassociating"``): the
    candidates (the flat and the hierarchical round) timed in lockstep,
    rank 0's winner and provenance on both ranks, its rounds equal to the
    ``tuned_plan`` run's bit for bit, the second build a cache hit on both
    ranks.  (a) runs beside (e), (b) alone, (f) beside (c), then (d)
    alone, so that its select and BN records are taken on an otherwise
    idle card ((a), (e) and (f) together can run the card out of
    memory).  Every select and BN launch of the ranks held against the
    plain versions."""
    from blades_tpu_torch.ops import _cuda

    _cuda.build()  # the ranks load this build
    _cuda.library()
    work = _work_dir("mesh")
    t0 = time.perf_counter()
    groups = [_mesh_start("sharded", 2, "gloo", work),
              _mesh_start("gossip-nccl", 1, "nccl", work)]
    a, e = _mesh_wait_all(groups)
    log(f"mesh (a)+(e): 2 gloo ranks and 1 NCCL rank in "
        f"{time.perf_counter() - t0:.1f} s (setup {a[0]['setup_s']:.1f} / "
        f"{e[0]['setup_s']:.1f} s, parts {a[0]['part_s']:.1f} / "
        f"{e[0]['part_s']:.1f} s)")
    t0 = time.perf_counter()
    b = _mesh_wait(_mesh_start("hier", 4, "gloo", work))
    log(f"mesh (b): 4 gloo ranks in {time.perf_counter() - t0:.1f} s "
        f"(setup {b[0]['setup_s']:.1f} s, part {b[0]['part_s']:.1f} s)")
    t0 = time.perf_counter()
    groups = [_mesh_start("autotune", 2, "gloo", work),
              _mesh_start("nccl", 1, "nccl", work)]
    f, c = _mesh_wait_all(groups)
    log(f"mesh (f)+(c): 2 gloo ranks and 1 NCCL rank in "
        f"{time.perf_counter() - t0:.1f} s (setup {f[0]['setup_s']:.1f} / "
        f"{c[0]['setup_s']:.1f} s, parts {f[0]['part_s']:.1f} / "
        f"{c[0]['part_s']:.1f} s)")
    # (d) alone: its records are timed on an otherwise idle card.
    t0 = time.perf_counter()
    g = _mesh_wait(_mesh_start("gossip", 2, "gloo", work))
    log(f"mesh (d): 2 gloo ranks in {time.perf_counter() - t0:.1f} s "
        f"(setup {g[0]['setup_s']:.1f} s, part {g[0]['part_s']:.1f} s)")

    # (a) the sharded round.
    r0 = a[0]
    want = {"column_median": MESH_ROUNDS,
            **{k: MESH_ROUNDS * MESH_BN_ROUND for k in BN_TPU}}
    for r, res in enumerate(a):
        check(res["counts"] == want, f"mesh (a) rank {r}: launches "
              f"{res['counts']}, expected {want}")
        check(res["maps"].get("column_median/select:radix") == MESH_ROUNDS,
              f"mesh (a) rank {r}: select routes {res['maps']}")
        check(res["digest"] == r0["digest"], f"mesh (a): rank {r}'s "
              "parameters differ from rank 0's")
        check(res["audited"][0] == MESH_ROUNDS
              and res["audited"][1] == 2 * MESH_ROUNDS * MESH_BN_ROUND,
              f"mesh (a) rank {r}: audited {res['audited']}")
    check(all(r0["same"]), f"mesh (a): the sharded round differs from the "
          f"dense round (max abs err {r0['err']})")
    dense_want = {"column_median": MESH_ROUNDS,
                  **{k: 2 * MESH_ROUNDS * MESH_BN_ROUND for k in BN_TPU}}
    check(r0["dense_counts"] == dense_want, f"mesh (a): dense launches "
          f"{r0['dense_counts']}, expected {dense_want}")
    d = r0["d"]
    nbytes = 60 * d * 4
    log(f"mesh (a): sharded ResNet-10 x 60 (d = {d:,}) on 2 gloo ranks "
        f"sharing cuda:0 equals the one-process dense round bit for bit "
        f"in {MESH_TURNS} turns (agg norms {r0['agg_norms'][0]} vs "
        f"{r0['agg_norms'][1]}); launches per rank "
        + "; ".join(f"rank {r}: {res['counts']} ({res['maps']})"
                    for r, res in enumerate(a)) + f" [{card}]")
    log(f"mesh (a): rounds/s in turns, dense / sharded: "
        + ", ".join(f"{MESH_ROUNDS / ds:.4f} / {MESH_ROUNDS / ss:.4f}"
                    for ds, ss in zip(r0["dense_s"], r0["sharded_s"]))
        + f" (rank 1: {MESH_ROUNDS / a[1]['sharded_s'][-1]:.4f}); "
        f"the gather: {nbytes:,} bytes out on every rank ({nbytes // 2:,} "
        f"from the other rank), {r0['gather_ms']:.3f} / "
        f"{a[1]['gather_ms']:.3f} ms (one run after a warm-up, gloo through "
        f"the host, two ranks on one card: not an NCCL or multi-GPU number) "
        f"[{card}]")

    # (b) the hierarchical round.
    h0 = b[0]
    for key in ("b1", "b2", "nnm2"):
        for r, res in enumerate(b):
            h = res[key]
            check(h["counts"] == want and h["finite"]
                  and all(math.isfinite(v) for v in h["losses"]),
                  f"mesh (b) {key} rank {r}: launches {h['counts']}, "
                  f"expected {want}; finite {h['finite']}, losses "
                  f"{h['losses']}")
            check(h["digest"] == h0[key]["digest"], f"mesh (b) {key}: rank "
                  f"{r}'s parameters differ from rank 0's")
            check(all(x == h["model_bytes"] for x in h["ici_bytes"]),
                  f"mesh (b) {key} rank {r}: ici_bytes {h['ici_bytes']}, "
                  f"the comm model {h['model_bytes']}")
    check(h0["b1"]["same"], f"mesh (b): hier at bucket_size 1 differs from "
          f"the dense round (max abs err {h0['b1']['err']})")
    check(h0["b1"]["kept"] == h0["nnm2"]["kept"] == [60] * MESH_ROUNDS
          and h0["b2"]["kept"] == [30] * MESH_ROUNDS,
          f"mesh (b): preagg_kept {h0['b1']['kept']} / {h0['b2']['kept']} "
          f"/ {h0['nnm2']['kept']}")
    log(f"mesh (b): hier on a (2, 2) mesh of 4 gloo ranks sharing cuda:0: "
        f"bucket_size 1 equals the dense round bit for bit; bucket_size 2 "
        f"keeps {h0['b2']['kept'][0]} rows, ici_bytes "
        f"{h0['b2']['ici_bytes'][0]:,} = hier_wire_bytes(hier_round_volumes)"
        f" (bucket_size 1: {h0['b1']['ici_bytes'][0]:,}); train_loss "
        f"{h0['b2']['losses']}; {MESH_ROUNDS / h0['b1']['train_s']:.4f} / "
        f"{MESH_ROUNDS / h0['b2']['train_s']:.4f} rounds/s on rank 0 "
        f"(four ranks on one card) [{card}]")
    pm = h0["preagg_ms"]
    log(f"mesh (b): nnm at bucket_size 2 keeps {h0['nnm2']['kept'][0]} "
        f"rows, ici_bytes {h0['nnm2']['ici_bytes'][0]:,} = the comm "
        f"model's; train_loss {h0['nnm2']['losses']}; "
        f"{MESH_ROUNDS / h0['nnm2']['train_s']:.4f} rounds/s on rank 0; "
        f"the pre-aggregation alone on a rank's (30, {d:,}) f32 block at "
        f"bucket_size 2: bucket {pm['bucket']:.3f} ms, nnm {pm['nnm']:.3f} "
        f"ms (median of 3, rank 0, the other ranks idle) [{card}]")

    # (c) one NCCL rank.
    c0 = c[0]
    check(c0["backend"] == "nccl" and c0["same"],
          f"mesh (c): backend {c0['backend']}, the NCCL rank's sharded_step "
          f"differs from the dense round (max abs err {c0['err']})")
    check(c0["counts"] == {"column_median": MESH_ROUNDS,
                           **{k: 2 * MESH_ROUNDS * MESH_BN_ROUND
                              for k in BN_TPU}},
          f"mesh (c): launches {c0['counts']}")
    log(f"mesh (c): sharded_step on one NCCL rank equals the dense round "
        f"bit for bit; launches {c0['counts']} [{card}]")
    gcounts, grecords = _mesh_gossip_checks(g, e[0], card)
    _mesh_autotune_checks(f, card)
    counts = {"column_median:mesh": r0["counts"]["column_median"],
              **{f"{k}:mesh": r0["counts"][k] for k in BN_TPU}, **gcounts}
    return counts, {**r0["records"], **grecords}


def _forged_classes(mask, malicious):
    """A selection with the forged lanes taken as one class (they carry one
    identical row, so which of them a tie-break picks is not a choice
    between updates): the benign lanes picked, and how many forged."""
    return ([i for i, (s, m) in enumerate(zip(mask, malicious))
             if s and not m], sum(1 for s, m in zip(mask, malicious)
                                  if s and m))


def phase_dsharded(card):
    """The width-sharded round through ``FedavgConfig`` -> ``Fedavg.train()``
    (``execution="dsharded"``): (a) the mesh example's three points at full
    ResNet-18 width, 64 clients (16 ALIE, 8 elided a rank) on 2 gloo ranks
    sharing cuda:0, one dispatch of 2 rounds each, in turns with the
    one-process dense round on the elision-ordered federation (Median bit
    for bit or within ``RTOL`` / ``ATOL``, the phase says which; Multikrum
    the same selected clients, Signguard the same survivors, the ALIE
    lanes' identical forged rows taken as one client; every aggregator's
    round-1 aggregate within ``RTOL`` / ``ATOL``); (b) a group of one NCCL
    rank in this process through ``dsharded_step`` at 256 clients, 64
    elided, under Median, the dense round bit for bit.  Every select and
    BN launch of (a)'s Median turn and of (b) held against the plain
    versions; the launches per rank and round derived from the model.  The ranks' results go to
    ``chiprun_out/dsharded.json`` before they are checked."""
    import gc

    import numpy as np
    import torch

    from blades_tpu_torch.ops import _cuda
    from blades_tpu_torch.parallel import elision_client_order

    _cuda.build()  # the ranks load this build
    _cuda.library()
    work = _work_dir("dsharded")
    t0 = time.perf_counter()
    a = _mesh_wait(_mesh_start("dsharded", 2, "gloo", work))
    log(f"dsharded (a): 2 gloo ranks in {time.perf_counter() - t0:.1f} s "
        f"(a rank's start to its group {a[0]['setup_s']:.1f} s, its turns "
        f"and audits {a[0]['part_s']:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    b = _dsharded_here(work)
    log(f"dsharded (b): a group of one NCCL rank in this process, "
        f"{time.perf_counter() - t0:.1f} s (the process held "
        f"{held / 2**30:.2f} GiB before, inside its peaks)")
    with open(os.path.join(HERE, "chiprun_out", "dsharded.json"), "w") as fh:
        json.dump({"a": a, "b": b}, fh, default=str)

    # (a) the three aggregators on 2 gloo ranks.
    cut = DSHARDED_CUT
    k, n, f = 2, cut["num_clients"], cut["num_malicious_clients"]
    mal = [bool(v) for v in (np.arange(n) < f)[elision_client_order(n, f,
                                                                     k)]]
    check(sorted(a[0]) == sorted(DSHARDED_AGGS + ("setup_s", "part_s")),
          f"dsharded (a): the example's points {sorted(a[0])}")
    med = a[0]["Median"]
    layers = med["bn_layers"]
    blocks = -(-(n // k - f // k) // cut["client_block"])
    dense_blocks = -(-n // cut["client_block"])
    bn_round = layers * blocks  # one local step
    for agg in DSHARDED_AGGS:
        r0, dense = a[0][agg], a[0][agg]["dense"]
        if agg == "Median":
            ok = r0["same"] or r0["close"]
            held = ("bit for bit" if r0["same"] else
                    f"within rtol {RTOL} / atol {ATOL} (max abs err "
                    f"{r0['err']:.3e}), not bit for bit")
        else:
            mine = [_forged_classes(m, mal) for m in r0["masks"]]
            want = [_forged_classes(m, mal) for m in dense["masks"]]
            # The selections of both rounds here, and round 1's aggregate
            # below: round 2 trains from round 1's parameters in bf16,
            # which can widen a forged row's last-ulp difference (the
            # card's column sums are not width-invariant) past RTOL / ATOL.
            ok = mine == want and len(mine) == DSHARDED_ROUNDS
            picked = [[i for i, v in enumerate(m) if v] for m in r0["masks"]]
            dense_picked = [[i for i, v in enumerate(m) if v]
                            for m in dense["masks"]]
            lanes = ("equal" if picked == dense_picked else
                     f"{picked} against the dense round's {dense_picked}")
            held = (f"{'the same' if mine == want else 'OTHER'} "
                    f"{'selected clients' if agg == 'Multikrum' else 'mask'}"
                    f" (benign / forged lanes kept a round "
                    f"{[(len(b), fk) for b, fk in mine]}; the lanes "
                    f"{lanes}); parameters "
                    f"{'within' if r0['close'] else 'not within'} rtol "
                    f"{RTOL} / atol {ATOL} after 2 rounds (max abs err "
                    f"{r0['err']:.3e})")
        rounds = "; ".join(
            f"round {i + 1} "
            f"{'bit for bit' if same else 'within' if near else 'NOT within'}"
            f" (max abs err {err:.3e})"
            for i, (err, near, same) in enumerate(r0["agg_rounds"]))
        held += f"; the aggregate: {rounds}"
        log(f"dsharded (a) {agg}: ResNet-18 x {n} (d = {med['d']:,}, {f} "
            f"ALIE, {f // k} elided a rank) on 2 gloo ranks sharing cuda:0 "
            f"against the one-process dense round on the elision-ordered "
            f"federation: {held}; agg norm {r0['row']['agg_norm']} vs "
            f"{dense['agg_norm']}; rounds/s dsharded "
            f"{DSHARDED_ROUNDS / r0['s']:.4f} (rank 1 "
            f"{DSHARDED_ROUNDS / a[1][agg]['s']:.4f}) / dense "
            f"{DSHARDED_ROUNDS / dense['s']:.4f}; peak "
            f"{r0['peak'] / 2**30:.2f} / {a[1][agg]['peak'] / 2**30:.2f} "
            f"GiB a rank, dense {dense['peak'] / 2**30:.2f} GiB; launches a "
            f"rank {r0['counts']} [{card}]")
        check(ok and len(r0["agg_rounds"]) == DSHARDED_ROUNDS
              and r0["agg_rounds"][0][1],
              f"dsharded (a) {agg} differs from the dense round: {held}")
        want_counts = {kk: DSHARDED_ROUNDS * bn_round for kk in BN_TPU}
        dense_want = {kk: DSHARDED_ROUNDS * layers * dense_blocks
                      for kk in BN_TPU}
        if agg == "Median":
            want_counts["column_median"] = DSHARDED_ROUNDS
            dense_want["column_median"] = DSHARDED_ROUNDS
        check(dense["counts"] == dense_want, f"dsharded (a) {agg}: dense "
              f"launches {dense['counts']}, expected {dense_want}")
        for r, res in enumerate(a):
            x = res[agg]
            check(x["counts"] == want_counts, f"dsharded (a) {agg} rank {r}: "
                  f"launches {x['counts']}, expected {want_counts}")
            check(x["digest"] == r0["digest"], f"dsharded (a) {agg}: rank "
                  f"{r}'s parameters differ from rank 0's")
            check(x["order_ok"] and x["f_local"] == f // k
                  and x["row"].get("elided_lanes") == f
                  and x["row"].get("round_ok") is True
                  and x["row"].get("num_unhealthy") == 0
                  and math.isfinite(x["row"]["train_loss"]),
                  f"dsharded (a) {agg} rank {r}: layout / row {x['row']}")
            if agg == "Median":
                check(x["maps"].get("column_median/select:radix")
                      == DSHARDED_ROUNDS, f"dsharded (a) rank {r}: select "
                      f"routes {x['maps']}")
                check(x["audited"] == [DSHARDED_ROUNDS,
                                       2 * DSHARDED_ROUNDS * bn_round],
                      f"dsharded (a) rank {r}: audited {x['audited']}")
    rows = n // k
    out_bytes = rows * (med["d_pad"] // k) * 4 * (k - 1)
    swaps = [[round(ms, 3) for ms in x["Median"]["swap_ms"]] for x in a]
    check(all(len(ms) == DSHARDED_ROUNDS for ms in swaps),
          f"dsharded (a): swaps timed {swaps}")
    log(f"dsharded (a): the all-to-all: a rank's ({rows}, {med['d_pad']:,}) "
        f"f32 block -> its ({n}, {med['d_pad'] // k:,}) shard, {out_bytes:,} "
        f"bytes out and {out_bytes:,} in a rank; the Median turn's rounds' "
        f"swaps {swaps[0]} / {swaps[1]} ms a rank (timed in the round after "
        f"a barrier; gloo through the host, two ranks on one card: not an "
        f"NCCL or multi-GPU number); BN layouts {med['bn_lines']} [{card}]")

    # (b) one NCCL rank.
    nn, ff = DSHARDED_NCCL_CUT["num_clients"], DSHARDED_NCCL_CUT[
        "num_malicious_clients"]
    nb = b["bn_layers"] * -(-(nn - ff) // DSHARDED_NCCL_CUT["client_block"])
    want_b = {"column_median": 1, **{kk: nb for kk in BN_TPU}}
    log(f"dsharded (b): dsharded_step on one NCCL rank, ResNet-18 x {nn} "
        f"({ff} elided) against the one-process dense round: "
        f"{'bit for bit' if b['same'] else 'DIFFERS'} (max abs err "
        f"{b['err']:.3e}); launches {b['counts']} (dense "
        f"{b['dense_counts']}); peak {b['peak'] / 2**30:.2f} GiB (dense "
        f"{b['dense_peak'] / 2**30:.2f} GiB); round {b['s']:.3f} s (dense "
        f"{b['dense_s']:.3f} s) [{card}]")
    check(b["backend"] == "nccl" and b["same"] and b["f_local"] == ff
          and b["elided"] == ff, f"dsharded (b): backend {b['backend']}, "
          f"f_local {b['f_local']}, the NCCL rank's dsharded_step differs "
          f"from the dense round (max abs err {b['err']})")
    check(b["counts"] == want_b, f"dsharded (b): launches {b['counts']}, "
          f"expected {want_b}")
    check(list(b["audited"]) == [1, 2 * nb], f"dsharded (b): audited "
          f"{b['audited']}")

    # Every point's recorder against the comm model.
    from blades_tpu_torch.parallel.comm_model import (
        H100_NVLINK_BYTES_PER_SEC,
        dsharded_round_volumes,
        hier_wire_bytes,
        project_multichip_rounds_per_sec,
    )

    def model(cfg, n_, d_, k_):
        vols = dsharded_round_volumes(
            n_, d_, k_, aggregator=cfg["server_config"]["aggregator"]["type"],
            adversary=cfg["adversary_config"]["type"],
            health_check=bool(cfg.get("health_check")))
        return vols, [[v.label, v.kind, v.payload_bytes, k_] for v in vols
                      for _ in range(v.count)]

    points = _dsharded_trials(cut)
    for agg in DSHARDED_AGGS:
        vols, want = model(points[agg], n, a[0][agg]["d"], k)
        for r, res in enumerate(a):
            got = [list(e) for e in res[agg]["events"]]
            check(got == want and res[agg]["ici_bytes"] == hier_wire_bytes(
                [(v, k) for v in vols]), f"dsharded (a) {agg} rank {r}: "
                f"recorder {res[agg]['events']} against the model {want}")
        log(f"dsharded (a) {agg}: each rank's recorder equals "
            f"dsharded_round_volumes event by event: "
            f"{[(v.label, v.kind, v.payload_bytes, v.count) for v in vols]}, "
            f"{a[0][agg]['ici_bytes']:,} wire bytes a rank a round")
    vols, want = model(_dsharded_trials(DSHARDED_NCCL_CUT)["Median"], nn,
                       a[0]["Median"]["d"], 1)
    check([list(e) for e in b["events"]] == want, f"dsharded (b): "
          f"recorder {b['events']} against the model {want}")
    log(f"dsharded (b): the recorder equals dsharded_round_volumes on a ring "
        f"of one ({len(b['events'])} collectives, 0 wire bytes)")
    proj = project_multichip_rounds_per_sec(
        1.0 / b["s"], nn - ff, 1000, 8, a[0]["Median"]["d"],
        aggregator="Median", adversary="ALIE", num_malicious=250)
    log(f"dsharded projection (a model, not a measurement): ResNet-18 x 1000 "
        f"(250 ALIE) on 8 cards from (b)'s measured {1.0 / b['s']:.4f} "
        f"rounds/s over {nn - ff} trained lanes, at NVIDIA's H100 SXM "
        f"data-sheet NVLink figure {H100_NVLINK_BYTES_PER_SEC / 1e9:.0f} GB/s "
        f"one way (never measured here: one card): {proj['rounds_per_sec']} "
        f"rounds/s (compute {proj['t_compute_s']} s, wire {proj['t_ici_s']} "
        f"s, {proj['wire_bytes_per_chip']:,} bytes a card, dominant "
        f"{proj['dominant_collective']}, {proj['trained_lanes_per_chip']} "
        f"trained lanes a card)")
    counts = {"column_median:dsharded": med["counts"]["column_median"],
              "column_median:dsharded-nccl": b["counts"]["column_median"],
              **{f"{kk}:dsharded": med["counts"][kk] for kk in BN_TPU},
              **{f"{kk}:dsharded-nccl": b["counts"][kk] for kk in BN_TPU}}
    return counts, {**med["records"], **b["records"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                         f"{','.join(PHASES + EXTRA_PHASES)}")
    ap.add_argument("--port", default=HERE,
                    help="the directory holding the blades_tpu_torch "
                         "package to drive (default: beside this script); "
                         "another tree's, to time its kernels in the same "
                         "call")
    # One rank of the mesh phase (phase_mesh starts them).
    for flag, kind in (("--mesh-part", str), ("--mesh-rank", int),
                       ("--mesh-world", int), ("--mesh-url", str),
                       ("--mesh-backend", str), ("--mesh-out", str)):
        ap.add_argument(flag, type=kind, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mesh_part is not None:
        return _mesh_rank_main(args)
    MESH_PORT.append(os.path.abspath(args.port))
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.port))
    try:
        import blades_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    # Full f32 where f32 is asked for (cuDNN would take TF32 otherwise).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    LOG_FILE.append(open(os.path.join(out_dir, "chip_smoke.log"), "w"))
    card = smi()
    log(f"card: {card}")
    records = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    # Every phase's drivers share the datasets built before them.
    datasets = contextlib.ExitStack()
    try:
        datasets.enter_context(_shared_datasets(keep=SHARED_DATASETS))
        if "build" in phases:
            run("build", phase_build)
        if "small" in phases:
            run("small", phase_small)
        if "kernels" in phases:
            records = run("kernels", phase_kernels)
        launches = {}
        if "main" in phases:
            launches.update(run("main", phase_main)[0])
        if "wide" in phases:
            counts, recs = run("wide", phase_wide, card)
            launches.update(counts)
            records.update(recs)
        if "full" in phases:
            launches.update(run("full", phase_full))
        if "aggregators" in phases:
            launches.update(run("aggregators", phase_aggregators))
        if "rowgeom" in phases:
            launches.update(run("rowgeom", phase_rowgeom))
        if "fedavg" in phases:
            launches.update(run("fedavg", phase_fedavg))
        for name, fn in (("chunked", phase_chunked), ("sweep", phase_sweep),
                         ("resnet34", phase_resnet34), ("cct", phase_cct),
                         ("wire", phase_wire), ("async", phase_async),
                         ("window", phase_window), ("obs", phase_obs),
                         ("gossip", phase_gossip), ("lanes", phase_lanes),
                         ("autotune", phase_autotune), ("mesh", phase_mesh),
                         ("dsharded", phase_dsharded)):
            if name in phases:
                counts, recs = run(name, fn, card)
                launches.update(counts)
                records.update(recs)
        if "profile" in phases:
            run("profile", phase_profile, os.path.join(HERE, "chiprun_out"))
        if "bnstages" in phases:
            run("bnstages", phase_bnstages)
        if "ringsweep" in phases:
            run("ringsweep", phase_ringsweep,
                os.path.join(HERE, "chiprun_out"))
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        datasets.close()
    for name, r in records.items():
        r["launches"] = launches.get(name, 0)
    if set(PHASES) <= set(phases):
        missing = [n for n, r in records.items() if r["launches"] < 1]
        if missing:
            print(f"chip_smoke: FAILED: kernels never launched on their "
                  f"path: {missing}", file=sys.stderr)
            return 1
    kernels = {"kernels": list(records.values())}
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
