#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (difacto_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]...

Drives the port's serving and training paths (and the batch learners,
phase 14, the capacity tier and the durable training state, phase 15,
the serve lifecycle and the online loop, phase 16, the serving fleet,
phase 17, the fault points and tracers, phase 18, the examples'
(dp, fs) mesh, phase 19, multi-host training, phase 20, and the run-time
tracers of steps, copies, syncs and collectives, phase 21, checked
against the port's own static analyzer, phase 22) at the full
width
of examples/criteo_hashed.conf (FM, V_dim 16,
4,194,304 hashed rows: a 2.0 GiB fp32 table on the card), also streamed through the producer
threads and worker processes, from text and from the rec2 cache that
task=convert writes, and of examples/criteo_dict.conf (the
dictionary store at the JAX package's defaults), with random weights and
synthetic Criteo rows made from a seed, and holds the CUDA kernels (the
fused-row gather and the scatter with its FTRL/AdaGrad epilogue, and the
chunked FM backward) against their plain PyTorch versions. Phases:

1. the card's name and power limit; build the kernels with nvcc, one
   thread (and one nvcc) per source, all started together, and the
   native parsers with g++ beside them; with them each ``--parent``
   tree's ``gather_rows.cu`` and ``scatter_epilogue.cu``;
2. the gather kernel against ``gather_rows_ref`` on the card, byte for
   byte: full-width fp32, bf16 and int8 containers, u_cap 8 / 12288 /
   49152 with out-of-bounds pad lanes, and an all-OOB slot vector; then,
   in each container, rows of 16, 48, 128, 256, 512 and 1,040 bytes (1,
   3, 8, 16, 32 and 65 vectors) at the edges of the kernel's tiles and
   persistent grid (u of 1, a pass and a tile less one, exact and plus
   one, and one past the grid's depths: its stride + 1), an all-OOB
   vector, and ``out=`` as a slice at an offset inside a larger output;
3. ``task=pred``: write a seeded checkpoint with ``SlotStore.save``, open
   it with ``open_serving_store(device="cuda")``, score >= 20,000 rows in
   ``batch_size`` windows through the CLI's pred loop, check them against
   a float64 numpy FM over the logical arrays (1e-4), score again
   (bit-identical), and count the kernel's launches;
4. ``task=serve``: the port's ServeServer over the same store answers a
   pipelined window of rows that straddles two pred windows, equal to the
   pred file's probability column; ``#health`` answers ready;
5. the gather's device time (torch.profiler) at the main path's own slot
   vectors, its bound, the plain version's time and one
   ``torch.index_select`` as a yardstick; the same in seeded bf16 and
   int8 tables of the main path's geometry. In each, with ``--parent
   DIR``, each tree's ``gather_rows.cu`` is timed in turns with this
   tree's kernel on the same slot vectors (parents, this, this, parents),
   and both again on 8-row vectors (5 real rows, 3 pads), the floor
   beside each bound;
6. the scatter kernel against ``fm_update_rows_ref`` / ``scatter_rows_ref``
   on the card, byte for byte, epilogue on and off: fp32, bf16, int8 and
   fp8 containers; the in-pad layout, the appended layout with its gap
   lanes (the main path's full-width [4,194,304 x 128] fp32 table) and
   the appended V_dim 64 layout; at the edges of the kernel's tiles and
   persistent grid: u_cap 8 with 5 and with 1 real row, 12288 and 12301
   with 11,692 real (a real/pad boundary inside a tile, u_cap not a
   multiple of the tile), 49152 with 40,000 real (more than one pass of
   the grid), and all-OOB vectors of 12288 and 49152 (table unchanged);
7. ``task=train`` through the port's learner at full width: 50,000
   synthetic train and 10,000 validation rows, 2 epochs, ``has_aux=1
   model_out=...``, the replay cache at its default budget (epoch 0
   streams and stages, epoch 1 replays). The objective per row falls
   from epoch 0 to 1; the launch counts match the batches (one gather
   and one scatter per step, one more of each per epoch-0 batch for the
   count push, one gather per validation block and epoch); a second run
   leaves a bit-identical table, and a third with the kernels swapped
   for their plain versions the same table again; each epoch's wall
   time; the saved model scored through phase 3's pred path is within
   1e-4 of a float64 numpy FM over the saved arrays;
8. a streamed and a replayed train step's host wall time, device busy
   time, idle share, device events per step and top device entries
   (torch.profiler over 5 steps), and the scatter kernel's device time
   on both routes at the main path's own slot vectors on the trained
   table: epilogue on (the push) beside its bound, the plain version and
   one ``index_copy_`` of the precomputed new rows; epilogue off (the
   epoch-0 count push) beside its bound, the plain version and
   ``index_copy_`` of the in-bounds rows, which computes the same
   function. The timing loop cycles 5 payloads, more than the L2 holds;
   the push is timed L2-warm as well (one payload repeated), and in
   bf16, int8 and fp8 tables of the same shape. With ``--parent DIR`` (a
   checkout of another commit, e.g. unpacked with ``git archive`` under
   the ignored ``difacto_tpu_torch/_build/``), that tree's
   ``scatter_epilogue.cu`` (phase 1) is timed in turns with this one on
   the same inputs (parent, this, this, parent); the flag may be given
   more than once, each tree named by its directory;
9. ``task=train`` at the JAX package's defaults on the dictionary store
   at the full width of examples/criteo_dict.conf (no ``hash_capacity``,
   ``device_cache_mb`` 2048, ``shuffle`` 10, flat: ``mesh_dp=1
   mesh_fs=1``, as every phase but 19 runs the confs): 150,000
   train and 10,000 validation rows, 3 epochs. The table grows from
   16,384 rows at least 4 times while the cache stages, and the staged
   slot pads are rewritten before epoch 1 replays; the objective per row
   falls every epoch; the replayed epochs make no host-to-device copy
   (torch.profiler); the launches match the batches; a second run and a
   run on the plain versions leave the same table and key map bit for
   bit; each epoch's wall time; the saved dictionary model scored by
   ``task=pred`` is within 1e-4 of a float64 FM over its arrays and keys;
10. a short V_dim 16 dictionary run from 1,024 rows with
    ``pad_v_rows_max_mb=1``: its growth crosses the padded layout's limit
    at 2,048 rows and the rows are laid out anew; the same table bit for
    bit on the plain versions;
11. examples/local.conf (logistic regression on the flat V_dim=0 table,
    the dictionary store): the objective falls over 5 epochs and
    ``task=pred`` of the saved model is within 1e-4 of a float64 model;
12. the streamed pipeline at the full width of examples/criteo_hashed.conf
    with ``device_cache_mb=0`` (phase 7's 50,000 train and 10,000
    validation rows, 2 epochs, both streamed): (a) one producer thread,
    (f) four threads, (b) four worker processes over the shared-memory
    ring with ``device_dedup=1`` (engaged in epoch 1), (c) four threads
    with ``stream_chunks=1``, twice, (d) run (b) on the plain versions,
    (e) run (b) with ``ckpt_interval=1 ckpt_keep=2 metrics_path=...``
    stopped after epoch 0 and rerun with ``auto_resume=1``. Runs (f),
    (b), (d) and the resumed (e) leave (a)'s table bit for bit, (c)
    agrees with (a) within 2e-5 and repeats bit for bit; each run's
    launches match its batches; (b) reports ``producer_mode=process``
    and no ring segment is left in /dev/shm; the metrics JSONL holds
    every ``stage_seconds_total`` stage; (a)'s saved model scores within
    1e-4 of a float64 FM. (g) the defaults (``producer_mode`` and
    ``num_producers`` unset): process mode on a host with at least 4
    cores, (a)'s table bit for bit; with ``--parent DIR`` each tree's
    learner trains the same run in its own interpreter, in turns with
    this tree's (parents, this, this, parents). Each run's epoch wall
    times and ``stage_stats()`` are printed, and the producers' own rate
    without a step behind them (one thread, four threads, four
    processes: the seconds to the first batch and to the last);
13. the rec2 cache at the same width: ``python -m difacto_tpu_torch
    task=convert`` writes phase 12's train and validation rows as
    1,000-row pre-localized members (serially, and the train rows again
    with ``convert_procs`` at auto), its rows/s logged; the native
    parsers (built with g++ in phase 1) must have loaded. 2 epochs train
    from the cache: (h) four producer threads and (i) four worker
    processes (``device_cache_mb=0``, 10 parts, shuffle 10), (j) rec2
    and (k) text at one part with shuffle 0, (l) the defaults with the
    replay cache, again, and on the plain versions. (i) leaves (h)'s
    table, (k) (j)'s and the (l) runs each other's, bit for bit; each
    run's launches match its batches; the gather and both push routes
    equal their plain versions byte for byte on the slot vectors the
    cache path packs; (l)'s model scored by ``task=pred`` from the
    validation cache is within 1e-4 of a float64 FM, and ``task=dump``
    writes one line per live row. The parse and pack stages per batch
    are printed for rec2 and (from phase 12) for text on each transport;
14. the batch learners on the card (TF32 must be off): (a)
    ``python -m difacto_tpu_torch examples/bcd.conf`` and
    ``examples/lbfgs.conf`` as they are, on the default device: BCD at the
    reference's optimum (objective summed over rcv1's 100 rows within
    1e-3 relative of 15.884923, 47 nonzeros), L-BFGS's 19 objectives
    within 1e-5 of the reference's; (b) BCD's diag-Newton run within
    1e-5 relative and L-BFGS with V (V_dim 5, the reference's
    deterministic init) within 2e-4 of their goldens, through
    ``Learner.create``; (c) at full width, phase 12's 50,000 train and
    10,000 validation rows (the same fields, labelled from a planted
    model of two fields, so that a validation AUC means something) in 5
    training tiles: BCD with examples/bcd.conf's learner keys, 3 epochs,
    and L-BFGS as an FM (``V_dim 16 l2 0.1 V_l2 0.01 m 5``), 5 epochs.
    Each: the objective falls (BCD's training loss + l1 |w|_1), the
    validation AUC exceeds 0.5, a second run and a run whose tile cache
    evicts (BCD: 2 slices, 1 MB; L-BFGS: 1 MB) give the same progress
    and weights bit for bit, and the card's checkpoint warm-starts the
    same first epoch on the card and on the CPU within 1e-5 relative.
    Printed: blocks, tiles, N, per-epoch wall, median host ms per BCD
    block and per ``_calc_grad`` pass, device busy ms, idle share and the
    top device entries of one BCD epoch and one pass (torch.profiler),
    peak allocated memory. Neither kernel of the port launches;
15. the capacity tier and the durable training state at the width of
    phase 12, on its rows (four producer threads, ``device_cache_mb=0``,
    2 epochs): (m) ``cold_tier_rows`` leaving a 524,288-row device table
    (256 MiB of fp32 rows for the logical 4,194,304), with
    ``admit_min_count=2`` and ``evict_occupancy=0.05`` (evicting at epoch
    0's end): the tier's hit, miss, promote and demote counters, the
    evictions and the admission's drops above 0; the launches equal the
    steps plus the tier's own promote, demote and eviction calls; a
    second run and a run on the plain versions leave the same device
    table, residency maps, clock and host rows bit for bit; the gather and
    the scatter with its epilogue off equal their plain versions byte for
    byte on the padded slot vectors of the run's largest promote, demote
    and eviction; the saved model holds the logical rows and scores by
    ``task=pred`` within 1e-4 of a float64 FM; one int8 epoch on the
    kernels equals its run on the plain versions. Printed: the objective
    per epoch beside phase 12 (f)'s, the host ms per batch in
    ``route_payload``, the epoch walls and the peak allocated memory
    beside (f)'s. (n) ``wal_flush_batches=10 ckpt_interval=1 ckpt_keep=2``,
    two peer directories with ``replica_k=2`` and ``auto_resume=1``:
    phase 12 (f)'s table bit for bit, one gather more per flush, every
    segment verifies, ``Replicator.scrub`` repairs nothing. (o) run (n)
    again in a child ``python -m difacto_tpu_torch`` armed with
    ``DIFACTO_FAULTS=wal.append:kill`` at epoch 1's second window (after a
    wait, so its replica pushes have landed), its local directory deleted,
    then rerun with ``auto_resume=1``: the recovery stamp's rungs hold
    ``peer`` and ``wal`` with ``0 < skip_batches <= 10``, the launches
    match the resumed steps and the replayed segments, and the run ends
    on (n)'s table bit for bit; the recovery's seconds are printed.
16. the serve lifecycle and the online loop at the same width (a load
    generator in its own interpreter, ``chip_smoke.loadgen``, drives the
    server through ServeClients whose endpoint list starts with a dead
    port): (p) a ServeServer over phase 3's model (the task=serve
    defaults: batch 256, 2 ms, 1,024 queued rows; ``takeover`` on, a
    ModelReloader attached): the highest closed-loop row rate it
    sustains, then 50% of it offered open-loop: 10 s alone, a
    same-geometry ``#reload`` of a second model, a blue/green ``#reload``
    of a model at hash_capacity 2,097,152, ``run_takeover`` to a successor
    ``python -m difacto_tpu_torch task=serve`` on the same card and port,
    and a SIGTERM drain of the successor (exit 0). Every row answered
    once, no ``!err``, each answer the pred column of the model then
    serving; ``#metrics`` parses and agrees with ``#stats``;
    model_generation 1, 2, 3, then 1 on the successor; the gathers equal
    the dispatches plus the blue/green warm. Printed: the sustained rate,
    p50 and p99 at 50% (client clock and #stats), each swap's wall time
    and p99 inside it, the warm, the peak allocated memory, warm_s and
    takeover_gap_ms, the drain. (q) a ServeServer with an OnlineLog
    (1,000-row segments, ``label_delay_s`` 0.5, ``negative``) and an
    OnlineTrainer thread on the card pushing each committed generation
    (``online_ckpt_interval_s`` 2) as ``#reload``: >= 20,000 ``#score``
    rows with ``#label`` behind every other one, until the served
    generation advanced twice under load; after ``log.end``,
    ``task=online online_replay=1`` in a subprocess leaves the online
    final checkpoint byte for byte; the answers after the last reload
    equal ``task=pred`` of it; the launches equal the predicts, the
    training batches and segment 0's count pushes. Printed: a segment
    pass, a checkpoint, each reload push, ``train_behind_serve_s`` and
    ``online_rows_behind``.
17. the serving fleet at the same width, over phase 3's model: (r) two
    in-process ServeServers behind an in-process RouterServer, P2C and
    then ``balance=affinity`` with ``affinity_capacity`` 4,194,304 (the
    Criteo rows' leading key I1 puts them all on one owner) and with
    capacity 0 (the splitmix64 ring, which spreads them over both): 2,000
    rows through the router equal the pred column, ``#health`` shows
    both replicas ready, the ``#stats`` backends' rows sum to the rows
    sent and equal the router's ``#metrics``, each replica's
    ``#metrics`` agrees with its ``#stats``, the gathers equal the
    executors' dispatches, the affinity hits are live and on the ring
    both replicas get rows. Then every part in
    its own process: (s) two ``task=serve`` replicas and ``python -m
    difacto_tpu_torch.tools.fleet route`` routers; the closed-loop rate
    direct to one replica and through the router to one and to two;
    half the two-replica rate open-loop through the router while
    ``run_rolling_restart`` replaces both replicas with
    ``spawn_successor`` processes on the card (no ``!err``, no
    ``!shed``, every answer the pred column; p50/p99 before and inside
    the roll, each successor's warm_s). (t) two ``route --takeover``
    members on one port under ``python -m
    difacto_tpu_torch.tools.loadgen --endpoints`` (the port's
    ``run_loadgen_failover``): the member holding the client's
    connection is SIGKILLed, then ``run_router_group_roll`` replaces the
    group, no ``!err`` either time. (u) an Autoscaler (min 1, max 2, the
    load generator's p99 its latency signal) over one replica behind an
    in-process router at 1.5x that replica's closed-loop rate: exactly
    one spawn of a ``task=serve`` process on the card, in the router's
    ``#stats`` and ``#metrics``, and once the load stops exactly one
    drain; no ``!err``; the seconds from the decision to the first row
    the new replica answers. nvidia-smi's per-process memory is sampled
    throughout and every child is reaped.
18. the last four fault points and the lock and race tracers, at the
    same width on phase 12's rows, each step printing one JSON line:
    (a) ``step.device:err@1:5`` raises ``FaultInjected`` at the sixth
    dispatched step, after exactly five steps' launches, and counts once
    into ``faults_fired_total``; (b) ``producer.part:err@1:3`` on one
    producer thread and on one worker process (through the inherited
    ``DIFACTO_FAULTS``): the failed parts are retried and the table
    equals phase 12 run (a)'s bit for bit; (c) ``ckpt.write:kill@1:1``
    in a ``task=train`` subprocess tears epoch 1's checkpoint and dies,
    ``auto_resume`` walks past it to epoch 0 and saves run (a)'s model,
    which ``task=pred`` scores, and ``ckpt.read:err@1`` on a load raises
    typed; (d) two train epochs and a 1,000-row served window (with an
    online log and a shedding burst) in a subprocess with
    ``DIFACTO_LOCKTRACE=1 DIFACTO_RACETRACE=1``: every observed lock
    edge is in the static graph of ``difacto_tpu_torch/utils/
    lockorder.json`` (the repo's analyzer over the port, cycle-free, kept
    current by tests/test_torch_lint.py), every shared field is known
    safe and every race alarm suppressed; the traced epochs' wall times
    beside the same epochs untraced in a subprocess of their own; (e)
    where fsspec imports, one epoch from a ``memory://`` text part and
    from a ``memory://`` rec2 cache into a ``memory://`` model, and pred
    from it: tables and predictions equal the local runs' byte for byte
    (without fsspec one line says it was not run).
19. the examples' single-process (dp, fs) mesh on the card, run right
    after phase 8 under ``DIFACTO_TORCH_VIRTUAL_DEVICES=8`` (eight logical
    devices on the one card, set for these runs only): (a)
    examples/criteo_hashed.conf as written (``mesh_dp=2 mesh_fs=4``) on
    phase 7's rows, 2 epochs at the default ``device_cache_mb``: the
    objective per row falls and each epoch's is within 1e-5 relative of
    phase 7's flat run; the launches equal the non-empty shard runs the
    routing asked for (printed beside phase 7's); a repeat run leaves the
    table bit for bit; a replayed step's wall, busy time, idle share and
    device events beside phase 8's flat step. (b) ``mesh_dp=1
    mesh_fs=4`` and ``mesh_force=1`` at 1 x 1 leave phase 7's table bit
    for bit. (c) (a)'s model, saved per key range (``_fs-<i>-of-4``
    members and the stub), scored by ``task=pred`` at ``serve_mesh_fs``
    4 and 1 and under the conf's mesh keys: three byte-identical files
    within 1e-4 of a float64 FM; ``task=serve`` at ``serve_mesh_fs=4``
    answers a window equal to that pred column. (d)
    examples/criteo_dict.conf on its 2 x 4 mesh on the same rows: the
    dictionary grows (each capacity a multiple of 4), a repeat run is
    bit-identical (table and keys), and with ``device_cache_mb=0`` on
    both each epoch is within 1e-5 of its flat run. (e) BCD
    (examples/bcd.conf) at ``mesh_dp=4`` at the reference's optimum,
    L-BFGS at ``mesh_fs=4`` (linear and FM with V) at the goldens, each
    beside its flat run. (f) ``capacity_scaling_report`` at fs 1, 2 and
    4 at the conf's geometry (the fs=4 leg is its 4,194,304-row table at
    V_dim 16, batches of 1,000 rows of 39 features, 50 timed steps).
    (g) each shard's gather and push device time at (a)'s staged slot
    vectors, beside the flat kernel's on the same vectors; with
    ``--parent DIR`` each tree's ``gather_rows.cu`` is timed in turns
    with this tree's on the shards', the routed and the flat pulls. (h)
    (a)'s table placed: each logical device's bytes read from its
    shard's own allocations (4,194,304 / 4 rows each at full width), no
    other tensor of the table's rows on the card, the peak allocated over
    run (a) beside the table's bytes, and the bytes copied between
    logical devices per replayed step (utils/collscan, kind
    ``device_copy``) with that step's busy time.
20. multi-host training, run right after phase 19: ``launch.py -n 2``
    (unedited) starts two ranks of the port's CLI entry point on the one
    card, ``DIFACTO_TORCH_VIRTUAL_DEVICES=4`` each, so the conf's 2 x 4
    mesh has dp across the ranks and fs = 4 inside each; both planes run
    over gloo (ranks that share a card cannot use NCCL). (a') the conf
    unshuffled in one part, rank 0 on 25,000 of phase 7's rows and rank 1
    on the same rows permuted: each epoch's loss per row within 2e-4
    relative of one process over the same global batches (interleaved at
    twice the batch size). (a) examples/criteo_hashed.conf as written on
    phase 7's rows, 2 epochs, a checkpoint each epoch: the ranks' losses,
    tables and final and ``_iter-k`` parts equal bit for bit; the loss
    falls (beside phase 19's, whose steps hold half the rows); each rank's
    launches equal its routed shard runs; the control and data planes'
    bytes per step; a replayed step profiled on both ranks (wall, busy,
    idle, the data-plane gathers' share) beside phase 19's; each rank's
    routed gather and push against their plain versions at its own staged
    slot vectors; the card's memory.used with both replicas alive; a
    repeat run leaves (a)'s table. (b) ``--bounded-delay 4``: (a)'s table
    bit for bit and a non-zero ``push_delay_batches``. (c)
    ``--max-restarts 1`` with heartbeats: rank 1 SIGKILLed mid-epoch 1,
    launch.py relaunches one rank (``mesh_dp`` follows the rank count),
    which resumes from ``_iter-0`` and finishes; the seconds to recover.
    (d) BCD and L-BFGS on two ranks on rcv1 at the goldens. (e)
    ``bounded_delay_report`` at the conf's geometry (fs 4, 1,048,576 rows
    a shard, V_dim 16, 1,000 rows of 39 nonzeros a step).
21. the port's tracers (utils/devtrace.py, utils/collscan.py, the device
    annotations of obs/trace.py), run last, each leg in interpreters of
    its own with only its knobs set: (a) phase 3's pred and phase 4's
    server (three windows, then the same twice more) under
    ``DIFACTO_JAXTRACE=1``: the programs' signatures frozen after the warm
    windows (``devmap`` finds no unknown site, no undeclared copy and no
    signature after the warm-up), no undeclared CUDA sync under a serve
    dispatch (``torch.cuda.set_sync_debug_mode("warn")``, classified by
    stack), ``serve.scores`` once per pred window and dispatch, each
    kernel site's launches equal to ``gather_rows_cuda.launches``; (b)
    phase 7's replayed 2-epoch train traced and untraced: no signature
    new in epoch 1, the tables' digests and the losses equal, the
    launches phase 7's; both runs' epoch walls and every undeclared sync
    site of the train run with its count per step; (c) ``DIFACTO_TRACE``
    and ``DIFACTO_TRACE_DEVICE`` over 5,000 rows, 2 epochs (the second
    replayed): the exported Chrome trace holds the gather and the
    scatter kernels, each inside a range named after a span; (d)
    ``DIFACTO_HLOSCAN=1`` with ``DIFACTO_HLOSCAN_ROWS=4194304`` over
    phase 20 (a)'s ``launch.py -n 2`` for 1 epoch: no table-axis
    collective, each rank's scanned collectives and bytes equal its data
    plane's counters, the bytes a train step and the peak above entry
    per program printed, ``collmap --check`` exits 0.
22. the port's own analyzer (difacto_tpu_torch/analysis, stdlib ``ast``:
    the card machine has no jax), after phase 21: (a) ``python -m
    difacto_tpu_torch.analysis`` over ``difacto_tpu_torch/`` with no
    baseline gives 0 findings, with the findings per rule (all
    suppressed), each pass's seconds and the hot set's size printed; (b)
    its lock graph equals ``utils/lockorder.json``; (c) ``devmap --check``
    over phase 21's dumps of the serve dispatch, the train run and both
    ranks, and ``collmap --check`` over both ranks' scans, each merged
    with the static model (dynamic within static); (d) the port's
    ``lockmap --check`` over phase 18 (d)'s lock dump: no dynamic-only
    edge, no cycle; (e) the port's ``obs_report`` over phase 12 (e)'s
    ``metrics_path`` JSONL, one line each.
23. the chunked backward's kernel (``fm_chunk_grad.cu``, run right after
    phase 2) at the batches of the benchmark's two cells (65,536 rows of
    ``benchmark/traffic``'s Criteo mixes, V_dim 16 and 64, their chunked
    layouts built on the card): three calls bit for bit, within 1e-5 of
    each element's sum of magnitudes from its plain version, and its
    device time beside its bytes bound and the plain version's, two
    batches cycled.

Kernel times are device time from torch.profiler: the kernels' own
durations summed, without the host's launch gaps. A profile on the card
now and then loses device events, so a timed profile is kept only when it
holds exactly ``rounds`` times the events of a one-pass profile.

Prints the whole smoke's wall time, one JSON line of kernel numbers (the
scatter's two routes as two entries, the chunked backward one a cell
with the launches of the whole process; otherwise launches summed over the main
paths of phases 3, 4, 7, 9, 10, 12, 13, 15, 16, 17 (r), 18 (a) and
(b), 19 (a), (c) and (d), 20 (a) on both ranks and 21 (a), (b) and (d),
each counted from 0 just before its own run), then, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when there is no CUDA device, when the port is not beside it, or when any
phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

SEED = 20240613
CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "examples", "criteo_hashed.conf")
N_ROWS = 20_000
N_TRAIN, N_VAL = 50_000, 10_000
DICT_CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "examples", "criteo_dict.conf")
N_DICT_TRAIN, N_DICT_EPOCHS = 150_000, 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published HBM3 rate
KERNELS = {                 # library: source
    "gather_rows": "difacto_tpu_torch/ops/csrc/gather_rows.cu",
    "scatter_epilogue": "difacto_tpu_torch/ops/csrc/scatter_epilogue.cu",
    "fm_chunk_grad": "difacto_tpu_torch/ops/csrc/fm_chunk_grad.cu",
}
# the kernels line: entry -> (library, the TPU kernel it replaces)
ENTRIES = {
    "gather_rows": ("gather_rows", "difacto_tpu/ops/fused.py:254"),
    "scatter_epilogue": ("scatter_epilogue", "difacto_tpu/ops/fused.py:337"),
    "scatter_epilogue_off": ("scatter_epilogue",
                             "difacto_tpu/ops/fused.py:300"),
    "fm_chunk_grad": ("fm_chunk_grad",
                      "none (jnp: difacto_tpu/losses/fm.py:167)"),
}
DEV = "cuda"                # "cpu" only in a rehearsal off the card
T_START = 0.0


def sync() -> None:
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ data
def synthetic_model(C: int, k: int, seed: int) -> dict:
    """Logical arrays of a trained-looking hashed FM: ~30% of w zeroed
    (l1), ~half the embeddings live."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(C) * 0.05).astype(np.float32)
    w[rng.rand(C) < 0.3] = 0.0
    w[0] = 0.0                                   # the trash row
    return {"w": w,
            "cnt": rng.randint(0, 100, C).astype(np.float32),
            "v_live": rng.rand(C) < 0.5,
            "V": ((rng.rand(C, k) - 0.5) * 0.2).astype(np.float32)}


def synthetic_criteo(n: int, seed: int, planted: bool = False) -> bytes:
    """Criteo-format text: label, 13 integer fields, 26 categorical hex
    fields; zipf-distributed values, ~2% empty fields. The labels are
    Bernoulli(0.25) draws independent of the fields, or with ``planted``
    (the same rows) draws from a planted logistic model of two fields,
    which a learner can find."""
    rng = np.random.RandomState(seed)
    ints = np.minimum(rng.zipf(1.5, (n, 13)), 10 ** 6) - 1
    cats = np.minimum(rng.zipf(1.2, (n, 26)), 1 << 24) \
        + np.arange(26) * (1 << 25)
    empty = rng.rand(n, 39) < 0.02
    labels = (rng.rand(n) < 0.25).astype(int)
    if planted:
        score = 1.5 * (cats[:, 0] % 4 == 0) + (ints[:, 1] % 3 == 0) - 1.8
        labels = (rng.rand(n) < 1 / (1 + np.exp(-score))).astype(int)
    lines = []
    for i in range(n):
        f = [str(v) for v in ints[i]] + [format(v, "08x") for v in cats[i]]
        f = ["" if e else s for s, e in zip(f, empty[i])]
        lines.append(str(labels[i]) + "\t" + "\t".join(f))
    return ("\n".join(lines) + "\n").encode()


def reference_margins(text: bytes, arrays: dict, hash_capacity: int = 0,
                      keys=None, data_format: str = "criteo",
                      l1_shrk: bool = True) -> np.ndarray:
    """float64 numpy FM over the logical arrays, straight from the
    formula (the reference's fm_loss.h): every nonzero x of a row adds
    x w[slot] to the linear term and x V[slot] (masked by live & w != 0)
    to the interaction. Slots are the hashed rule's (``hash_capacity``),
    or the row of the id in a dictionary model's sorted ``keys`` (an id
    the model does not hold adds nothing). A flat model has no V."""
    from difacto_tpu_torch.base import reverse_bytes
    from difacto_tpu_torch.data.parsers import parse_criteo, parse_libsvm
    from difacto_tpu_torch.store.local import hash_slots
    blk = (parse_criteo if data_format == "criteo" else parse_libsvm)(text)
    rev = reverse_bytes(blk.index)
    if keys is None:
        slot = hash_slots(rev, hash_capacity)
    else:
        i = np.minimum(np.searchsorted(keys, rev), len(keys) - 1)
        slot = np.where(keys[i] == rev, i, len(keys))   # len: a zero row
        arrays = {f: np.concatenate([a, np.zeros((1,) + a.shape[1:],
                                                 a.dtype)])
                  for f, a in arrays.items()}
    x = blk.values_or_ones().astype(np.float64)
    row = np.repeat(np.arange(blk.size), np.diff(blk.offset))
    lin = np.bincount(row, weights=x * arrays["w"].astype(np.float64)[slot],
                      minlength=blk.size)
    V = arrays.get("V")
    if V is None or V.shape[1] == 0:
        return np.clip(lin, -20.0, 20.0)
    live = arrays["v_live"][slot]
    if l1_shrk:
        live = live & (arrays["w"][slot] != 0)
    xV = V.astype(np.float64)[slot] * (live * x)[:, None]
    XV = np.zeros((blk.size, V.shape[1]))
    XXVV = np.zeros_like(XV)
    np.add.at(XV, row, xV)
    np.add.at(XXVV, row, xV * xV)
    return np.clip(lin + 0.5 * (XV ** 2 - XXVV).sum(1), -20.0, 20.0)


# ------------------------------------------------------------ phases
def phase_card(parents: list, work: str):
    """The card's name and power limit; every kernel built at once, with
    the ``scatter_epilogue.cu`` and ``gather_rows.cu`` of each tree in
    ``parents``: returns the nvidia-smi line and {"scatter": {tree: its
    launch function}, "gather": {tree: its launch function}}."""
    import ctypes
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path
    from difacto_tpu_torch import native
    from difacto_tpu_torch.ops import build, fused
    names = {os.path.basename(os.path.normpath(d)): d for d in parents}
    if len(names) != len(parents) or set(names) & {"kernel"}:
        raise ValueError(f"--parent trees need distinct directory names "
                         f"other than 'kernel': {parents}")
    # (route, tree) -> its source, built beside this tree's own libraries
    extra = {}
    for n, d in names.items():
        extra[("scatter", n)] = Path(d) / KERNELS["scatter_epilogue"]
        extra[("gather", n)] = Path(d) / KERNELS["gather_rows"]

    def so(route, n):
        return Path(work) / f"{n}_{route}.so"

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(KERNELS) + len(extra) + 1) as pool:
        builds = [pool.submit(build.library, name) for name in KERNELS]
        builds.append(pool.submit(native.get_lib))
        others = {key: pool.submit(build.compile_source, src, so(*key))
                  for key, src in extra.items()}
        for b in builds:
            b.result()
        logs = {f"{n} {route}": f.result()
                for (route, n), f in others.items()}
    log(f"phase 1 ok: kernels (and the native parsers, g++) built in "
        f"{time.monotonic() - t0:.2f} s"
        + (f" (and the scatter_epilogue.cu and gather_rows.cu of "
           f"{', '.join(names)})" if names else ""))
    logs.update((name, build.build_log(name)) for name in KERNELS)
    for n, text in logs.items():
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  ptxas {n}: " + ln.strip())
    fns = {"scatter": {}, "gather": {}}
    for route, n in extra:
        lib = ctypes.CDLL(str(so(route, n)))
        if route == "scatter":
            fn = lib.difacto_scatter_epilogue
            fn.argtypes = fused.SCATTER_ARGTYPES
        else:
            fn = lib.difacto_gather_rows      # as ops/fused._gather_fn
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 \
                + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[route][n] = fn
    return line, fns


def _slot_vector(C: int, n_real: int, u: int, gen, dev):
    import torch
    from difacto_tpu_torch.store.local import pad_slots_oob
    real = torch.randperm(C, generator=gen, device=dev)[:n_real]
    real = torch.sort(real).values.to(torch.int32).cpu().numpy()
    return torch.from_numpy(pad_slots_oob(real, u, C)).to(dev)


def phase_kernel_vs_plain(C: int) -> float:
    """Byte-exact kernel vs plain gather; returns the max abs difference
    seen over the fp32 compares (0.0 when every byte agrees)."""
    import torch
    from difacto_tpu_torch.ops import fused
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    for name, bits, dt in (("fp32", torch.int32, torch.float32),
                           ("bf16", torch.int16, torch.bfloat16),
                           ("int8", torch.int8, torch.int8)):
        info = torch.iinfo(bits)
        table = torch.randint(info.min, info.max, (C, 128), dtype=bits,
                              generator=gen, device=dev).view(dt)
        cases = [(u, n) for u, n in ((8, 5), (12288, 9000), (49152, 40000),
                                     (12288, 0)) if n < C]
        for u, n_real in cases:
            slots = _slot_vector(C, n_real, u, gen, dev)
            got = fused.gather_rows(table, slots)
            want = fused.gather_rows_ref(table, slots)
            sync()
            same = torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            if dt == torch.float32:
                fin = torch.isfinite(got) & torch.isfinite(want)
                diff = (got[fin] - want[fin]).abs()
                worst = max(worst, float(diff.max()) if diff.numel() else 0.)
            log(f"  {name} C={C} u_cap={u} real={n_real}: "
                f"{'bit-exact' if same else 'MISMATCH'}")
            if not same:
                raise AssertionError(f"gather kernel != plain on {name} "
                                     f"u_cap={u}")
        del table
        n = gather_edge_cases(fused.gather_rows, dt, bits, gen, dev)
        log(f"  {name}: rows of {', '.join(map(str, GATHER_ROW_BYTES))} "
            f"bytes at the tiles' and the grid's edges, all-OOB vectors and "
            f"out= slices: {n} cases bit-exact")
    torch.cuda.empty_cache()
    log("phase 2 ok: gather kernel bit-exact with its plain version")
    return worst


# the benchmark's two cells: (name, traffic file, V_dim, fused row lanes)
CHUNK_GRAD_CELLS = (
    ("fm16.replay_b65k", "benchmark/traffic/replay_b65k_kaggle.json", 16,
     128),
    ("fm64.replay_b65k", "benchmark/traffic/replay_b65k_1tb.json", 64, 256))


def criteo_panel(traffic_path: str, B: int, seed: int, dev):
    """A staged replay batch of ``B`` rows of a traffic file's mix
    (benchmark/gen.py): each field's value is a key of its own, the lanes
    are the keys' sorted-unique positions, a row's tokens lead its panel
    row and its empty fields' cells trail as lane 0 with value 0, as the
    packer lays them; with its chunked-run layout built on the card.
    Returns (PanelBatch, u_cap)."""
    import torch
    from benchmark import gen
    from difacto_tpu_torch.ops.batch import PanelBatch, panel_chunk_tokens
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           traffic_path)) as f:
        rows = gen.make_rows(json.load(f), B, seed)
    ni = rows["ints"].shape[1]
    keys = np.concatenate([rows["ints"] + (np.arange(ni) << 40),
                           rows["cats"] + (ni << 40)], axis=1)
    full = ~rows["empty"]
    lanes = np.zeros(keys.shape, dtype=np.int64)
    uniq, inv = np.unique(keys[full], return_inverse=True)
    lanes[full] = inv
    lead = np.argsort(~full, axis=1, kind="stable")   # tokens first
    idx = np.take_along_axis(lanes, lead, axis=1).astype(np.int32)
    vals = np.take_along_axis(full, lead, axis=1).astype(np.float32)
    u_cap = -(-len(uniq) // 1024) * 1024
    t = functools.partial(torch.tensor, device=dev)
    pb = PanelBatch(idx=t(idx), vals=t(vals), labels=None, rweight=None,
                    row_mask=None, num_rows=t(B), num_uniq=t(len(uniq)))
    return panel_chunk_tokens(pb, u_cap), u_cap


def chunk_grad_bytes(pb, U: int, k: int) -> int:
    """Bytes the chunked backward needs: chunk_lane, the real chunks'
    (lane < U) chunk_idx and chunk_vals, p, XV, V and v_mask read once,
    gw and gV written once. The trailing pad chunks' slots are not read."""
    C, L = pb.chunk_idx.shape
    real = int((pb.chunk_lane < U).sum())
    B = pb.idx.shape[0]
    vals = 0 if pb.chunk_vals is None else real * L * 4
    return real * L * 4 + C * 4 + vals + B * 4 + B * k * 4 \
        + U * k * 4 + U * 4 + U * 4 + U * k * 4


def phase_chunk_grad() -> dict:
    """Phase 23: the chunked backward's kernel (csrc/fm_chunk_grad.cu) at
    the benchmark cells' batches, two staged batches a cell cycled so the
    chunk arrays come from HBM: against its plain version (within 1e-5 of
    each element's sum of magnitudes, three calls bit for bit, each a
    launch of the kernel entry), its device time beside its bytes bound
    and the plain version's. Returns {cell: numbers}."""
    import torch
    from difacto_tpu_torch.losses import FMParams, fm
    from difacto_tpu_torch.ops import fused
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for cell, traffic, k, lanes in CHUNK_GRAD_CELLS:
        args = []
        for b in range(2):
            pb, U = criteo_panel(traffic, 65536, SEED + b, dev)
            B = pb.idx.shape[0]
            rows = torch.randn((U, lanes), generator=gen, device=dev) * 0.1
            params = FMParams(
                w=torch.zeros(U, device=dev), V=rows[:, :k],
                v_mask=(torch.rand(U, generator=gen, device=dev)
                        < 0.9).float())
            sums = torch.randn((B, 1 + 2 * k), generator=gen, device=dev)
            p = torch.randn(B, generator=gen, device=dev) * 0.3
            args.append((params, pb, p, sums[:, 1:1 + k]))
        params, pb, p, xv = args[0]
        before = fused.fm_chunk_grad_cuda.launches
        runs = [fm._fm_grad_panel_chunked(params, pb, p, xv)
                for _ in range(3)]
        if fused.fm_chunk_grad_cuda.launches - before != len(runs):
            raise AssertionError(
                f"{cell}: {len(runs)} calls of the chunked backward "
                f"launched its kernel entry "
                f"{fused.fm_chunk_grad_cuda.launches - before} times")
        want = fm.fm_grad_panel_chunked_ref(params, pb, p, xv)
        cv = pb.chunk_vals
        scale = fm.fm_grad_panel_chunked_ref(
            params._replace(V=-params.V.abs()),
            pb._replace(chunk_vals=None if cv is None else cv.abs()),
            p.abs(), xv.abs())
        sync()
        worst = 0.0
        for i, (g, w, sc) in enumerate(zip(runs[0], want, scale)):
            if not all(torch.equal(r[i].view(torch.int32),
                                   g.view(torch.int32)) for r in runs[1:]):
                raise AssertionError(f"{cell}: the chunked backward did "
                                     "not repeat bit for bit")
            worst = max(worst, float(((g - w).abs()
                                      / sc.clamp_min(1e-30)).max()))
        if worst > 1e-5:
            raise AssertionError(f"{cell}: kernel against plain {worst:.3g}"
                                 " of the sum of magnitudes (limit 1e-5)")
        C = pb.chunk_lane.shape[0]
        lens = torch.bincount(pb.chunk_lane[pb.chunk_lane < U].long(),
                              minlength=U)
        nbytes = np.mean([chunk_grad_bytes(a[1], a[0].w.shape[0], k)
                          for a in args])
        ms = device_ms(fm._fm_grad_panel_chunked, args)
        plain_ms = device_ms(fm.fm_grad_panel_chunked_ref, args)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[cell] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "err": worst}
        log(f"  {cell}: B {B}, U {U}, k {k}, C {C} chunks ("
            f"{int((pb.chunk_lane < U).sum())} real, longest lane "
            f"{int(lens.max())}), {nbytes / 1e6:.1f} MB: kernel {ms:.4f} ms"
            f" against its bound {bound_ms:.4f} ms "
            f"({100 * bound_ms / ms:.1f}%), plain {plain_ms:.4f} ms; "
            f"{worst:.3g} of the sum of magnitudes from the plain version, "
            "3 calls bit for bit")
        del args, runs, want, scale
        torch.cuda.empty_cache()
    log("phase 23 ok: the chunked backward's kernel at the benchmark's "
        "batches")
    return out


# row sizes of the gather's edge cases: 1, 3, 8, 16, 32 and 65 vectors
GATHER_ROW_BYTES = (16, 48, 128, 256, 512, 1040)


def gather_resident_warps() -> tuple:
    """The warps that csrc/gather_rows.cu's kernels with R = 1, 2 and 4
    rows in flight keep on the current card at once, as its launch reads
    them from the occupancy API."""
    import ctypes
    from difacto_tpu_torch.ops import build
    warps = (ctypes.c_int64 * 3)()
    rc = build.library("gather_rows").difacto_gather_resident_warps(warps)
    if rc != 0:
        raise RuntimeError(f"difacto_gather_resident_warps: CUDA error {rc}")
    return tuple(warps)


def gather_edges(row_bytes: int, warps: tuple) -> list:
    """Slot counts at the edges of csrc/gather_rows.cu's tiles and
    persistent grid: 1; a warp's pass of P = 32 / min(32, row_bytes / 16)
    rows and a 4-pass tile, each less one, exact and plus one; one past
    the tiles of P << k rows that the ``warps`` (resident warps at R = 1,
    2, 4) hold, where the launch deepens R from 1 and from 2 and, at R =
    4, the grid's stride + 1, where the warps loop."""
    P = 32 // min(32, row_bytes // 16)
    return sorted({1, P - 1, P, P + 1, 4 * P - 1, 4 * P, 4 * P + 1}
                  .union(w * (P << k) + 1 for k, w in enumerate(warps))
                  - {0})


def gather_edge_cases(gather, dt, bits, gen, dev, C: int = 4096,
                      rows: tuple = GATHER_ROW_BYTES) -> int:
    """``gather`` against ``gather_rows_ref`` byte for byte on [C, W] tables
    of every row size in ``rows``: random slots with OOB lanes on both
    sides at every ``gather_edges`` count, an all-OOB vector, and two
    vectors written through ``out=`` into a slice at an offset inside a
    larger output whose other rows must stay as they were. Returns the
    number of cases; raises on the first that differs."""
    import torch
    from difacto_tpu_torch.ops import fused
    info = torch.iinfo(bits)
    # the plain version on the CPU has no grid: small stand-ins there
    warps = gather_resident_warps() if dev.type == "cuda" else (8, 8, 8)
    n = 0
    for rb in rows:
        W = rb // torch.tensor([], dtype=dt).element_size()
        table = torch.randint(info.min, info.max, (C, W), dtype=bits,
                              generator=gen, device=dev).view(dt)
        vecs = [torch.randint(-3, C + 3, (u,), dtype=torch.int32,
                              generator=gen, device=dev)
                for u in gather_edges(rb, warps)]
        vecs.append(torch.full((300,), C, dtype=torch.int32, device=dev))
        for s in vecs:
            got = gather(table, s)
            sync()
            if not torch.equal(got.view(torch.uint8),
                               fused.gather_rows_ref(table, s).view(
                                   torch.uint8)):
                raise AssertionError(f"gather kernel != plain on {dt} rows "
                                     f"of {rb} bytes, u={s.numel()}")
            n += 1
        for s in vecs[-1], vecs[-2]:
            u = s.numel()
            big = torch.randint(info.min, info.max, (u + 200, W), dtype=bits,
                                generator=gen, device=dev).view(dt)
            want = big.clone()
            want[100:100 + u] = fused.gather_rows_ref(table, s)
            gather(table, s, big[100:100 + u])
            sync()
            if not torch.equal(big.view(torch.uint8), want.view(torch.uint8)):
                raise AssertionError(f"gather kernel into out= at row 100 "
                                     f"!= plain on {dt} rows of {rb} "
                                     f"bytes, u={u}")
            n += 1
        del table, vecs
    return n


def phase_pred(work: str, kwargs: list, uparam, arrays: dict, text: bytes):
    """Save, open, score through the CLI pred loop, check."""
    import torch
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.data.parsers import parse_criteo
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.serve import PredictExecutor, open_serving_store
    from difacto_tpu_torch.store.convert import state_from_numpy
    from difacto_tpu_torch.store.local import SlotStore

    t0 = time.monotonic()
    writer = SlotStore(uparam, device=DEV)
    writer.state = state_from_numpy(uparam, arrays, device=DEV)
    model = os.path.join(work, "model_part-0")
    nnz_w = writer.save(model)
    del writer
    torch.cuda.empty_cache()
    store, meta, _ = open_serving_store(os.path.join(work, "model"),
                                        device=DEV)
    table = store.state.VVg
    log(f"  checkpoint: {meta}, {nnz_w} non-zero w; table "
        f"{tuple(table.shape)} {table.dtype} "
        f"{table.numel() * table.element_size() / 2 ** 30:.2f} GiB on "
        f"{table.device}; save+open {time.monotonic() - t0:.1f} s")

    data = os.path.join(work, "criteo.txt")
    with open(data, "wb") as f:
        f.write(text)
    pred_out = os.path.join(work, "pred")
    fused.gather_rows_cuda.launches = 0
    t0 = time.monotonic()
    run_pred(kwargs + [("data_in", data), ("pred_out", pred_out)],
             device=DEV, store=store)
    sync()
    pred_s = time.monotonic() - t0
    launches = fused.gather_rows_cuda.launches
    with open(pred_out + "_part-0", "rb") as f:
        lines = f.read().splitlines()
    if len(lines) != N_ROWS:
        raise AssertionError(f"pred file has {len(lines)} rows, want "
                             f"{N_ROWS}")
    if launches <= 0:
        raise AssertionError("task=pred never launched the gather kernel")

    # float64 reference, and a second scoring of every window
    ref = reference_margins(text, arrays, uparam.hash_capacity)
    probs = np.array([float(l.split(b"\t")[1]) for l in lines])
    p_err = float(np.abs(probs - 1.0 / (1.0 + np.exp(-ref))).max())
    blk = parse_criteo(text)
    bs = int(dict(kwargs).get("batch_size", 1000))
    ex1, ex2 = PredictExecutor(store), PredictExecutor(store)
    m_err, windows = 0.0, []
    for s in range(0, blk.size, bs):
        sub = blk.slice(s, min(s + bs, blk.size))
        a = ex1.predict_scores(sub)
        b = ex2.predict_scores(sub)
        if not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
            raise AssertionError(f"window {s}: repeat scores differ")
        m_err = max(m_err, float(np.abs(a - ref[s:s + len(a)]).max()))
        windows.append(sub)
    if not (np.isfinite(probs).all() and m_err <= 1e-4 and p_err <= 1e-4):
        raise AssertionError(f"pred vs float64 reference: margin err "
                             f"{m_err}, prob err {p_err} (limit 1e-4)")
    log(f"  pred: {len(lines)} rows in {pred_s:.2f} s "
        f"({len(lines) / pred_s:.0f} rows/s incl. host parse), "
        f"{launches} gather launches, max |margin - f64| {m_err:.3g}, "
        f"max |prob - f64| {p_err:.3g}, repeat bit-identical, "
        f"shape caps {ex1.shapes.snapshot()}")
    log("phase 3 ok: task=pred at full width matches the float64 reference")
    return store, lines, launches, windows


def phase_serve(store, lines, text: bytes, batch: int,
                label: str = "phase 4") -> int:
    import torch
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.serve import ServeServer
    # a window that straddles two pred windows: each row is scored in
    # other company than in the pred file, so equal answers show that a
    # row's score does not depend on its batch
    lo = batch // 2
    rows = text.splitlines()[lo:lo + batch]
    fused.gather_rows_cuda.launches = 0
    srv = ServeServer(store, batch_size=batch, max_delay_ms=2000.0,
                      queue_cap=4 * batch, data_format="criteo").start()
    try:
        with socket.create_connection((srv.host, srv.port), timeout=120) \
                as c:
            c.sendall(b"".join(r + b"\n" for r in rows) + b"#health\n")
            f = c.makefile("rb")
            got = [f.readline().rstrip(b"\n") for _ in rows]
            health = json.loads(f.readline())
            c.sendall(b"#stats\n")
            stats = json.loads(f.readline())
    finally:
        srv.close()
    sync()
    launches = fused.gather_rows_cuda.launches
    want = [l.split(b"\t")[1] for l in lines[lo:lo + batch]]
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        raise AssertionError(f"serve answers differ from the pred column "
                             f"on {bad} of {len(want)} rows")
    if health.get("status") != "ready":
        raise AssertionError(f"#health answered {health}")
    if launches <= 0:
        raise AssertionError("task=serve never launched the gather kernel")
    log(f"  serve: rows {lo}:{lo + len(got)} (straddling pred windows) "
        f"answered in {stats['batches']} "
        f"micro-batch(es), p50 {stats.get('p50_ms')} ms, p99 "
        f"{stats.get('p99_ms')} ms, {launches} gather launches, "
        f"#health {health['status']}")
    log(f"{label} ok: task=serve answers equal the pred column")
    return launches


def _profile(fn, args_list, rounds: int):
    """(device us, device events, event names in order) of ``rounds``
    passes of ``fn`` over ``args_list`` under torch.profiler. On the card
    a profile now and then misses the first one or two kernels launched
    after it starts, so it starts with marker kernels
    (``torch.cuda._sleep``'s spin kernel), waits for them and 2 ms more,
    and ends with one; markers are left out of the count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.002)
        for _ in range(rounds):
            for a in args_list:
                fn(*a)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and "spin_kernel" not in e.key]
    names = [e.name for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.time_range.start)]
    return (sum(e.self_device_time_total for e in dev),
            sum(e.count for e in dev), names)


def device_ms(fn, args_list, rounds: int = 5) -> float:
    """Mean device ms of one ``fn(*args)``: the CUDA kernels' own
    durations, summed per call, over ``rounds`` passes of ``args_list``.
    A profile is kept only when it holds exactly ``rounds`` times the
    device events of a one-pass profile taken just before it (the card's
    profiler now and then loses events); at most 8 tries."""
    import torch
    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    seen = []
    for _ in range(8):
        _, per_pass, names = _profile(fn, args_list, 1)
        us, events, _ = _profile(fn, args_list, rounds)
        if per_pass > 0 and events == rounds * per_pass:
            return us / 1e3 / (rounds * len(args_list))
        seen.append((per_pass, events))
    raise RuntimeError(
        f"torch.profiler: no profile of {rounds} passes held {rounds} x "
        f"the events of one pass in 8 tries (one pass, {rounds} passes: "
        f"{seen}); the last one-pass profile: "
        + "; ".join(n[:60] for n in names))


def device_ms_turns(cands, rounds: int = 5) -> dict:
    """Device ms of each ``(name, fn, args_list)``, timed in turns: the
    order a, b, ..., b, a, so that a drift over the call weighs on each
    alike. Returns {name: [first, second]}."""
    got: dict = {}
    for name, fn, args in list(cands) + list(reversed(cands)):
        got.setdefault(name, []).append(device_ms(fn, args, rounds))
    return got


def with_fn(fn, wrapper, attr: str = "_scatter_fn"):
    """``wrapper`` (of ops/fused.py) launching library function ``fn``
    (another tree's build) instead of this tree's: ``attr`` names the
    library lookup the wrapper calls, ``_scatter_fn`` or ``_gather_fn``."""
    from difacto_tpu_torch.ops import fused

    def run(*args):
        saved = getattr(fused, attr)
        setattr(fused, attr, lambda: fn)
        try:
            return wrapper(*args)
        finally:
            setattr(fused, attr, saved)
    return run


def gather_turns(others: dict, wrapper, args: list) -> tuple:
    """``wrapper`` (a function that launches the gather through
    ops/fused.py) over ``args``, timed in turns with each of ``others``
    ({tree: its gather library function}) launched in this tree's place:
    parents, this, this, parents. Returns ({name: mean ms}, the turns as
    text); this tree's kernel is named "kernel"."""
    cands = [(n, with_fn(fn, wrapper, "_gather_fn"), args)
             for n, fn in others.items()] + [("kernel", wrapper, args)]
    turns = device_ms_turns(cands)
    return ({n: float(np.mean(v)) for n, v in turns.items()},
            ", ".join(f"{n} {'/'.join(f'{v:.5f}' for v in turns[n])}"
                      for n, *_ in cands))


def phase_measure(store, windows, others: dict) -> dict:
    """The kernel at the main path's own slot vectors (one per pred
    window, cycled so that repeats see the cache as the stream does), on
    the fp32 table and on seeded bf16 and int8 tables of its geometry;
    ``others`` ({tree: launch function}, the parents' kernels) timed in
    turns with this tree's, and each of them on 8-row vectors, the
    floor. Returns the fp32 numbers
    of the kernels line."""
    import dataclasses
    import torch
    from difacto_tpu_torch.data.localizer import compact
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.ops.batch import bucket
    from difacto_tpu_torch.store.local import pad_slots_oob
    table = store.state.VVg
    C, W = table.shape
    real_slots = []
    for sub in windows:
        _, uniq, _ = compact(sub)
        real_slots.append(np.unique(store.map_keys(uniq)).astype(np.int32))
    # the executor's sticky cap: the bucket of the largest window
    u_cap = bucket(max(len(s) for s in real_slots))
    vecs = [torch.from_numpy(pad_slots_oob(s, u_cap, C)).to(DEV)
            for s in real_slots]
    prefixes = [torch.from_numpy(s).to(DEV) for s in real_slots]
    # the floor: 5 real rows and 3 pads, as phase 2's smallest vector
    floor = [torch.from_numpy(pad_slots_oob(s[:5], 8, C)).to(DEV)
             for s in real_slots]
    real = float(np.mean([len(s) for s in real_slots]))

    def library(t, s):
        return torch.index_select(t, 0, s)

    def turns_of(args):
        return gather_turns(others, fused.gather_rows_cuda, args)

    for kind in ("fp32", "bf16", "int8"):
        if kind == "fp32":
            tab = table
        else:   # the same slot vectors into a seeded table of this kind
            param = dataclasses.replace(store.param, slot_dtype=kind)
            tab = _seeded_table(param, C, SEED + 10)
        kv = [(tab, s) for s in vecs]
        ms, order = turns_of(kv)
        floor_ms, floor_order = turns_of([(tab, s) for s in floor])
        plain_ms = device_ms(fused.gather_rows_ref, kv)
        library_ms = device_ms(library, [(tab, s) for s in prefixes])
        for t, s in kv[:4]:
            # lint: ok(torch-shard-kernel) the kernel against its plain
            # version, beside the main path: a check, not a dispatch
            if not torch.equal(fused.gather_rows_cuda(t, s).view(torch.uint8),
                               fused.gather_rows_ref(t, s).view(torch.uint8)):
                raise AssertionError(f"kernel != plain on a main-path "
                                     f"vector, {kind} table")
        rb = tab.shape[1] * tab.element_size()
        moved = real * rb + u_cap * rb + 4 * u_cap
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        log(f"  gather, {kind} table [{C}, {tab.shape[1]}] {tab.dtype}, "
            f"u_cap {u_cap}, {real:.0f} real rows on average: kernel "
            f"{ms['kernel']:.5f} ms (in turns: {order} ms), plain "
            f"{plain_ms:.5f} ms, index_select {library_ms:.5f} ms, bound "
            f"{bound_ms:.5f} ms ({moved / 1e6:.2f} MB at 3.35 TB/s) -> "
            f"{bound_ms / ms['kernel']:.1%} of the bound; the floor, 8 "
            f"rows: kernel {floor_ms['kernel']:.5f} ms (in turns: "
            f"{floor_order} ms)")
        if kind == "fp32":      # the main path's table: the kernels line
            main = {"ms": ms["kernel"], "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms}
        del tab, kv
        torch.cuda.empty_cache()
    profile_predict(store, windows[:5])
    log("phase 5 ok: measured")
    return main


def profile_predict(store, windows) -> None:
    """Where a predict window's time goes: host wall time vs the card's
    busy time (sum of kernel durations), and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from difacto_tpu_torch.serve import PredictExecutor
    ex = PredictExecutor(store)
    for sub in windows:
        ex.predict_scores(sub)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for sub in windows:
            ex.predict_scores(sub)
        sync()
        wall = (time.perf_counter() - t0) * 1e3 / len(windows)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / len(windows)
    log(f"  predict window (1000 rows): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({1 - busy / wall:.1%} idle), "
        f"{sum(e.count for e in dev) / len(windows):.0f} kernels")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3 / len(windows):8.4f} ms "
            f"x{e.count // len(windows):4d}  {e.key[:90]}")


# ------------------------------------------------------------ training
def _seeded_table(param, C: int, seed: int):
    """[C, Wx] fused rows built on the card from seeded values: V with
    all-zero halves on every 7th row, w zero on every 3rd, z spread
    around l1, cnt around V_threshold, live half the rows."""
    import torch
    from difacto_tpu_torch.updaters import sgd_updater as T
    gen = torch.Generator(device=DEV).manual_seed(seed)
    k = param.V_dim

    def r(*shape):
        return torch.rand(shape, generator=gen, device=DEV)
    V = (r(C, k) - 0.5) * 0.2
    V[::7] = 0.0
    w = r(C) - 0.5
    w[::3] = 0.0
    thr = float(param.V_threshold)
    return T.build_rows(param, C, V, r(C, k) * 2.0, w,
                        (r(C) - 0.5) * 4.0 * max(param.l1, 0.5),
                        r(C) * 2.0, torch.floor(r(C) * 2.0 * thr + 1.0),
                        r(C) < 0.5)


def _step_inputs(k: int, u: int, seed: int):
    import torch
    gen = torch.Generator(device=DEV).manual_seed(seed)
    gw = torch.randn(u, generator=gen, device=DEV) * 0.3
    gV = torch.randn(u, k, generator=gen, device=DEV) * 0.1
    vmask = (torch.rand(u, generator=gen, device=DEV) < 0.6).float()
    return gw, gV, vmask


def phase_scatter_vs_plain(uparam) -> dict:
    """Byte-exact scatter kernel vs its plain version, epilogue on and
    off; returns the max abs difference over the fp32 compares of each
    route, {True: on, False: off}."""
    import dataclasses
    import torch
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.updaters import sgd_updater as T
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    worst = {True: 0.0, False: 0.0}
    for layout, kw in (("in-pad", dict(V_dim=16, pad_v_rows=True)),
                       ("appended+gap", dict(V_dim=16, pad_v_rows=False)),
                       ("appended V64", dict(V_dim=64, pad_v_rows=False))):
        for kind in ("fp32", "bf16", "int8", "fp8"):
            full = layout == "appended+gap" and kind == "fp32"
            # the main path's full table, else a small one
            C = uparam.hash_capacity if full \
                else min(65536, uparam.hash_capacity)
            param = dataclasses.replace(uparam, slot_dtype=kind,
                                        hash_capacity=C, **kw)
            table = _seeded_table(param, C, SEED + 7)
            epi = T.epilogue_spec(param, C)
            plain = functools.partial(T.row_epilogue, param, C)
            rows_src = _seeded_table(param, 49152, SEED + 8)
            for u, n_real in ((8, 5), (8, 1), (12288, 11692),
                              (12301, 11692), (49152, 40000), (12288, 0),
                              (49152, 0)):
                slots = _slot_vector(C, n_real, u, gen, DEV)
                rows = rows_src[:u].contiguous()
                gw, gV, vm = _step_inputs(param.V_dim, u, SEED + u)
                for on in (True, False):
                    got, want = table.clone(), table.clone()
                    if on:
                        fused.fm_update_rows(got, slots, rows, gw, gV, vm,
                                             epi, plain)
                        fused.fm_update_rows_ref(want, slots, rows, gw, gV,
                                                 vm, plain)
                    else:
                        fused.scatter_rows(got, slots, rows)
                        fused.scatter_rows_ref(want, slots, rows)
                    sync()
                    same = torch.equal(got.view(torch.uint8),
                                       want.view(torch.uint8))
                    if n_real == 0:
                        same = same and torch.equal(got.view(torch.uint8),
                                                    table.view(torch.uint8))
                    if kind == "fp32":
                        fin = torch.isfinite(got) & torch.isfinite(want)
                        d = (got[fin] - want[fin]).abs()
                        worst[on] = max(worst[on], float(d.max())
                                        if d.numel() else 0.0)
                    if not same:
                        raise AssertionError(
                            f"scatter kernel != plain: {layout} {kind} "
                            f"C={C} u_cap={u} real={n_real} "
                            f"epilogue={'on' if on else 'off'}")
                    del got, want
            log(f"  {layout} {kind} [{C} x {table.shape[1]}] "
                f"{table.dtype}: u_cap 8 (5, 1 real) / 12288, 12301 "
                "(11692 real) / 49152 (40000 real) / all-OOB 12288, 49152, "
                "epilogue on and off: bit-exact")
            del table, rows_src
            torch.cuda.empty_cache()
    log("phase 6 ok: scatter kernel bit-exact with its plain version")
    return worst


def _count_batches(p, data_in: str, data_val: str, epochs: int):
    """(train batches per epoch, validation blocks per epoch) the
    learner's readers will cut, counted with the same readers."""
    from difacto_tpu_torch.data.batch_reader import BatchReader
    from difacto_tpu_torch.data.reader import Reader
    n = p.num_jobs_per_epoch
    train = [sum(1 for part in range(n) for _ in BatchReader(
        data_in, p.data_format, part, n, p.batch_size,
        p.batch_size * p.shuffle, p.neg_sampling, seed=e * n + part))
        for e in range(epochs)]
    val = sum(1 for _ in Reader(data_val, p.data_format, 0, 1,
                                chunk_bytes=256 << 20))
    return train, val


def _h2d_copies(fn) -> tuple:
    """(host-to-device copies, device events) the card recorded while
    ``fn()`` ran, from torch.profiler. As in :func:`_profile`, marker
    kernels lead and end the profile (the card's profiler now and then
    misses the first kernels after it starts) and are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.002)
        fn()
        sync()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and "spin_kernel" not in e.name]
    h2d = [e for e in ev if "HtoD" in e.name]
    if h2d:
        ops = {e.key: e.count for e in prof.key_averages()
               if e.key in ("aten::copy_", "aten::_to_copy")}
        log(f"    host-to-device copies: {len(h2d)}; copy ops: {ops}")
    return len(h2d), len(ev)


def _train(kwargs: list, watch_replays: bool = False, epoch_end=None):
    """One ``task=train`` run through the learner: (learner, per-epoch
    (training, validation) progress, [(epoch, job, wall s)], and with
    ``watch_replays`` [(epoch, job, host-to-device copies, device
    events)] of every replayed epoch, from the profiler). ``epoch_end``
    is called with each epoch's number after its progress is kept."""
    from difacto_tpu_torch.learners.sgd import SGDLearner
    ln = SGDLearner(device=DEV)
    ln.init(list(kwargs))
    progress, walls, replays = [], [], []
    ln.add_epoch_end_callback(lambda k, t, v: progress.append((t, v)))
    if epoch_end is not None:
        ln.add_epoch_end_callback(lambda k, t, v: epoch_end(k))
    run_epoch, replay = ln._run_epoch, ln._replay_cached

    def timed(epoch, job_type, prog):
        t0 = time.perf_counter()
        run_epoch(epoch, job_type, prog)
        sync()
        walls.append((epoch, job_type, time.perf_counter() - t0))

    def watched(job_type, epoch, cache, prog):
        if DEV != "cuda":
            replay(job_type, epoch, cache, prog)
            replays.append((epoch, job_type, 0, 0))
            return
        n, ev = _h2d_copies(lambda: replay(job_type, epoch, cache, prog))
        replays.append((epoch, job_type, n, ev))

    ln._run_epoch = timed
    if watch_replays:
        ln._replay_cached = watched
    ln.run()
    sync()
    return ln, progress, walls, replays


def _epoch_walls(walls) -> str:
    return ", ".join(f"{e}{'t' if j == 3 else 'v'} {s:.3f}"
                     for e, j, s in walls)


def _swap_plain():
    """Swap the three kernel dispatchers for their plain versions; returns
    a function that swaps them back."""
    from difacto_tpu_torch.ops import fused

    def plain_push(table, slots, rows, gw, gV, vmask, epi, epilogue):
        return fused.fm_update_rows_ref(table, slots, rows, gw, gV, vmask,
                                        epilogue)

    saved = (fused.gather_rows, fused.fm_update_rows, fused.scatter_rows)
    fused.gather_rows = fused.gather_rows_ref
    fused.fm_update_rows = plain_push
    fused.scatter_rows = fused.scatter_rows_ref

    def restore():
        fused.gather_rows, fused.fm_update_rows, fused.scatter_rows = saved
    return restore


# the three table kernels, which the phases hold to their batches, and the
# chunked backward's, counted beside them from 0 on every main path
TABLE_COUNTERS = ("gather_rows_cuda", "fm_update_rows_cuda",
                  "scatter_rows_cuda")
COUNTERS = TABLE_COUNTERS + ("fm_chunk_grad_cuda",)


def _reset_counts() -> None:
    from difacto_tpu_torch.ops import fused
    for c in COUNTERS:
        getattr(fused, c).launches = 0


def _counts() -> dict:
    from difacto_tpu_torch.ops import fused
    return {c: getattr(fused, c).launches for c in COUNTERS}


def _table_part(launches: dict) -> dict:
    """The table kernels' part of a launch count."""
    return {c: launches[c] for c in TABLE_COUNTERS}


def phase_train(work: str, conf: list, uparam) -> dict:
    """Phase 7: the hashed store at full width, the replay cache at its
    default budget: epoch 0 streams and stages, epoch 1 replays."""
    import torch
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.learners.sgd import SGDLearnerParam
    t0 = time.monotonic()
    data_in = os.path.join(work, "train.txt")
    data_val = os.path.join(work, "val.txt")
    with open(data_in, "wb") as f:
        f.write(synthetic_criteo(N_TRAIN, SEED + 2))
    val_text = synthetic_criteo(N_VAL, SEED + 3)
    with open(data_val, "wb") as f:
        f.write(val_text)
    model = os.path.join(work, "trained")
    kwargs = conf + [("data_in", data_in), ("data_val", data_val),
                     ("max_num_epochs", "2"), ("stop_rel_objv", "0"),
                     ("stop_val_auc", "-2")]
    lp, _ = SGDLearnerParam.init_allow_unknown(kwargs)
    train_b, val_b = _count_batches(lp, data_in, data_val, 1)
    nb = train_b[0]
    log(f"  {N_TRAIN} train + {N_VAL} validation rows written in "
        f"{time.monotonic() - t0:.1f} s: {nb} train batches per epoch "
        f"(epoch 1 replays them), {val_b} validation block(s); "
        f"device_cache_mb {lp.device_cache_mb}")

    _reset_counts()
    t0 = time.monotonic()
    ln, progress, walls, _ = _train(kwargs + [("has_aux", "1"),
                                              ("model_out", model)])
    train_s = time.monotonic() - t0
    launches = _counts()
    # one gather and one push per step, one more gather and a count
    # push per epoch-0 batch, one gather per validation block and epoch
    want = {"gather_rows_cuda": 2 * nb + nb + 2 * val_b,
            "fm_update_rows_cuda": 2 * nb, "scatter_rows_cuda": nb}
    if _table_part(launches) != want:
        raise AssertionError(f"launch counts {launches}, the batches need "
                             f"{want}")
    info = ln.device_cache_info()
    if not all(c["complete"] for c in info.values()):
        raise AssertionError(f"the replay cache did not cover the run: "
                             f"{info}")
    loss = [t.loss / t.nrows for t, _ in progress]
    if not (len(loss) == 2 and np.isfinite(loss).all()
            and loss[1] < loss[0]):
        raise AssertionError(f"objective per row did not fall: {loss}")
    first = ln.store.state.VVg.clone()
    log(f"  run 1: {train_s:.1f} s for 2 epochs, loss/row {loss[0]:.6f} -> "
        f"{loss[1]:.6f}, val AUC "
        f"{[round(v.auc / max(v.nrows, 1), 6) for _, v in progress]}, "
        f"launches {launches} (as the batches need), cache {info}")
    del ln
    torch.cuda.empty_cache()

    ln, _, walls, _ = _train(kwargs)
    if not torch.equal(ln.store.state.VVg.view(torch.int32),
                       first.view(torch.int32)):
        raise AssertionError("a second training run left another table")
    del ln
    torch.cuda.empty_cache()
    log(f"  run 2: final table bit-identical to run 1; epoch wall s "
        f"(t training, v validation; epoch 0 streams, 1 replays): "
        f"{_epoch_walls(walls)}")

    _reset_counts()
    restore = _swap_plain()
    try:
        ln, _, _, _ = _train(kwargs)
    finally:
        restore()
    if any(_table_part(_counts()).values()):
        raise AssertionError("the run on the plain versions launched a "
                             "kernel")
    if not torch.equal(ln.store.state.VVg.view(torch.int32),
                       first.view(torch.int32)):
        raise AssertionError("the run on the plain versions left another "
                             "table than the kernels")
    log("  run 3 (gather/scatter swapped for their plain versions): final "
        "table bit-identical to run 1")
    torch.cuda.empty_cache()

    # the saved model through phase 3's pred path vs a float64 FM
    with np.load(model + "_part-0") as z:
        arrays = {f: z[f] for f in ("w", "V", "v_live")}
    pred_out = os.path.join(work, "trained_pred")
    run_pred(conf + [("model_in", model), ("data_in", data_val),
                     ("pred_out", pred_out)], device=DEV)
    with open(pred_out + "_part-0", "rb") as f:
        probs = np.array([float(l.split(b"\t")[1])
                          for l in f.read().splitlines()])
    ref = reference_margins(val_text, arrays, uparam.hash_capacity)
    p_err = float(np.abs(probs - 1.0 / (1.0 + np.exp(-ref))).max())
    if len(probs) != N_VAL or not p_err <= 1e-4:
        raise AssertionError(f"trained model's pred vs float64 FM: "
                             f"{len(probs)} rows, prob err {p_err}")
    log(f"  saved model: {int((arrays['w'] != 0).sum())} non-zero w, "
        f"{int(arrays['v_live'].sum())} live embeddings; task=pred over the "
        f"validation rows within {p_err:.3g} of the float64 FM")
    log("phase 7 ok: task=train at full width, the replay cache at its "
        "default, deterministic, kernels = plain versions")
    # run 1's table and objectives stay for phase 19's mesh runs
    return {"launches": launches, "learner": ln, "data_in": data_in,
            "data_val": data_val, "val_text": val_text, "walls": walls,
            "loss": loss, "bits": first}


def phase_measure_train(ln, data_in: str, parent_fns: dict) -> dict:
    """A train step's time budget and the scatter kernel at the main
    path's own inputs (the trained table, 5 batches of epoch 1)."""
    import dataclasses
    import torch
    from difacto_tpu_torch.data.batch_reader import BatchReader
    from difacto_tpu_torch.data.pack_stream import (ShapeSchedule,
                                                    prepare_hashed)
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.ops.batch import bucket, unpack_panel
    from difacto_tpu_torch.updaters.sgd_updater import (epilogue_spec,
                                                        row_epilogue)
    p, store = ln.param, ln.store
    C = store.param.hash_capacity
    shapes = ShapeSchedule()
    blocks, n = [], p.num_jobs_per_epoch
    for part in range(n):                 # epoch 1's full batches
        blocks += [b for b in BatchReader(
            data_in, p.data_format, part, n, p.batch_size,
            p.batch_size * p.shuffle, seed=n + part)
            if b.size == p.batch_size]
        if len(blocks) >= 5:
            break
    blocks = blocks[:5]
    payloads = [prepare_hashed(shapes, C, b, False, False, 8, "train",
                               bucket(p.batch_size, 8)) for b in blocks]

    def step(pl):
        i32 = torch.from_numpy(pl.i32).to(DEV)
        f32 = torch.from_numpy(pl.f32).to(DEV)
        batch, slots, _ = unpack_panel(i32, f32, pl.b_cap, pl.d2, pl.u_cap,
                                       binary=pl.binary)
        store.state, objv, auc = ln._train_step(store.state, batch, slots)
        return objv

    if any(pl.layout != "panel" for pl in payloads):
        raise AssertionError("the Criteo batches did not pack as panels")
    from difacto_tpu_torch.learners.sgd import K_TRAINING
    # full staged batches (a part's ragged last batch packs as COO)
    staged = [st for items in ln._caches[K_TRAINING].entries.values()
              for st in items if st.chunks is not None
              and st.nrows == p.batch_size][:5]
    if len(staged) < 5:
        raise AssertionError("the replay cache holds fewer than 5 full "
                             "chunked panels")

    def replayed(st):
        pending = []
        ln._dispatch_staged(K_TRAINING, st, False, pending)
        return pending[-1][1]

    budget = {"streamed": profile_steps(step, payloads, "streamed"),
              "replayed": profile_steps(replayed, staged, "replayed")}
    if budget["replayed"]["h2d"]:
        raise AssertionError("a replayed step copied from the host")

    # the scatter kernel at the main path's own inputs, both routes
    from difacto_tpu_torch.losses import FMParams
    sp = store.param
    k = sp.V_dim
    epi = epilogue_spec(sp, C)
    plain = functools.partial(row_epilogue, sp, C)
    table = store.state.VVg
    steps = []                  # per payload: slots, rows, gw, gV, vm
    for pl in payloads:
        i32 = torch.from_numpy(pl.i32).to(DEV)
        f32 = torch.from_numpy(pl.f32).to(DEV)
        batch, slots, _ = unpack_panel(i32, f32, pl.b_cap, pl.d2, pl.u_cap,
                                       binary=pl.binary)
        rows = store.fns.pull_rows(store.state, slots)
        w, V, vm = store.fns.rows_to_params(store.state, rows)
        params = FMParams(w=w, V=V, v_mask=vm)
        pred, xv = ln.loss.predict_xv(params, batch)
        gw, gV = ln.loss.calc_grad(params, batch, pred, xv)
        steps.append((slots, rows, gw.contiguous(), gV.contiguous(), vm))
    u_cap = payloads[0].u_cap
    ok = [(s >= 0) & (s < C) for s, *_ in steps]
    real = float(np.mean([int(o.sum()) for o in ok]))
    real_vm = float(np.mean([int((o & (st[4] > 0)).sum())
                             for o, st in zip(ok, steps)]))
    on = measure_scatter(table, steps, epi, plain, parent_fns,
                         f"fp32 [{C}, {table.shape[1]}] (trained)")
    off = measure_scatter(table, steps, None, None, parent_fns,
                          f"fp32 [{C}, {table.shape[1]}] (trained)")
    row_bytes = table.shape[1] * table.element_size()
    on["bound_ms"] = (4 * u_cap + real * (2 * row_bytes + 8)
                      + real_vm * 4 * k) / HBM_BYTES_PER_S * 1e3
    off["bound_ms"] = (4 * u_cap + real * 2 * row_bytes) \
        / HBM_BYTES_PER_S * 1e3
    for name, t in (("epilogue on", on), ("epilogue off", off)):
        log(f"  scatter {name}: {real:.0f} real rows of u_cap {u_cap} on "
            f"average ({real_vm:.0f} with vmask > 0), bound "
            f"{t['bound_ms']:.5f} ms at 3.35 TB/s -> kernel at "
            f"{t['bound_ms'] / t['ms']:.1%} of it, index_copy_'s "
            f"{t['library_ms'] / t['ms']:.2f}x the kernel's time"
            + "".join(f", {n}'s {v / t['ms']:.2f}x"
                      for n, v in t["others_ms"].items()))

    # the push in bf16, int8 and fp8 tables of the main path's shape
    # (their layout at this capacity: in-pad), seeded, at the same slot
    # vectors and gradients
    for kind in ("bf16", "int8", "fp8"):
        param = dataclasses.replace(sp, slot_dtype=kind)
        tab = _seeded_table(param, C, SEED + 9)
        steps_k = [(s, fused.gather_rows_ref(tab, s), gw, gV, vm)
                   for s, _, gw, gV, vm in steps]
        t = measure_scatter(tab, steps_k, epilogue_spec(param, C),
                            functools.partial(row_epilogue, param, C),
                            parent_fns, f"{kind} [{C}, {tab.shape[1]}]")
        rb = tab.shape[1] * tab.element_size()
        bound = (4 * u_cap + real * (2 * rb + 8) + real_vm * 4 * k) \
            / HBM_BYTES_PER_S * 1e3
        log(f"  scatter epilogue on, {kind}: bound {bound:.5f} ms -> "
            f"kernel at {bound / t['ms']:.1%} of it")
        del tab, steps_k
        torch.cuda.empty_cache()
    log("phase 8 ok: measured")
    return {"on": on, "off": off, "steps": budget}


def profile_steps(fn, items, what: str) -> dict:
    """A train step's host wall time (``fn(item)`` over ``items``, ended
    by a synchronize), the card's busy time (the sum of its kernels'
    durations), idle share and kernels per step, from torch.profiler,
    and the top device entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for it in items:
        fn(it)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in items:
            fn(it)
        sync()
        wall = (time.perf_counter() - t0) * 1e3 / len(items)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / len(items)
    if DEV == "cuda" and busy <= 0:
        raise RuntimeError("torch.profiler recorded no device activity")
    kernels = sum(e.count for e in dev) / len(items)
    h2d = sum(e.count for e in dev if "HtoD" in e.key) / len(items)
    log(f"  {what} train step (1000 Criteo rows): wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms ({1 - busy / wall:.1%} idle), "
        f"{kernels:.0f} device events per step ({h2d:.0f} host-to-device "
        "copies)")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3 / len(items):8.4f} ms "
            f"x{e.count // len(items):4d}  {e.key[:90]}")
    return {"wall_ms": wall, "busy_ms": busy, "kernels": kernels,
            "h2d": h2d}


def measure_scatter(table, steps, epi, plain, parent_fns: dict,
                    what: str) -> dict:
    """One scatter route on ``steps`` (per payload: slots, gathered rows,
    gw, gV, vmask): the kernel (and other trees', in turns), the plain
    version and one ``index_copy_`` of the in-bounds rows (of the new rows
    where ``epi`` is set), cycled over the payloads; then the kernel on
    one payload repeated, L2-warm. The table is written in place."""
    import torch
    from difacto_tpu_torch.ops import fused
    C = table.shape[0]
    if epi is not None:
        kern = fused.fm_update_rows_cuda
        args = [(table, s, r, gw, gV, vm, epi) for s, r, gw, gV, vm in steps]
        plain_fn = fused.fm_update_rows_ref
        plain_args = [a[:6] + (plain,) for a in args]
        new = [plain(r, gw, gV, vm) for _, r, gw, gV, vm in steps]
    else:
        kern = fused.scatter_rows_cuda
        args = [(table, s, r) for s, r, *_ in steps]
        plain_fn, plain_args = fused.scatter_rows_ref, args
        new = [r for _, r, *_ in steps]
    lib_args = []
    for (s, *_), r in zip(steps, new):
        ok = (s >= 0) & (s < C)
        lib_args.append((table, s[ok].long(), r[ok].contiguous()))

    def library(t, s, r):
        return t.index_copy_(0, s, r)

    cands = [(n, with_fn(f, kern), args) for n, f in parent_fns.items()]
    cands.insert((len(cands) + 1) // 2, ("kernel", kern, args))
    turns = device_ms_turns(cands)
    out = {"ms": float(np.mean(turns["kernel"])),
           "plain_ms": device_ms(plain_fn, plain_args),
           "library_ms": device_ms(library, lib_args),
           "warm_ms": device_ms(kern, args[:1]),
           "others_ms": {n: float(np.mean(turns[n])) for n in parent_fns}}
    row_bytes = table.shape[1] * table.element_size()
    s0, r0, *_ = steps[0]
    touched = (r0.numel() * r0.element_size() + 4 * s0.numel()
               + sum(t.numel() * 4 for t in steps[0][2:])
               + int(((s0 >= 0) & (s0 < C)).sum()) * row_bytes)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size \
        if DEV == "cuda" else 0
    route = "on" if epi is not None else "off"
    order = ", ".join(f"{n} {'/'.join(f'{v:.5f}' for v in turns[n])}"
                      for n, *_ in cands)
    log(f"  scatter epilogue {route}, {what}, u_cap {s0.numel()}: kernel "
        f"{out['ms']:.5f} ms (in turns: {order} ms), plain "
        f"{out['plain_ms']:.5f} ms, index_copy_ {out['library_ms']:.5f} ms; "
        f"the loop cycles {len(steps)} payloads, "
        f"{len(steps) * touched / 1e6:.1f} MB against a {l2 / 1e6:.1f} MB "
        f"L2; one payload repeated ({touched / 1e6:.1f} MB, L2-warm): "
        f"kernel {out['warm_ms']:.5f} ms")
    return out


def _dict_growths(ln, start: int) -> int:
    cap = ln.store.state.capacity
    return max(0, cap.bit_length() - start.bit_length())


def phase_train_dict(work: str) -> dict:
    """Phase 9: ``task=train`` at the JAX package's defaults on the
    dictionary store, at the full width of examples/criteo_dict.conf."""
    import torch
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.config import parse_config_file
    from difacto_tpu_torch.learners.sgd import SGDLearnerParam
    # the flat table phase 9 always measured; phase 19 runs the mesh
    conf = parse_config_file(DICT_CONF) + [("mesh_dp", "1"),
                                           ("mesh_fs", "1")]
    n_train = N_DICT_TRAIN
    t0 = time.monotonic()
    data_in = os.path.join(work, "dict_train.txt")
    data_val = os.path.join(work, "dict_val.txt")
    with open(data_in, "wb") as f:
        f.write(synthetic_criteo(n_train, SEED + 4))
    val_text = synthetic_criteo(N_VAL, SEED + 5)
    with open(data_val, "wb") as f:
        f.write(val_text)
    model = os.path.join(work, "dict_model")
    kwargs = conf + [("data_in", data_in), ("data_val", data_val),
                     ("max_num_epochs", str(N_DICT_EPOCHS)),
                     ("stop_rel_objv", "0"), ("stop_val_auc", "-2")]
    lp, rest = SGDLearnerParam.init_allow_unknown(kwargs)
    (nb,), val_b = _count_batches(lp, data_in, data_val, 1)
    start = dict(rest).get("init_capacity", 1 << 14)
    log(f"config {DICT_CONF}: V_dim {dict(rest)['V_dim']}, no "
        f"hash_capacity (the dictionary store from {start} rows), "
        f"batch_size {lp.batch_size}, device_cache_mb {lp.device_cache_mb}, "
        f"shuffle {lp.shuffle}, flat (mesh_dp=1 mesh_fs=1; phase 19 runs "
        f"the conf's mesh); {n_train} train + "
        f"{N_VAL} validation rows written in {time.monotonic() - t0:.1f} s: "
        f"{nb} train batches per epoch, {val_b} validation block(s)")

    _reset_counts()
    t0 = time.monotonic()
    ln, progress, walls, replays = _train(
        kwargs + [("has_aux", "1"), ("model_out", model)],
        watch_replays=True)
    train_s = time.monotonic() - t0
    launches = _counts()
    E = N_DICT_EPOCHS
    want = {"gather_rows_cuda": E * nb + nb + E * val_b,
            "fm_update_rows_cuda": E * nb, "scatter_rows_cuda": nb}
    if _table_part(launches) != want:
        raise AssertionError(f"launch counts {launches}, the batches need "
                             f"{want}")
    growths = _dict_growths(ln, int(start))
    if growths < 4:
        raise AssertionError(f"the table grew {growths} times, want >= 4")
    info = ln.device_cache_info()
    if not all(c["complete"] for c in info.values()):
        raise AssertionError(f"the replay cache did not cover the run: "
                             f"{info}")
    if len(replays) != 2 * (E - 1) or any(n for _, _, n, _ in replays):
        raise AssertionError(f"replayed epochs (epoch, job, host-to-device "
                             f"copies, device events): {replays}")
    if DEV == "cuda" and any(ev < (nb if job == 3 else 1)
                             for _, job, _, ev in replays):
        raise AssertionError(f"the profiler saw too few device events in "
                             f"a replayed epoch: {replays}")
    loss = [t.loss / t.nrows for t, _ in progress]
    if not (len(loss) == E and np.isfinite(loss).all()
            and all(b < a for a, b in zip(loss, loss[1:]))):
        raise AssertionError(f"objective per row did not fall: {loss}")
    first = ln.store.state.VVg.clone()
    keys = ln.store._keys.copy()
    cap = ln.store.state.capacity
    log(f"  run 1: {train_s:.1f} s for {E} epochs, loss/row "
        f"{' -> '.join(f'{l:.6f}' for l in loss)}, val AUC "
        f"{[round(v.auc / max(v.nrows, 1), 6) for _, v in progress]}; "
        f"{len(keys)} keys, table {start} -> {cap} rows ({growths} "
        f"doublings, {tuple(first.shape)} {first.dtype}, "
        f"{first.numel() * first.element_size() / 2 ** 20:.0f} MiB); "
        f"launches {launches} (as the batches need); replay cache "
        f"{info} of {lp.device_cache_mb} MB; replayed epochs (epoch, "
        f"job, host-to-device copies, device events): {replays}")
    del ln
    torch.cuda.empty_cache()

    ln, _, walls, _ = _train(kwargs)
    if not (torch.equal(ln.store.state.VVg.view(torch.int32),
                        first.view(torch.int32))
            and np.array_equal(ln.store._keys, keys)):
        raise AssertionError("a second run left another table or key map")
    del ln
    torch.cuda.empty_cache()
    log(f"  run 2: table and key map bit-identical to run 1; epoch wall s "
        f"(epoch 0 streams and stages, later epochs replay): "
        f"{_epoch_walls(walls)}")

    _reset_counts()
    restore = _swap_plain()
    try:
        ln, _, _, _ = _train(kwargs)
    finally:
        restore()
    if any(_table_part(_counts()).values()):
        raise AssertionError("the run on the plain versions launched a "
                             "kernel")
    if not (torch.equal(ln.store.state.VVg.view(torch.int32),
                        first.view(torch.int32))
            and np.array_equal(ln.store._keys, keys)):
        raise AssertionError("the run on the plain versions left another "
                             "table or key map than the kernels")
    del ln, first
    torch.cuda.empty_cache()
    log("  run 3 (gather/scatter swapped for their plain versions): table "
        "and key map bit-identical to run 1")

    with np.load(model + "_part-0") as z:
        arrays = {f: z[f] for f in ("w", "V", "v_live")}
        saved_keys = z["keys"]
    pred_out = os.path.join(work, "dict_pred")
    run_pred(conf + [("model_in", model), ("data_in", data_val),
                     ("pred_out", pred_out)], device=DEV)
    with open(pred_out + "_part-0", "rb") as f:
        probs = np.array([float(l.split(b"\t")[1])
                          for l in f.read().splitlines()])
    ref = reference_margins(val_text, arrays, keys=saved_keys)
    p_err = float(np.abs(probs - 1.0 / (1.0 + np.exp(-ref))).max())
    if len(probs) != N_VAL or not p_err <= 1e-4:
        raise AssertionError(f"dictionary model's pred vs float64 FM: "
                             f"{len(probs)} rows, prob err {p_err}")
    log(f"  saved model: {len(saved_keys)} keys; task=pred over the "
        f"validation rows within {p_err:.3g} of the float64 FM")
    log("phase 9 ok: task=train at the defaults on the dictionary store at "
        "full width: grows, replays with no host-to-device copy, "
        "deterministic, kernels = plain versions")
    return {"launches": launches, "walls": walls}


def phase_layout_cross(work: str) -> dict:
    """Phase 10: a V_dim 16 dictionary run whose growth crosses
    ``pad_v_rows_max_mb=1`` at 2,048 rows (the in-pad row becomes the
    appended one), on the kernels and on the plain versions."""
    import torch
    from difacto_tpu_torch.config import parse_config_file
    from difacto_tpu_torch.updaters.sgd_updater import row_layout
    data_in = os.path.join(work, "cross_train.txt")
    with open(data_in, "wb") as f:
        f.write(synthetic_criteo(4000, SEED + 6))
    kwargs = parse_config_file(DICT_CONF) + [
        ("mesh_dp", "1"), ("mesh_fs", "1"),
        ("data_in", data_in), ("max_num_epochs", "2"),
        ("pad_v_rows_max_mb", "1"), ("init_capacity", "1024")]
    _reset_counts()
    ln, _, _, _ = _train(kwargs)
    launches = _counts()
    p, cap = ln.store.param, ln.store.state.capacity
    before, after = row_layout(p, 2048), row_layout(p, cap)
    if not (cap > 2048 and before[1] == 64 and after[1] == p.V_dim):
        raise AssertionError(f"the layout did not cross: capacity {cap}, "
                             f"(k, h, Wx, off) {before} -> {after}")
    if not all(_table_part(launches).values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    table, keys = ln.store.state.VVg.clone(), ln.store._keys.copy()
    del ln
    restore = _swap_plain()
    try:
        ln, _, _, _ = _train(kwargs)
    finally:
        restore()
    if not (torch.equal(ln.store.state.VVg.view(torch.int32),
                        table.view(torch.int32))
            and np.array_equal(ln.store._keys, keys)):
        raise AssertionError("the layout-crossing run on the plain versions "
                             "left another table")
    log(f"  1024 -> {cap} rows, (k, h, Wx, off) {before} -> {after}; "
        f"launches {launches}; the plain-version run: the same table and "
        "key map bit for bit")
    log("phase 10 ok: growth across pad_v_rows_max_mb, kernels = plain "
        "versions")
    return {"launches": launches}


def phase_local_conf(work: str) -> None:
    """Phase 11: examples/local.conf (logistic regression, the flat
    V_dim=0 table, the dictionary store) through the CLI's learner on the
    card, scored through task=pred against a float64 reference."""
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.config import parse_config_file
    root = os.path.dirname(os.path.abspath(__file__))
    conf = parse_config_file(os.path.join(root, "examples", "local.conf"))
    conf = [(k, os.path.join(root, v) if k == "data_in" else v)
            for k, v in conf]
    model = os.path.join(work, "local")
    _reset_counts()
    ln, progress, walls, _ = _train(conf + [
        ("max_num_epochs", "5"), ("stop_rel_objv", "0"),
        ("model_out", model)])
    loss = [t.loss / t.nrows for t, _ in progress]
    if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
        raise AssertionError(f"local.conf objective per row did not fall: "
                             f"{loss}")
    if any(_table_part(_counts()).values()) or ln.store.param.V_dim != 0:
        raise AssertionError("the flat table launched a fused-row kernel")
    data = dict(conf)["data_in"]
    pred_out = os.path.join(work, "local_pred")
    run_pred([("model_in", model), ("data_in", data),
              ("pred_out", pred_out)], device=DEV)
    with open(pred_out + "_part-0", "rb") as f:
        probs = np.array([float(l.split(b"\t")[1])
                          for l in f.read().splitlines()])
    with np.load(model + "_part-0") as z:
        arrays, keys = {"w": z["w"]}, z["keys"]
    with open(data, "rb") as f:
        ref = reference_margins(f.read(), arrays, keys=keys,
                                data_format="libsvm")
    p_err = float(np.abs(probs - 1.0 / (1.0 + np.exp(-ref))).max())
    if len(probs) != 100 or not p_err <= 1e-4:
        raise AssertionError(f"local.conf pred vs float64 LR: {len(probs)} "
                             f"rows, prob err {p_err}")
    log(f"  local.conf: loss/row {' -> '.join(f'{l:.6f}' for l in loss)}, "
        f"{len(keys)} keys saved, epoch wall s {_epoch_walls(walls)}; "
        f"task=pred within {p_err:.3g} of the float64 LR")
    log("phase 11 ok: the flat table trains and scores on the card")


def _ring_segments() -> set:
    """This process's live shared-memory ring segments."""
    from difacto_tpu_torch.data.shm_ring import RING_PREFIX
    mine = f"{RING_PREFIX}{os.getpid()}_"
    return {n for n in os.listdir("/dev/shm") if n.startswith(mine)}


def _bits_equal(a, b) -> bool:
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _time_producers(lp, data_in: str, hash_capacity: int) -> dict:
    """The producers alone, with no step behind them: epoch 1's batches
    of ``data_in`` through one thread, four threads and four worker
    processes (``spec_iter``, the process mode's make_iter, in all
    three). Seconds to the first batch (for the processes: spawn,
    imports and the first part's first batch) and to the last."""
    import functools
    from difacto_tpu_torch.data.pack_stream import StreamSpec, spec_iter
    from difacto_tpu_torch.data.producer_pool import (OrderedProducerPool,
                                                      ProcessProducerPool)
    from difacto_tpu_torch.ops.batch import bucket
    n = lp.num_jobs_per_epoch
    spec = StreamSpec(
        parts=tuple(range(n)), n_jobs=n, data_in=data_in,
        data_format=lp.data_format, batch_size=lp.batch_size,
        shuffle=lp.shuffle, neg_sampling=lp.neg_sampling, epoch=1,
        hash_capacity=hash_capacity, want_counts=False, fill_counts=False,
        dim_min=8, job="train", b_cap=bucket(lp.batch_size, 8))
    make = functools.partial(spec_iter, spec)
    pools = {
        "1 thread": lambda: OrderedProducerPool(n, make, n_workers=1,
                                                depth=3),
        "4 threads": lambda: OrderedProducerPool(n, make, n_workers=4,
                                                 depth=3),
        "4 processes": lambda: ProcessProducerPool(
            n, make, n_workers=4, depth=3, slot_bytes=1 << 20)}
    out = {}
    for name, pool in pools.items():
        t0 = time.perf_counter()
        first, count = None, 0
        for _ in pool():
            if first is None:
                first = time.perf_counter() - t0
            count += 1
        total = time.perf_counter() - t0
        out[name] = (first, total, count)
        log(f"  producers alone, {name}: first batch after {first:.3f} s, "
            f"{count} batches in {total:.3f} s "
            f"({1e3 * total / count:.2f} ms per batch)")
    return out


# one task=train run of another tree's learner, in its own interpreter
# (that tree's difacto_tpu_torch first on sys.path, its kernels built
# before the clock starts): prints [(epoch, job, wall s)]
_TREE_TRAIN = r"""
import json, sys, time
import torch
from difacto_tpu_torch.learners.sgd import SGDLearner
from difacto_tpu_torch.ops import build
for name in json.loads(sys.argv[2]) if sys.argv[3] == "cuda" else ():
    build.library(name)
ln = SGDLearner(device=sys.argv[3])
ln.init([tuple(kv) for kv in json.loads(sys.argv[1])])
walls, run_epoch = [], ln._run_epoch
def timed(epoch, job_type, prog):
    t0 = time.perf_counter()
    run_epoch(epoch, job_type, prog)
    if sys.argv[3] == "cuda":
        torch.cuda.synchronize()
    walls.append((epoch, job_type, time.perf_counter() - t0))
ln._run_epoch = timed
ln.run()
print(json.dumps(walls))
"""


def _tree_train(tree: str, kwargs: list) -> list:
    """[(epoch, job, wall s)] of one ``task=train`` run of ``tree``'s
    learner (a checkout of another commit) on ``kwargs``."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    r = subprocess.run(
        [sys.executable, "-c", _TREE_TRAIN, json.dumps(kwargs),
         json.dumps(sorted(KERNELS)), DEV],
        cwd=tree, env=env, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"the learner of {tree} failed:\n"
                             f"{r.stderr[-3000:]}")
    return [tuple(w) for w in json.loads(r.stdout.splitlines()[-1])]


def phase_stream(work: str, conf: list, uparam,
                 parents: tuple = ()) -> dict:
    """Phase 12: the streamed pipeline (``device_cache_mb=0``) at the full
    width of examples/criteo_hashed.conf, 50,000 train and 10,000
    validation rows, 2 epochs: (a) one producer thread; (f) four
    threads; (b) four worker processes over the shared-memory ring with
    ``device_dedup=1`` (it engages in epoch 1, past the count push); (c)
    four threads with ``stream_chunks=1``, twice; (d) run (b) on the
    plain versions; (e) run (b) with interval checkpoints and
    ``metrics_path``, stopped after epoch 0, then resumed with
    ``auto_resume=1``; (g) the defaults (``producer_mode`` and
    ``num_producers`` unset), which are process mode on a host with at
    least 4 cores. With ``parents`` (checkouts of other commits), each
    tree's learner trains the defaults run too, in turns with this
    tree's (parents, this, this, parents), for the epoch times."""
    import torch
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.learners.sgd import SGDLearnerParam
    data_in = os.path.join(work, "train.txt")
    data_val = os.path.join(work, "val.txt")
    if not os.path.exists(data_in):
        with open(data_in, "wb") as f:
            f.write(synthetic_criteo(N_TRAIN, SEED + 2))
    if not os.path.exists(data_val):
        with open(data_val, "wb") as f:
            f.write(synthetic_criteo(N_VAL, SEED + 3))
    with open(data_val, "rb") as f:
        val_text = f.read()
    kwargs = conf + [("data_in", data_in), ("data_val", data_val),
                     ("max_num_epochs", "2"), ("stop_rel_objv", "0"),
                     ("stop_val_auc", "-2"), ("device_cache_mb", "0"),
                     ("report_interval", "0")]
    lp, _ = SGDLearnerParam.init_allow_unknown(kwargs)
    train_b, val_b = _count_batches(lp, data_in, data_val, 2)
    if train_b[0] != train_b[1]:
        raise AssertionError(f"epochs cut {train_b} batches")
    nb = train_b[0]
    # one gather and one push per step, one more gather and a count push
    # per epoch-0 batch, one gather per validation block and epoch
    want = {"gather_rows_cuda": 2 * nb + nb + 2 * val_b,
            "fm_update_rows_cuda": 2 * nb, "scatter_rows_cuda": nb}
    log(f"  {nb} train batches per epoch (both epochs stream), {val_b} "
        f"validation block(s); {os.cpu_count()} host cores")
    total = {c: 0 for c in COUNTERS}
    peaks = {}

    def run(name, extra, counted=True):
        if counted:
            _reset_counts()
        base = _peak_reset()
        ln, progress, walls, _ = _train(kwargs + list(extra))
        # the run's own peak, above what earlier phases hold
        peaks[name] = (torch.cuda.max_memory_allocated() - base
                       if DEV == "cuda" else 0)
        if counted:
            got = _counts()
            for c in COUNTERS:
                total[c] += got[c]
        st = ln.stage_stats()
        log(f"  run {name}: epoch wall s {_epoch_walls(walls)}; stages "
            f"{st}")
        bits = ln.store.state.VVg.clone()
        loss = [t.loss / t.nrows for t, _ in progress]
        del ln
        gc.collect()
        torch.cuda.empty_cache()
        return bits, loss, st, walls

    model = os.path.join(work, "stream_a")
    bits_a, loss_a, st_a, walls_a = run(
        "(a) 1 thread", [("num_producers", "1"),
                         ("producer_mode", "thread"), ("has_aux", "1"),
                         ("model_out", model)])
    if _table_part(total) != want:
        raise AssertionError(f"run (a) launches {total}, the batches need "
                             f"{want}")
    if not (np.isfinite(loss_a).all() and loss_a[1] < loss_a[0]):
        raise AssertionError(f"objective per row did not fall: {loss_a}")
    bits_f, loss_f, st_f, walls_f = run(
        "(f) 4 threads", [("num_producers", "4"),
                          ("producer_mode", "thread")])
    if not _bits_equal(bits_f, bits_a) or st_f["producer_mode"] != "thread":
        raise AssertionError("4 producer threads left another table")
    del bits_f
    proc = [("num_producers", "4"), ("producer_mode", "process"),
            ("device_dedup", "1")]
    before = _ring_segments()
    bits_b, _, st_b, walls_b = run("(b) 4 processes, device_dedup", proc)
    if st_b["producer_mode"] != "process":
        raise AssertionError(f"run (b) ran on {st_b['producer_mode']}")
    if not _bits_equal(bits_b, bits_a):
        raise AssertionError("run (b) left another table than run (a)")
    del bits_b
    chunked = [("num_producers", "4"), ("producer_mode", "thread"),
               ("stream_chunks", "1")]
    bits_c, loss_c, _, walls_c = run("(c) 4 threads, stream_chunks",
                                     chunked)
    bits_c2, loss_c2, _, _ = run("(c) again", chunked)
    if not _bits_equal(bits_c, bits_c2) or loss_c != loss_c2:
        raise AssertionError("stream_chunks=1 did not repeat bit for bit")
    del bits_c2
    ref = bits_a.view(torch.float32)
    c_err = float((bits_c - ref).abs().max()) / float(ref.abs().max())
    l_err = max(abs(x - y) / abs(y) for x, y in zip(loss_c, loss_a))
    if not (c_err <= 2e-5 and l_err <= 2e-5):
        raise AssertionError(f"stream_chunks=1 vs run (a): table {c_err}, "
                             f"loss {l_err} (limit 2e-5)")
    del bits_c
    log(f"  run (c) vs (a): table within {c_err:.3g} of max|a|, loss per "
        f"row within {l_err:.3g} (limit 2e-5)")
    _reset_counts()
    restore = _swap_plain()
    try:
        bits_d, _, _, _ = run("(d) run (b) on the plain versions", proc,
                              counted=False)
    finally:
        restore()
    if any(_table_part(_counts()).values()):
        raise AssertionError("the run on the plain versions launched a "
                             "kernel")
    if not _bits_equal(bits_d, bits_a):
        raise AssertionError("run (d) left another table than run (a)")
    del bits_d
    ck = os.path.join(work, "stream_e")
    metrics = os.path.join(work, "stream_e.jsonl")
    fault = proc + [("ckpt_interval", "1"), ("ckpt_keep", "2"),
                    ("model_out", ck), ("metrics_path", metrics),
                    ("metrics_interval_s", "1")]
    run("(e) stopped after epoch 0", fault + [("max_num_epochs", "1")])
    if not os.path.exists(ck + "_iter-0_part-0"):
        raise AssertionError("run (e) left no interval checkpoint")
    bits_e, _, st_e, walls_e = run("(e) resumed", fault + [
        ("max_num_epochs", "2"), ("auto_resume", "1")])
    if [e for e, j, _ in walls_e if j == 3] != [1]:
        raise AssertionError(f"run (e) did not resume at epoch 1: "
                             f"{walls_e}")
    if not _bits_equal(bits_e, bits_a):
        raise AssertionError("the resumed run (e) left another table than "
                             "run (a)")
    del bits_e
    # (g) the defaults, in turns with the parents' learners on the same
    # arguments
    trees = {os.path.basename(os.path.normpath(d)): d for d in parents}
    tree_walls = {n: [_tree_train(d, kwargs)] for n, d in trees.items()}
    bits_g, _, st_g, walls_g = run("(g) the defaults", [])
    auto = "process" if (os.cpu_count() or 1) >= 4 else "thread"
    if st_g["producer_mode"] != auto:
        raise AssertionError(f"the defaults ran on {st_g['producer_mode']}, "
                             f"not {auto}")
    if not _bits_equal(bits_g, bits_a):
        raise AssertionError("run (g) left another table than run (a)")
    del bits_g
    walls_g = [walls_g]
    if parents:
        walls_g.append(run("(g) again", [], counted=False)[3])
        for n, d in trees.items():
            tree_walls[n].append(_tree_train(d, kwargs))
    for name, turns in tree_walls.items():
        for w in turns:
            log(f"  the defaults on the learner of {name}: epoch wall s "
                f"{_epoch_walls(w)}")
    if _table_part(total) != {c: 7 * v for c, v in want.items()}:
        raise AssertionError(f"runs (a), (f), (b), (c) x2, (e) and (g) "
                             f"launched {total}, the batches need 7 x "
                             f"{want}")
    leaked = _ring_segments() - before
    if leaked:
        raise AssertionError(f"shared-memory segments left: {leaked}")
    with open(metrics) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    stages = lines[-1]["metrics"]["counters"]["stage_seconds_total"]
    need = {f"stage={s}" for s in ("parse", "pack", "ring_wait",
                                   "transfer", "step")}
    if not need <= set(stages):
        raise AssertionError(f"metrics JSONL stages {sorted(stages)}")
    log(f"  run (e): {len(lines)} metrics lines; the last one's stages "
        f"{ {k: round(v, 3) for k, v in stages.items()} }")
    # the saved model of run (a) through phase 3's pred path vs a float64
    # FM over its arrays
    with np.load(model + "_part-0") as z:
        arrays = {f: z[f] for f in ("w", "V", "v_live")}
    pred_out = os.path.join(work, "stream_pred")
    run_pred(conf + [("model_in", model), ("data_in", data_val),
                     ("pred_out", pred_out)], device=DEV)
    with open(pred_out + "_part-0", "rb") as f:
        probs = np.array([float(x.split(b"\t")[1])
                          for x in f.read().splitlines()])
    ref_m = reference_margins(val_text, arrays, uparam.hash_capacity)
    p_err = float(np.abs(probs - 1.0 / (1.0 + np.exp(-ref_m))).max())
    if len(probs) != N_VAL or not p_err <= 1e-4:
        raise AssertionError(f"run (a)'s model pred vs float64 FM: "
                             f"{len(probs)} rows, prob err {p_err}")
    log(f"  run (a)'s saved model: task=pred within {p_err:.3g} of the "
        "float64 FM")
    producers = _time_producers(lp, data_in, uparam.hash_capacity)
    log("phase 12 ok: the streamed pipeline at full width; threads, "
        "processes, device_dedup and the resumed run leave run (a)'s "
        "table bit for bit, stream_chunks within 2e-5; no ring segment "
        "left")
    return {"launches": total, "batches": nb, "val_blocks": val_b,
            "loss_f": loss_f, "peak_f": peaks["(f) 4 threads"],
            "walls_f": walls_f, "bits_f": bits_a.cpu(),
            "walls": {"a": walls_a, "f": walls_f, "b": walls_b,
                      "c": walls_c, "e": walls_e, "g": walls_g,
                      "parents": tree_walls},
            "stages": {"a": st_a, "f": st_f, "b": st_b, "e": st_e,
                       "g": st_g},
            "producers": producers}


def _cli(args: list) -> tuple:
    """``python -m difacto_tpu_torch args...`` in its own interpreter
    from this tree; returns (its wall seconds, its log)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "difacto_tpu_torch", *args],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"difacto_tpu_torch {args[0]} failed:\n"
                             f"{r.stderr[-3000:]}")
    return time.perf_counter() - t0, r.stderr


def _cache_batches(uri: str, batch_size: int, n_jobs: int) -> int:
    """Batches per epoch the cached reader cuts from ``uri`` over
    ``n_jobs`` parts (members are batch-aligned, so shuffling the rows
    within them moves no batch boundary)."""
    from difacto_tpu_torch.data.cached import CachedBatchReader
    return sum(1 for part in range(n_jobs) for _ in CachedBatchReader(
        uri, part, n_jobs, batch_size))


def _kernels_on_cache_payloads(table, uri: str, uparam) -> None:
    """The gather and both push routes on the slot vectors the cache path
    packs (prepare_from_uniq of the first three members, epoch 0), on the
    trained table: each kernel equals its plain version byte for byte."""
    import torch
    from difacto_tpu_torch.data.cached import CachedBatchReader
    from difacto_tpu_torch.data.pack_stream import (ShapeSchedule,
                                                    prepare_from_uniq)
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.updaters import sgd_updater as T
    C = table.shape[0]
    epi = T.epilogue_spec(uparam, C)
    plain = functools.partial(T.row_epilogue, uparam, C)
    shapes = ShapeSchedule()
    for i, (sub, uniq, cnts) in enumerate(CachedBatchReader(
            uri, batch_size=1000, need_counts=True)):
        if i == 3:
            break
        pl = prepare_from_uniq(shapes, C, sub, uniq, cnts, True, True, 8,
                               "train", 1024)
        off = pl.b_cap * pl.d2 if pl.layout == "panel" else 2 * pl.d2
        slots = torch.from_numpy(pl.i32[off:off + pl.u_cap].copy()).to(DEV)
        rows = fused.gather_rows(table, slots)
        same = torch.equal(rows.view(torch.uint8), fused.gather_rows_ref(
            table, slots).view(torch.uint8))
        gw, gV, vm = _step_inputs(uparam.V_dim, pl.u_cap, SEED + 13 + i)
        for on in (True, False):
            got, want = table.clone(), table.clone()
            if on:
                fused.fm_update_rows(got, slots, rows, gw, gV, vm, epi,
                                     plain)
                fused.fm_update_rows_ref(want, slots, rows, gw, gV, vm,
                                         plain)
            else:
                fused.scatter_rows(got, slots, rows)
                fused.scatter_rows_ref(want, slots, rows)
            sync()
            same &= torch.equal(got.view(torch.uint8),
                                want.view(torch.uint8))
            del got, want
        if not same:
            raise AssertionError(f"a kernel != its plain version on cached "
                                 f"batch {i} (u_cap {pl.u_cap})")
        log(f"  cached batch {i}: {pl.layout}, {sub.size} rows, u_cap "
            f"{pl.u_cap} ({int(pl.i32[-1])} real): gather, push and count "
            "push bit-exact with their plain versions")


def phase_cache(work: str, conf: list, uparam, text: dict) -> dict:
    """Phase 13: the rec2 cache at the full width of
    examples/criteo_hashed.conf. ``task=convert`` writes phase 12's
    50,000 train and 10,000 validation rows as 1,000-row pre-localized
    members (serially, then the train rows again with ``convert_procs``
    at auto); 2 epochs train from the serial cache: (h) four producer
    threads and (i) four worker processes (``device_cache_mb=0``, 10
    parts, shuffle 10), (j) rec2 and (k) text at one part with shuffle 0
    (threads), (l) the defaults with the replay cache, twice, and once
    on the plain versions. (i) equals (h), (k) equals (j), and the three
    (l) runs equal each other, bit for bit; launches match the batches;
    (l)'s model scores through phase 3's pred path, reading the
    validation cache, within 1e-4 of a float64 FM, and ``task=dump``
    writes one line per live row. ``text`` is phase 12's result: its
    stage_stats of the same runs from text on threads (f) and processes
    (g) are printed per batch beside the cache's."""
    import torch
    from difacto_tpu_torch import native
    from difacto_tpu_torch.__main__ import main as cli_main
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.learners.sgd import SGDLearnerParam
    from difacto_tpu_torch.updaters.sgd_updater import TRASH_SLOT
    t_phase = time.monotonic()
    lib = native.get_lib()
    if lib is None:
        raise AssertionError("the native parsers did not build or load")
    log(f"  native parsers loaded: {native.library_path().name} "
        "(libsvm, criteo, adfea; g++ at first use)")
    data_in = os.path.join(work, "train.txt")
    data_val = os.path.join(work, "val.txt")
    with open(data_val, "rb") as f:
        val_text = f.read()
    cache, cache_val, cache_auto = (os.path.join(work, n) for n in (
        "train.rec", "val.rec", "train_auto.rec"))
    secs = {}
    for name, src, out, procs in (("serial", data_in, cache, "1"),
                                  ("val", data_val, cache_val, "1"),
                                  ("auto", data_in, cache_auto, "0")):
        secs[name], _ = _cli(["task=convert", f"data_in={src}",
                              "data_format=criteo", f"data_out={out}",
                              "data_out_format=rec", "batch_size=1000",
                              f"convert_procs={procs}"])
    from difacto_tpu_torch.data.reader import Reader
    n_auto = sum(b.size for b in Reader(cache_auto, "rec"))
    if n_auto != N_TRAIN:
        raise AssertionError(f"the auto convert holds {n_auto} rows")
    log(f"  task=convert (CLI wall, interpreter start included): "
        f"{N_TRAIN} rows serially in {secs['serial']:.2f} s "
        f"({N_TRAIN / secs['serial']:.0f} rows/s), with convert_procs "
        f"auto ({len(os.listdir(cache_auto))} members over "
        f"{min(os.cpu_count() or 1, 8)} workers) in {secs['auto']:.2f} s "
        f"({N_TRAIN / secs['auto']:.0f} rows/s); {N_VAL} validation rows "
        f"in {secs['val']:.2f} s")
    base = conf + [("data_in", cache), ("data_val", cache_val),
                   ("data_format", "rec"), ("max_num_epochs", "2"),
                   ("stop_rel_objv", "0"), ("stop_val_auc", "-2"),
                   ("report_interval", "0")]
    lp, _ = SGDLearnerParam.init_allow_unknown(base)
    val_b = _cache_batches(cache_val, lp.batch_size, 1)
    total = {c: 0 for c in COUNTERS}

    def run(name, kwargs, nb, nv, counted=True):
        _reset_counts()
        ln, progress, walls, _ = _train(kwargs)
        got = _counts()
        want = ({"gather_rows_cuda": 3 * nb + 2 * nv,
                 "fm_update_rows_cuda": 2 * nb, "scatter_rows_cuda": nb}
                if counted else {c: 0 for c in TABLE_COUNTERS})
        if _table_part(got) != want:
            raise AssertionError(f"run {name} launches {got}, the batches "
                                 f"need {want}")
        for c in COUNTERS:
            total[c] += got[c]
        st = ln.stage_stats()
        per = {k: round(1e3 * st[k + "_s"] / (2 * nb), 3)
               for k in ("parse", "pack")}
        log(f"  run {name}: epoch wall s {_epoch_walls(walls)}; parse "
            f"{per['parse']} ms and pack {per['pack']} ms per batch; "
            f"stages {st}; launches {got}")
        loss = [t.loss / t.nrows for t, _ in progress]
        if not (np.isfinite(loss).all() and loss[1] < loss[0]):
            raise AssertionError(f"run {name}: loss per row {loss}")
        bits = ln.store.state.VVg.clone()
        del ln
        gc.collect()
        torch.cuda.empty_cache()
        return bits, st, per

    streamed = [("device_cache_mb", "0"), ("num_producers", "4")]
    nb = _cache_batches(cache, lp.batch_size, lp.num_jobs_per_epoch)
    bits_h, st_h, _ = run("(h) rec2, 4 threads", base + streamed + [
        ("producer_mode", "thread")], nb, val_b)
    bits_i, st_i, _ = run("(i) rec2, 4 processes", base + streamed + [
        ("producer_mode", "process")], nb, val_b)
    if st_i["producer_mode"] != "process" or not _bits_equal(bits_i,
                                                             bits_h):
        raise AssertionError("run (i) left another table than run (h)")
    del bits_i
    one = streamed + [("num_jobs_per_epoch", "1"), ("shuffle", "0"),
                      ("producer_mode", "thread")]
    nb1 = _cache_batches(cache, lp.batch_size, 1)
    bits_j, _, per_j = run("(j) rec2, one part", base + one, nb1, val_b)
    from_text = conf + [("data_in", data_in), ("data_val", data_val),
                        ("max_num_epochs", "2"), ("stop_rel_objv", "0"),
                        ("stop_val_auc", "-2"), ("report_interval", "0")]
    bits_k, _, per_k = run("(k) text, one part", from_text + one, nb1, 1)
    if not _bits_equal(bits_k, bits_j):
        raise AssertionError("text and rec2 at one part left two tables")
    del bits_j, bits_k, bits_h
    model = os.path.join(work, "cache_l")
    bits_l, st_l, _ = run("(l) rec2, the defaults", base + [
        ("has_aux", "1"), ("model_out", model)], nb, val_b)
    bits_l2, _, _ = run("(l) again", base, nb, val_b)
    restore = _swap_plain()
    try:
        bits_l3, _, _ = run("(l) on the plain versions", base, nb, val_b,
                            counted=False)
    finally:
        restore()
    if not (_bits_equal(bits_l2, bits_l) and _bits_equal(bits_l3, bits_l)):
        raise AssertionError("the replayed runs (l) left different tables")
    del bits_l2, bits_l3
    _kernels_on_cache_payloads(bits_l, cache, uparam)
    del bits_l
    torch.cuda.empty_cache()
    for name, key in (("4 threads", "f"), ("4 processes", "g")):
        st = text["stages"][key]
        per = {k: round(1e3 * st[k + "_s"] / (2 * text["batches"]), 3)
               for k in ("parse", "pack")}
        log(f"  text, {name} (phase 12 run ({key})): parse {per['parse']} "
            f"ms and pack {per['pack']} ms per batch")
    with np.load(model + "_part-0") as z:
        arrays = {f: z[f] for f in ("w", "V", "v_live")}
    pred_out = os.path.join(work, "cache_pred")
    run_pred(conf + [("model_in", model), ("data_in", cache_val),
                     ("data_format", "rec"), ("pred_out", pred_out)],
             device=DEV)
    with open(pred_out + "_part-0", "rb") as f:
        probs = np.array([float(x.split(b"\t")[1])
                          for x in f.read().splitlines()])
    ref_m = reference_margins(val_text, arrays, uparam.hash_capacity)
    p_err = float(np.abs(probs - 1.0 / (1.0 + np.exp(-ref_m))).max())
    if len(probs) != N_VAL or not p_err <= 1e-4:
        raise AssertionError(f"run (l)'s model pred (from the validation "
                             f"cache) vs float64 FM: {len(probs)} rows, "
                             f"prob err {p_err}")
    dump = os.path.join(work, "cache_l.tsv")
    t0 = time.perf_counter()
    cli_main(["task=dump", f"device={DEV}", f"model_in={model}_part-0",
              f"hash_capacity={uparam.hash_capacity}", f"name_dump={dump}"])
    dump_s = time.perf_counter() - t0
    live = (arrays["w"] != 0) | arrays["v_live"]
    live[TRASH_SLOT] = False
    with open(dump, "rb") as f:
        n_lines = sum(1 for _ in f)
    if n_lines != int(live.sum()):
        raise AssertionError(f"task=dump wrote {n_lines} lines for "
                             f"{int(live.sum())} live rows")
    log(f"  run (l)'s model: task=pred over the validation cache within "
        f"{p_err:.3g} of the float64 FM; task=dump {n_lines} lines (the "
        f"live rows) in {dump_s:.2f} s")
    log(f"phase 13 ok in {time.monotonic() - t_phase:.1f} s: the rec2 cache "
        "at full width; threads = processes, text = rec2 at one part, the "
        "replayed runs repeat and equal the plain versions, bit for bit")
    return {"launches": total, "convert_s": secs,
            "stages": {"h": st_h, "i": st_i, "j": per_j, "k": per_k,
                       "l": st_l}}


# the reference's goldens (tests/cpp/bcd_learner_test.cc,
# tests/cpp/lbfgs_learner_test.cc), copied: the smoke imports no tests
BCD_OPTIMUM = (15.884923, 47)   # objv summed over rcv1's 100 rows, nnz(w)
OBJV_DIAG_NEWTON = [
    34.877064, 33.885559, 29.572740, 27.458964, 25.317689, 23.917098,
    22.855843, 22.099876, 21.552682, 21.137216,
]
OBJV_BASIC = [
    34.603421, 12.655075, 5.224232, 2.713903, 1.290586, 0.645131, 0.317889,
    0.156723, 0.075331, 0.032091, 0.018044, 0.008562, 0.004336, 0.002132,
    0.001051, 0.000506, 0.000227, 0.000119, 0.000059,
]
OBJV_WITHV = [
    35.224265, 21.631514, 18.394319, 16.077692, 12.389012, 8.888516,
    8.446880, 8.146090, 8.023501, 7.981967, 7.955119, 7.937092, 7.922456,
    7.880596, 7.861660, 7.838057, 7.807892, 7.784401, 7.756756, 7.728613,
    7.724718, 7.709527, 7.705667,
]


def _det_init(lens, weights):
    """The reference's deterministic V init (lbfgs_learner_test.cc:128-140):
    V[j] = (j - V_dim/2) * .01."""
    n = 0
    for ln in lens:
        for i in range(ln):
            if i > 0:
                weights[n] = (i - (ln - 1) / 2) * 0.01
            n += 1
    return weights


def _batch_run(name: str, kwargs: list, device=None, init=None,
               callback=None):
    """One run of a batch learner through ``Learner.create``: (learner,
    per-epoch progress, per-epoch wall s, host s per BCD block or per
    L-BFGS ``_calc_grad`` pass). The first epoch's wall includes reading
    the data and building the tiles; ``callback(learner, epoch, prog)``
    runs after each epoch's wall is taken."""
    from difacto_tpu_torch.learners.base import Learner
    ln = Learner.create(name, device=device or DEV)
    rest = ln.init(list(kwargs))
    if rest:
        raise AssertionError(f"{name}: unknown keys {rest}")
    if init is not None:
        ln.set_weight_initializer(init)
    progs, walls, steps = [], [], []
    mark = [time.perf_counter()]

    def cb(epoch, prog):
        sync()
        now = time.perf_counter()
        walls.append(now - mark[0])
        progs.append(prog)
        if callback is not None:
            callback(ln, epoch, prog)
        mark[0] = time.perf_counter()

    ln.add_epoch_end_callback(cb)
    attr = "_iterate_block" if name == "bcd" else "_calc_grad"
    inner = getattr(ln, attr)

    def timed(*args):
        t0 = time.perf_counter()
        out = inner(*args)
        sync()
        steps.append(time.perf_counter() - t0)
        return out

    setattr(ln, attr, timed)
    ln.run()
    sync()
    delattr(ln, attr)         # later calls (the profiles) are not timed
    return ln, progs, walls, steps


def _np_bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return np.array_equal(a.view(np.int32), b.view(np.int32))


def _rel_close(a, b, tol: float) -> bool:
    return all(abs(x - y) <= tol * max(abs(y), 1e-30)
               for x, y in zip(a, b))


def _peak_reset() -> int:
    """Reset the card's peak-memory count; returns the bytes allocated
    now (earlier phases' tensors), which the peak is read above."""
    import torch
    if DEV != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _busy_idle(fn) -> tuple:
    """(device busy ms, host wall ms, idle share, top device entries,
    device events per pass) of one ``fn()``: the median device time of
    three one-pass profiles against the median wall of three passes timed
    without the profiler, and the five entries with the most device time
    in one more profile (name, ms, calls). A pass here launches thousands
    of kernels, and the card's profiler may lose a few of them (a BCD
    epoch's count was seen to move between 7,836 and 7,840 on an H100),
    so ``device_ms``'s exact-count rule does not apply; the counts are
    returned instead."""
    fn()
    sync()
    profs = [_profile(fn, [()], 1) if DEV == "cuda" else
             (device_ms(fn, [()], 1) * 1e3, 0, []) for _ in range(3)]
    busy = float(np.median([us for us, _, _ in profs])) / 1e3
    events = [n for _, n, _ in profs]
    walls = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    top = []
    if DEV == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        ev = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
        top = [(e.key[:48], e.self_device_time_total / 1e3, e.count)
               for e in ev[:5]]
    return busy, wall, 1.0 - busy / wall, top, events


def _top_text(top) -> str:
    return "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in top)


def phase_batch_learners(work: str, smi: str) -> dict:
    """Phase 14: the batch learners on the card. (a) examples/bcd.conf and
    examples/lbfgs.conf through the CLI on the default device; (b) BCD's
    diag-Newton and L-BFGS's with-V goldens through the learner API; (c)
    full width: phase 12's 50,000 train and 10,000 validation rows (the
    same fields, labelled from a planted model), BCD with bcd.conf's
    learner keys and L-BFGS as an FM (V_dim 16), each repeated, with a
    tile cache small enough to evict, and warm-started on the card and on
    the CPU from its card checkpoint. Neither path launches a kernel of
    the port."""
    import torch
    from difacto_tpu_torch.config import parse_config_file
    t_phase = time.monotonic()
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 matmuls are on: the L-BFGS Gram matrix "
                             "and direction must run in full float32")
    root = os.path.dirname(os.path.abspath(__file__))
    rcv1 = os.path.join(root, "tests", "data", "rcv1_100.libsvm")
    dev_args = ["device=cpu"] if DEV == "cpu" else []
    _reset_counts()

    # (a) the examples as they are, through the CLI
    bcd_cli_s, err = _cli([os.path.join("examples", "bcd.conf")]
                          + dev_args)
    rows = re.findall(r"epoch: (\d+), objv: (\S+), auc: \S+, acc: \S+, "
                      r"nnz\(w\): (\d+), rows: (\d+)", err)
    objv = float(rows[-1][1]) * int(rows[-1][3])
    nnz = int(rows[-1][2])
    if len(rows) != 50 or abs(objv - BCD_OPTIMUM[0]) / objv >= 1e-3 \
            or nnz != BCD_OPTIMUM[1]:
        raise AssertionError(f"examples/bcd.conf: {len(rows)} epochs, objv "
                             f"{objv}, nnz {nnz}; want {BCD_OPTIMUM}")
    lbfgs_cli_s, err = _cli([os.path.join("examples", "lbfgs.conf")]
                            + dev_args)
    got = np.array([float(v) for v in re.findall(
        r"epoch \d+: objv = ([^,]+),", err)])
    cli_err = float(np.abs(got - OBJV_BASIC).max()) \
        if len(got) == len(OBJV_BASIC) else float("inf")
    if not cli_err < 1e-5:
        raise AssertionError(f"examples/lbfgs.conf objv {got.tolist()} vs "
                             f"{OBJV_BASIC}")
    log(f"  (a) CLI: bcd.conf objv {objv:.6f} nnz {nnz} after 50 epochs "
        f"({bcd_cli_s:.1f} s); lbfgs.conf 19 epochs within {cli_err:.3g} "
        f"of the golden ({lbfgs_cli_s:.1f} s)")

    # (b) the other goldens through the learner API
    _, dn, _, _ = _batch_run("bcd", [
        ("data_in", rcv1), ("l1", ".1"), ("lr", ".05"),
        ("block_ratio", "0.001"), ("tail_feature_filter", "0"),
        ("max_num_epochs", "10")])
    dn_err = max(abs(p.objv - g) / p.objv
                 for p, g in zip(dn, OBJV_DIAG_NEWTON))
    _, wv, _, _ = _batch_run("lbfgs", [
        ("data_in", rcv1), ("m", "5"), ("V_dim", "5"), ("l2", "0.1"),
        ("V_l2", "0.01"), ("V_threshold", "0"), ("rho", "0.5"),
        ("init_alpha", "1"), ("tail_feature_filter", "0"),
        ("max_num_epochs", str(len(OBJV_WITHV)))], init=_det_init)
    wv_err = max(abs(p.objv - g) for p, g in zip(wv, OBJV_WITHV))
    if len(dn) != 10 or not dn_err < 1e-5 or len(wv) != len(OBJV_WITHV) \
            or not wv_err < 2e-4:
        raise AssertionError(f"goldens: diag-Newton rel {dn_err}, with-V "
                             f"abs {wv_err}")
    log(f"  (b) diag-Newton 10 epochs within {dn_err:.3g} relative, "
        f"L-BFGS with V 23 epochs within {wv_err:.3g}")

    # (c) full width
    data_in = os.path.join(work, "bl_train.txt")
    data_val = os.path.join(work, "bl_val.txt")
    with open(data_in, "wb") as f:
        f.write(synthetic_criteo(N_TRAIN, SEED + 2, planted=True))
    with open(data_val, "wb") as f:
        f.write(synthetic_criteo(N_VAL, SEED + 3, planted=True))
    chunk = os.path.getsize(data_in) // 5     # >= 5 training tiles
    data = [("data_in", data_in), ("data_val", data_val),
            ("data_format", "criteo")]
    out = {"smi": smi}

    bcd_conf = [(k, v) for k, v in parse_config_file(
        os.path.join(root, "examples", "bcd.conf"))
        if k not in ("data_in", "learner", "max_num_epochs")]
    bkw = data + bcd_conf + [("data_chunk_size", str(chunk)),
                             ("max_num_epochs", "3")]
    model = os.path.join(work, "bcd_model")
    base = _peak_reset()
    from difacto_tpu_torch.losses.metrics import (auc_times_n_np,
                                                  logit_objv_np)

    def split(tiles, is_train):
        """(labels, preds) of the training or the validation tiles."""
        ts = [t for t in tiles if t["is_train"] == is_train]
        return (np.concatenate([t["label_np"] for t in ts]),
                torch.cat([t["pred"][:t["size"]] for t in ts]).cpu().numpy())

    # the progress sums the loss over training and validation rows
    # (UpdtPred); the sweeps minimize the training loss + l1 |w|_1
    def objective(out):
        return lambda ln, e, p: out.append(
            (logit_objv_np(*split(ln.tiles, True))
             + ln.uparam.l1 * np.abs(ln.w.astype(np.float64)).sum())
            / ln.ntrain)

    objv = []
    ln, pa, walls, steps = _batch_run("bcd", bkw + [("model_out", model)],
                                      callback=objective(objv))
    peak = torch.cuda.max_memory_allocated() - base if DEV == "cuda" else 0
    vlab, vpred = split(ln.tiles, False)
    val_auc = auc_times_n_np(vlab, vpred) / len(vlab)
    ntr = sum(t["is_train"] for t in ln.tiles)
    if not (objv[-1] < objv[0] and val_auc > 0.5 and ntr >= 4):
        raise AssertionError(f"bcd at full width: training objective/row "
                             f"{objv}, val auc "
                             f"{val_auc}, {ntr} train tiles")
    _, pb, _, _ = _batch_run("bcd", bkw)
    lc, pc, _, _ = _batch_run("bcd", bkw + [("tile_cache_items", "2"),
                                            ("tile_cache_mb", "1")])
    if pb != pa or pc != pa or not _np_bits_equal(lc.w, ln.w):
        raise AssertionError("bcd: a repeat or the small-cache run left "
                             "another trajectory")
    if lc._tile_cache.misses <= 3 * len(ln.tiles) * len(ln.blocks):
        raise AssertionError("bcd: the small slice cache did not evict")
    warm = bkw + [("max_num_epochs", "1"), ("model_in", model)]
    wobj = []
    _, wc, _, _ = _batch_run("bcd", warm, callback=objective(wobj))
    _, wh, _, _ = _batch_run("bcd", warm, device="cpu")
    if not _rel_close(wh[0], wc[0], 1e-5) or not wobj[0] < objv[0]:
        raise AssertionError(f"bcd warm start, card {wc[0]} vs CPU {wh[0]}, "
                             f"objective {wobj} against a cold {objv[0]}")
    busy, wall, idle, top, events = _busy_idle(
        lambda: [ln._iterate_block(f) for f in range(len(ln.blocks))])
    out["bcd"] = dict(blocks=len(ln.blocks), tiles=len(ln.tiles),
                      nf=len(ln.feaids), walls=walls,
                      block_ms=1e3 * float(np.median(steps)),
                      busy_ms=busy, wall_ms=wall, idle=idle, peak=peak,
                      objv=objv, val_auc=val_auc,
                      misses=lc._tile_cache.misses)
    log(f"  (c) bcd: {len(ln.blocks)} blocks, {len(ln.tiles)} tiles "
        f"({ntr} train), {len(ln.feaids)} features; training loss + l1 "
        f"|w|_1 per row "
        f"{' -> '.join(f'{o:.6f}' for o in objv)}, validation AUC "
        f"{val_auc:.4f}; epoch wall s {', '.join(f'{w:.3f}' for w in walls)} "
        f"(epoch 0 with the read); host ms per block, median "
        f"{out['bcd']['block_ms']:.3f}; one epoch: device busy "
        f"{busy:.3f} ms of {wall:.3f} ms wall, idle {idle:.1%}; peak "
        f"allocated {peak / 2**20:.1f} MiB over the run's start; repeat "
        f"and small cache "
        f"({lc._tile_cache.misses} slice builds) bit-identical; CPU warm "
        f"start within 1e-5 ({smi})")
    log(f"    bcd epoch: device events per profile {events}; top device "
        f"entries: {_top_text(top)}")

    lkw = data + [("V_dim", "16"), ("l2", "0.1"), ("V_l2", "0.01"),
                  ("m", "5"), ("max_num_epochs", "5"),
                  ("data_chunk_size", repr(chunk / 2 ** 20))]
    model = os.path.join(work, "lbfgs_model")
    base = _peak_reset()
    ln, pa, walls, steps = _batch_run("lbfgs", lkw + [("model_out", model)])
    peak = torch.cuda.max_memory_allocated() - base if DEV == "cuda" else 0
    if not (pa[-1].objv < pa[0].objv and pa[-1].val_auc > 0.5
            and ln._n_tiles["train"] >= 4):
        raise AssertionError(f"lbfgs at full width: {pa}")
    lb, pb, _, _ = _batch_run("lbfgs", lkw)
    lc, pc, _, _ = _batch_run("lbfgs", lkw + [("tile_cache_mb", "1")])
    if pb != pa or pc != pa or not _bits_equal(lb.weights, ln.weights) \
            or not _bits_equal(lc.weights, ln.weights):
        raise AssertionError("lbfgs: a repeat or the small-cache run left "
                             "another trajectory")
    # a tile outgrows the 1 MB budget alone, so every fetch rebuilds
    if lc._tile_cache.misses < len(steps) * ln._n_tiles["train"]:
        raise AssertionError("lbfgs: the small tile cache did not evict")
    warm = lkw + [("max_num_epochs", "1"), ("model_in", model)]
    _, wc, _, _ = _batch_run("lbfgs", warm)
    _, wh, _, _ = _batch_run("lbfgs", warm, device="cpu")
    if not _rel_close(wh[0], wc[0], 1e-5) or not wc[0].objv < pa[0].objv:
        raise AssertionError(f"lbfgs warm start, card {wc[0]} vs CPU "
                             f"{wh[0]}")
    busy, wall, idle, top, events = _busy_idle(
        lambda: ln._calc_grad(ln.weights))
    out["lbfgs"] = dict(tiles=ln._n_tiles, N=ln.N, walls=walls,
                        grad_ms=1e3 * float(np.median(steps)),
                        passes=len(steps), busy_ms=busy, wall_ms=wall,
                        idle=idle, peak=peak,
                        objv=[p.objv for p in pa],
                        val_auc=[p.val_auc for p in pa],
                        misses=lc._tile_cache.misses)
    log(f"  (c) lbfgs FM V_dim 16: {ln._n_tiles} tiles, N {ln.N}; objv "
        f"{' -> '.join(f'{p.objv:.3f}' for p in pa)}, validation AUC "
        f"{' -> '.join(f'{p.val_auc:.4f}' for p in pa)}; epoch wall s "
        f"{', '.join(f'{w:.3f}' for w in walls)} (epoch 0 with the read); "
        f"host ms per _calc_grad pass, median "
        f"{out['lbfgs']['grad_ms']:.3f} "
        f"({len(steps)} passes); one pass: device busy {busy:.3f} ms of "
        f"{wall:.3f} ms wall, idle {idle:.1%}; peak allocated "
        f"{peak / 2**20:.1f} MiB over the run's start; repeat and small "
        f"cache "
        f"({lc._tile_cache.misses} tile builds) bit-identical; CPU warm "
        f"start within 1e-5 ({smi})")
    log(f"    lbfgs _calc_grad pass: device events per profile {events}; "
        f"top device entries: {_top_text(top)}")
    if any(_table_part(_counts()).values()):
        raise AssertionError(f"the batch learners launched a kernel of the "
                             f"port: {_counts()}")
    log(f"phase 14 ok in {time.monotonic() - t_phase:.1f} s: the batch "
        "learners at the goldens and at full width, bit-identical repeats "
        "and evicting caches, checkpoints read on the CPU")
    return out


# phase 15: the device table under the cold tier, and the WAL's kill point
CAP_HOT_ROWS = 524_288      # 256 MiB of fp32 rows instead of 2 GiB
EVICT_OCCUPANCY = "0.05"    # under epoch 0's occupancy, so it evicts there
KILL_DELAY_MS = 10_000      # the killed run waits this long first, so its
#                             replica pushes have landed on the peers


def _tier_state(tier) -> tuple:
    """What the cold tier holds (residency maps, clock, host rows as
    sorted slots and a digest of their bits), for exact comparisons."""
    import hashlib
    slots = np.fromiter(tier._rows.keys(), np.int64, len(tier._rows))
    slots.sort()
    h = hashlib.sha256()
    for sl in slots.tolist():
        h.update(tier._rows[sl].tobytes())
    return (tier._resident.copy(), tier._owner.copy(), tier._clock.copy(),
            slots, h.hexdigest())


def _same_tier(a: tuple, b: tuple) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a[:4], b[:4])) \
        and a[4] == b[4]


def _recording(cls, name: str, keep):
    """Wrap method ``name`` of ``cls`` so each call's (args, result) that
    ``keep`` accepts is recorded; returns (records, restore)."""
    orig = getattr(cls, name)
    records = []

    def wrapped(self, *args):
        out = orig(self, *args)
        if keep(args, out):
            records.append(out)
        return out

    setattr(cls, name, wrapped)
    return records, lambda: setattr(cls, name, orig)


def _timing(cls, names) -> tuple:
    """Wrap methods ``names`` of ``cls`` to sum their host seconds;
    returns ({name: [seconds, calls]}, restore)."""
    spent = {n: [0.0, 0] for n in names}
    origs = {n: getattr(cls, n) for n in names}

    def wrap(n, orig):
        def timed(self, *args, **kw):
            t = time.perf_counter()
            try:
                return orig(self, *args, **kw)
            finally:
                spent[n][0] += time.perf_counter() - t
                spent[n][1] += 1
        return timed

    for n, orig in origs.items():
        setattr(cls, n, wrap(n, orig))

    def restore():
        for n, orig in origs.items():
            setattr(cls, n, orig)
    return spent, restore


def phase_capacity(work: str, conf: list, uparam, ts: dict) -> dict:
    """Phase 15: the capacity tier and the durable training state at the
    full width of examples/criteo_hashed.conf, on phase 12's rows with four
    producer threads and ``device_cache_mb=0``, 2 epochs. (m) the cold
    tier (``cold_tier_rows`` leaves a 524,288-row device table) with
    admission and eviction: a second run and a run on the plain versions
    leave the same device table, residency and host rows; the gather and
    the scatter with its epilogue off equal their plain versions on the
    largest promote, demote and eviction vectors; the saved model is
    logical and scores within 1e-4 of a float64 FM; one epoch at int8
    against the plain versions. (n) the WAL (``wal_flush_batches=10``),
    interval checkpoints and two peer replicas: phase 12 (f)'s table bit
    for bit, one gather more per flush, every segment verifies, the scrub
    repairs nothing. (o) run (n) in a child ``python -m
    difacto_tpu_torch``, SIGKILLed at a WAL append of epoch 1, its local
    directory deleted, rerun with ``auto_resume=1``: the ladder climbs
    ``peer`` and ``wal`` and the run ends on (n)'s table."""
    import torch
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.capacity.tier import ColdTier
    from difacto_tpu_torch.durability import wal
    from difacto_tpu_torch.durability.replicate import Replicator
    from difacto_tpu_torch.learners.sgd import SGDLearner
    from difacto_tpu_torch.obs import REGISTRY
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.store.local import SlotStore
    t_phase = time.monotonic()
    C = uparam.hash_capacity
    hot = CAP_HOT_ROWS if DEV == "cuda" else C // 8
    data_in = os.path.join(work, "train.txt")
    data_val = os.path.join(work, "val.txt")
    with open(data_val, "rb") as f:
        val_text = f.read()
    base = conf + [("data_in", data_in), ("data_val", data_val),
                   ("max_num_epochs", "2"), ("stop_rel_objv", "0"),
                   ("stop_val_auc", "-2"), ("device_cache_mb", "0"),
                   ("report_interval", "0"), ("num_producers", "4"),
                   ("producer_mode", "thread")]
    nb, val_b = ts["batches"], ts["val_blocks"]
    total = {c: 0 for c in COUNTERS}
    names = ("store_tier_hits_total", "store_tier_misses_total",
             "store_tier_promotes_total", "store_tier_demotes_total",
             "store_evictions_total", "store_admit_drops_total")

    def reg():
        return {n: REGISTRY.counter(n).value() for n in names}

    def want(epochs, calls, epoch0=True, skip=0, wal_gathers=0,
             replayed=0):
        """Launches of a run: a gather and a push per step, a gather and a
        count push per epoch-0 batch, a gather per validation block and
        epoch, and the tier's, the WAL's and the replay's own moves."""
        steps = epochs * nb - skip
        first = nb if epoch0 else 0
        return {"gather_rows_cuda": steps + first + epochs * val_b
                + calls.get("demote", 0) + calls.get("evict", 0)
                + wal_gathers,
                "fm_update_rows_cuda": steps,
                "scatter_rows_cuda": first + calls.get("promote", 0)
                + replayed}

    # ------------------------------------------------------ (m) the tier
    tier_kw = base + [("cold_tier_rows", str(C - hot)),
                      ("admit_min_count", "2"),
                      ("evict_occupancy", EVICT_OCCUPANCY)]
    model = os.path.join(work, "tier_m")

    def tier_run(name, extra, counted=True, epochs=2):
        before = reg()
        _reset_counts()
        evicted, restore_ev = _recording(SlotStore, "maybe_evict",
                                         lambda a, n: True)
        # where the routing's host time goes: the LRU choice and the
        # demote (its gather, the copy to the host, the dict inserts), the
        # promote's host rows (dict pops, virgin rows) and the rest
        spent, restore_t = _timing(ColdTier, ("route", "_demote_lru",
                                              "_demote", "_tier_values",
                                              "_promote"))
        pk = _peak_reset()
        try:
            ln, progress, walls, _ = _train(tier_kw + list(extra))
        finally:
            restore_ev()
            restore_t()
        got = _counts()
        peak = (torch.cuda.max_memory_allocated() - pk
                if DEV == "cuda" else 0)
        delta = {n: REGISTRY.counter(n).value() - before[n] for n in names}
        tier = ln.store.tier
        route = {"sum": ln.tier_route_s, "count": ln.tier_routes}
        out = dict(launches=got, delta=delta, calls=dict(tier.calls),
                   largest=dict(tier.largest), state=_tier_state(tier),
                   bits=ln.store.state.VVg.clone(), walls=walls, peak=peak,
                   loss=[t.loss / t.nrows for t, _ in progress],
                   route_ms=1e3 * route["sum"] / max(route["count"], 1),
                   routes=route["count"], evicted=list(evicted),
                   stats=ln.store.capacity_stats(),
                   spent={n: round(1e3 * v[0] / max(route["count"], 1), 3)
                          for n, v in spent.items()})
        if counted:
            w = want(epochs, tier.calls)
            if _table_part(got) != w:
                raise AssertionError(f"run {name} launches {got}, the steps "
                                     f"and the tier's moves need {w}")
            for c in COUNTERS:
                total[c] += got[c]
        elif any(_table_part(got).values()):
            raise AssertionError(f"run {name} on the plain versions "
                                 f"launched {got}")
        log(f"  run {name}: epoch wall s {_epoch_walls(walls)}; loss/row "
            f"{[round(x, 6) for x in out['loss']]}; tier calls "
            f"{out['calls']}; evicted per epoch {out['evicted']}; "
            f"route {out['route_ms']:.2f} ms per batch over "
            f"{out['routes']} batches (ms per batch in {out['spent']}); "
            f"peak "
            f"{peak / 2 ** 20:.1f} MiB; counters "
            f"{ {n[:-6]: int(v) for n, v in delta.items()} }")
        del ln
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
        return out

    m1 = tier_run("(m) 1", [("has_aux", "1"), ("model_out", model)])
    zero = [n for n, v in m1["delta"].items() if not v > 0]
    if zero:
        raise AssertionError(f"run (m): counters not above 0: {zero}")
    if not (len(m1["evicted"]) == 2 and m1["evicted"][0] > 0):
        raise AssertionError(f"eviction did not fire at epoch 0's end: "
                             f"{m1['evicted']}")
    if not np.isfinite(m1["loss"]).all():
        raise AssertionError(f"run (m) objective {m1['loss']}")
    m2 = tier_run("(m) 2", [])
    restore = _swap_plain()
    try:
        m3 = tier_run("(m) on the plain versions", [], counted=False)
    finally:
        restore()
    for name, other in (("a second run", m2), ("the plain versions", m3)):
        if not (_bits_equal(other["bits"], m1["bits"])
                and _same_tier(other["state"], m1["state"])):
            raise AssertionError(f"the tiered run on {name} left another "
                                 "table, residency or host rows")
    log("  runs (m) 2 and (m) on the plain versions: device table, "
        "residency maps, clock and host rows bit for bit as run (m) 1")
    # the kernels on the largest vectors the run moved
    table = m1["bits"]
    sizes = {}
    for kind in ("demote", "evict"):
        n, pad = m1["largest"][kind]
        sl = torch.from_numpy(pad).to(table.device)
        if not torch.equal(fused.gather_rows(table, sl).view(torch.uint8),
                           fused.gather_rows_ref(table, sl).view(
                               torch.uint8)):
            raise AssertionError(f"the gather kernel differs from its plain "
                                 f"version on the largest {kind}")
        sizes[kind] = (n, len(pad))
    n, pad = m1["largest"]["promote"]
    sl = torch.from_numpy(pad).to(table.device)
    gen = torch.Generator(device=table.device).manual_seed(SEED)
    rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (len(pad), table.shape[1]),
                         dtype=torch.int32, generator=gen,
                         device=table.device).view(table.dtype)
    got_t, want_t = table.clone(), table.clone()
    fused.scatter_rows(got_t, sl, rows)
    fused.scatter_rows_ref(want_t, sl, rows)
    if not _bits_equal(got_t, want_t):
        raise AssertionError("the scatter kernel (epilogue off) differs from "
                             "its plain version on the largest promote")
    sizes["promote"] = (n, len(pad))
    del got_t, want_t, rows
    log(f"  gather and scatter (epilogue off) = plain versions byte for "
        f"byte at the largest moves (rows, padded length): {sizes}")
    with np.load(model + "_part-0") as z:
        arrays = {f: z[f] for f in ("w", "V", "v_live")}
    if arrays["w"].shape[0] != C:
        raise AssertionError(f"the tiered model saved {arrays['w'].shape[0]} "
                             f"rows, not the logical {C}")
    pred_out = os.path.join(work, "tier_pred")
    run_pred(conf + [("model_in", model), ("data_in", data_val),
                     ("pred_out", pred_out)], device=DEV)
    with open(pred_out + "_part-0", "rb") as f:
        probs = np.array([float(x.split(b"\t")[1])
                          for x in f.read().splitlines()])
    ref_m = reference_margins(val_text, arrays, C)
    p_err = float(np.abs(probs - 1.0 / (1.0 + np.exp(-ref_m))).max())
    if len(probs) != N_VAL or not p_err <= 1e-4:
        raise AssertionError(f"the tiered model's pred vs float64 FM: "
                             f"{len(probs)} rows, prob err {p_err}")
    log(f"  the tiered model holds the logical {C} rows; task=pred within "
        f"{p_err:.3g} of the float64 FM")
    log(f"  objective per row by epoch: tiered {m1['loss']}, phase 12 (f) "
        f"untiered {ts['loss_f']}; peak allocated {m1['peak'] / 2 ** 20:.1f}"
        f" MiB tiered, {ts['peak_f'] / 2 ** 20:.1f} MiB untiered; epoch "
        f"wall s tiered {_epoch_walls(m1['walls'])}, untiered "
        f"{_epoch_walls(ts['walls_f'])}; route {m1['route_ms']:.2f} ms per "
        f"batch; capacity {m1['stats']}")
    del m2, m3
    q1 = tier_run("(m) int8, 1 epoch", [("slot_dtype", "int8"),
                                        ("max_num_epochs", "1")], epochs=1)
    restore = _swap_plain()
    try:
        q2 = tier_run("(m) int8 on the plain versions",
                      [("slot_dtype", "int8"), ("max_num_epochs", "1")],
                      counted=False, epochs=1)
    finally:
        restore()
    if not (_bits_equal(q1["bits"], q2["bits"])
            and _same_tier(q1["state"], q2["state"])):
        raise AssertionError("the int8 tiered epoch on the plain versions "
                             "left another table, residency or host rows")
    log("  int8: one tiered epoch on the kernels = on the plain versions, "
        "bit for bit")
    del q1, q2, table

    # ------------------------------------------ (n) the WAL and replicas
    def wal_kwargs(d):
        peers = [os.path.join(d, "p1"), os.path.join(d, "p2")]
        m = os.path.join(d, "local", "m")
        return base + [("wal_flush_batches", "10"), ("ckpt_interval", "1"),
                       ("ckpt_keep", "2"), ("model_out", m),
                       ("replica_peers", ",".join(peers)),
                       ("replica_k", "2"), ("auto_resume", "1")], m, peers

    n_dir = os.path.join(work, "wal_n")
    kw_n, model_n, peers_n = wal_kwargs(n_dir)
    gathers, restore_w = _recording(SlotStore, "wal_touched_rows",
                                    lambda a, out: len(a[0]) > 0)
    _reset_counts()
    try:
        ln, _, walls_n, _ = _train(kw_n)
    finally:
        restore_w()
    got = _counts()
    w = want(2, {}, wal_gathers=len(gathers))
    if _table_part(got) != w:
        raise AssertionError(f"run (n) launches {got}; the steps and "
                             f"{len(gathers)} WAL flushes need {w}")
    for c in COUNTERS:
        total[c] += got[c]
    if not torch.equal(ln.store.state.VVg.cpu().view(torch.int32),
                       ts["bits_f"].view(torch.int32)):
        raise AssertionError("the WAL run left another table than phase 12 "
                             "(f)")
    del ln
    gc.collect()
    segs = [os.path.join(d, n) for d in
            [wal.wal_dir(model_n)] + [wal.wal_dir(os.path.join(p, "m"))
                                      for p in peers_n]
            for n in sorted(os.listdir(d))]
    for sp in segs:
        wal.read_segment(sp)
    r = Replicator(peers_n, 2, 0, root=os.path.dirname(model_n))
    try:
        repairs = r.scrub(model_n)
    finally:
        r.close()
    if repairs:
        raise AssertionError(f"the scrub repaired {repairs} peer files")
    log(f"  run (n) WAL + 2 replicas: phase 12 (f)'s table bit for bit; "
        f"{len(gathers)} WAL flush gathers beside the steps' launches "
        f"{got}; {len(segs)} segments verify (local and peers); scrub "
        f"repairs 0; epoch wall s {_epoch_walls(walls_n)}")
    shutil.rmtree(n_dir, ignore_errors=True)

    # ------------------------------------------------- (o) the recovery
    o_dir = os.path.join(work, "wal_o")
    kw_o, model_o, peers_o = wal_kwargs(o_dir)
    root = os.path.dirname(os.path.abspath(__file__))
    # the appends before the kill: epoch 0's full windows and its boundary,
    # then epoch 1's first window; the kill is at its second
    after = nb // 10 + 2
    faults = (f"wal.append:delay_ms={KILL_DELAY_MS}@1:{after},"
              f"wal.append:kill@1:{after}")
    env = dict(os.environ, PYTHONPATH=root, DIFACTO_FAULTS=faults)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "difacto_tpu_torch",
                        *[f"{k}={v}" for k, v in kw_o], f"device={DEV}"],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=900)
    child_s = time.perf_counter() - t0
    if r.returncode != -9:
        raise AssertionError(f"the armed run was not SIGKILLed (rc "
                             f"{r.returncode}):\n{r.stderr[-3000:]}")
    shutil.rmtree(os.path.dirname(model_o))
    t_rec, restore_r = _timing(SGDLearner, ("_try_resume",))
    gathers, restore_w = _recording(SlotStore, "wal_touched_rows",
                                    lambda a, out: len(a[0]) > 0)
    _reset_counts()
    try:
        ln, _, walls_o, _ = _train(kw_o)
    finally:
        restore_w()
        restore_r()
    got = _counts()
    with open(model_o + ".recovery.json") as f:
        stamp = json.load(f)
    skip = stamp.get("skip_batches", 0)
    if not ("peer" in stamp["rungs"] and "wal" in stamp["rungs"]
            and 0 < skip <= 10):
        raise AssertionError(f"the recovery stamp {stamp}")
    w = want(1, {}, epoch0=False, skip=skip, wal_gathers=len(gathers),
             replayed=stamp["wal_segments"])
    if _table_part(got) != w:
        raise AssertionError(f"the recovered run launched {got}; resuming "
                             f"epoch 1 past {skip} replayed batches needs "
                             f"{w}")
    for c in COUNTERS:
        total[c] += got[c]
    if not torch.equal(ln.store.state.VVg.cpu().view(torch.int32),
                       ts["bits_f"].view(torch.int32)):
        raise AssertionError("the recovered run left another table than "
                             "run (n)")
    del ln
    gc.collect()
    shutil.rmtree(o_dir, ignore_errors=True)
    log(f"  run (o): the armed child was SIGKILLed after {child_s:.1f} s "
        f"(a {KILL_DELAY_MS / 1e3:.0f} s wait before the kill included); "
        f"local directory deleted; the rerun recovered in "
        f"{t_rec['_try_resume'][0]:.3f} s "
        f"through rungs {stamp['rungs']} (head {stamp['head']}, "
        f"skip {skip}, {stamp['wal_replay_batches']} batches replayed) "
        f"and ended on run (n)'s table bit for bit; epoch wall s "
        f"{_epoch_walls(walls_o)}")
    log(f"phase 15 ok in {time.monotonic() - t_phase:.1f} s: the cold tier, "
        "admission and eviction deterministic and = plain versions; the WAL "
        "run = phase 12 (f); SIGKILL + disk loss recovered through peer + "
        "wal to the same table")
    return {"launches": total, "route_ms": m1["route_ms"],
            "sizes": sizes}


# ------------------------------------------------------------ phase 16
LIFE_CONNS = 4              # closed-loop connections of the rate probe
LIFE_PROBE_S = 3.0          # seconds of the rate probe
OPEN_CONNS = 16             # open-loop connections
OPEN_TICK_S = 0.02          # each connection sends one window per tick
OPEN_BASE_S = 10.0          # open-loop seconds before the first reload
SETTLE_S = 3.0              # open-loop seconds after each event
CHECK_ROWS = 2000           # rows checked against a pred column per swap
ONLINE_ROWS = 20_000        # at least this many #score rows in (q)
ONLINE_RATE = 1000.0        # rows/s the (q) client offers
ONLINE_SEG = 1000           # rows per sealed segment
STATS_WINDOW = 8192         # ServeStats' latency window


def loadgen(spec_path: str) -> None:
    """Phase 16's load generator, in an interpreter of its own so that its
    threads never take the server's interpreter lock:
    ``python3 -c 'import chip_smoke; chip_smoke.loadgen(SPEC)'``. The JSON
    spec names the mode, the endpoint list, the rows file and the result
    file:

    - ``closed``: ``conns`` ServeClients, each sends pipelined windows of
      ``window`` rows back to back for ``seconds``;
    - ``open``: ``conns`` ServeClients share ``rate`` rows/s on a fixed
      schedule (windows of ``window`` rows, each row's latency counted
      from its scheduled time, so a late send is charged to the server)
      until ``stop`` exists; a ``!shed`` row is sent again (a draining
      replica sheds) and a dropped connection resends its unanswered
      tail (ServeClient), so every row ends with exactly one answer;
      with ``p99_file``, every 0.25 s the p99 of the rows answered in
      the last second goes there (``{"t": ..., "p99_ms": ...}``), the
      client-side view an autoscaler's ``latency_fn`` reads;
    - ``online``: one client sends ``#score <id> <row>`` for every row and
      ``#label <id> <y>`` right behind it for every even id, ``rate``
      rows/s, at least ``min_rows`` rows and then until ``stop`` exists.
    In the closed and open modes the ``sending`` file appears once a
    first window has come back. Times are ``time.monotonic()``, one clock
    across the machine's processes."""
    from difacto_tpu_torch.serve.client import ServeClient

    with open(spec_path) as f:
        spec = json.load(f)
    with open(spec["rows"], "rb") as f:
        rows = f.read().splitlines()
    eps = [tuple(e) for e in spec["endpoints"]]
    mode = spec["mode"]
    out = {"mode": mode, "t0": time.monotonic()}

    def answered() -> None:
        """The first window came back: the ``sending`` file says so."""
        if not os.path.exists(spec["sending"]):
            with open(spec["sending"], "w"):
                pass

    def client():
        return ServeClient(endpoints=eps, retries=20, eject_after=3,
                           backoff_s=0.01, reprobe_s=30.0,
                           deadline_s=120.0)

    if mode == "closed":
        counts = [0] * spec["conns"]
        bad = [0] * spec["conns"]
        end = time.monotonic() + spec["seconds"]

        def closed(k):
            w, i = spec["window"], k * spec["window"]
            with client() as c:
                while time.monotonic() < end:
                    got = c.score_lines([rows[(i + j) % len(rows)]
                                         for j in range(w)])
                    answered()
                    counts[k] += len(got)
                    bad[k] += sum(g.startswith(b"!") for g in got)
                    i += w * spec["conns"]

        ts = [threading.Thread(target=closed, args=(k,), daemon=True)
              for k in range(spec["conns"])]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        out.update(rows=sum(counts), bad=sum(bad),
                   seconds=time.monotonic() - out["t0"])
    elif mode == "open":
        K, w = spec["conns"], spec["window"]
        per_s = spec["rate"] / K
        recs = [[] for _ in range(K)]
        resent = [0] * K
        failovers = [0] * K
        t_start = time.monotonic() + 0.2

        def open_loop(k):
            with client() as c:
                n = 0
                while not os.path.exists(spec["stop"]):
                    sched = t_start + n * w / per_s
                    delay = sched - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                    idx = [((n * w + j) * K + k) % len(rows)
                           for j in range(w)]
                    todo = list(range(w))
                    reply = [None] * w
                    t_send = time.monotonic()
                    while todo:
                        got = c.score_lines([rows[idx[j]] for j in todo])
                        again = []
                        for j, g in zip(todo, got):
                            if g.startswith(b"!shed"):
                                again.append(j)
                            else:
                                reply[j] = g
                        resent[k] += len(again)
                        todo = again
                        if todo:
                            time.sleep(0.005)
                    t_recv = time.monotonic()
                    answered()
                    recs[k].extend((idx[j], sched, t_send, t_recv,
                                    reply[j].decode()) for j in range(w))
                    n += 1
                failovers[k] = c.failovers

        ts = [threading.Thread(target=open_loop, args=(k,), daemon=True)
              for k in range(K)]
        for t in ts:
            t.start()
        while spec.get("p99_file") and any(t.is_alive() for t in ts):
            now = time.monotonic()
            lat = [r[3] - r[1] for rs in recs for r in rs[-4096:]
                   if r[3] > now - 1.0]
            with open(spec["p99_file"] + ".tmp", "w") as f:
                json.dump({"t": now, "p99_ms": _pct(lat, 99)
                           if lat else 0.0}, f)
            os.replace(spec["p99_file"] + ".tmp", spec["p99_file"])
            time.sleep(0.25)
        for t in ts:
            t.join()
        flat = [r for rs in recs for r in rs]
        out.update(idx=[r[0] for r in flat], sched=[r[1] for r in flat],
                   send=[r[2] for r in flat], recv=[r[3] for r in flat],
                   reply=[r[4] for r in flat], resent=sum(resent),
                   failovers=sum(failovers))
    elif mode == "online":
        w = 50
        sent = acked = labels = err = 0
        t_start = time.monotonic()
        with client() as c:
            n = 0
            while (sent < spec["min_rows"]
                   or not os.path.exists(spec["stop"])):
                sched = t_start + n * w / spec["rate"]
                delay = sched - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                lines = []
                for j in range(sent, sent + w):
                    row = rows[j % len(rows)]
                    lines.append(b"#score %d %s" % (j, row))
                    if j % 2 == 0:
                        lines.append(b"#label %d %s"
                                     % (j, row.split(b"\t", 1)[0]))
                for ln, g in zip(lines, c.score_lines(lines)):
                    if ln.startswith(b"#label"):
                        labels += 1
                        acked += (not g.startswith(b"!")
                                  and json.loads(g)["ok"])
                        err += g.startswith(b"!")
                    else:
                        err += g.startswith(b"!")
                sent += w
                n += 1
        out.update(sent=sent, labels=labels, acked=acked, err=err)
    out["t1"] = time.monotonic()
    with open(spec["out"], "w") as f:
        json.dump(out, f)


def _start_loadgen(work: str, name: str, **spec):
    """Start ``loadgen`` in its own interpreter; returns (process, the
    result file, the stop file)."""
    root = os.path.dirname(os.path.abspath(__file__))
    spec.update(out=os.path.join(work, f"{name}.json"),
                stop=os.path.join(work, f"{name}.stop"),
                sending=os.path.join(work, f"{name}.sending"))
    path = os.path.join(work, f"{name}.spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("DIFACTO_FAULTS", None)
    with open(os.path.join(work, f"{name}.log"), "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.loadgen({path!r})"],
            cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=err)
    return proc, spec["out"], spec["stop"]


def _finish_loadgen(work, name, proc, out, stop, timeout=120) -> dict:
    with open(stop, "w"):
        pass
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        with open(os.path.join(work, f"{name}.log"), "rb") as f:
            tail = f.read()[-3000:].decode("utf-8", "replace")
        raise AssertionError(f"loadgen {name} exited {rc}:\n{tail}")
    with open(out) as f:
        return json.load(f)


def _pred_column(work: str, name: str, conf: list, param, seed: int
                 ) -> tuple:
    """Save a seeded synthetic model of ``param``'s geometry and score
    phase 3's rows with ``task=pred``: (model prefix, its probability
    column)."""
    import torch
    from difacto_tpu_torch.store.convert import state_from_numpy
    from difacto_tpu_torch.store.local import SlotStore
    model = os.path.join(work, name)
    writer = SlotStore(param, device=DEV)
    writer.state = state_from_numpy(
        param, synthetic_model(param.hash_capacity, param.V_dim, seed),
        device=DEV)
    writer.save(model + "_part-0")
    del writer
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return model, _pred_of(work, name, conf, model)


def _pred_of(work: str, name: str, conf: list, model: str) -> list:
    from difacto_tpu_torch.__main__ import run_pred
    pred = os.path.join(work, f"{name}_pred")
    run_pred(conf + [("model_in", model),
                     ("data_in", os.path.join(work, "criteo.txt")),
                     ("pred_out", pred)], device=DEV)
    with open(pred + "_part-0", "rb") as f:
        return [l.split(b"\t")[1] for l in f.read().splitlines()]


def _score_all(c, rows: list) -> list:
    """Every row's answer through client ``c`` in 256-row windows, a
    ``!shed`` row sent again (the queue holds 1,024 rows and the open loop
    shares it)."""
    out = []
    for i in range(0, len(rows), 256):
        part = rows[i:i + 256]
        got = c.score_lines(part)
        for _ in range(1000):
            todo = [j for j, g in enumerate(got) if g.startswith(b"!shed")]
            if not todo:
                break
            time.sleep(0.005)
            for j, g in zip(todo, c.score_lines([part[j] for j in todo])):
                got[j] = g
        out.extend(got)
    return out


def _warm_ms(store, caps, keys, workers: int) -> float:
    """Milliseconds to warm ``keys`` on a fresh executor over ``store``
    with ``workers`` threads (the blue/green warm of serve/reload.py)."""
    from concurrent.futures import ThreadPoolExecutor
    from difacto_tpu_torch.serve import PredictExecutor
    ex = PredictExecutor(store)
    ex.seed_caps(caps)
    t = time.monotonic()
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(ex.warm_bucket, keys))
    return (time.monotonic() - t) * 1e3


def _pct(a, q) -> float:
    return float(np.percentile(np.asarray(a), q) * 1e3) if len(a) else \
        float("nan")


def _metrics_agree(text: str, stats: dict) -> str:
    """Each latency quantile ``#metrics`` derives lies in the histogram
    bucket that holds the exact percentile ``#stats`` reports (both over
    the same responses); returns the compared values."""
    from difacto_tpu_torch.obs import DEFAULT_BOUNDS
    bounds = (0.0,) + tuple(DEFAULT_BOUNDS)
    vals = {}
    for ln in text.splitlines():
        if ln.startswith("difacto_serve_latency_seconds_quantile{"):
            q = float(ln.split('quantile="')[1].split('"')[0])
            vals[q] = float(ln.split()[-1])
        elif not ln.startswith("#") and len(ln.split()) != 2:
            raise AssertionError(f"#metrics line does not parse: {ln!r}")
    shown = []
    for q, key in ((0.5, "p50_ms"), (0.95, "p95_ms"), (0.99, "p99_ms")):
        exact = stats[key] / 1e3
        i = int(np.searchsorted(bounds, exact))
        lo, hi = bounds[max(i - 1, 0)], bounds[min(i, len(bounds) - 1)]
        if not lo <= vals[q] <= hi:
            raise AssertionError(f"#metrics p{q * 100:g} {vals[q]} s is "
                                 f"outside [{lo}, {hi}] s around #stats "
                                 f"{exact} s")
        shown.append(f"p{q * 100:g} {vals[q] * 1e3:.3f} vs "
                     f"{stats[key]:.3f} ms")
    return ", ".join(shown)


def phase_lifecycle(work: str, conf: list, uparam, lines: list,
                    smi: str) -> dict:
    """Phase 16 (p): the serve lifecycle at the full width of
    examples/criteo_hashed.conf. A ServeServer (batch 256, 2 ms, queue
    1,024 rows: the task=serve defaults) over phase 3's model with
    ``takeover`` on and a ModelReloader; a load generator in its own
    interpreter drives it through ServeClients whose endpoint list starts
    with a dead port. First the highest row rate it sustains
    (closed-loop, 4 connections x 256-row windows), then 50% of it
    offered open-loop on 16 connections (one window every 20 ms each):
    10 s alone, then a same-geometry
    ``#reload`` of a second model, then a ``#reload`` of a model at
    hash_capacity 2,097,152 (blue/green), then ``run_takeover`` to a
    successor ``python -m difacto_tpu_torch task=serve`` on the same card
    and port, then a SIGTERM drain of the successor (exit 0). No ``!err``
    and one answer per row; every answer is its row's ``task=pred`` column
    of the model then serving (either model's inside a swap); #metrics
    parses and its quantiles agree with #stats; model_generation goes 1,
    2, 3 and then 1 on the successor; the gather launches equal the
    executors' dispatches plus the blue/green warm's."""
    import dataclasses

    import torch
    from difacto_tpu_torch.serve import (ModelReloader, PredictExecutor,
                                         ServeClient, ServeServer,
                                         open_serving_store, run_takeover)
    from difacto_tpu_torch.serve.fleet import spawn_successor
    from difacto_tpu_torch.store.local import SlotStore
    t_phase = time.monotonic()
    C = uparam.hash_capacity
    rows_file = os.path.join(work, "criteo.txt")
    with open(rows_file, "rb") as f:
        rows = f.read().splitlines()
    model_a = os.path.join(work, "model")
    col_a = [l.split(b"\t")[1] for l in lines]
    model_b, col_b = _pred_column(work, "life_b", conf, uparam, SEED + 16)
    param_g = dataclasses.replace(uparam, hash_capacity=C // 2)
    model_g, col_g = _pred_column(work, "life_g", conf, param_g, SEED + 17)
    for name, col in (("b", col_b), ("g", col_g)):
        if sum(x != y for x, y in zip(col_a, col)) < len(col_a) // 2:
            raise AssertionError(f"model {name} answers like phase 3's")
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip() \
        if DEV == "cuda" else "no card"
    log(f"  compute mode {mode!r}; models b (same geometry) and g "
        f"(hash_capacity {C // 2}) saved and scored in "
        f"{time.monotonic() - t_phase:.1f} s [{smi}]")

    store, _, _ = open_serving_store(model_a, device=DEV)
    srv = ServeServer(store, data_format="criteo", takeover=True).start()
    del store
    srv.reloader = ModelReloader(srv.executor, model_a, server=srv)
    blue = srv.executor
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()
    eps = [("127.0.0.1", dead_port), (srv.host, srv.port)]
    check = rows[:CHECK_ROWS]
    procs, box = [], {}
    # the server's side of each window: every predict's start and
    # seconds, and each store load's seconds
    predicts = []
    pred_orig = PredictExecutor.predict

    def timed_predict(self, blk):
        t = time.monotonic()
        try:
            return pred_orig(self, blk)
        finally:
            predicts.append((t, time.monotonic() - t))

    PredictExecutor.predict = timed_predict
    loads, restore_loads = _timing(SlotStore, ["load"])
    _reset_counts()
    try:
        with ServeClient(endpoints=eps, retries=5, eject_after=1,
                         reprobe_s=300.0) as c:
            if c.failovers < 1 or c.port != srv.port:
                raise AssertionError("the client never failed over past "
                                     "the dead port")
            if _score_all(c, check) != col_a[:CHECK_ROWS]:
                raise AssertionError("answers differ from phase 3's pred")
            g, o, s = _start_loadgen(work, "probe", mode="closed",
                                     endpoints=eps, rows=rows_file,
                                     conns=LIFE_CONNS, window=256,
                                     seconds=LIFE_PROBE_S)
            procs.append(g)
            probe = _finish_loadgen(work, "probe", g, o, s)
            if probe["bad"]:
                raise AssertionError(f"rate probe: {probe['bad']} rows "
                                     "answered !err or !shed")
            rate_max = probe["rows"] / probe["seconds"]
            rate = 0.5 * rate_max
            window = max(1, int(round(rate / OPEN_CONNS * OPEN_TICK_S)))
            log(f"  sustained {rate_max:.0f} rows/s closed-loop "
                f"({LIFE_CONNS} connections x 256-row windows, "
                f"{probe['seconds']:.1f} s); offering {rate:.0f} rows/s "
                f"open-loop on {OPEN_CONNS} connections, {window}-row "
                f"windows [{smi}]")
            g, o, s = _start_loadgen(work, "open", mode="open",
                                     endpoints=eps, rows=rows_file,
                                     conns=OPEN_CONNS, window=window,
                                     rate=rate)
            procs.append(g)
            time.sleep(OPEN_BASE_S)
            t_base = time.monotonic()
            st_base = c.stats()
            base = _peak_reset()
            ev = {}
            for name, model, want in (("reload", model_b, col_b),
                                      ("bluegreen", model_g, col_g)):
                t0 = time.monotonic()
                res = c.reload(model)
                t1 = time.monotonic()
                if not res.get("ok"):
                    raise AssertionError(f"{name}: {res}")
                ev[name] = (t0, t1, res["model_generation"])
                if _score_all(c, check) != want[:CHECK_ROWS]:
                    raise AssertionError(f"answers after the {name} differ "
                                         "from the pred column")
                time.sleep(SETTLE_S)
            st = c.stats()
            green = srv.executor
            if green is blue or st["bluegreen_swaps"] != 1 \
                    or [ev[n][2] for n in ev] != [2, 3]:
                raise AssertionError(f"swaps: {st}, {ev}")
            # blue and its table go once the last reference does
            blue_dispatches = blue.stats()["dispatches"]
            del blue
            gc.collect()
            peak = (torch.cuda.max_memory_allocated() - base
                    if DEV == "cuda" else 0)
            held = (torch.cuda.memory_allocated() - base
                    if DEV == "cuda" else 0)
            # phase 3's table was resident at the start, g's (half its
            # rows) is now: allocated memory fell by g's table
            table = green.store.state.VVg
            g_bytes = table.numel() * table.element_size()
            del table
            if DEV == "cuda" and held > -g_bytes + (256 << 20):
                raise AssertionError(
                    f"{held / 2 ** 30:.3f} GiB more allocated after the "
                    "swaps than before: an old table was not freed")

            def spawn(ready_file):
                box["proc"] = spawn_successor(
                    model_g, srv.port, ready_file, ["data_format=criteo"],
                    host=srv.host, device=DEV)
                return box["proc"]

            tk0 = time.monotonic()
            rep = run_takeover(srv.host, srv.port, spawn_fn=spawn,
                               wait_s=600.0)
            tk1 = time.monotonic()
        lg = _finish_loadgen(work, "open", g, o, s)
        t_stop = time.monotonic()
        deadline = time.monotonic() + 60
        while not srv._is_closed():
            if time.monotonic() > deadline:
                raise AssertionError("the incumbent never drained")
            time.sleep(0.05)
        counts = _counts()
        gathers = (blue_dispatches + green.stats()["dispatches"]
                   + green._warmed)
        with ServeClient(srv.host, srv.port) as c2:
            if _score_all(c2, check) != col_g[:CHECK_ROWS]:
                raise AssertionError("the successor's answers differ from "
                                     "the pred column")
            h = c2.health()
            st2 = c2.stats()
            if st2["responses"] > STATS_WINDOW:
                raise AssertionError(f"the successor answered "
                                     f"{st2['responses']} rows, more than "
                                     "#stats' window")
            agree = _metrics_agree(c2.metrics(), st2)
        if h["server_id"] != rep["successor"] or h["model_generation"] != 1:
            raise AssertionError(f"successor health {h}, report {rep}")
        proc = box["proc"]
        t2 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        drain_s = time.monotonic() - t2
        if rc != 0:
            raise AssertionError(f"the successor exited {rc} on SIGTERM")
    finally:
        PredictExecutor.predict = pred_orig
        restore_loads()
        for p in procs + ([box["proc"]] if "proc" in box else []):
            if p.poll() is None:
                p.kill()
                p.wait()
        srv.close()
    # every row answered once, by the model then serving
    idx = np.asarray(lg["idx"])
    send, recv = np.asarray(lg["send"]), np.asarray(lg["recv"])
    lat = recv - np.asarray(lg["sched"])
    reply = [r.encode() for r in lg["reply"]]
    bad = [r for r in reply if r.startswith(b"!")]
    if bad:
        raise AssertionError(f"{len(bad)} open-loop rows answered {bad[0]}")
    # the model a row met is the one serving when its batch was scored,
    # between its send and its answer: A until the first swap committed,
    # B between the two swaps, G after the second
    (rb0, rb1, _), (bg0, bg1, _) = ev["reload"], ev["bluegreen"]
    for i, (k, r) in enumerate(zip(idx, reply)):
        allowed = ({col_a[k]} if send[i] < rb1 else set()) \
            | ({col_b[k]} if send[i] < bg1 and recv[i] > rb0 else set()) \
            | ({col_g[k]} if recv[i] > bg0 else set())
        if r not in allowed:
            raise AssertionError(f"open-loop row {k} sent {send[i]:.3f} "
                                 f"answered {r!r}, not the serving "
                                 "model's pred")

    def sel(lo, hi):
        return lat[(send >= lo) & (send < hi)]

    # the baseline: the second half of the open loop before any event
    base_l, rb_l, bg_l = (sel(t_base - OPEN_BASE_S / 2, t_base),
                          sel(rb0, rb1),
                          sel(bg0, bg1))
    to_l = sel(tk0, tk1)
    pt = np.asarray([t for t, _ in predicts])
    pd = np.asarray([x for _, x in predicts])

    def server_side(lo, hi):
        d = pd[(pt >= lo) & (pt < hi)]
        return (f"{len(d)} predicts, median {_pct(d, 50):.3f} ms, max "
                f"{_pct(d, 100):.3f} ms" if len(d) else "no predict")

    out = {
        "rate_max": rate_max, "rate": rate, "rows": len(idx),
        "p50": _pct(base_l, 50), "p99": _pct(base_l, 99),
        "stats_p50": st_base.get("p50_ms"), "stats_p99":
            st_base.get("p99_ms"),
        "reload_s": rb1 - rb0, "reload_p99": _pct(rb_l, 99),
        "bluegreen_s": bg1 - bg0, "bluegreen_p99": _pct(bg_l, 99),
        "warm_ms": st["last_warm_ms"], "peak_gib": peak / 2 ** 30,
        "held_gib": held / 2 ** 30, "warm_s": rep["warm_s"],
        "gap_ms": rep["takeover_gap_ms"], "takeover_p99": _pct(to_l, 99),
        "drain_s": drain_s, "launches": counts}
    if counts["gather_rows_cuda"] != gathers or \
            counts["fm_update_rows_cuda"] or counts["scatter_rows_cuda"]:
        raise AssertionError(f"phase 16 (p) launches {counts}, want "
                             f"{gathers} gathers (dispatches + warm) and "
                             "no push")
    # does warm_workers gain anything? green's warm set again, on 1 and
    # on 4 threads in turns (measurement launches, after the count)
    caps, keys = green.warm_set()
    warm = {1: [], 4: []}
    for workers in (1, 4, 4, 1):
        warm[workers].append(_warm_ms(green.store, caps, keys, workers))
    log(f"  open loop at {rate:.0f} rows/s: {len(idx)} rows, every one "
        f"answered once ({lg['resent']} shed rows sent again, "
        f"{lg['failovers']} client failovers), no !err; baseline p50 "
        f"{out['p50']:.3f} ms p99 {out['p99']:.3f} ms on the client's "
        f"clock, #stats p50 {out['stats_p50']} ms p99 {out['stats_p99']} ms"
        f" [{smi}]")
    log(f"  the server's predicts: baseline "
        f"{server_side(t_base - OPEN_BASE_S / 2, t_base)}; inside the "
        f"same-geometry reload {server_side(rb0, rb1)}; inside the "
        f"blue/green {server_side(bg0, bg1)}; inside the takeover "
        f"{server_side(tk0, tk1)}; store loads "
        f"{loads['load'][0]:.3f} s over {loads['load'][1]} [{smi}]")
    log(f"  same-geometry #reload (swap_store): {out['reload_s']:.3f} s, "
        f"p99 inside it {out['reload_p99']:.3f} ms; blue/green #reload to "
        f"hash_capacity {C // 2}: {out['bluegreen_s']:.3f} s, warm "
        f"{out['warm_ms']:.3f} ms over {green._warmed} buckets, p99 inside "
        f"it {out['bluegreen_p99']:.3f} ms; peak allocated across both "
        f"{out['peak_gib']:.3f} GiB above the start, "
        f"{out['held_gib']:+.3f} GiB allocated after than before (the 2 "
        f"GiB tables freed, the 1 GiB one held); the same warm set again "
        f"on 1 thread {', '.join(f'{x:.3f}' for x in warm[1])} ms, on 4 "
        f"{', '.join(f'{x:.3f}' for x in warm[4])} ms [{smi}]")
    log(f"  takeover: successor {rep['successor']} (pid {h['pid']}) ready "
        f"after warm_s {rep['warm_s']} s, takeover_gap_ms "
        f"{rep['takeover_gap_ms']}, p99 inside the takeover "
        f"{out['takeover_p99']:.3f} ms; #metrics vs #stats on the "
        f"successor: {agree}; SIGTERM drained it in {drain_s:.3f} s, "
        f"exit 0; generations 1 -> 2 -> 3, successor 1; launches "
        f"{counts} = dispatches + warm [{smi}]")
    log(f"phase 16 (p) ok in {time.monotonic() - t_phase:.1f} s: reload, "
        "blue/green, takeover and drain under open-loop load")
    return out


def phase_online(work: str, conf: list, uparam, smi: str) -> dict:
    """Phase 16 (q): the online loop at the same width. A ServeServer
    over phase 3's model with an OnlineLog (1,000-row segments,
    ``label_delay_s`` 0.5, ``negative`` default) and a ModelReloader on
    the trainer's ``model_out``; an OnlineTrainer thread on the card
    (batch 1,000, ``online_ckpt_interval_s`` 2, ``online_endpoints`` the
    server). A client offers >= 20,000 of phase 3's rows as ``#score`` at
    1,000 rows/s, with ``#label`` behind every other one, until the served
    generation has advanced twice. After ``log.end`` the trainer drains;
    ``python -m difacto_tpu_torch task=online online_replay=1`` over the
    same log leaves the online final checkpoint array for array, byte for
    byte; the served answers after the last reload equal ``task=pred`` of
    the final checkpoint; the launches equal the server's dispatches plus
    one gather and one push per training batch and one gather and one
    count push per batch of segment 0."""
    from difacto_tpu_torch.obs import REGISTRY
    from difacto_tpu_torch.online import OnlineLog, OnlineParam, \
        OnlineTrainer
    from difacto_tpu_torch.online import loop as online_loop
    from difacto_tpu_torch.online.log import read_index
    from difacto_tpu_torch.serve import (ModelReloader, ServeClient,
                                         ServeServer, open_serving_store)
    t_phase = time.monotonic()
    d = os.path.join(work, "online")
    log_dir, model = os.path.join(d, "olog"), os.path.join(d, "model")
    rows_file = os.path.join(work, "criteo.txt")
    with open(rows_file, "rb") as f:
        check = f.read().splitlines()[:CHECK_ROWS]
    olog = OnlineLog(log_dir, segment_rows=ONLINE_SEG, label_delay_s=0.5,
                     label_default="negative")
    store, _, _ = open_serving_store(os.path.join(work, "model"),
                                     device=DEV)
    srv = ServeServer(store, data_format="criteo", online_log=olog).start()
    del store
    srv.reloader = ModelReloader(srv.executor, model, server=srv)
    ex = srv.executor
    learn = conf + [("model_out", model), ("has_aux", "1"),
                    ("num_producers", "1"), ("producer_mode", "thread")]
    tr = OnlineTrainer(OnlineParam(
        online_log_dir=log_dir, online_ckpt_interval_s=2.0,
        online_endpoints=f"{srv.host}:{srv.port}"), learn, device=DEV)
    ln = tr.learner
    seg_s, saves, pushes = [], [], []
    run_epoch, save_ckpt = ln._run_epoch, ln._save_checkpoint
    push = online_loop.push_reload

    def timed_epoch(*a):
        t = time.perf_counter()
        run_epoch(*a)
        sync()
        seg_s.append(time.perf_counter() - t)

    def timed_save(*a):
        t = time.perf_counter()
        save_ckpt(*a)
        saves.append(time.perf_counter() - t)

    def timed_push(*a, **kw):
        t = time.monotonic()
        res = push(*a, **kw)
        pushes.append((t, time.monotonic(), ex.generation, res))
        return res

    ln._run_epoch, ln._save_checkpoint = timed_epoch, timed_save
    online_loop.push_reload = timed_push
    behind, stop_mon = [], threading.Event()

    def monitor():
        while not stop_mon.wait(0.25):
            behind.append((REGISTRY.value("train_behind_serve_s"),
                           REGISTRY.value("online_rows_behind")))

    res = {}

    def train():
        res.update(trained=tr.run())

    tt = threading.Thread(target=train)
    mon = threading.Thread(target=monitor)
    g = None
    _reset_counts()
    try:
        tt.start()
        mon.start()
        g, o, s = _start_loadgen(work, "online", mode="online",
                                 endpoints=[(srv.host, srv.port)],
                                 rows=rows_file, rate=ONLINE_RATE,
                                 min_rows=ONLINE_ROWS)
        deadline = time.monotonic() + 240
        while ex.generation < 3:
            if time.monotonic() > deadline or not tt.is_alive():
                raise AssertionError(f"the served generation reached only "
                                     f"{ex.generation} under load")
            time.sleep(0.1)
        lg = _finish_loadgen(work, "online", g, o, s)
        time.sleep(0.6)             # past the last label horizon
        olog.end()
        tt.join(timeout=600)
        if tt.is_alive():
            raise AssertionError("the trainer never drained the log")
        stop_mon.set()
        mon.join()
        counts = _counts()
        st = ex.stats()
        with ServeClient(srv.host, srv.port) as c:
            answers = _score_all(c, check)
    finally:
        tr.stop()
        stop_mon.set()
        online_loop.push_reload = push
        if g is not None and g.poll() is None:
            g.kill()
            g.wait()
        srv.close()
    if lg["err"] or lg["acked"] != lg["labels"]:
        raise AssertionError(f"online client: {lg}")
    if srv.stats_snapshot()["bluegreen_swaps"] or srv.executor is not ex:
        raise AssertionError("the online loop swapped executors")
    under = sum(1 for t0, t1, _, r in pushes
                if r["ok"] and t1 <= lg["t1"])
    if under < 2:
        raise AssertionError(f"{under} generation(s) landed under load")
    idx = read_index(log_dir)
    bs = int(dict(conf)["batch_size"])
    n_batches = sum(-(-e["rows"] // bs) for e in idx)
    seg0 = -(-idx[0]["rows"] // bs)
    want = {"gather_rows_cuda": st["dispatches"] + n_batches + seg0,
            "fm_update_rows_cuda": n_batches, "scatter_rows_cuda": seg0}
    if _table_part(counts) != want:
        raise AssertionError(f"phase 16 (q) launches {counts}, want {want}"
                             f" ({st['dispatches']} predicts, {n_batches} "
                             f"training batches, {seg0} in segment 0)")
    # the offline replay of the same sealed log
    replay = os.path.join(d, "replay")
    wall_r, _ = _cli([f"{k}={v}" for k, v in learn if k != "model_out"]
                     + ["task=online", "online_replay=1",
                        f"online_log_dir={log_dir}",
                        f"model_out={replay}", "online_ckpt_interval_s=0",
                        f"device={DEV}"])
    with np.load(model + "_part-0") as a, np.load(replay + "_part-0") as b:
        if set(a.files) != set(b.files) or any(
                a[k].tobytes() != b[k].tobytes() for k in a.files):
            raise AssertionError("the replay's final checkpoint differs "
                                 "from the online one")
    col = _pred_of(work, "online_final", conf, model)
    if answers != col[:CHECK_ROWS]:
        raise AssertionError("answers after the last reload differ from "
                             "task=pred of the final checkpoint")
    lat = [t1 - t0 for t0, t1, _, r in pushes if r["ok"]]
    out = {"segments": len(idx), "rows": sum(e["rows"] for e in idx),
           "seg_s": float(np.median(seg_s)), "save_s": float(np.median(
               saves)), "push_s": lat, "generations": ex.generation,
           "behind_s_max": max(b for b, _ in behind),
           "rows_behind_max": max(r for _, r in behind),
           "replay_s": wall_r, "launches": counts}
    log(f"  online: {lg['sent']} #score rows ({lg['labels']} #label, all "
        f"joined), {out['rows']} rows in {out['segments']} segments, "
        f"trained through {res['trained']}; a segment pass {out['seg_s']:.3f}"
        f" s (median), a checkpoint {out['save_s']:.3f} s, reload push -> "
        f"model_generation {', '.join(f'{x:.3f}' for x in lat)} s; "
        f"train_behind_serve_s max {out['behind_s_max']:.3f}, "
        f"online_rows_behind max {out['rows_behind_max']:.0f}; served "
        f"generation {ex.generation} ({under} under load) [{smi}]")
    log(f"  replay (python -m difacto_tpu_torch task=online "
        f"online_replay=1): {wall_r:.1f} s, final checkpoint byte for byte "
        f"the online one; answers after the last reload = its task=pred; "
        f"launches {counts} = predicts + batches + segment 0's [{smi}]")
    log(f"phase 16 (q) ok in {time.monotonic() - t_phase:.1f} s: serve -> "
        "log -> train -> reload")
    return out


# ------------------------------------------------------------ phase 17
FLEET_CHECK = 2000          # rows sent through the in-process router (r)
FLEET_BASE_S = 3.0          # open-loop seconds before the roll (s)
FLEET_OVERLOAD = 1.5        # (u) offers this times one replica's rate
KILL_RUN_S = 8.0            # (t) the load generator's seconds around the kill
GROUP_RUN_S = 16.0          # (t) the load generator's seconds around the roll
FLEET_EXTRA = ["data_format=criteo"]   # the replicas' task=serve keys
SCALE_P99_MS = 1000.0       # (u) the autoscaler's client p99 limit


def _free_port() -> int:
    """A port that was free a moment ago."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ready_endpoint(proc, ready: str, wait_s: float = 300.0) -> tuple:
    """Wait for a spawned replica's or router's ready file: (host, port)."""
    from difacto_tpu_torch.serve.fleet import _wait_ready_file
    _wait_ready_file(ready, proc, wait_s, 0.05)
    while True:
        with open(ready) as f:
            parts = f.read().split()
        if len(parts) == 2:
            return parts[0], int(parts[1])
        time.sleep(0.02)


def _reap(proc, timeout: float = 60.0) -> int:
    """The process's exit code; killed (and reported so) past ``timeout``."""
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return -9


def _smi_apps(stop, out: dict) -> None:
    """Sample ``nvidia-smi`` until ``stop``: the card's largest
    ``memory.used`` and the most processes on the card at once."""
    while not stop.wait(1.0):
        r = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
        d = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
        if r.returncode != 0 or d.returncode != 0:
            out["error"] = (r.stderr or d.stderr).strip()[:200]
            return
        n = sum(1 for l in r.stdout.splitlines() if l.strip())
        out["max_procs"] = max(out.get("max_procs", 0), n)
        out["max_used_mib"] = max(out.get("max_used_mib", 0),
                                  int(d.stdout.split()[0]))


def _loadgen_cli(work: str, name: str, endpoint: tuple, qps: float,
                 seconds: float):
    """``python -m difacto_tpu_torch.tools.loadgen --endpoints`` (the
    port's ``run_loadgen_failover``) in its own interpreter."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("DIFACTO_FAULTS", None)
    with open(os.path.join(work, f"{name}.log"), "wb") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "difacto_tpu_torch.tools.loadgen",
             "--endpoints", f"{endpoint[0]}:{endpoint[1]}", "--data",
             os.path.join(work, "criteo.txt"), "--qps", str(qps),
             "--duration", str(seconds)], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=err, text=True)


def _loadgen_cli_result(work: str, name: str, proc, timeout=120) -> dict:
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        with open(os.path.join(work, f"{name}.log"), "rb") as f:
            tail = f.read()[-3000:].decode("utf-8", "replace")
        raise AssertionError(f"loadgen {name} exited {proc.returncode}:"
                             f"\n{tail}")
    return json.loads(out.strip().splitlines()[-1])


def _router_rows_metric(text: str) -> dict:
    """``difacto_router_rows_forwarded_total`` per endpoint from a
    router's ``#metrics``."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith("difacto_router_rows_forwarded_total{"):
            ep = ln.split('endpoint="')[1].split('"')[0]
            out[ep] = float(ln.split()[-1])
        elif ln and not ln.startswith("#") and len(ln.split()) != 2:
            raise AssertionError(f"#metrics line does not parse: {ln!r}")
    return out


def _open_rows(lg: dict, col: list, what: str) -> tuple:
    """Check an open-loop run: no ``!`` reply, every answer its row's pred
    column; returns (send, latency) arrays."""
    reply = [r.encode() for r in lg["reply"]]
    bad = [r for r in reply if r.startswith(b"!")]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} rows answered {bad[0]}")
    wrong = sum(r != col[k] for k, r in zip(lg["idx"], reply))
    if wrong:
        raise AssertionError(f"{what}: {wrong} answers differ from the "
                             "pred column")
    send = np.asarray(lg["send"])
    return send, np.asarray(lg["recv"]) - np.asarray(lg["sched"])


def phase_fleet_inproc(work: str, lines: list, C: int, smi: str) -> dict:
    """Phase 17 (r): two in-process ServeServers (``takeover`` on) over
    phase 3's model at full width behind an in-process RouterServer,
    first P2C, then ``balance=affinity`` with ``affinity_capacity`` C
    (the Criteo rows' leading key, the count field I1, hashes every row
    to one owner) and with capacity 0 (the splitmix64 ring).
    Each time a pipelined window of 2,000 rows goes through the router:
    the answers equal the pred column byte for byte, ``#health`` shows the
    router and both replicas ready, the ``#stats`` backends' rows sum to
    the rows sent and equal the router's ``#metrics``, each replica's
    ``#metrics`` agrees with its ``#stats``, and the gather launches equal
    the two executors' dispatches; under affinity the hit counter is
    live, and on the ring both replicas get rows."""
    import torch
    from difacto_tpu_torch.serve import (RouterServer, ServeClient,
                                         ServeServer, open_serving_store)
    t_phase = time.monotonic()
    with open(os.path.join(work, "criteo.txt"), "rb") as f:
        rows = f.read().splitlines()[:FLEET_CHECK]
    col = [l.split(b"\t")[1] for l in lines[:FLEET_CHECK]]
    model = os.path.join(work, "model")
    reps = []
    total = {c: 0 for c in COUNTERS}
    shown = []
    try:
        for _ in range(2):
            store, _, _ = open_serving_store(model, device=DEV)
            reps.append(ServeServer(store, data_format="criteo",
                                    takeover=True).start())
            del store
        eps = [(s.host, s.port) for s in reps]
        for balance, cap in (("p2c", C), ("affinity", C),
                             ("affinity", 0)):
            what = balance if balance == "p2c" else f"affinity {cap}"
            d0 = [s.executor.stats()["dispatches"] for s in reps]
            _reset_counts()
            router = RouterServer(eps, balance=balance,
                                  affinity_capacity=cap).start()
            try:
                t0 = time.monotonic()
                with ServeClient(router.host, router.port,
                                 timeout=120) as c:
                    got = c.score_lines(rows)
                    sync()
                    wall = time.monotonic() - t0
                    h, st, text = c.health(), c.stats(), c.metrics()
            finally:
                router.close()
            counts = _counts()
            disp = sum(s.executor.stats()["dispatches"] - d
                       for s, d in zip(reps, d0))
            if got != col:
                bad = sum(g != w for g, w in zip(got, col))
                raise AssertionError(f"(r) {what}: {bad} answers through "
                                     "the router differ from the pred "
                                     "column")
            if not (h.get("router") and h["status"] == "ready"
                    and h["replicas_live"] == 2):
                raise AssertionError(f"(r) {what}: #health {h}")
            per = {b["endpoint"]: b["rows"] for b in st["backends"]}
            if sum(per.values()) != len(rows) or st["rows"] != len(rows):
                raise AssertionError(f"(r) {what}: #stats backends {per},"
                                     f" rows {st['rows']}, sent {len(rows)}")
            if {k: float(v) for k, v in per.items() if v} != \
                    _router_rows_metric(text):
                raise AssertionError(f"(r) {what}: #metrics "
                                     f"{_router_rows_metric(text)} vs "
                                     f"#stats {per}")
            if counts["gather_rows_cuda"] != disp or \
                    counts["fm_update_rows_cuda"] or \
                    counts["scatter_rows_cuda"]:
                raise AssertionError(f"(r) {what}: launches {counts}, "
                                     f"want {disp} gathers (dispatches)")
            if balance == "affinity" and not (
                    st["affinity_hits"] > 0 and st["affinity_misses"] == 0
                    and (cap or min(per.values()) > 0)):
                raise AssertionError(f"(r) {what}: affinity counters "
                                     f"{st}")
            for c_ in COUNTERS:
                total[c_] += counts[c_]
            shown.append(
                f"{what}: {len(rows)} rows in {wall:.3f} s, backends "
                f"{sorted(per.values())}, {disp} dispatches = "
                f"{counts['gather_rows_cuda']} gathers"
                + (f", affinity hits {int(st['affinity_hits'])}"
                   if balance == "affinity" else ""))
        agree = []
        for s in reps:
            with ServeClient(s.host, s.port) as c:
                agree.append(_metrics_agree(c.metrics(), c.stats()))
    finally:
        for s in reps:
            s.close()
        del reps
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
    log(f"  (r) in-process router over two replicas: "
        f"{'; '.join(shown)}; #metrics vs #stats per replica: "
        f"{' | '.join(agree)} [{smi}]")
    log(f"phase 17 (r) ok in {time.monotonic() - t_phase:.1f} s: answers "
        "through the router (p2c, affinity on the slots and on the ring) = "
        "pred, launches = dispatches")
    return {"launches": total}


def _cpu_s(pid: int) -> float:
    """CPU seconds (user + system) process ``pid`` has used, from /proc."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            p = f.read().rsplit(")", 1)[1].split()
    except OSError:
        return 0.0
    return (int(p[11]) + int(p[12])) / os.sysconf("SC_CLK_TCK")


def _established(pid: int, port: int) -> int:
    """Established TCP connections process ``pid`` holds on local port
    ``port`` (from /proc): which router group member serves a client."""
    inodes = set()
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                t = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if t.startswith("socket:["):
                inodes.add(t[8:-1])
    except OSError:
        return 0
    n = 0
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                next(f)
                for ln in f:
                    p = ln.split()
                    if (p[3] == "01" and p[9] in inodes
                            and int(p[1].rsplit(":", 1)[1], 16) == port):
                        n += 1
        except OSError:
            continue
    return n


def _client_member(client, members, port: int) -> list:
    """The members of a router group that hold an established connection
    on ``port`` once ``client`` (a load generator) has connected; empty
    if it exits first or 60 s pass."""
    deadline = time.monotonic() + 60
    while client.poll() is None and time.monotonic() < deadline:
        held = [m for m in members if _established(m.pid, port)]
        if held:
            return held
        time.sleep(0.05)
    return []


class _Fleet:
    """Phase 17 (s)-(u)'s processes: every replica, router and load
    generator started here is reaped by ``close``."""

    def __init__(self, work: str, lines: list, smi: str):
        self.work, self.smi = work, smi
        self.model = os.path.join(work, "model")
        self.rows_file = os.path.join(work, "criteo.txt")
        self.col = [l.split(b"\t")[1] for l in lines]
        self.procs = []
        self.out = {}

    def replica(self, name: str, port: int = 0, host: str = "127.0.0.1"):
        from difacto_tpu_torch.serve.fleet import spawn_successor
        ready = os.path.join(self.work, f"{name}.ready")
        p = spawn_successor(self.model, port or _free_port(), ready,
                            FLEET_EXTRA, host=host, device=DEV)
        self.procs.append(p)
        return p, ready

    def router(self, name: str, endpoints: str, port: int = 0,
               host: str = "127.0.0.1"):
        from difacto_tpu_torch.serve.fleet import spawn_router
        ready = os.path.join(self.work, f"{name}.ready")
        p = spawn_router(endpoints, port or _free_port(), ready, host=host)
        self.procs.append(p)
        return p, ready

    def closed(self, name: str, ep: tuple, conns: int,
               watch: dict) -> tuple:
        """Closed-loop rows/s to ``ep`` on ``conns`` connections of
        256-row windows (phase 16's load generator), and the cores each
        process of ``watch`` (name -> pid) and the load generator used
        meanwhile."""
        g, o, s = _start_loadgen(self.work, name, mode="closed",
                                 endpoints=[ep], rows=self.rows_file,
                                 conns=conns, window=256,
                                 seconds=LIFE_PROBE_S)
        self.procs.append(g)
        watch = dict(watch, loadgen=g.pid)
        while not os.path.exists(s[:-len(".stop")] + ".sending"):
            if g.poll() is not None:
                break
            time.sleep(0.02)
        c0, t0 = {k: _cpu_s(p) for k, p in watch.items()}, time.monotonic()
        time.sleep(LIFE_PROBE_S / 2)
        cores = {k: round((_cpu_s(p) - c0[k]) / (time.monotonic() - t0), 2)
                 for k, p in watch.items()}
        r = _finish_loadgen(self.work, name, g, o, s)
        if r["bad"]:
            raise AssertionError(f"{name}: {r['bad']} rows answered !")
        return r["rows"] / r["seconds"], cores

    def open_gen(self, name: str, ep: tuple, rate: float, **spec):
        window = max(1, int(round(rate / OPEN_CONNS * OPEN_TICK_S)))
        g, o, s = _start_loadgen(self.work, name, mode="open",
                                 endpoints=[ep], rows=self.rows_file,
                                 conns=OPEN_CONNS, window=window, rate=rate,
                                 **spec)
        self.procs.append(g)
        return g, o, s

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def fleet_rates_roll(f: _Fleet) -> tuple:
    """Phase 17 (s): replicas A and B (``python -m difacto_tpu_torch
    task=serve``) over phase 3's model and two ``python -m
    difacto_tpu_torch.tools.fleet route`` routers, one over A and one over
    A and B: the closed-loop rate (4 connections x 256-row windows)
    direct to A, through the router to A and to A and B; then half of the
    two-replica rate open-loop on 16 connections through the router while
    ``run_rolling_restart`` replaces A and B with ``spawn_successor``
    processes on the card: no ``!err``, no ``!shed``, every answer the
    pred column, each incumbent exits 0. Returns the two successors'
    (process, endpoint) pairs."""
    from difacto_tpu_torch.serve import ServeClient, run_rolling_restart
    from difacto_tpu_torch.serve.fleet import spawn_successor
    t0 = time.monotonic()
    (pa, ra), (pb, rb) = f.replica("rep_a"), f.replica("rep_b")
    ep_a, ep_b = _ready_endpoint(pa, ra), _ready_endpoint(pb, rb)
    warm_ab = time.monotonic() - t0
    two = f"{ep_a[0]}:{ep_a[1]},{ep_b[0]}:{ep_b[1]}"
    (p1, r1), (p2, r2) = (f.router("route_a", f"{ep_a[0]}:{ep_a[1]}"),
                          f.router("route_ab", two))
    ep_r1, ep_r2 = _ready_endpoint(p1, r1), _ready_endpoint(p2, r2)
    # each replica's first rows, checked: the warm-up before the rates
    with open(f.rows_file, "rb") as fh:
        rows = fh.read().splitlines()[:CHECK_ROWS]
    for ep in (ep_a, ep_b):
        with ServeClient(*ep) as c:
            if _score_all(c, rows) != f.col[:CHECK_ROWS]:
                raise AssertionError(f"(s) replica {ep} answers differ "
                                     "from the pred column")
    # the same rows in flight at each replica: 4 x 256 direct (its queue
    # cap); the router forwards one 64-row chunk per client connection
    # at a time, so 16 connections to one replica, 32 to two
    reps = {"replica A": pa.pid, "replica B": pb.pid}
    rate_a, cores_a = f.closed("rate_a", ep_a, LIFE_CONNS, reps)
    rate_r1, cores_r1 = f.closed("rate_r1", ep_r1, 4 * LIFE_CONNS,
                                 dict(reps, router=p1.pid))
    rate_r2, cores_r2 = f.closed("rate_r2", ep_r2, 8 * LIFE_CONNS,
                                 dict(reps, router=p2.pid))
    p1.terminate()
    _reap(p1)
    log(f"  (s) replicas up in {warm_ab:.1f} s (both started together), "
        f"{CHECK_ROWS} rows each = the pred column; closed-loop "
        f"(256-row windows): direct to one replica on {LIFE_CONNS} "
        f"connections {rate_a:.0f} rows/s (cores {cores_a}); through the "
        f"router to one on {4 * LIFE_CONNS} {rate_r1:.0f} "
        f"({rate_r1 / rate_a:.2f}x; cores {cores_r1}), to two on "
        f"{8 * LIFE_CONNS} {rate_r2:.0f} ({rate_r2 / rate_a:.2f}x; cores "
        f"{cores_r2}) [{f.smi}]")
    rate = 0.5 * rate_r2
    g, o, s = f.open_gen("roll", ep_r2, rate)
    while not os.path.exists(s[:-len(".stop")] + ".sending"):
        if g.poll() is not None:
            raise AssertionError("(s) the load generator exited early")
        time.sleep(0.02)
    # the cores the serving processes (and the load generator) use before
    # and inside the roll; an incumbent that exits stays readable as a
    # zombie until it is reaped after the roll
    serving = {"replicas": (pa.pid, pb.pid), "router": (p2.pid,),
               "loadgen": (g.pid,)}

    def cpu() -> dict:
        return {k: sum(_cpu_s(p) for p in ps) for k, ps in serving.items()}

    tb0, cb0 = time.monotonic(), cpu()
    time.sleep(FLEET_BASE_S)
    succ = {}

    def spawn(i, host, port, ready_file):
        p = spawn_successor(f.model, port, ready_file, FLEET_EXTRA,
                            host=host, device=DEV)
        f.procs.append(p)
        succ[i] = p
        return p

    tr0, cb1 = time.monotonic(), cpu()
    roll = run_rolling_restart(two, spawn_fn=spawn, wait_s=600.0)
    tr1, cb2 = time.monotonic(), cpu()
    succ_cpu = sum(_cpu_s(p.pid) for p in succ.values())
    cores_before = {k: round((cb1[k] - cb0[k]) / (tr0 - tb0), 2)
                    for k in cb0}
    cores_inside = {k: round((cb2[k] - cb1[k]) / (tr1 - tr0), 2)
                    for k in cb0}
    cores_inside["successors"] = round(succ_cpu / (tr1 - tr0), 2)
    time.sleep(SETTLE_S)
    lg = _finish_loadgen(f.work, "roll", g, o, s)
    if not roll["ok"]:
        raise AssertionError(f"(s) rolling restart: {roll}")
    rcs = [_reap(pa), _reap(pb)]
    if rcs != [0, 0]:
        raise AssertionError(f"(s) the incumbents exited {rcs}")
    if lg["resent"]:
        raise AssertionError(f"(s) {lg['resent']} rows answered !shed "
                             "during the roll")
    send, lat = _open_rows(lg, f.col, "(s) roll")
    before = lat[(send >= tr0 - FLEET_BASE_S / 2) & (send < tr0)]
    inside = lat[(send >= tr0) & (send < tr1)]
    with ServeClient(*ep_r2) as c:
        h = c.health()
    if h["replicas_live"] != 2 or {r["server_id"] for r in h["replicas"]} \
            != {r["successor"] for r in roll["replicas"]}:
        raise AssertionError(f"(s) after the roll: {h}")
    p2.terminate()
    _reap(p2)
    f.out.update(rate_a=rate_a, rate_r1=rate_r1, rate_r2=rate_r2,
                 roll_p50=_pct(before, 50), roll_p99=_pct(before, 99),
                 in_p50=_pct(inside, 50), in_p99=_pct(inside, 99),
                 roll_s=tr1 - tr0,
                 warm_s=[r["warm_s"] for r in roll["replicas"]],
                 cores_before=cores_before, cores_inside=cores_inside)
    o_ = f.out
    log(f"  (s) open loop at {rate:.0f} rows/s through the router, "
        f"{len(send)} rows, every one the pred column, no !err, no !shed "
        f"({lg['failovers']} client failovers); p50/p99 "
        f"{o_['roll_p50']:.3f}/{o_['roll_p99']:.3f} ms before the roll, "
        f"{o_['in_p50']:.3f}/{o_['in_p99']:.3f} ms inside it "
        f"({o_['roll_s']:.1f} s); successors' warm_s {o_['warm_s']}; the "
        f"cores used before the roll {cores_before}, inside it "
        f"{cores_inside} ({os.cpu_count()} CPUs); the incumbents exited 0 "
        f"[{f.smi}]")
    eps = [r["endpoint"].rsplit(":", 1) for r in roll["replicas"]]
    return [(succ[i], (h_, int(p_))) for i, (h_, p_) in enumerate(eps)]


def fleet_group(f: _Fleet, reps: list) -> None:
    """Phase 17 (t): two ``route`` members on one ``SO_REUSEPORT`` port
    over ``reps`` under the port's ``run_loadgen_failover`` (``python -m
    difacto_tpu_torch.tools.loadgen``, its own interpreter): the member
    holding the client's connection is SIGKILLed, no ``!err``; a third
    member restores the group, then ``run_router_group_roll`` replaces
    both members under load: no ``!err``, successors distinct from the
    incumbents, which exit 0."""
    from difacto_tpu_torch.serve import run_router_group_roll
    from difacto_tpu_torch.serve.fleet import spawn_router
    eps = ",".join(f"{h}:{p}" for _, (h, p) in reps)
    gport = _free_port()
    m1, q1 = f.router("group_1", eps, gport)
    m2, q2 = f.router("group_2", eps, gport)
    ep_g = _ready_endpoint(m1, q1)
    _ready_endpoint(m2, q2)
    qps = min(2000.0, 0.25 * f.out["rate_r2"])
    lk = _loadgen_cli(f.work, "group_kill", ep_g, qps, KILL_RUN_S)
    f.procs.append(lk)
    held = _client_member(lk, (m1, m2), gport)
    if len(held) != 1:
        raise AssertionError(f"(t) the client's connection: {held}")
    victim = held[0]
    time.sleep(2.0)
    victim.send_signal(signal.SIGKILL)
    kill = _loadgen_cli_result(f.work, "group_kill", lk)
    if kill["err"] or kill["ok"] < kill["sent"] // 2:
        raise AssertionError(f"(t) member kill: {kill}")
    _reap(victim)
    alive = m2 if victim is m1 else m1
    m3, q3 = f.router("group_3", eps, gport)
    _ready_endpoint(m3, q3)
    lr = _loadgen_cli(f.work, "group_roll", ep_g, qps, GROUP_RUN_S)
    f.procs.append(lr)
    if not _client_member(lr, (alive, m3), gport):
        raise AssertionError("(t) the load generator never connected")
    time.sleep(1.0)
    rsucc = []

    def rspawn(i, host, port, ready_file):
        p = spawn_router(eps, port, ready_file, host=host)
        f.procs.append(p)
        rsucc.append(p)
        return p

    tg0 = time.monotonic()
    groll = run_router_group_roll(ep_g[0], ep_g[1], group_size=2,
                                  spawn_fn=rspawn, endpoints=eps,
                                  wait_s=300.0)
    tg1 = time.monotonic()
    grp = _loadgen_cli_result(f.work, "group_roll", lr)
    if not groll["ok"]:
        raise AssertionError(f"(t) group roll: {groll}")
    incs = {r["incumbent"] for r in groll["routers"]}
    succs = {r["successor"] for r in groll["routers"]}
    if incs & succs or len(succs) != 2:
        raise AssertionError(f"(t) group roll: {groll}")
    if grp["err"] or grp["ok"] < grp["sent"] // 2:
        raise AssertionError(f"(t) load through the group roll: {grp}")
    rcs = [_reap(alive), _reap(m3)]
    if rcs != [0, 0]:
        raise AssertionError(f"(t) the rolled members exited {rcs}")
    for p in rsucc:
        p.terminate()
        _reap(p)
    f.out.update(kill_max=kill.get("max_ms"), kill_p99=kill.get("p99_ms"),
                 group_roll_s=tg1 - tg0, group_max=grp.get("max_ms"),
                 group_p99=grp.get("p99_ms"))
    log(f"  (t) router group on port {gport} at {qps:.0f} rows/s: the "
        f"member holding the client's connection SIGKILLed; {kill['ok']} "
        f"of {kill['sent']} rows ok, {kill['shed']} shed, no !err, max "
        f"{kill.get('max_ms')} ms, p99 {kill.get('p99_ms')} ms; the group "
        f"rolled in {tg1 - tg0:.1f} s (successors' warm_s "
        f"{[r['warm_s'] for r in groll['routers']]}): {grp['ok']} of "
        f"{grp['sent']} rows ok, {grp['shed']} shed, no !err, max "
        f"{grp.get('max_ms')} ms, p99 {grp.get('p99_ms')} ms; the "
        f"incumbents exited 0 [{f.smi}]")


def fleet_autoscale(f: _Fleet, rep: tuple) -> None:
    """Phase 17 (u): an in-process RouterServer over replica ``rep`` and
    an Autoscaler (min 1, max 2) that spawns ``task=serve`` processes on
    the card, reading the load generator's p99 as its latency signal.
    1.5x the replica's closed-loop rate offered open-loop makes exactly
    one spawn, which joins the router's ``#stats`` backends and
    shows in its ``#metrics`` (``autoscale_spawns_total``); once the load
    stops, exactly one drain, and the drained replica exits 0. No
    ``!err``; every answer is the pred column."""
    from difacto_tpu_torch.obs import REGISTRY
    from difacto_tpu_torch.serve import Autoscaler, RouterServer
    ring = os.path.join(f.work, "fleet.ring")
    rtr = RouterServer([rep], endpoints_file=ring).start()
    spawned = []

    def spawn(idx):
        t = time.monotonic()
        p, ready = f.replica(f"scale_{idx}")
        spawned.append((t, _ready_endpoint(p, ready), p))
        return spawned[-1][1]

    p99_file = os.path.join(f.work, "scale.p99")

    def client_p99() -> float:
        """The load generator's p99 over its last second; 0 once it has
        stopped writing (no traffic)."""
        try:
            with open(p99_file) as fh:
                d = json.load(fh)
        except (OSError, ValueError):
            return 0.0
        return d["p99_ms"] if time.monotonic() - d["t"] < 2.0 else 0.0

    spawns0 = REGISTRY.value("autoscale_spawns_total")
    drains0 = REGISTRY.value("autoscale_drains_total")
    # behind a router a replica's admission queue stays short (the router
    # forwards one 64-row chunk per client connection at a time, and the
    # backlog waits in front of it), so the client's p99 is the signal
    # that sees the overload
    scaler = Autoscaler([rep], spawn, router=(rtr.host, rtr.port),
                        min_replicas=1, max_replicas=2, endpoints_file=ring,
                        latency_fn=client_p99, up_p99_ms=SCALE_P99_MS,
                        # and a loaded replica's queue holds a few chunks,
                        # so idle means a queue that is all but empty
                        down_queue_frac=0.01,
                        # #health's shed_rate is a lifetime fraction: after
                        # a shed it never returns to 0, so the idle test
                        # reads the queue alone
                        down_shed_rate=1.0)
    try:
        urate = FLEET_OVERLOAD * f.out["rate_a"]
        g, o, s = f.open_gen("scale", (rtr.host, rtr.port), urate,
                         p99_file=p99_file)
        scaler.start()
        t_first = None
        deadline = time.monotonic() + 180
        while t_first is None:
            if time.monotonic() > deadline:
                raise AssertionError(f"(u) no scale-up: {scaler.events}")
            if spawned:
                key = f"{spawned[0][1][0]}:{spawned[0][1][1]}"
                if any(b["endpoint"] == key and b["rows"] > 0
                       for b in rtr.backends_snapshot()):
                    t_first = time.monotonic()
            time.sleep(0.02)
        st_up = rtr.stats_snapshot()
        text_up = rtr.metrics_text()
        time.sleep(SETTLE_S)
        lg = _finish_loadgen(f.work, "scale", g, o, s)
        t_stop = time.monotonic()
        while REGISTRY.value("autoscale_drains_total") == drains0:
            if time.monotonic() > t_stop + 120:
                raise AssertionError(f"(u) no drain after the load: "
                                     f"{scaler.events}")
            time.sleep(0.05)
        t_drain = time.monotonic()
        time.sleep(3 * scaler.poll_s)
    finally:
        scaler.close()
        rtr.close()
    if [e["action"] for e in scaler.events] != ["up", "down"]:
        raise AssertionError(f"(u) autoscaler events {scaler.events}")
    if REGISTRY.value("autoscale_spawns_total") - spawns0 != 1:
        raise AssertionError("(u) autoscale_spawns_total did not move by 1")
    key = f"{spawned[0][1][0]}:{spawned[0][1][1]}"
    if key not in {b["endpoint"] for b in st_up["backends"]}:
        raise AssertionError(f"(u) the spawn is not in the router's "
                             f"#stats: {st_up['backends']}")
    if not re.search(r"^difacto_autoscale_spawns_total \d", text_up, re.M):
        raise AssertionError("(u) autoscale_spawns_total is not in the "
                             "router's #metrics")
    rc = _reap(spawned[0][2])
    if rc != 0:
        raise AssertionError(f"(u) the drained replica exited {rc}")
    send, lat = _open_rows(lg, f.col, "(u) autoscale")
    f.out.update(spawn_to_routed_s=t_first - spawned[0][0],
                 stop_to_drain_s=t_drain - t_stop)
    log(f"  (u) autoscaler over one replica at {urate:.0f} rows/s "
        f"({FLEET_OVERLOAD}x its closed-loop rate): events "
        f"{[(round(e['t'], 2), e['action'], e['endpoint'])
            for e in scaler.events]}; "
        f"{f.out['spawn_to_routed_s']:.2f} s from the scale-up decision to "
        f"the first row answered by the new replica; {len(send)} rows, "
        f"every one the pred column, no !err ({lg['resent']} shed rows "
        f"sent again); the drain {f.out['stop_to_drain_s']:.1f} s after "
        f"the load stopped, the drained replica exited 0; p50/p99 over the "
        f"run {_pct(lat, 50):.3f}/{_pct(lat, 99):.3f} ms [{f.smi}]")


def phase_fleet(work: str, lines: list, smi: str) -> dict:
    """Phase 17 (s), (t), (u): the fleet with every part in its own
    process on the card (the autoscaler's router in this one, so that its
    ``#metrics`` holds the autoscaler's counters), nvidia-smi's
    per-process memory sampled throughout."""
    from difacto_tpu_torch.serve.fleet import drain_endpoint
    t_phase = time.monotonic()
    f = _Fleet(work, lines, smi)
    stop, apps = threading.Event(), {}
    sampler = threading.Thread(target=_smi_apps, args=(stop, apps),
                               daemon=True)
    if DEV == "cuda":
        sampler.start()
    try:
        reps = fleet_rates_roll(f)
        fleet_group(f, reps)
        (pa, ep_a), (pb, ep_b) = reps
        drain_endpoint(*ep_b)
        if _reap(pb) != 0:
            raise AssertionError("a drained replica did not exit 0")
        fleet_autoscale(f, ep_a)
        pa.terminate()
        if _reap(pa) != 0:
            raise AssertionError("the last replica did not exit 0 on "
                                 "SIGTERM")
    finally:
        stop.set()
        f.close()
    if DEV == "cuda":
        sampler.join()
    f.out["smi"] = apps
    log(f"  nvidia-smi per-process memory over (s)-(u): "
        + (f"the card's memory.used at most {apps['max_used_mib']} MiB "
           f"with at most {apps['max_procs']} processes on it"
           if "max_used_mib" in apps
           else f"not available ({apps.get('error', 'no sample')})")
        + f" [{smi}]")
    log(f"phase 17 (s)-(u) ok in {time.monotonic() - t_phase:.1f} s: "
        "rates, a rolling restart, a router group kill and roll, an "
        "autoscale up and down, no !err")
    return f.out


# ------------------------------------------------ phase 18: faults, traces
LOCKORDER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "difacto_tpu_torch", "utils", "lockorder.json")
STEP_FAULT_N = 5


def _step_line(step: str, **fields) -> None:
    print(json.dumps({"phase18": step, **fields}), flush=True)


def _fired(point: str) -> float:
    from difacto_tpu_torch.obs import REGISTRY
    return REGISTRY.value("faults_fired_total", point=point, kind="err")


def _cli_faulted(args: list, faults: str = "") -> subprocess.CompletedProcess:
    """``python -m difacto_tpu_torch args...`` with ``DIFACTO_FAULTS`` set
    to ``faults`` (or unset)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("DIFACTO_FAULTS", None)
    if faults:
        env["DIFACTO_FAULTS"] = faults
    return subprocess.run([sys.executable, "-m", "difacto_tpu_torch",
                           *args, f"device={DEV}"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)


def traced_run(spec_path: str) -> None:
    """Phase 18 (d)'s subprocess, started with ``DIFACTO_LOCKTRACE=1
    DIFACTO_RACETRACE=1`` (and once without, for the epochs' times): two
    train epochs on four producer threads, then (traced) a 1,000-row
    window of ``task=serve``'s server (with an online log) over the
    saved model, and an 8,000-row burst into its 1,024-row queue, which
    sheds; dumps the lock edges and the field states, and writes the
    epochs' wall times and the answers."""
    with open(spec_path) as f:
        spec = json.load(f)
    global DEV
    DEV = spec["device"]
    from difacto_tpu_torch.online.log import OnlineLog
    from difacto_tpu_torch.serve import (ServeClient, ServeServer,
                                         open_serving_store)
    from difacto_tpu_torch.utils import locktrace, shared
    ln, _, walls, _ = _train([tuple(kv) for kv in spec["kwargs"]])
    del ln
    epochs = [w[2] for w in walls]
    if not spec["serve"]:
        with open(spec["out"], "w") as f:
            json.dump({"epoch_s": epochs}, f)
        return
    store, _, _ = open_serving_store(spec["model"], device=DEV)
    log_ = OnlineLog(spec["log_dir"], segment_rows=500)
    srv = ServeServer(store, data_format="criteo", batch_size=256,
                      online_log=log_).start()
    with open(spec["rows"], "rb") as f:
        rows = [r for r in f.read().splitlines() if r]
    try:
        with ServeClient(srv.host, srv.port) as c:
            window = c.predict(rows[:1000])
        # the burst's first batch waits until a row has been shed (60 s
        # at most): a scorer faster than the connection's parser never
        # fills the queue, so without the wait the burst sheds only on a
        # slow enough host
        plain, t_end = srv.batcher.predict_fn, time.monotonic() + 60.0

        def held(blk):
            while srv.batcher.stats.shed_rate() == 0 \
                    and time.monotonic() < t_end:
                time.sleep(0.001)
            return plain(blk)
        srv.batcher.predict_fn = held
        with ServeClient(srv.host, srv.port) as c:
            burst = c.predict(rows[:2000] * 4)
    finally:
        srv.close()
        log_.end()
    locktrace.dump(spec["locks"])
    shared.dump(spec["fields"])
    with open(spec["out"], "w") as f:
        json.dump({"epoch_s": epochs, "window": window,
                   "shed": sum(g is None for g in burst)}, f)


def phase_faults(work: str, conf: list, bits_a, smi: str) -> dict:
    """Phase 18: the last four fault points and the lock and race tracers
    at full width, on phase 12's rows. Returns the launches of its
    counted runs."""
    import torch
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.serve import open_serving_store
    from difacto_tpu_torch.utils import faultinject
    t18 = time.monotonic()
    data_in = os.path.join(work, "train.txt")
    data_val = os.path.join(work, "val.txt")
    base = conf + [("data_in", data_in), ("stop_rel_objv", "0"),
                   ("stop_val_auc", "-2"), ("device_cache_mb", "0"),
                   ("report_interval", "0")]
    total = {c: 0 for c in COUNTERS}

    def counted(extra):
        _reset_counts()
        try:
            return _train(base + list(extra))
        finally:
            for c, n in _counts().items():
                total[c] += n

    # (a) step.device: the (N+1)-th dispatched step raises, typed; the
    # kernels ran for exactly N steps (epoch 0: two gathers per step, one
    # for the count push, and one scatter each way)
    n = STEP_FAULT_N
    fired0 = _fired("step.device")
    faultinject.configure(f"step.device:err@1:{n}")
    try:
        try:
            counted([("max_num_epochs", "1"), ("num_producers", "1"),
                     ("producer_mode", "thread")])
        except faultinject.FaultInjected as e:
            err = e
        else:
            raise AssertionError("step.device:err never raised")
        stats = faultinject.stats()
    finally:
        faultinject.configure("")
    got = _counts()
    want = {"gather_rows_cuda": 2 * n, "fm_update_rows_cuda": n,
            "scatter_rows_cuda": n}
    fired = _fired("step.device") - fired0
    if _table_part(got) != want or fired != 1 \
            or stats != {"step.device": 1} or not isinstance(err, OSError):
        raise AssertionError(f"(a) launches {got} (want {want}), fired "
                             f"{fired}, {stats}, {type(err).__name__}")
    _step_line("a", fault=f"step.device:err@1:{n}", error=type(err).__name__,
               fired=fired, launches=got)

    # (b) producer.part: every 4th part attempt fails and is retried, on
    # one producer thread and on one worker process (armed through the
    # DIFACTO_FAULTS it inherits); the table is run (a)'s of phase 12
    ab = [("data_val", data_val), ("max_num_epochs", "2"),
          ("num_producers", "1"), ("has_aux", "1")]
    out_b = {}
    for mode in ("thread", "process"):
        if mode == "thread":
            faultinject.configure("producer.part:err@1:3")
        else:
            os.environ["DIFACTO_FAULTS"] = "producer.part:err@1:3"
        try:
            ln, prog, walls, _ = counted(ab + [("producer_mode", mode)])
            local = faultinject.stats().get("producer.part", 0)
        finally:
            faultinject.configure("")
            os.environ.pop("DIFACTO_FAULTS", None)
        retries = ln.obs.value("producer_part_retries_total")
        fired = ln.obs.value("faults_fired_total", point="producer.part",
                             kind="err") if mode == "process" else local
        same = _bits_equal(ln.store.state.VVg.cpu(), bits_a)
        if retries < 1 or fired != retries or not same \
                or ln.stage_stats()["producer_mode"] != mode:
            raise AssertionError(f"(b) {mode}: fired {fired}, retries "
                                 f"{retries}, table = run (a): {same}")
        out_b[mode] = {"fired": fired, "retries": retries,
                       "epoch_s": [round(w[2], 3) for w in walls]}
        del ln
        gc.collect()
        torch.cuda.empty_cache() if DEV == "cuda" else None
    _step_line("b", fault="producer.part:err@1:3", table_equals_12a=True,
               **out_b)

    # (c) ckpt.write:kill in a subprocess mid-way through epoch 1's
    # checkpoint; auto_resume walks past the torn generation and saves
    # run (a)'s model; task=pred of the result scores; ckpt.read:err on a
    # load raises typed
    model = os.path.join(work, "chaos", "m")
    args = ["task=train", f"data_in={data_in}", f"data_val={data_val}",
            "max_num_epochs=2", "num_producers=1", "producer_mode=thread",
            "has_aux=1", "stop_rel_objv=0", "stop_val_auc=-2",
            "device_cache_mb=0", "report_interval=0", "ckpt_interval=1",
            "auto_resume=1", f"model_out={model}"] + [
        f"{k}={v}" for k, v in conf]
    t0 = time.monotonic()
    r1 = _cli_faulted(args, "ckpt.write:kill@1:1")
    torn = f"{model}_iter-1_part-0"
    if r1.returncode != -signal.SIGKILL or not os.path.exists(torn) \
            or os.path.exists(torn + ".manifest.json"):
        raise AssertionError(f"(c) the killed run: rc {r1.returncode}\n"
                             f"{r1.stderr[-2000:]}")
    r2 = _cli_faulted(args)
    if r2.returncode != 0 or "auto-resumed from epoch 0" not in r2.stderr \
            or "walking back" not in r2.stderr:
        raise AssertionError(f"(c) the resumed run: rc {r2.returncode}\n"
                             f"{r2.stderr[-3000:]}")
    with np.load(model + "_part-0") as z, \
            np.load(os.path.join(work, "stream_a_part-0")) as za:
        if sorted(z.files) != sorted(za.files) or not all(
                np.array_equal(z[k], za[k]) for k in za.files):
            raise AssertionError("(c) the resumed model != phase 12 run "
                                 "(a)'s")
    pred = os.path.join(work, "chaos", "pred")
    run_pred([("data_in", data_val), ("data_format", "criteo"),
              ("model_in", model + "_part-0"), ("pred_out", pred),
              ("batch_size", "1000")], device=DEV)
    with open(pred + "_part-0") as f:
        p = np.array([float(ln.split()[-1]) for ln in f])
    if len(p) != N_VAL or not np.isfinite(p).all() \
            or not ((p > 0) & (p < 1)).all():
        raise AssertionError(f"(c) pred of the resumed model: {len(p)} "
                             "rows, not all probabilities")
    faultinject.configure("ckpt.read:err@1")
    try:
        try:
            open_serving_store(model + "_part-0", device=DEV)
        except faultinject.FaultInjected as e:
            read_err = type(e).__name__
        else:
            raise AssertionError("ckpt.read:err never raised")
        read_fired = faultinject.stats().get("ckpt.read", 0)
    finally:
        faultinject.configure("")
    _step_line("c", fault="ckpt.write:kill@1:1", killed_rc=r1.returncode,
               resumed_from=0, table_equals_12a=True, pred_rows=len(p),
               read_fault="ckpt.read:err@1", read_error=read_err,
               read_fired=read_fired,
               seconds=round(time.monotonic() - t0, 1))

    # (d) two epochs traced and untraced, each in a subprocess of its own
    # (the tracers arm at import), then the traced one serves
    root = os.path.dirname(os.path.abspath(__file__))
    specs = {}
    for traced in (True, False):
        dd = os.path.join(work, "traced" if traced else "untraced")
        os.makedirs(dd, exist_ok=True)
        kw = base + [("max_num_epochs", "2"), ("num_producers", "4"),
                     ("producer_mode", "thread"),
                     ("model_out", os.path.join(dd, "m"))]
        spec = specs[traced] = {
            "device": DEV, "kwargs": kw, "serve": traced,
            "model": os.path.join(dd, "m"), "rows": data_val,
            "log_dir": os.path.join(dd, "log"),
            "locks": os.path.join(dd, "locks.json"),
            "fields": os.path.join(dd, "fields.json"),
            "out": os.path.join(dd, "out.json")}
        with open(os.path.join(dd, "spec.json"), "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=root)
        for v in ("DIFACTO_LOCKTRACE", "DIFACTO_RACETRACE"):
            env.pop(v, None)
            if traced:
                env[v] = "1"
        r = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.traced_run({os.path.join(dd, 'spec.json')!r})"],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"(d) the {'' if traced else 'un'}traced "
                                 f"run failed:\n{r.stderr[-3000:]}")
    with open(specs[False]["out"]) as f:
        untraced = json.load(f)["epoch_s"]
    spec = specs[True]
    with open(LOCKORDER) as f:
        static = json.load(f)
    with open(spec["locks"]) as f:
        edges = [(e["src"], e["dst"]) for e in json.load(f)["edges"]]
    with open(spec["fields"]) as f:
        fields = json.load(f)["fields"]
    with open(spec["out"]) as f:
        out = json.load(f)
    sites, graph = static["sites"], {tuple(e) for e in static["edges"]}
    bad = [e for e in edges if e[0] not in sites or e[1] not in sites
           or (sites[e[0]], sites[e[1]]) not in graph]
    alarms = sorted(fid for fid, rec in fields.items()
                    if rec["state"] == "shared-modified"
                    and rec["lockset"] == [])
    shared_f = [fid for fid, rec in fields.items()
                if rec["state"] != "exclusive"]
    window = out["window"]
    if static["cycles"] or not edges or bad \
            or any(a not in static["race_suppressed"] for a in alarms) \
            or any(f not in static["race_traced_known_safe"]
                   for f in shared_f) or not shared_f \
            or len(window) != 1000 or any(g is None for g in window) \
            or out["shed"] == 0:
        raise AssertionError(f"(d) edges {len(edges)}, not static {bad}, "
                             f"alarms {alarms}, shared {shared_f}, "
                             f"shed {out['shed']}")
    _step_line("d", edges=len(edges), static_edges=len(graph),
               cycles=0, shared_fields=len(shared_f), alarms=alarms,
               epoch_s_traced=[round(x, 3) for x in out["epoch_s"]],
               epoch_s_untraced=[round(x, 3) for x in untraced],
               window_rows=len(window), burst_shed=out["shed"])

    # (e) remote streams on memory://, where fsspec imports
    import importlib.util
    if importlib.util.find_spec("fsspec") is None:
        _step_line("e", remote="not run: fsspec is not installed")
    else:
        _step_line("e", **phase_remote(work, conf, data_in, data_val))
    log(f"phase 18 ok in {time.monotonic() - t18:.1f} s: fault points and "
        f"tracing ({smi})")
    return {"launches": total}


def phase_remote(work: str, conf: list, data_in: str, data_val: str
                 ) -> dict:
    """Phase 18 (e): one epoch from a ``memory://`` text part and from a
    ``memory://`` rec2 cache into a ``memory://`` model_out, then pred
    from it into ``memory://``; tables and predictions equal the local
    runs' byte for byte."""
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.data.converter import Converter
    from difacto_tpu_torch.utils import stream
    with open(data_in, "rb") as f, \
            stream.open_stream("memory://p18/train.txt", "wb") as g:
        g.write(f.read())
    ep = [("max_num_epochs", "1"), ("num_producers", "1"),
          ("producer_mode", "thread"), ("stop_rel_objv", "0"),
          ("device_cache_mb", "0"), ("report_interval", "0")]
    rec = []
    for out in (os.path.join(work, "p18.rec"), "memory://p18/c.rec"):
        c = Converter()
        c.init(conf + [("data_in", data_in), ("data_out", out),
                       ("data_out_format", "rec"), ("convert_procs", "1")])
        c.run()
        rec.append(out)
    got = {}
    for name, src, fmt, m in (
            ("text local", data_in, "criteo", os.path.join(work, "p18t")),
            ("text remote", "memory://p18/train.txt", "criteo",
             "memory://p18/t"),
            ("rec2 local", rec[0], "rec", os.path.join(work, "p18r")),
            ("rec2 remote", rec[1], "rec", "memory://p18/r")):
        ln, _, _, _ = _train(conf + ep + [("data_in", src),
                                          ("data_format", fmt),
                                          ("model_out", m)])
        bits = ln.store.state.VVg.clone()
        del ln
        run_pred([("data_in", data_val), ("data_format", "criteo"),
                  ("model_in", m + "_part-0"), ("pred_out", m + ".pred"),
                  ("batch_size", "1000")], device=DEV)
        with stream.open_stream(m + ".pred_part-0", "rb") as f:
            got[name] = (bits, f.read())
    for kind in ("text", "rec2"):
        a, b = got[f"{kind} local"], got[f"{kind} remote"]
        if not _bits_equal(a[0], b[0]) or a[1] != b[1]:
            raise AssertionError(f"(e) {kind}: remote != local")
    return {"text_equal": True, "rec2_equal": True,
            "pred_rows": got["text remote"][1].count(b"\n")}


# ---------------------------------------------------------- phase 19
VIRTUAL_DEVICES = 8         # logical devices phase 19's runs see


class _virtual_devices:
    """``DIFACTO_TORCH_VIRTUAL_DEVICES`` set for phase 19's runs only (the
    port's counterpart of XLA's host device count: eight logical devices
    on the one card, so the examples' 2 x 4 mesh runs there)."""

    def __init__(self, n: int = VIRTUAL_DEVICES):
        self.n = n

    def __enter__(self):
        from difacto_tpu_torch.utils.platform import VIRTUAL_DEVICES_ENV
        self.key = VIRTUAL_DEVICES_ENV
        self.old = os.environ.get(self.key)
        os.environ[self.key] = str(self.n)
        return self

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.key, None)
        else:
            os.environ[self.key] = self.old


def _routed_runs():
    """Tally, per kernel counter, the launches the shard routing asks for
    (one per non-empty shard run of every routed gather and push); returns
    (tally, restore)."""
    from difacto_tpu_torch.parallel import sharded
    tally = dict.fromkeys(TABLE_COUNTERS, 0)
    saved = (sharded.sharded_gather, sharded.sharded_push,
             sharded.sharded_scatter)

    def wrap(fn, key):
        def run(shards, ss, *a, **k):
            tally[key] += sum(1 for _ in sharded._runs(ss))
            return fn(shards, ss, *a, **k)
        return run

    sharded.sharded_gather = wrap(saved[0], "gather_rows_cuda")
    sharded.sharded_push = wrap(saved[1], "fm_update_rows_cuda")
    sharded.sharded_scatter = wrap(saved[2], "scatter_rows_cuda")

    def restore():
        (sharded.sharded_gather, sharded.sharded_push,
         sharded.sharded_scatter) = saved
    return tally, restore


def _host_table(state):
    """A state's whole fused table on the host (a mesh's shards copied
    in shard order), for comparisons."""
    from difacto_tpu_torch.parallel.sharded import host_state
    return host_state(state).VVg


def _bits_same(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _mesh_runs(kw: list, what: str, model: str = "") -> dict:
    """One mesh training run, its launches checked against the routed
    shard runs: {learner, loss per row per epoch, walls, launches}."""
    _reset_counts()
    tally, restore = _routed_runs()
    t0 = time.monotonic()
    try:
        extra = [("has_aux", "1"), ("model_out", model)] if model else []
        ln, progress, walls, _ = _train(kw + extra)
    finally:
        restore()
    wall = time.monotonic() - t0
    launches = _counts()
    if _table_part(launches) != tally:
        raise AssertionError(f"{what}: launches {launches}, the shard runs "
                             f"routed {tally}")
    if not all(_table_part(launches).values()):
        raise AssertionError(f"{what}: a kernel never launched: {launches}")
    loss = [t.loss / t.nrows for t, _ in progress]
    return {"ln": ln, "loss": loss, "walls": walls, "launches": launches,
            "wall": wall}


def _shard_times(ln, staged, table_flat, others: dict) -> dict:
    """Phase 19 (g): each shard's gather and push device time at the main
    path's own slot vectors (the mesh run's staged batches), beside the
    flat kernel's on the same vectors and the whole routed pull/push; the
    gathers in turns with ``others`` ({tree: its gather library function},
    the ``--parent`` trees')."""
    import torch
    from difacto_tpu_torch.learners.sgd import K_TRAINING  # noqa: F401
    from difacto_tpu_torch.losses import FMParams
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.ops.batch import unpack_panel
    from difacto_tpu_torch.parallel import sharded
    from difacto_tpu_torch.updaters.sgd_updater import (epilogue_spec,
                                                        row_epilogue)
    store, loss = ln.store, ln.loss
    C = store.state.capacity
    shards = [s.VVg for s in store.state.shards]
    epi = epilogue_spec(store.param, C)
    plain = functools.partial(row_epilogue, store.param, C)
    items = []
    for st in staged:
        batch, slots, _ = unpack_panel(st.i32, st.f32, st.b_cap, st.d2,
                                       st.u_cap, binary=st.binary)
        ci, cl, cv = st.chunks
        batch = batch._replace(chunk_idx=ci, chunk_lane=cl, chunk_vals=cv)
        ss = sharded.ShardedSlots(slots, st.route[1], st.route[0])
        rows = store.fns.pull_rows(store.state, ss)
        w, V, vm = store.fns.rows_to_params(store.state, rows)
        pred, xv = loss.predict_xv(FMParams(w=w, V=V, v_mask=vm), batch)
        gw, gV = loss.calc_grad(FMParams(w=w, V=V, v_mask=vm), batch,
                                pred, xv)
        items.append((ss, rows, gw.contiguous(), gV.contiguous(), vm))
    sync()
    g_flat, t_flat = gather_turns(others, fused.gather_rows_cuda,
                                  [(table_flat, ss.slots)
                                   for ss, *_ in items])
    g_routed, t_routed = gather_turns(
        others, lambda ss: sharded.sharded_gather(shards, ss),
        [(ss,) for ss, *_ in items])
    out = {"gather_flat": g_flat["kernel"],
        "gather_routed": g_routed["kernel"],
        "push_flat": device_ms(
            fused.fm_update_rows_cuda,
            [(table_flat, ss.slots, r, gw, gV, vm, epi)
             for ss, r, gw, gV, vm in items]),
        "push_routed": device_ms(
            lambda ss, r, gw, gV, vm: sharded.sharded_push(
                shards, ss, r, gw, gV, vm, epi, plain), items),
        "gather_shard": [], "push_shard": [], "lanes": [],
        "turns": [f"flat: {t_flat}", f"routed: {t_routed}"]}
    for f in range(store.fs_count):
        g_args, p_args, lanes = [], [], []
        for ss, r, gw, gV, vm in items:
            a, b = ss.offsets[f], ss.offsets[f + 1]
            if b == a:
                continue
            table, dev = shards[f], shards[f].device
            g_args.append((table, ss.local[f]))
            p_args.append((table, ss.local[f], *(
                t[a:b].to(dev) for t in (r, gw, gV, vm)), epi))
            lanes.append(b - a)
        g_shard, t_shard = gather_turns(others, fused.gather_rows_cuda,
                                        g_args)
        out["gather_shard"].append(g_shard["kernel"])
        out["turns"].append(f"shard {f}: {t_shard}")
        out["push_shard"].append(device_ms(fused.fm_update_rows_cuda,
                                           p_args))
        out["lanes"].append(float(np.mean(lanes)))
    u = items[0][0].slots.shape[0]
    log(f"  (g) device time at the mesh run's own slot vectors ({len(items)}"
        f" staged batches, u_cap {u}; shard lanes on average "
        f"{[round(x) for x in out['lanes']]}, the pad tail in shard 3's):")
    log("      gather per shard " + ", ".join(
        f"{t * 1e3:.2f}" for t in out["gather_shard"])
        + f" us; routed pull {out['gather_routed'] * 1e3:.2f} us; the flat "
        f"kernel on the same vector {out['gather_flat'] * 1e3:.2f} us")
    log("      the gathers in turns (ms): " + "; ".join(out["turns"]))
    log("      push per shard " + ", ".join(
        f"{t * 1e3:.2f}" for t in out["push_shard"])
        + f" us; routed push {out['push_routed'] * 1e3:.2f} us; the flat "
        f"kernel on the same vector {out['push_flat'] * 1e3:.2f} us")
    del items
    torch.cuda.empty_cache()
    return out


def _moved_per_step(replayed, staged) -> dict:
    """The copies between logical devices of the replayed ``staged``
    steps, recorded by utils/collscan (kind ``device_copy``), per step."""
    from difacto_tpu_torch.utils import collscan
    old = os.environ.get("DIFACTO_HLOSCAN")
    os.environ["DIFACTO_HLOSCAN"] = "1"
    collscan.reset()
    try:
        for st in staged:
            replayed(st)
        sync()
        progs = collscan.programs()
    finally:
        if old is None:
            os.environ.pop("DIFACTO_HLOSCAN", None)
        else:
            os.environ["DIFACTO_HLOSCAN"] = old
        collscan.reset()
    moves = [c for rec in progs.values() for c in rec["collectives"]
             if c["kind"] == "device_copy"]
    others = [c for rec in progs.values() for c in rec["collectives"]
              if c["kind"] != "device_copy"]
    n = len(staged)
    return {"copies": sum(c["count"] for c in moves) / n,
            "bytes": sum(c["count"] * c["bytes"] for c in moves) / n,
            "table_axis": sum(c["table_axis"] for c in moves),
            "other_collectives": len(others)}


def _mesh_placement(ln, staged, replayed, peak: int, held, step,
                    flat_step) -> dict:
    """Phase 19 (h), on run (a)'s learner: each logical device's table
    bytes read from its shard's allocations, no tensor of the table's
    rows on the card but those the smoke holds (``held``: phase 7's flat
    table, (a)'s host copy), the run's peak allocated beside the table's
    bytes, and the bytes copied between logical devices per replayed
    step (utils/collscan)."""
    import torch
    from difacto_tpu_torch.updaters.sgd_updater import state_bytes
    store = ln.store
    st = store.state
    C, fs = st.capacity, store.fs_count
    per_dev = store.device_bytes()
    total = state_bytes(store.param, C)
    width = st.shards[0].VVg.shape[1]
    if per_dev != [total // fs] * fs or st.rows != C // fs:
        raise AssertionError(f"(h) shard bytes {per_dev}, rows {st.rows}; "
                             f"want {total // fs} and {C // fs} each")
    keep = {t.untyped_storage().data_ptr() for t in held}
    gc.collect()
    whole = [tuple(t.shape) for t in gc.get_objects()
             if isinstance(t, torch.Tensor) and t.dim() and t.shape[0] == C
             and t.device == st.devices[0]
             and t.untyped_storage().data_ptr() not in keep]
    if whole:
        raise AssertionError(f"(h) tensors of the table's {C} rows: "
                             f"{whole}")
    moved = _moved_per_step(replayed, staged)
    if moved["table_axis"] or moved["other_collectives"] \
            or not moved["copies"]:
        raise AssertionError(f"(h) the moves between logical devices: "
                             f"{moved}")
    log(f"  (h) run (a)'s table: {fs} shards of {C // fs} rows x {width} "
        f"lanes, each its own allocation of {per_dev[0]} B on its logical "
        f"device ({total} B in all), no tensor of {C} rows on the card "
        f"but phase 7's flat table; peak allocated over run (a) "
        f"{peak} B above its start, {peak / total:.3f} x the table's "
        f"bytes; a replayed step copies {moved['bytes']:.0f} B in "
        f"{moved['copies']:.1f} copies between logical devices "
        f"(utils/collscan, kind device_copy, none table-axis); its busy "
        f"time {step['busy_ms']:.3f} ms (phase 8's flat step "
        f"{flat_step['busy_ms']:.3f} ms)")
    return {"bytes_per_device": per_dev, "rows": C // fs, "width": width,
            "table_bytes": total, "peak": peak, "moved": moved,
            "busy_ms": step["busy_ms"]}


def phase_mesh(work: str, mesh_conf: list, uparam, tr: dict, m: dict,
               smi: str, gathers: dict) -> dict:
    """Phase 19: the examples' (dp, fs) mesh on the card, under
    ``DIFACTO_TORCH_VIRTUAL_DEVICES=8``. (a) examples/criteo_hashed.conf
    as written (2 x 4) on phase 7's rows; (b) 1 x 4 and ``mesh_force`` at
    1 x 1 against phase 7's table; (c) the sharded model scored by
    task=pred and task=serve; (d) examples/criteo_dict.conf on its mesh;
    (e) BCD at ``mesh_dp=4`` and L-BFGS at ``mesh_fs=4``; (f) the capacity
    scaling report; (g) the shard launches' device times, the gathers in
    turns with ``gathers`` ({tree: its gather library function}); (h)
    (a)'s placement: each shard its own allocation, the run's peak and
    the copies between logical devices per replayed step."""
    import torch
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.config import parse_config_file
    from difacto_tpu_torch.learners.sgd import K_TRAINING
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.parallel.capacity import capacity_scaling_report
    from difacto_tpu_torch.serve import open_serving_store
    from difacto_tpu_torch.store.convert import (fs_shard_path,
                                                 read_sharded_columns)
    from difacto_tpu_torch.store.local import SlotStore
    t19 = time.monotonic()
    data_in, data_val = tr["data_in"], tr["data_val"]
    base = [("data_in", data_in), ("data_val", data_val),
            ("max_num_epochs", "2"), ("stop_rel_objv", "0"),
            ("stop_val_auc", "-2")]
    kw = mesh_conf + base
    C, k = uparam.hash_capacity, uparam.V_dim
    out = {"launches": dict.fromkeys(COUNTERS, 0)}

    def add(launches):
        for c in COUNTERS:
            out["launches"][c] += launches[c]

    with _virtual_devices():
        # (a) the conf as written; (h) reads the peak above this base
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        base_alloc = torch.cuda.memory_allocated() if DEV == "cuda" else 0
        model = os.path.join(work, "mesh_model")
        a = _mesh_runs(kw, "(a)", model)
        peak = (torch.cuda.max_memory_allocated() - base_alloc
                if DEV == "cuda" else 0)
        ln = a["ln"]
        if ln.mesh.shape != {"dp": 2, "fs": 4} or ln.store.fs_count != 4:
            raise AssertionError(f"(a) ran on {ln.mesh}, not the conf's 2 x 4")
        add(a["launches"])
        loss = a["loss"]
        err = _rel_err(loss, tr["loss"])
        if not (len(loss) == 2 and loss[1] < loss[0] and err <= 1e-5):
            raise AssertionError(f"(a) loss/row {loss}, phase 7's flat "
                                 f"{tr['loss']} (relative {err})")
        info = ln.device_cache_info()
        if not all(c["complete"] for c in info.values()):
            raise AssertionError(f"(a) the replay cache: {info}")
        log(f"  (a) {CONF} as written, mesh {ln.mesh}: loss/row "
            f"{loss[0]:.8f} -> {loss[1]:.8f}, within {err:.3g} relative of "
            f"phase 7's flat run; {a['wall']:.1f} s; launches "
            f"{a['launches']} = the non-empty shard runs routed (phase 7's "
            f"flat run: {tr['launches']}); epoch walls "
            f"{_epoch_walls(a['walls'])}")
        staged = [st for items in ln._caches[K_TRAINING].entries.values()
                  for st in items if st.chunks is not None
                  and st.nrows == ln.param.batch_size][:5]
        if len(staged) < 5:
            raise AssertionError("(a) the replay cache holds fewer than 5 "
                                 "full chunked panels")

        def replayed(st):
            pending = []
            ln._dispatch_staged(K_TRAINING, st, False, pending)
            return pending[-1][1]

        first = _host_table(ln.store.state)
        step = profile_steps(replayed, staged, "(a) mesh 2 x 4 replayed")
        flat = m["steps"]["replayed"]
        log(f"  (a) the mesh's replayed step beside phase 8's flat one: wall "
            f"{step['wall_ms']:.3f} vs {flat['wall_ms']:.3f} ms, busy "
            f"{step['busy_ms']:.3f} vs {flat['busy_ms']:.3f} ms, idle "
            f"{1 - step['busy_ms'] / step['wall_ms']:.1%} vs "
            f"{1 - flat['busy_ms'] / flat['wall_ms']:.1%}, device events "
            f"{step['kernels']:.0f} vs {flat['kernels']:.0f}")
        out["step"] = step
        out["loss"] = loss
        out["placement"] = _mesh_placement(ln, staged, replayed, peak,
                                           (tr["bits"], first), step, flat)
        # (g) on the same staged batches (the pushes write the table)
        out["shards"] = _shard_times(ln, staged, tr["bits"].clone(),
                                     gathers)
        del ln, a, staged
        gc.collect()
        torch.cuda.empty_cache()
        again = _mesh_runs(kw, "(a) repeat")
        if not _bits_same(_host_table(again["ln"].store.state), first):
            raise AssertionError("(a) a repeat run left another table")
        log("  (a) repeat run: the table bit for bit")
        del again, first
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the degenerate meshes leave phase 7's table bit for bit
        for name, over in (("mesh_dp=1 mesh_fs=4",
                            [("mesh_dp", "1"), ("mesh_fs", "4")]),
                           ("mesh_force=1 at 1 x 1",
                            [("mesh_dp", "1"), ("mesh_fs", "1"),
                             ("mesh_force", "1")])):
            b = _mesh_runs(kw + over, f"(b) {name}")
            if not _bits_same(_host_table(b["ln"].store.state),
                              tr["bits"].cpu()):
                raise AssertionError(f"(b) {name}: not phase 7's table")
            log(f"  (b) {name}: phase 7's table bit for bit, launches "
                f"{b['launches']}")
            del b
            gc.collect()
            torch.cuda.empty_cache()

        # (c) the sharded model, scored
        mfile = model + "_part-0"
        for i in range(4):
            if not os.path.exists(fs_shard_path(mfile, i, 4)):
                raise AssertionError(f"(c) missing member {i} of 4")
        flat_conf = mesh_conf + [("mesh_dp", "1"), ("mesh_fs", "1")]
        preds, t_pred = {}, {}
        for name, extra in (("serve_mesh_fs=4", [("serve_mesh_fs", "4")]),
                            ("serve_mesh_fs=1", [("serve_mesh_fs", "1")]),
                            ("mesh_dp=2 mesh_fs=4", [])):
            conf_p = (flat_conf if extra else mesh_conf) + extra
            p_out = os.path.join(work, "mesh_pred_" + name.split()[0])
            fused.gather_rows_cuda.launches = 0
            t0 = time.monotonic()
            run_pred(conf_p + [("model_in", model), ("data_in", data_val),
                               ("pred_out", p_out)], device=DEV)
            sync()
            t_pred[name] = (time.monotonic() - t0,
                            fused.gather_rows_cuda.launches)
            out["launches"]["gather_rows_cuda"] += \
                fused.gather_rows_cuda.launches
            with open(p_out + "_part-0", "rb") as f:
                preds[name] = f.read()
        if len(set(preds.values())) != 1:
            raise AssertionError("(c) the pred files differ across "
                                 f"{list(preds)}")
        lines = preds["serve_mesh_fs=4"].splitlines()
        arrays = read_sharded_columns(mfile, 4, C, k, ("w", "V", "v_live"),
                                      True)
        ref = reference_margins(tr["val_text"], arrays, C)
        probs = np.array([float(x.split(b"\t")[1]) for x in lines])
        p_err = float(np.abs(probs - 1.0 / (1.0 + np.exp(-ref))).max())
        if len(probs) != N_VAL or not p_err <= 1e-4:
            raise AssertionError(f"(c) pred vs float64 FM: {len(probs)} "
                                 f"rows, prob err {p_err}")
        log(f"  (c) members _fs-0..3-of-4 and the stub; task=pred "
            + "; ".join(f"{n}: {s:.2f} s, {g} gather launches"
                        for n, (s, g) in t_pred.items())
            + f"; the three files byte-identical, within {p_err:.3g} of "
            "the float64 FM")
        store, _, _ = open_serving_store(model, [("serve_mesh_fs", "4")],
                                         device=DEV)
        if store.fs_count != 4:
            raise AssertionError(f"(c) serving store fs={store.fs_count}")
        batch = int(dict(mesh_conf)["batch_size"])
        out["launches"]["gather_rows_cuda"] += phase_serve(
            store, lines, tr["val_text"], batch, label="  (c) serve_mesh_fs=4")
        del store, arrays
        gc.collect()
        torch.cuda.empty_cache()

        # (d) examples/criteo_dict.conf on its mesh, cut in rows only
        dconf = parse_config_file(DICT_CONF)
        dkw = dconf + base
        grown = []
        real_grow = SlotStore.grow_to

        def grow_to(self, capacity):
            if capacity > self.state.capacity:
                grown.append(capacity)
            return real_grow(self, capacity)

        SlotStore.grow_to = grow_to
        try:
            d1 = _mesh_runs(dkw, "(d) as written")
            d2 = _mesh_runs(dkw, "(d) repeat")
        finally:
            SlotStore.grow_to = real_grow
        add(d1["launches"])
        dl = d1["ln"]
        if dl.mesh.shape != {"dp": 2, "fs": 4} or dl.store.hashed:
            raise AssertionError(f"(d) ran on {dl.mesh}")
        if not grown or any(c % 4 for c in grown):
            raise AssertionError(f"(d) growths {grown}")
        if not (_bits_same(_host_table(dl.store.state),
                           _host_table(d2["ln"].store.state))
                and np.array_equal(dl.store._keys, d2["ln"].store._keys)):
            raise AssertionError("(d) a repeat run left another table")
        d_info = dl.device_cache_info()
        log(f"  (d) {DICT_CONF} as written, mesh {dl.mesh}: the dictionary "
            f"grew {grown[:len(grown) // 2]} (each a multiple of 4), "
            f"{dl.store.num_features} keys; loss/row "
            f"{[round(x, 8) for x in d1['loss']]}; a repeat run bit for bit "
            f"(table and keys); launches {d1['launches']}; cache {d_info}; "
            f"{d1['wall']:.1f} s")
        del d1, d2, dl
        gc.collect()
        torch.cuda.empty_cache()
        off = [("device_cache_mb", "0")]
        dm = _mesh_runs(dkw + off, "(d) cache off")
        df = _train(dkw + off + [("mesh_dp", "1"), ("mesh_fs", "1")])
        f_loss = [t.loss / t.nrows for t, _ in df[1]]
        d_err = _rel_err(dm["loss"], f_loss)
        if not d_err <= 1e-5:
            raise AssertionError(f"(d) mesh loss/row {dm['loss']} vs flat "
                                 f"{f_loss}")
        log(f"  (d) device_cache_mb=0 on both (the mesh dictionary stages "
            f"in its second pass, the flat one replays its first, so only "
            f"streamed epochs see the same batches): each epoch within "
            f"{d_err:.3g} relative of the flat run")
        del dm, df
        gc.collect()
        torch.cuda.empty_cache()

        # (e) the batch learners on their meshes, rcv1
        rcv1 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "data", "rcv1_100.libsvm")
        bcd = [("data_in", rcv1)] + [
            (k_, v) for k_, v in parse_config_file(os.path.join(
                os.path.dirname(os.path.abspath(__file__)), "examples",
                "bcd.conf")) if k_ not in ("data_in", "learner")]
        bl, bp, _, _ = _batch_run("bcd", bcd + [("mesh_dp", "4")])
        _, bf, _, _ = _batch_run("bcd", bcd)
        b_objv, b_nnz = bp[-1].objv, int(bp[-1].nnz_w)
        b_err = _rel_err([p.objv for p in bp], [p.objv for p in bf])
        if bl.mesh.shape != {"dp": 4, "fs": 1} or b_nnz != BCD_OPTIMUM[1] \
                or abs(b_objv - BCD_OPTIMUM[0]) / b_objv >= 1e-3 \
                or not b_err <= 1e-5:
            raise AssertionError(f"(e) BCD mesh_dp=4: objv {b_objv}, nnz "
                                 f"{b_nnz}, vs flat {b_err}")
        lb = [("data_in", rcv1), ("m", "5"), ("V_dim", "0"), ("l2", "0"),
              ("init_alpha", "1"), ("tail_feature_filter", "0"),
              ("max_num_epochs", str(len(OBJV_BASIC)))]
        ll, lp_, _, _ = _batch_run("lbfgs", lb + [("mesh_fs", "4")])
        _, lf, _, _ = _batch_run("lbfgs", lb)
        l_err = float(np.abs(np.array([p.objv for p in lp_])
                             - OBJV_BASIC).max())
        lv = [("data_in", rcv1), ("m", "5"), ("V_dim", "5"), ("l2", "0.1"),
              ("V_l2", "0.01"), ("V_threshold", "0"), ("rho", "0.5"),
              ("init_alpha", "1"), ("tail_feature_filter", "0"),
              ("max_num_epochs", str(len(OBJV_WITHV)))]
        _, vp, _, _ = _batch_run("lbfgs", lv + [("mesh_fs", "4")],
                                 init=_det_init)
        _, vf, _, _ = _batch_run("lbfgs", lv, init=_det_init)
        v_err = float(np.abs(np.array([p.objv for p in vp])
                             - OBJV_WITHV).max())
        lf_err = float(np.abs(np.array([p.objv for p in lp_])
                              - [p.objv for p in lf]).max())
        vf_err = float(np.abs(np.array([p.objv for p in vp])
                              - [p.objv for p in vf]).max())
        if ll.mesh.shape != {"dp": 1, "fs": 4} or not l_err < 1e-5 \
                or not v_err < 2e-4 or not lf_err < 1e-5 \
                or not vf_err < 2e-4:
            raise AssertionError(f"(e) L-BFGS mesh_fs=4: golden {l_err} / "
                                 f"{v_err}, vs flat {lf_err} / {vf_err}")
        log(f"  (e) BCD mesh_dp=4 (examples/bcd.conf): objv {b_objv:.6f}, "
            f"nnz {b_nnz}, each epoch within {b_err:.3g} relative of the "
            f"flat run; L-BFGS mesh_fs=4: linear within {l_err:.3g} of the "
            f"golden ({lf_err:.3g} of flat), FM with V within {v_err:.3g} "
            f"({vf_err:.3g} of flat)")

        # (f) capacity scaling over fs 1, 2, 4 at the conf's geometry: the
        # fs=4 leg is the conf's own table (hash_capacity rows at its
        # V_dim), each step a batch_size batch of 39-feature Criteo rows
        rep = capacity_scaling_report(
            fs_values=[1, 2, 4], base_capacity=C // 4, V_dim=k,
            batch=int(dict(mesh_conf)["batch_size"]), nnz_per_row=39,
            steps=50, device=DEV)
        if rep["legs"][-1]["hash_capacity"] != C:
            raise AssertionError(f"(f) the fs=4 leg is not the conf's "
                                 f"table: {rep['legs'][-1]}")
        if any(x["table_bytes_per_device"]
               != x["table_bytes_total"] // x["fs"] for x in rep["legs"]):
            raise AssertionError(f"(f) bytes per device are not total // "
                                 f"fs: {rep['legs']}")
        log(f"  (f) capacity_scaling_report ({smi}; V_dim {k}, "
            f"{rep['config']['batch']} x {rep['config']['nnz_per_row']} "
            f"nonzeros, {rep['config']['steps']} timed steps; each shard "
            "its own allocation, all on the one card): " + "; ".join(
            f"fs {x['fs']}: {x['hash_capacity']} rows, "
            f"{x['table_bytes_per_shard']} B/shard, "
            f"{x['table_bytes_per_device']} B per logical device "
            "(total // fs, from the allocations), "
            f"{x['examples_per_sec']:.0f} ex/s, {x['step_ms']} ms/step"
            for x in rep["legs"])
            + f"; capacity x{rep['capacity_scaling']}, throughput retained "
            f"{rep['throughput_retention']}")
        out["capacity"] = rep
    dt = time.monotonic() - t19
    log(f"phase 19 ok in {dt:.1f} s: the examples' 2 x 4 mesh on the card "
        "(DIFACTO_TORCH_VIRTUAL_DEVICES=8), every shard through the CUDA "
        "kernels")
    out["seconds"] = dt
    return out



# ------------------------------------------------------------- phase 20
MH_DEVICES = 4              # logical devices per rank: 2 ranks x 4 = 2 x 4


def _plain_counting() -> None:
    """A rehearsal off the card: the three ``fused`` dispatchers take
    their plain versions and bump the kernels' launch counters."""
    from difacto_tpu_torch.ops import fused

    def counting(ref, counter):
        def run(*a, **k):
            counter.launches += 1
            return ref(*a, **k)
        return run

    fused.gather_rows = counting(fused.gather_rows_ref,
                                 fused.gather_rows_cuda)
    fused.scatter_rows = counting(fused.scatter_rows_ref,
                                  fused.scatter_rows_cuda)

    def fm_update(table, slots, rows, gw, gV, vmask, epi, epilogue=None):
        fused.fm_update_rows_cuda.launches += 1
        return fused.fm_update_rows_ref(table, slots, rows, gw, gV, vmask,
                                        epilogue)

    fused.fm_update_rows = fm_update


def _rank_checks(ln, staged) -> dict:
    """Phase 20: this rank's kernels against their plain versions at its
    own staged slot vectors and its own table (no collective: the
    gradient is this rank's blocks' alone): the routed gather bit for bit,
    and the routed push on one copy of the table beside the plain push on
    another."""
    import dataclasses

    import torch
    from difacto_tpu_torch.losses import FMParams
    from difacto_tpu_torch.ops.batch import unpack_panel
    from difacto_tpu_torch.parallel import sharded
    from difacto_tpu_torch.updaters.sgd_updater import (epilogue_spec,
                                                        row_epilogue)
    store = ln.store
    loss = dataclasses.replace(ln.loss, plane=None)
    C = store.state.capacity
    epi = epilogue_spec(store.param, C)
    plain = functools.partial(row_epilogue, store.param, C)

    def tables():
        return [s.VVg for s in store.state.shards]

    def copies():
        return [t.clone() for t in tables()]
    g_err = p_err = 0.0
    for st in staged:
        batch, slots, _ = unpack_panel(st.i32, st.f32, st.b_cap, st.d2,
                                       st.u_cap, binary=st.binary)
        ci, cl, cv = st.chunks
        batch = batch._replace(chunk_idx=ci, chunk_lane=cl, chunk_vals=cv)
        ss = sharded.ShardedSlots(slots, st.route[1], st.route[0])
        shards = tables()
        got = sharded.sharded_gather(shards, ss)
        ref = sharded.sharded_gather_ref(shards, ss)
        if not _bits_same(got, ref):
            raise AssertionError("phase 20: the routed gather differs from "
                                 "its plain version")
        rows = store.fns.pull_rows(store.state, ss)
        w, V, vm = store.fns.rows_to_params(store.state, rows)
        pred, xv = loss.predict_xv(FMParams(w=w, V=V, v_mask=vm), batch)
        gw, gV = loss.calc_grad(FMParams(w=w, V=V, v_mask=vm), batch, pred,
                                xv)
        a, b = copies(), copies()
        sharded.sharded_push(a, ss, rows, gw.contiguous(),
                             gV.contiguous(), vm, epi, plain)
        sharded.sharded_push_ref(b, ss, rows, gw.contiguous(),
                                 gV.contiguous(), vm, plain)
        sync()
        a, b = (torch.cat([t.cpu() for t in x]) for x in (a, b))
        if not _bits_same(a, b):
            p_err = max(p_err, float((a - b).abs().max()))
            raise AssertionError(f"phase 20: the routed push differs from "
                                 f"its plain version by {p_err}")
        g_err = max(g_err, float((got - ref).abs().max()))
        del a, b
        torch.cuda.empty_cache() if DEV == "cuda" else None
    return {"gather_err": g_err, "push_err": p_err, "batches": len(staged)}


def _host_steps(fn, items, what: str) -> dict:
    """profile_steps' stand-in in a rehearsal off the card: host time."""
    for it in items:
        fn(it)
    t0 = time.perf_counter()
    for it in items:
        fn(it)
    wall = (time.perf_counter() - t0) * 1e3 / len(items)
    return {"wall_ms": wall, "busy_ms": wall, "kernels": 0.0}


def rank_cli(spec_path: str) -> int:
    """Phase 20's rank under launch.py: the port's CLI entry point
    (``difacto_tpu_torch.__main__.main``, what ``python -m
    difacto_tpu_torch`` runs) with the spec's arguments, its kernel
    launches tallied against the shard runs its routing asked for; then
    this rank's evidence into ``<out>-<rank>.json``: per-epoch losses,
    launches, the control and data planes' traffic, the table's digest,
    and on request a replayed step's profile, the kernels against their
    plain versions and the card's memory with both replicas alive."""
    import hashlib

    import torch
    from difacto_tpu_torch import __main__ as cli
    from difacto_tpu_torch.learners import base, sgd
    from difacto_tpu_torch.obs import REGISTRY
    from difacto_tpu_torch.parallel import multihost
    with open(spec_path) as f:
        spec = json.load(f)
    global DEV, profile_steps
    DEV = spec["dev"]
    if DEV == "cpu":        # a rehearsal: plain kernels, host-timed steps
        _plain_counting()
        profile_steps = _host_steps
    rank = int(os.environ["DIFACTO_RANK"])
    nprocs = int(os.environ["DIFACTO_NPROCS"])
    attempt = int(os.environ.get("DIFACTO_RESTART", "0"))
    seen: dict = {"loss": []}
    real_create = base.Learner.create

    def create(name, device="cuda"):
        ln = real_create(name, device)
        seen["ln"] = ln
        if isinstance(ln, sgd.SGDLearner):
            ln.add_epoch_end_callback(lambda e, t, v: seen["loss"].append(
                [e, t.loss / max(t.nrows, 1), v.loss / max(v.nrows, 1)]))
        else:
            ln.add_epoch_end_callback(
                lambda e, p: seen["loss"].append([e, p.objv]))
        return ln

    base.Learner.create = staticmethod(create)
    ctrl = {"calls": 0, "bytes": 0}
    real_ctrl = sgd.control_allgather_np

    def ctrl_fn(arr):
        ctrl["calls"] += 1
        ctrl["bytes"] += int(np.asarray(arr).nbytes)
        return real_ctrl(arr)

    sgd.control_allgather_np = ctrl_fn
    if spec.get("kill_at") and rank == 1 and attempt == 0:
        real_gather, n = multihost.DataPlane.gather, [0]

        def dying(self, t):
            n[0] += 1
            if n[0] == spec["kill_at"]:
                print(f"rank 1: SIGKILL at data-plane gather {n[0]}",
                      flush=True)
                with open(spec["out"] + "-killed", "w") as f:
                    # the kill's time on the host's monotonic clock, the
                    # clock of the relaunched rank's t_start
                    f.write(repr(time.monotonic()))
                os.kill(os.getpid(), signal.SIGKILL)
            return real_gather(self, t)

        multihost.DataPlane.gather = dying
    argv = list(spec["argv"])
    if spec.get("dp_per_rank"):
        argv.append(f"mesh_dp={nprocs * spec['dp_per_rank']}")
    _reset_counts()
    tally, restore = _routed_runs()
    t_start = time.monotonic()
    try:
        rc = cli.main(argv)
    finally:
        restore()
    wall = time.monotonic() - t_start
    launches = _counts()
    ln = seen["ln"]
    out = {"rank": rank, "nprocs": nprocs, "attempt": attempt, "rc": rc,
           "wall": wall, "t_start": t_start, "loss": seen["loss"],
           "launches": launches,
           "tally": tally if isinstance(ln, sgd.SGDLearner) else None,
           "ctrl": ctrl}
    if isinstance(ln, sgd.SGDLearner):
        plane = ln.loss.plane
        out.update(
            tau=ln._tau, steps=ctrl["calls"],
            plane={"calls": plane.calls, "bytes_out": plane.bytes_out,
                   "seconds": plane.seconds} if plane is not None else None,
            staleness=REGISTRY.histogram("push_delay_batches").data(),
            backend=multihost.BACKEND)
        if spec.get("digest"):
            out["digest"] = hashlib.sha256(
                _host_table(ln.store.state).numpy()).hexdigest()
        if spec.get("scan"):
            # phase 21 (d): the collective scan of this rank's run
            from difacto_tpu_torch.utils import collscan, devtrace
            collscan.dump(f"{spec['out']}-{rank}-scan.json")
            # and its traced programs, copies and syncs, for phase 22
            devtrace.dump(f"{spec['out']}-{rank}-trace.json")
            out["train_site"] = ln._train_step.site
            out["train_calls"] = devtrace.sites()[
                ln._train_step.site]["calls"]
        if spec.get("profile"):
            from difacto_tpu_torch.learners.sgd import K_TRAINING
            staged = [st for items in
                      ln._caches[K_TRAINING].entries.values()
                      for st in items if st.chunks is not None][:5]

            def replayed(st):
                pending = []
                ln._dispatch_staged(K_TRAINING, st, False, pending)
                return pending[-1][1]

            step = profile_steps(replayed, staged, f"  rank {rank} replayed")
            # one more pass on the host clock, the data plane's share of it
            sync()
            s0, c0, g0 = plane.seconds, plane.calls, plane.collective_s
            t1 = time.perf_counter()
            for st in staged:
                replayed(st)
            sync()
            n = len(staged)
            step["host_ms"] = (time.perf_counter() - t1) * 1e3 / n
            step["gather_ms"] = (plane.seconds - s0) * 1e3 / n
            step["collective_ms"] = (plane.collective_s - g0) * 1e3 / n
            step["gathers"] = (plane.calls - c0) / n
            out["step"] = step
            out["checks"] = _rank_checks(ln, staged)
            torch.distributed.barrier()
            if rank == 0 and DEV == "cuda":
                out["memory_used"] = subprocess.run(
                    ["nvidia-smi", "--query-gpu=memory.used",
                     "--format=csv,noheader"], capture_output=True,
                    text=True).stdout.strip()
            torch.distributed.barrier()
    with open(f"{spec['out']}-{rank}.json", "w") as f:
        json.dump(out, f)
    return rc


def _launch_ranks(work: str, name: str, argv: list, launch_extra=(),
                  timeout: float = 600.0, env_extra=None, **spec) -> tuple:
    """Phase 20: ``launch.py -n 2 [launch_extra] -- python -c <rank_cli>``
    from the repo root with ``MH_DEVICES`` logical devices per rank (and
    ``env_extra`` in their environment); the ranks' evidence (of the last
    attempt) and the launcher's stderr."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(work, "mh_" + name)
    spec.update(argv=argv, out=out, dev=DEV)
    spec_path = out + ".spec.json"
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    env["DIFACTO_TORCH_VIRTUAL_DEVICES"] = str(MH_DEVICES)
    env["PYTHONPATH"] = root
    env.update(env_extra or {})
    cmd = [sys.executable, os.path.join(root, "launch.py"), "-n", "2",
           "--port", str(_free_port()), *launch_extra, "--",
           sys.executable, "-c",
           f"import sys, chip_smoke; sys.exit(chip_smoke.rank_cli("
           f"{spec_path!r}))"]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 20 {name}: launch.py exited "
                             f"{proc.returncode}\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    ranks = []
    for r in range(2):
        path = f"{out}-{r}.json"
        if os.path.exists(path):
            with open(path) as f:
                ranks.append(json.load(f))
    return ranks, proc.stderr, wall


def _same_parts(a: str, b: str) -> int:
    """The arrays of two checkpoints (a stub and its ``_fs-*`` members)
    equal, by their manifests' sha256 digests; the files compared."""
    from difacto_tpu_torch.utils import stream
    n = 0
    for pa in sorted(stream.glob(a + "*.manifest.json")):
        pb = b + pa[len(a):]
        with open(pa) as f, open(pb) as g:
            ma, mb = json.load(f)["arrays"], json.load(g)["arrays"]
        if ma != mb:
            raise AssertionError(f"phase 20: {pa} and {pb} differ")
        n += 1
    if n == 0:
        raise AssertionError(f"phase 20: no checkpoint at {a}")
    return n


def phase_multihost(work: str, tr: dict, t19: dict, smi: str) -> dict:
    """Phase 20: multi-host training under launch.py, two ranks on the one
    card (gloo for both planes), each with ``MH_DEVICES`` logical devices,
    so the conf's 2 x 4 mesh has dp across the ranks and fs = 4 inside
    each. (a') parity: the conf unshuffled in one part, each rank 25,000
    rows (rank 1's a permutation of rank 0's), each epoch's loss per row
    within 2e-4 relative of one process over the same global batches. (a)
    examples/criteo_hashed.conf as written on phase 7's rows, 2 epochs,
    checkpoints every epoch: the ranks' losses and their final and
    ``_iter-k`` parts equal bit for bit, the loss falls (printed beside
    phase 19's, whose steps are half the rows), each rank's launches
    equal to its routed shard runs; a replayed step profiled on
    both ranks beside phase 19's; the kernels against their plain versions
    on each rank; a repeat run gives (a)'s table bit for bit. (b)
    ``--bounded-delay 4``: (a)'s table bit for bit, the window's
    delay histogram non-zero. (c) ``--max-restarts 1`` with heartbeats:
    rank 1 SIGKILLed mid-epoch 1; one rank relaunches, resumes from
    ``_iter-0`` and finishes; the seconds to recover. (d) BCD and L-BFGS
    under ``launch.py -n 2`` on rcv1 at the goldens. (e)
    ``bounded_delay_report`` at the conf's geometry."""
    from difacto_tpu_torch.config import parse_config_file
    root = os.path.dirname(os.path.abspath(__file__))
    t20 = time.monotonic()
    out = {"launches": dict.fromkeys(COUNTERS, 0)}
    base = [CONF, f"data_in={tr['data_in']}", f"data_val={tr['data_val']}",
            "max_num_epochs=2", "stop_rel_objv=0", "stop_val_auc=-2",
            f"device={DEV}"]
    if DEV == "cpu":
        base.append("hash_capacity=8192")

    def agree(ranks, what):
        if len(ranks) != 2 or any(r["rc"] != 0 for r in ranks):
            raise AssertionError(f"phase 20 {what}: ranks {ranks}")
        if ranks[0]["loss"] != ranks[1]["loss"]:
            raise AssertionError(f"phase 20 {what}: the ranks' losses "
                                 f"differ: {ranks}")
        for r in ranks:
            if r["tally"] is not None and (
                    _table_part(r["launches"]) != r["tally"]
                    or not all(_table_part(r["launches"]).values())):
                raise AssertionError(
                    f"phase 20 {what}: rank {r['rank']} launches "
                    f"{r['launches']}, routed {r['tally']}")

    # (a') parity with one process over the same global batches: under
    # launch.py each rank reads batch_size rows of its own byte range, so
    # a step's batch is 2 x batch_size rows from two places of the file,
    # and phase 19's run (1,000-row steps, shuffled in 10 parts) is not
    # the same SGD. Here rank 0's half is 25,000 of phase 7's rows and
    # rank 1's the same rows permuted (equal bytes, so the byte split
    # falls between them); the one process reads the two halves' batches
    # interleaved at twice the batch size, unshuffled, in one part.
    with open(tr["data_in"], "rb") as f:
        rows = f.read().splitlines(keepends=True)
    bsz = int(dict(parse_config_file(CONF))["batch_size"])
    half = rows[:len(rows) // 2 // bsz * bsz]
    perm = [half[i] for i in np.random.RandomState(SEED).permutation(
        len(half))]
    par_in = os.path.join(work, "mh_parity.txt")
    ref_in = os.path.join(work, "mh_parity_ref.txt")
    with open(par_in, "wb") as f:
        f.write(b"".join(half + perm))
    with open(ref_in, "wb") as f:
        f.write(b"".join(b"".join(half[i:i + bsz] + perm[i:i + bsz])
                         for i in range(0, len(half), bsz)))
    keys = ["shuffle=0", "num_jobs_per_epoch=1", "max_num_epochs=2",
            "stop_rel_objv=0", "stop_val_auc=-2", f"device={DEV}"]
    if DEV == "cpu":
        keys.append("hash_capacity=8192")
    pa, _, pa_wall = _launch_ranks(
        work, "parity", [CONF, f"data_in={par_in}",
                         f"data_val={tr['data_val']}"] + keys)
    agree(pa, "(a')")
    with _virtual_devices():
        ref = _mesh_runs(parse_config_file(CONF) + [
            tuple(x.split("=", 1)) for x in keys if x != f"device={DEV}"]
            + [("data_in", ref_in), ("data_val", tr["data_val"]),
               ("batch_size", str(2 * bsz))], "(a') one process")
    p_loss = [x[1] for x in pa[0]["loss"]]
    p_err = _rel_err(p_loss, ref["loss"])
    if not (len(p_loss) == 2 and p_err <= 2e-4):
        raise AssertionError(f"(a') loss/row {p_loss}, one process "
                             f"{ref['loss']} (relative {p_err})")
    log(f"  (a') parity: 2 ranks x {len(half)} rows (rank 1's permuted), "
        f"unshuffled, one part, against one process (2 x 4 mesh, "
        f"DIFACTO_TORCH_VIRTUAL_DEVICES=8) over the same global batches "
        f"interleaved at batch_size {2 * bsz}: loss/row {p_loss} vs "
        f"{ref['loss']}, within {p_err:.3g} relative (bound 2e-4); "
        f"{pa_wall:.1f} s of launch.py")
    del ref
    gc.collect()

    # (a) the conf as written
    model = os.path.join(work, "mh_model")
    a, _, a_wall = _launch_ranks(
        work, "a", base + [f"model_out={model}", "has_aux=1",
                           "ckpt_interval=1"], digest=True, profile=True)
    agree(a, "(a)")
    for r in a:
        for c in COUNTERS:
            out["launches"][c] += r["launches"][c]
    loss = [x[1] for x in a[0]["loss"]]
    err = _rel_err(loss, t19["loss"])
    if not (len(loss) == 2 and loss[1] < loss[0]):
        raise AssertionError(f"(a) loss/row {loss}")
    if a[0]["digest"] != a[1]["digest"]:
        raise AssertionError("(a) the ranks' tables differ")
    files = sum(_same_parts(model + suf + "_part-0", model + suf + "_part-1")
                for suf in ("", "_iter-0", "_iter-1"))
    plane, steps = a[0]["plane"], a[0]["steps"]
    log(f"  (a) {CONF} as written, 2 ranks x {MH_DEVICES} logical devices "
        f"on the one card ({smi}), data plane {a[0]['backend']}: loss/row "
        f"{loss[0]:.8f} -> {loss[1]:.8f} on both ranks ({err:.3g} relative "
        f"from phase 19's single-process run, whose steps are half the "
        f"rows; (a') is the parity check); final and "
        f"_iter-0/1 parts of both ranks equal ({files} manifests); "
        f"launches per rank {a[0]['launches']} and {a[1]['launches']} = "
        f"the shard runs routed; {a_wall:.1f} s of launch.py")
    log(f"  (a) per rank: {a[0]['ctrl']['calls']} control exchanges, "
        f"{a[0]['ctrl']['bytes'] / max(a[0]['ctrl']['calls'], 1):.0f} B "
        f"each sent to the store; {plane['calls']} data-plane gathers, "
        f"{plane['bytes_out'] / max(plane['calls'], 1):.0f} B each sent, "
        f"{plane['seconds']:.2f} s in them ({smi})")
    for r in a:
        st = r["step"]
        log(f"  (a) rank {r['rank']} replayed step: wall {st['wall_ms']:.3f}"
            f" ms, busy {st['busy_ms']:.3f} ms, idle "
            f"{1 - st['busy_ms'] / st['wall_ms']:.1%}; phase 19's "
            f"single-process step: wall {t19['step']['wall_ms']:.3f} ms, "
            f"busy {t19['step']['busy_ms']:.3f} ms; a pass without the "
            f"profiler: {st['host_ms']:.3f} ms a step, its "
            f"{st['gathers']:.0f} gathers {st['gather_ms']:.3f} ms "
            f"({st['gather_ms'] / st['host_ms']:.1%}), "
            f"{st['collective_ms']:.3f} ms of them inside gloo, the rest "
            f"the copy out (waiting for the step's kernels) and back "
            f"({smi})")
        ck = r["checks"]
        log(f"  (a) rank {r['rank']}: routed gather and push against their "
            f"plain versions at {ck['batches']} staged slot vectors: max "
            f"abs err {ck['gather_err']} / {ck['push_err']}")
    if DEV == "cuda":
        log(f"  (a) memory.used with both replicas alive: "
            f"{a[0]['memory_used']} ({smi})")
    out["a"] = {"loss": loss, "step": [r["step"] for r in a],
                "plane": plane, "ctrl": a[0]["ctrl"], "wall": a_wall}
    again, _, _ = _launch_ranks(work, "a2", base, digest=True)
    agree(again, "(a) repeat")
    if again[0]["digest"] != a[0]["digest"]:
        raise AssertionError("(a) a repeat run left another table")
    log("  (a) repeat run: the table bit for bit")

    # (b) bounded delay: the deeper window only (phase 19 (h) pays for it)
    for tau in (4,):
        b, _, b_wall = _launch_ranks(
            work, f"b{tau}", base, ["--bounded-delay", str(tau)],
            digest=True)
        agree(b, f"(b) tau {tau}")
        hist = b[0]["staleness"]
        if b[0]["tau"] != tau or b[0]["digest"] != a[0]["digest"] \
                or not hist.get("count") or not hist.get("sum"):
            raise AssertionError(f"(b) tau {tau}: {b[0]}")
        log(f"  (b) --bounded-delay {tau}: (a)'s table bit for bit; "
            f"push_delay_batches {hist['count']} steps, mean "
            f"{hist['sum'] / hist['count']:.2f} batches ahead; "
            f"{b_wall:.1f} s of launch.py")

    # (c) kill one host mid-epoch 1, relaunch, resume: (a)'s run made
    # half its data-plane gathers in each epoch, so three quarters of them
    # falls in epoch 1's training
    kill_at = int(plane["calls"] * 0.75)
    cmodel = os.path.join(work, "mh_kill")
    c, err_text, c_wall = _launch_ranks(
        work, "c", base + [f"model_out={cmodel}", "ckpt_interval=1",
                           "auto_resume=1"],
        ["--max-restarts", "1", "--hb-port", str(_free_port()),
         "--hb-timeout", "2"], kill_at=kill_at, dp_per_rank=1)
    failed = re.search(r"attempt 0 failed \(rc=(-?\d+)\)", err_text)
    if not failed or len(c) != 1 or c[0]["attempt"] != 1 \
            or c[0]["nprocs"] != 1 or [x[0] for x in c[0]["loss"]] != [1]:
        raise AssertionError(f"(c) {c}\n{err_text[-3000:]}")
    with open(os.path.join(work, "mh_c-killed")) as f:
        t_kill = float(f.read())
    to_start = c[0]["t_start"] - t_kill
    to_end = to_start + c[0]["wall"]
    log(f"  (c) --max-restarts 1: rank 1 SIGKILLed at its data-plane gather "
        f"{kill_at} of {plane['calls']} (epoch 1); launch.py saw attempt 0 "
        f"fail with rc={failed.group(1)} and relaunched one rank, which "
        f"resumed from _iter-0 and finished epoch 1 (loss/row "
        f"{c[0]['loss'][0][1]:.8f}): {to_start:.1f} s from the kill to the "
        f"relaunched rank's entry point, {to_end:.1f} s to the end of its "
        f"run (the resume load and epoch 1 on one rank); all of launch.py "
        f"{c_wall:.1f} s")
    out["c"] = {"wall": c_wall, "to_start_s": to_start, "to_end_s": to_end}

    # (d) the batch learners
    rcv1 = os.path.join(root, "tests", "data", "rcv1_100.libsvm")
    for name, args, golden in (
            ("bcd", ["l1=.1", "lr=.05", "block_ratio=0.001",
                     "tail_feature_filter=0", "max_num_epochs=10"],
             OBJV_DIAG_NEWTON),
            ("lbfgs", ["m=5", "V_dim=0", "l2=0", "init_alpha=1",
                       "tail_feature_filter=0", "max_num_epochs=19"],
             OBJV_BASIC)):
        d, _, d_wall = _launch_ranks(
            work, "d_" + name, [f"learner={name}", f"data_in={rcv1}",
                                f"device={DEV}"] + args)
        agree(d, f"(d) {name}")
        objv = [x[1] for x in d[0]["loss"]]
        gap = float(np.max(np.abs(np.array(objv) - golden)
                           / np.maximum(np.abs(golden), 1.0)))
        if len(objv) != len(golden) or not gap <= 1e-4:
            raise AssertionError(f"(d) {name}: {objv} vs {golden}")
        log(f"  (d) {name} on 2 ranks: the golden within {gap:.3g}, both "
            f"ranks equal; {d_wall:.1f} s")

    # (e) the bounded-delay report at the conf's geometry
    from difacto_tpu_torch.parallel.capacity import bounded_delay_report
    conf = dict(parse_config_file(CONF))
    C = int(conf["hash_capacity"]) if DEV == "cuda" else 8192
    with _virtual_devices():
        rep = bounded_delay_report(
            fs=4, base_capacity=C // 4, V_dim=int(conf["V_dim"]),
            batch=int(conf["batch_size"]), nnz_per_row=39, steps=40,
            device=DEV)
    if [x["auc_delta"] for x in rep["auc"]] != [0.0] * len(rep["auc"]):
        raise AssertionError(f"(e) the windowed AUC moved: {rep['auc']}")
    log(f"  (e) bounded_delay_report (fs 4, {C // 4} rows a shard, V_dim "
        f"{conf['V_dim']}, {conf['batch_size']} x 39 nonzeros a step; "
        f"{smi}): base step {rep['base_step_ms']} ms; " + "; ".join(
            f"hosts {x['hosts']} tau {x['tau']}: {x['examples_per_sec']:.0f}"
            f" ex/s" for x in rep["legs"])
        + f"; retention by tau {rep['retention_by_tau']}; AUC "
        f"{[x['auc'] for x in rep['auc']]} at tau "
        f"{[x['tau'] for x in rep['auc']]}")
    out["report"] = rep
    dt = time.monotonic() - t20
    log(f"phase 20 ok in {dt:.1f} s: multi-host training under launch.py, "
        "two ranks on the one card, every step's sums gathered in order")
    out["seconds"] = dt
    return out

# ------------------------------------------------------------- phase 21
P21_DEVICE_ROWS = 5_000     # (c): 5 steps an epoch, epoch 1 replayed
P21_SPANS = ("epoch", "consumer.dispatch")
P21_KERNELS = ("gather_rows_kernel", "scatter_kernel")
# every knob the port reads for its tracers: a child of phase 21 starts
# with none but its own
P21_KNOBS = ("DIFACTO_JAXTRACE", "DIFACTO_JAXTRACE_OUT", "DIFACTO_HLOSCAN",
             "DIFACTO_HLOSCAN_ROWS", "DIFACTO_HLOSCAN_BUDGET",
             "DIFACTO_HLOSCAN_OUT", "DIFACTO_TRACE", "DIFACTO_TRACE_DEVICE",
             "DIFACTO_LOCKTRACE", "DIFACTO_RACETRACE")


def _fetch_points(fetches: dict) -> dict:
    out: dict = {}
    for rec in fetches.values():
        out[rec["point"]] = out.get(rec["point"], 0) + rec["count"]
    return out


def _p21_serve(spec: dict) -> dict:
    """Phase 21 (a), in the traced child: phase 3's pred of 20,000 rows,
    then phase 4's server over the same store answering three windows
    that straddle the pred windows (the warm-up, dumped), and the same
    windows twice more (dumped again)."""
    import torch
    from difacto_tpu_torch.__main__ import run_pred
    from difacto_tpu_torch.ops import fused
    from difacto_tpu_torch.serve import ServeServer, open_serving_store
    from difacto_tpu_torch.tools import devmap
    from difacto_tpu_torch.utils import devtrace
    store, _, _ = open_serving_store(spec["model"], device=DEV)
    devtrace.reset()
    _reset_counts()
    t0 = time.perf_counter()
    run_pred([tuple(x) for x in spec["pred_kwargs"]], device=DEV,
             store=store)
    sync()
    pred_s = time.perf_counter() - t0
    n_pred = _fetch_points(devtrace.fetches()).get("serve.scores", 0)
    batch = spec["batch"]
    with open(spec["data"], "rb") as f:
        rows = f.read().splitlines()
    with open(spec["pred_out"] + "_part-0", "rb") as f:
        col = [ln.split(b"\t")[1] for ln in f.read().splitlines()]
    los = [batch // 2 + i * batch for i in range(3)]
    warm, final = spec["out"] + "-serve-warm.json", \
        spec["out"] + "-serve.json"
    srv = ServeServer(store, batch_size=batch, max_delay_ms=2000.0,
                      queue_cap=4 * batch, data_format="criteo").start()
    wrong = 0
    try:
        with socket.create_connection((srv.host, srv.port), timeout=120) \
                as c:
            f = c.makefile("rb")
            for rnd in range(3):
                for lo in los:
                    win = rows[lo:lo + batch]
                    c.sendall(b"".join(r + b"\n" for r in win))
                    got = [f.readline().rstrip(b"\n") for _ in win]
                    wrong += sum(g != w for g, w in
                                 zip(got, col[lo:lo + batch]))
                if rnd == 0:
                    devtrace.dump(warm)
        dispatches = srv.executor.stats()["dispatches"]
    finally:
        srv.close()
    sync()
    devtrace.dump(final)
    d_final, d_warm = devtrace.load(final), devtrace.load(warm)
    graph = devmap.build(os.path.dirname(os.path.abspath(__file__)),
                         d_final, d_warm)
    kernels = {r["label"]: r["launches"] for r in d_final["sites"].values()
               if r["kind"] == "kernel"}
    progs = {r["label"]: [r["calls"], r["compiles"]]
             for r in d_final["sites"].values()
             if r["kind"] == "program" and r["calls"]}
    del store
    torch.cuda.empty_cache() if DEV == "cuda" else None
    return {"pred_windows": n_pred, "pred_s": pred_s,
            "dispatches": dispatches, "wrong": wrong,
            "points": _fetch_points(d_final["fetches"]),
            "puts": _fetch_points(d_final["puts"]),
            "syncs": d_final["syncs"],
            "declared_syncs": d_final["declared_syncs"],
            "failures": devmap.failures(graph), "kernels": kernels,
            "counters": _counts(), "programs": progs,
            "warm_programs": {r["label"]: [r["calls"], r["compiles"]]
                              for r in d_warm["sites"].values()
                              if r["kind"] == "program" and r["calls"]}}


def _p21_train(spec: dict) -> dict:
    """Phase 21 (b): phase 7's 2-epoch train (epoch 1 replays), dumped
    after epoch 0 and at the end when tracing is on; the launches, epoch
    walls, losses and the table's digest either way."""
    import hashlib

    from difacto_tpu_torch.tools import devmap
    from difacto_tpu_torch.utils import devtrace
    devtrace.reset()
    _reset_counts()
    traced = devtrace.enabled()
    warm, final = spec["out"] + "-train-warm.json", \
        spec["out"] + "-train.json"

    def epoch_end(k):
        if traced and k == 0:
            devtrace.dump(warm)

    ln, progress, walls, _ = _train([tuple(x) for x in spec["kwargs"]],
                                    epoch_end=epoch_end)
    out = {"launches": _counts(), "walls": walls,
           "loss": [t.loss / max(t.nrows, 1) for t, _ in progress]}
    if traced:
        devtrace.dump(final)
        d_final, d_warm = devtrace.load(final), devtrace.load(warm)
        graph = devmap.build(os.path.dirname(os.path.abspath(__file__)),
                             d_final, d_warm)
        out.update(
            steps=d_final["sites"][ln._train_step.site]["calls"],
            syncs=d_final["syncs"],
            declared_syncs=d_final["declared_syncs"],
            new_signatures=graph["new_signatures"],
            failures=graph["unknown_sites"] + graph["unknown_fetches"],
            points=_fetch_points(d_final["fetches"]),
            puts=_fetch_points(d_final["puts"]),
            kernels={r["label"]: r["launches"]
                     for r in d_final["sites"].values()
                     if r["kind"] == "kernel"},
            programs={r["label"]: [r["calls"], r["compiles"]]
                      for r in d_final["sites"].values()
                      if r["kind"] == "program" and r["calls"]})
    # after the dump: the digest's copy is the smoke's, not the run's
    out["digest"] = hashlib.sha256(_host_table(ln.store.state).numpy()
                                   ).hexdigest()
    return out


def tooling_child(spec_path: str) -> int:
    """Phase 21's child interpreter (``python -c 'import chip_smoke;
    chip_smoke.tooling_child(SPEC)'``), its knobs set by the parent:
    ``traced`` runs (a) and (b) under DIFACTO_JAXTRACE=1, ``untraced``
    (b) with every knob off, ``device`` a few replayed steps under
    DIFACTO_TRACE and DIFACTO_TRACE_DEVICE (c). Writes its evidence to
    ``<out>.json``."""
    from difacto_tpu_torch.utils import devtrace
    with open(spec_path) as f:
        spec = json.load(f)
    global DEV
    DEV = spec["dev"]
    if DEV == "cpu":        # a rehearsal: plain kernels, counted
        _plain_counting()
    out = {"mode": spec["mode"], "enabled": devtrace.enabled()}
    if spec["mode"] == "traced":
        out["a"] = _p21_serve(spec)
    if spec["mode"] in ("traced", "untraced"):
        out["b"] = _p21_train(spec)
    if spec["mode"] == "device":
        _reset_counts()
        _, _, walls, _ = _train([tuple(x) for x in spec["kwargs"]])
        out.update(launches=_counts(), walls=walls)
    # the detector turns on with the first wrapper the port makes
    out["sync_debug"] = devtrace.sync_debug_on()
    with open(spec["out"] + ".json", "w") as f:
        json.dump(out, f)
    return 0


def _tooling_child(work: str, mode: str, knobs: dict, **spec) -> dict:
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(work, f"p21_{mode}")
    spec.update(mode=mode, out=out, dev=DEV)
    with open(out + ".spec.json", "w") as f:
        json.dump(spec, f)
    env = {k: v for k, v in os.environ.items() if k not in P21_KNOBS}
    env.update(knobs, PYTHONPATH=root)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit("
         f"chip_smoke.tooling_child({out + '.spec.json'!r}))"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"phase 21 {mode}: the child exited "
                             f"{proc.returncode}\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    with open(out + ".json") as f:
        got = json.load(f)
    got["wall"] = time.monotonic() - t0
    return got


def _kernels_in_spans(events: list) -> dict:
    """Per kernel of ``P21_KERNELS``: (events, events inside a span's
    range). A kernel is inside when a GPU-side range of a span's name
    (``gpu_user_annotation``) holds it, or when its launch (the runtime
    call of the same correlation id) lies in a CPU range of a span's
    name on the launching thread."""
    def span(name: str) -> bool:
        return name in P21_SPANS or name.startswith("ProfilerStep#")

    gpu = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
           if e.get("cat") == "gpu_user_annotation" and span(e["name"])]
    cpu: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and span(e["name"]):
            cpu.setdefault((e.get("pid"), e.get("tid")), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
    launch = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == "cuda_runtime" and corr is not None:
            launch[corr] = (e.get("pid"), e.get("tid"), e["ts"])
    out = {}
    for name in P21_KERNELS:
        ks = [e for e in events
              if e.get("cat") == "kernel" and name in e.get("name", "")]
        inside = 0
        for k in ks:
            lo, hi = k["ts"], k["ts"] + k.get("dur", 0)
            ok = any(a <= lo and hi <= b for a, b in gpu)
            corr = (k.get("args") or {}).get("correlation")
            if not ok and corr in launch:
                pid, tid, t = launch[corr]
                ok = any(a <= t <= b for a, b in cpu.get((pid, tid), []))
            inside += ok
        out[name] = (len(ks), inside)
    return out


def phase_tooling(work: str, conf: list, tr: dict, batch: int,
                  smi: str) -> dict:
    """Phase 21: the port's tracers on the card at full width.

    (a) phase 3's pred and phase 4's server, traced
    (``DIFACTO_JAXTRACE=1``, in a child): signatures frozen after the
    warm windows, no undeclared sync under a serve dispatch,
    ``serve.scores`` once per window, each kernel site's launches equal
    to ``gather_rows_cuda.launches``. (b) phase 7's replayed 2-epoch
    train traced and untraced, each in a child: no signature new in epoch
    1, the two tables bit for bit, the untraced run's launches phase 7's;
    the epoch walls of both and every undeclared sync of the train step
    per step. (c) ``DIFACTO_TRACE`` + ``DIFACTO_TRACE_DEVICE`` over a few
    replayed steps: the exported Chrome trace holds both kernels, each
    inside a range named after a span. (d) ``DIFACTO_HLOSCAN=1`` with
    ``DIFACTO_HLOSCAN_ROWS`` at the table's rows over phase 20 (a)'s
    ``launch.py -n 2`` for 1 epoch: no table-axis collective, the scan's
    collectives equal the data plane's counters, the peak per program,
    ``collmap --check`` exits 0."""
    import contextlib
    import io

    from difacto_tpu_torch.tools import collmap
    from difacto_tpu_torch.utils import collscan
    t21 = time.monotonic()
    out = {"launches": dict.fromkeys(COUNTERS, 0)}
    kwargs = [list(x) for x in conf] + [
        ["data_in", tr["data_in"]], ["data_val", tr["data_val"]],
        ["max_num_epochs", "2"], ["stop_rel_objv", "0"],
        ["stop_val_auc", "-2"]]
    data = os.path.join(work, "criteo.txt")
    pred_out = os.path.join(work, "p21_pred")
    T = _tooling_child(
        work, "traced", {"DIFACTO_JAXTRACE": "1"}, kwargs=kwargs,
        model=os.path.join(work, "model"), data=data, pred_out=pred_out,
        batch=batch, pred_kwargs=[list(x) for x in conf] + [
            ["data_in", data], ["pred_out", pred_out]])
    a, bt = T["a"], T["b"]
    if not (T["enabled"] and (T["sync_debug"] or DEV != "cuda")):
        raise AssertionError(f"phase 21: the traced child ran untraced: "
                             f"{T}")
    # (a)
    want_scores = a["pred_windows"] + a["dispatches"]
    if a["failures"] or a["wrong"] or a["points"].get(
            "serve.scores") != want_scores or not a["pred_windows"]:
        raise AssertionError(f"phase 21 (a): {a}")
    serve_syncs = {s: r for s, r in a["syncs"].items() if r["serve"]}
    if serve_syncs:
        raise AssertionError(f"phase 21 (a): undeclared syncs under the "
                             f"serve dispatch: {serve_syncs}")
    # (a rehearsal off the card counts plain versions, which no kernel
    # site sees)
    if DEV == "cuda" and (a["kernels"].get("gather_rows_cuda")
                          != a["counters"]["gather_rows_cuda"]
                          or not a["kernels"].get("gather_rows_cuda")):
        raise AssertionError(f"phase 21 (a): kernel sites {a['kernels']} "
                             f"against the counters {a['counters']}")
    for c in COUNTERS:
        out["launches"][c] += a["counters"][c] + bt["launches"][c]
    log(f"  (a) traced pred ({a['pred_windows']} windows, "
        f"{a['pred_s']:.2f} s) and serve (3 windows, then twice more; "
        f"{a['dispatches']} dispatches, answers = the pred column): "
        f"programs [calls, signatures] warm {a['warm_programs']} -> "
        f"{a['programs']}; fetch points {a['points']}, host-to-device "
        f"{a['puts']}; kernel sites {a['kernels']} = counters; syncs "
        f"declared {a['declared_syncs']}, undeclared by site "
        f"{ {s: r['count'] for s, r in a['syncs'].items()} } (none under "
        f"a serve dispatch)")
    # (b)
    U = _tooling_child(work, "untraced", {}, kwargs=kwargs)
    bu = U["b"]
    if U["enabled"] or U["sync_debug"]:
        raise AssertionError(f"phase 21: the untraced child traced: {U}")
    if bu["launches"] != tr["launches"]:
        raise AssertionError(f"phase 21 (b): untraced launches "
                             f"{bu['launches']}, phase 7's "
                             f"{tr['launches']}")
    # each kernel site counts what its counter counts, the chunked
    # backward's among them (the training steps' calls)
    if bt["launches"] != tr["launches"] or (DEV == "cuda" and (
            bt["kernels"] != bt["launches"]
            or not bt["launches"]["fm_chunk_grad_cuda"])):
        raise AssertionError(f"phase 21 (b): traced launches "
                             f"{bt['launches']} (sites {bt['kernels']}), "
                             f"phase 7's {tr['launches']}")
    if bt["digest"] != bu["digest"] or bt["loss"] != bu["loss"]:
        raise AssertionError("phase 21 (b): the traced run's table or "
                             "losses differ from the untraced run's")
    if bt["new_signatures"] or bt["failures"]:
        raise AssertionError(f"phase 21 (b): {bt['new_signatures']} "
                             f"{bt['failures']}")
    for c in COUNTERS:
        out["launches"][c] += bu["launches"][c]
    steps = bt["steps"]
    per_step = {s: [r["count"], round(r["count"] / steps, 4),
                    r["in_program"]]
                for s, r in sorted(bt["syncs"].items(),
                                   key=lambda kv: -kv[1]["count"])}
    out["train_syncs"] = per_step
    log(f"  (b) phase 7's train traced and untraced: tables and losses "
        f"bit for bit, launches {bu['launches']} = phase 7's; programs "
        f"[calls, signatures] {bt['programs']}, none new in epoch 1; "
        f"fetch points {bt['points']}, host-to-device {bt['puts']}")
    log(f"  (b) epoch walls, traced: {_epoch_walls(bt['walls'])}; "
        f"untraced: {_epoch_walls(bu['walls'])}; child walls "
        f"{T['wall']:.1f} / {U['wall']:.1f} s")
    log(f"  (b) undeclared syncs of the train run over {steps} train "
        f"steps, [count, per step, inside a program] by site: "
        f"{per_step}; declared {bt['declared_syncs']}")
    # (c)
    small = os.path.join(work, "p21_small.txt")
    with open(tr["data_in"], "rb") as f:
        head = f.read().splitlines(keepends=True)[:P21_DEVICE_ROWS]
    with open(small, "wb") as f:
        f.write(b"".join(head))
    spans, logdir = os.path.join(work, "p21_spans.json"), \
        os.path.join(work, "p21_device")
    D = _tooling_child(
        work, "device", {"DIFACTO_TRACE": spans,
                         "DIFACTO_TRACE_DEVICE": logdir},
        kwargs=[list(x) for x in conf] + [
            ["data_in", small], ["max_num_epochs", "2"],
            ["stop_rel_objv", "0"]])
    traces = sorted(f for f in os.listdir(logdir) if f.endswith(".json"))
    if len(traces) != 1:
        raise AssertionError(f"phase 21 (c): traces {traces} in {logdir}")
    with open(os.path.join(logdir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    with open(spans) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    inside = _kernels_in_spans(events) if DEV == "cuda" else {}
    if DEV == "cuda" and not all(n > 0 and k == n
                                 for n, k in inside.values()):
        raise AssertionError(f"phase 21 (c): kernels (events, inside a "
                             f"span) {inside}")
    if not set(P21_SPANS) <= names:
        raise AssertionError(f"phase 21 (c): span names {names}")
    ranges = {e["name"] for e in events
              if e.get("cat") in ("user_annotation", "gpu_user_annotation")}
    log(f"  (c) DIFACTO_TRACE_DEVICE over {P21_DEVICE_ROWS} rows, 2 epochs "
        f"(epoch 1 replayed): {len(events)} trace events, span ranges "
        f"{sorted(r for r in ranges if not r.startswith('ProfilerStep'))} "
        f"and {sum(r.startswith('ProfilerStep') for r in ranges)} "
        f"profiler steps; kernels (events, inside a span range) {inside}; "
        f"epoch walls {_epoch_walls(D['walls'])}")
    # (d); a rehearsal off the card takes a table wider than its union
    # caps (at 8,192 rows a step's partials are as wide as the table)
    rows = str(dict(conf)["hash_capacity"]) if DEV == "cuda" else "32768"
    base = [CONF, f"data_in={tr['data_in']}", f"data_val={tr['data_val']}",
            "max_num_epochs=1", "stop_rel_objv=0", "stop_val_auc=-2",
            f"device={DEV}"]
    if DEV == "cpu":
        base.append(f"hash_capacity={rows}")
    ranks, _, d_wall = _launch_ranks(
        work, "scan", base, scan=True,
        env_extra={"DIFACTO_HLOSCAN": "1", "DIFACTO_HLOSCAN_ROWS": rows})
    if len(ranks) != 2 or any(r["rc"] != 0 for r in ranks):
        raise AssertionError(f"phase 21 (d): ranks {ranks}")
    for r in ranks:
        path = os.path.join(work, f"mh_scan-{r['rank']}-scan.json")
        doc = collscan.load(path)
        # the cross-process collectives, and apart from them the copies
        # between the rank's logical devices (kind device_copy)
        progs, moves = ({s: dict(rec, collectives=[
            c for c in rec["collectives"]
            if (c["kind"] == "device_copy") == want])
            for s, rec in doc["programs"].items()}
            for want in (False, True))
        tot = collscan.totals(progs)
        plane = r["plane"]
        if doc["rows"] != int(rows) \
                or collscan.violations(doc["programs"]):
            raise AssertionError(f"phase 21 (d) rank {r['rank']}: "
                                 f"{collscan.violations(doc['programs'])}")
        if tot != {"calls": plane["calls"], "bytes": plane["bytes_out"]}:
            raise AssertionError(f"phase 21 (d) rank {r['rank']}: scan "
                                 f"{tot}, data plane {plane}")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = collmap.main(["--root", os.path.dirname(
                os.path.abspath(__file__)), "--dynamic", path, "--check"])
        if rc != 0:
            raise AssertionError(f"phase 21 (d): collmap --check exited "
                                 f"{rc} on rank {r['rank']}'s scan")
        for c in COUNTERS:
            out["launches"][c] += r["launches"][c]
        train = progs[r["train_site"]]
        part = max(train["collectives"], key=lambda c: c["bytes"])
        n = r["train_calls"]
        log(f"  (d) rank {r['rank']}: {tot['calls']} collectives, "
            f"{tot['bytes']} B = the data plane's counters; the train "
            f"step ({n} steps): "
            f"{collscan.totals(progs, site=r['train_site'])['bytes'] / n:.0f}"
            f" B a step, its partials {part['shape']} {part['dtype']} "
            f"{part['bytes']} B; between its logical devices "
            f"{collscan.totals(moves)['calls']} copies, "
            f"{collscan.totals(moves)['bytes']} B; 0 table-axis at {rows} "
            f"rows; peak above "
            f"entry per program "
            f"{ {p['label'] or s: p['peak_temp_bytes'] for s, p in progs.items() if p['traced']} }"
            f"; store {doc['store']}; collmap --check 0")
    log(f"  (d) {d_wall:.1f} s of launch.py")
    log(f"phase 21 ok in {time.monotonic() - t21:.1f} s: the tracers at "
        f"full width ({smi})")
    return out


# ------------------------------------------------------------- phase 22
def _p22_tools(work: str, root: str) -> None:
    """Phase 22 (d) and (e): the port's lockmap and obs_report, the root
    tools' counterparts, over what phases 18 and 12 left in ``work``."""
    import contextlib
    import io
    # (d) the port's lockmap over phase 18 (d)'s lock dump
    from difacto_tpu_torch.tools import lockmap, obs_report
    locks = os.path.join(work, "traced", "locks.json")
    out = os.path.join(work, "lockmap.json")
    t0 = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = lockmap.main(["--root", root, "--dynamic", locks, "--check",
                           "--json", out])
    lm_s = time.monotonic() - t0
    with open(out) as f:
        lm = json.load(f)
    if rc != 0 or lm["dynamic_only"] or lm["cycles"] \
            or not lm["dynamic_edges"]:
        raise AssertionError(f"phase 22 (d): lockmap --check exited {rc}: "
                             f"dynamic-only {lm['dynamic_only']}, cycles "
                             f"{lm['cycles']}")
    log(f"  (d) python -m difacto_tpu_torch.tools.lockmap --check over "
        f"phase 18 (d)'s dump: rc 0, {len(lm['dynamic_edges'])} observed "
        f"edges ({len(lm['confirmed'])} confirmed, 0 dynamic-only), 0 "
        f"cycles, {len(lm['guarded_by'])} GuardedBy fields, {lm_s:.2f} s")
    # (e) the port's obs_report over phase 12 (e)'s metrics_path JSONL
    metrics = os.path.join(work, "stream_e.jsonl")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_report.main(["--metrics", metrics])
    text = buf.getvalue()
    sections = [x.strip("= ").split(" (")[0] for x in text.splitlines()
                if x.startswith("== ")]
    if rc != 0 or "streamed stage table" not in sections:
        raise AssertionError(f"phase 22 (e): obs_report exited {rc}: "
                             f"{text[:500]}")
    stage = [x.split() for x in text.splitlines()
             if x.startswith("  step ")]
    log(f"  (e) python -m difacto_tpu_torch.tools.obs_report over phase 12 "
        f"(e)'s metrics_path: rc 0, {len(text.splitlines())} lines, "
        f"sections {sections}; the step stage {' '.join(stage[0][1:])}"
        if stage else f"  (e) obs_report: rc 0, sections {sections}")


def phase_analyzer(work: str, smi: str) -> dict:
    """Phase 22: the port's own analyzer where the port runs (the card
    machine has no jax). (a) ``python -m difacto_tpu_torch.analysis``
    over ``difacto_tpu_torch/`` with no baseline: 0 findings; the
    findings per rule (every one suppressed with its reason), each
    pass's seconds and the hot set's size. (b) Its lock graph is the
    committed ``utils/lockorder.json``. (c) ``devmap --check`` over phase
    21's dumps of the serve dispatch and the train run (each beside its
    warm-up dump) and of both ranks' runs, and ``collmap --check`` over
    both ranks' scans, each merged with the static model: dynamic within
    static (no unknown site, copy, collective, grown unbounded signature
    or unknown hot-path sync). (d) ``lockmap --check`` over phase 18
    (d)'s lock dump: no dynamic-only edge, no cycle. (e) ``obs_report``
    over phase 12 (e)'s ``metrics_path`` JSONL."""
    import collections
    import contextlib
    import io

    from difacto_tpu_torch.analysis import cli
    from difacto_tpu_torch.tools import collmap, devmap
    from difacto_tpu_torch.utils import collscan, devtrace
    t22 = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    # (a)
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["difacto_tpu_torch", "--root", root, "--baseline",
                       "none", "--format", "json"])
    lint_s = time.monotonic() - t0
    doc = json.loads(buf.getvalue())
    if rc != 0 or doc["counts"]["active"]:
        active = [f for f in doc["findings"] if not f["suppressed"]]
        raise AssertionError(f"phase 22 (a): the analyzer exited {rc}: "
                             f"{doc['counts']} {active[:5]}")
    per_rule = collections.Counter(f["rule"] for f in doc["findings"])
    tm, sm = devmap.models(root)
    slow = sorted(doc["rule_seconds"].items(), key=lambda kv: -kv[1])
    log(f"  (a) python -m difacto_tpu_torch.analysis over "
        f"{doc['counts']['files']} files: rc 0, 0 active findings in "
        f"{lint_s:.2f} s ({doc['lint_seconds']} s of passes); findings "
        f"per rule, all suppressed with a reason: "
        f"{dict(sorted(per_rule.items()))}; seconds per pass: "
        f"{dict(slow)}; hot set "
        f"{len(tm.hot_funcs)} functions from {len(tm.hot_roots)} roots; "
        f"{len(tm.sites)} traced sites, {len(tm.fetch_sites)} fetch "
        f"sites, {len(sm.collective_sites)} collective lines")
    # (b)
    with open(os.path.join(root, cli.LOCKORDER)) as f:
        committed = json.load(f)
    graph_b = cli.lock_graph(root)
    if graph_b != committed:
        raise AssertionError("phase 22 (b): the analyzer's lock graph is "
                             "not utils/lockorder.json")
    log(f"  (b) the lock graph ({len(graph_b['sites'])} locks, "
        f"{len(graph_b['edges'])} edges, {len(graph_b['cycles'])} cycles) "
        f"= utils/lockorder.json")
    # (c)
    verdicts: dict = {}
    for name, dyn, warm in (
            ("serve", "p21_traced-serve.json", "p21_traced-serve-warm.json"),
            ("train", "p21_traced-train.json", "p21_traced-train-warm.json"),
            ("rank 0", "mh_scan-0-trace.json", None),
            ("rank 1", "mh_scan-1-trace.json", None)):
        path = os.path.join(work, dyn)
        args = ["--root", root, "--dynamic", path, "--check"]
        if warm:
            args += ["--warm", os.path.join(work, warm)]
        with contextlib.redirect_stdout(io.StringIO()):
            rc = devmap.main(args)
        graph = devmap.build(root, devtrace.load(path), devtrace.load(
            os.path.join(work, warm)) if warm else None)
        if rc != 0:
            raise AssertionError(f"phase 22 (c) {name}: devmap --check "
                                 f"exited {rc}: {devmap.failures(graph)}")
        for site, v in graph["sync_verdicts"].items():
            verdicts[site] = v
    for r in (0, 1):
        path = os.path.join(work, f"mh_scan-{r}-scan.json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = collmap.main(["--root", root, "--dynamic", path,
                               "--check"])
        graph = collmap.build(root, collscan.load(path))
        if rc != 0:
            raise AssertionError(
                f"phase 22 (c) rank {r}: collmap --check exited {rc}: "
                f"{graph['unknown_collectives']} {graph['table_hits']} "
                f"{graph['unknown_sites']}")
    log(f"  (c) devmap --check over the serve, train and two rank dumps "
        f"and collmap --check over the two scans: 0 each; the observed "
        f"undeclared syncs by the model's verdict: {verdicts}")
    _p22_tools(work, root)
    dt = time.monotonic() - t22
    log(f"phase 22 ok in {dt:.1f} s: the port's analyzer on the card "
        f"machine ({smi})")
    return {"seconds": dt, "findings": dict(per_rule),
            "rule_seconds": doc["rule_seconds"],
            "hot": len(tm.hot_funcs), "verdicts": verdicts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", action="append", default=[],
                    help="a checkout of another commit whose "
                         "gather_rows.cu phase 5 and scatter_epilogue.cu "
                         "phase 8 time, and whose learner phase 12 runs "
                         "at the defaults, in turns with this tree's (may "
                         "be given more than once)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        import difacto_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run it "
              "from the root of the repository", file=sys.stderr)
        return 2
    from difacto_tpu_torch.config import parse_config_file
    from difacto_tpu_torch.updaters.sgd_updater import SGDUpdaterParam

    global T_START
    T_START = time.monotonic()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        smi, kernel_fns = phase_card(args.parent, work)
        mesh_conf = parse_config_file(CONF)
        if DEV == "cpu":        # a rehearsal's table: the CPU holds less
            mesh_conf.append(("hash_capacity", "8192"))
        # the flat table every phase but 19 has always measured; phase 19
        # runs the conf as written, on its 2 x 4 mesh
        conf = mesh_conf + [("mesh_dp", "1"), ("mesh_fs", "1")]
        uparam, rest = SGDUpdaterParam.init_allow_unknown(conf)
        C, k = uparam.hash_capacity, uparam.V_dim
        batch = int(dict(rest)["batch_size"])
        log(f"config {CONF}: V_dim {k}, hash_capacity {C}, batch_size "
            f"{batch}, data_format {dict(rest)['data_format']}; flat "
            "(mesh_dp=1 mesh_fs=1) but in phase 19, which runs the conf's "
            f"mesh_dp={dict(mesh_conf)['mesh_dp']} "
            f"mesh_fs={dict(mesh_conf)['mesh_fs']}")
        gather_err = phase_kernel_vs_plain(C)
        cg = phase_chunk_grad()
        t0 = time.monotonic()
        arrays = synthetic_model(C, k, SEED)
        text = synthetic_criteo(N_ROWS, SEED + 1)
        log(f"  synthetic model + {N_ROWS} criteo rows in "
            f"{time.monotonic() - t0:.1f} s")
        store, lines, pred_launches, windows = phase_pred(
            work, conf, uparam, arrays, text)
        serve_launches = phase_serve(store, lines, text, batch)
        g = phase_measure(store, windows, kernel_fns["gather"])
        del store, arrays
        gc.collect()
        torch.cuda.empty_cache()
        scatter_err = phase_scatter_vs_plain(uparam)
        tr = phase_train(work, conf, uparam)
        m = phase_measure_train(tr["learner"], tr["data_in"],
                                kernel_fns["scatter"])
        del tr["learner"]
        gc.collect()
        torch.cuda.empty_cache()
        t19 = phase_mesh(work, mesh_conf, uparam, tr, m, smi,
                         kernel_fns["gather"])
        del tr["bits"]
        gc.collect()
        torch.cuda.empty_cache()
        t20 = phase_multihost(work, tr, t19, smi)
        td = phase_train_dict(work)
        tx = phase_layout_cross(work)
        phase_local_conf(work)
        ts = phase_stream(work, conf, uparam, tuple(args.parent))
        tc = phase_cache(work, conf, uparam, ts)
        ts_launches = ts["launches"]
        phase_batch_learners(work, smi)
        tq = phase_capacity(work, conf, uparam, ts)
        bits_a = ts["bits_f"]        # phase 12 run (a)'s table, for 18
        del ts
        gc.collect()
        torch.cuda.empty_cache()
        # phase 16 times a server on the host's clock: the objects fifteen
        # phases left behind are moved out of the collector's generations,
        # so that its full collections do not pause the server's threads
        log(f"  before phase 16: {threading.active_count()} threads, "
            f"{len(gc.get_objects())} objects tracked; frozen")
        gc.freeze()
        try:
            tp = phase_lifecycle(work, conf, uparam, lines, smi)
            to = phase_online(work, conf, uparam, smi)
            t17 = time.monotonic()
            tf = phase_fleet_inproc(work, lines, C, smi)
            phase_fleet(work, lines, smi)
            log(f"phase 17 ok in {time.monotonic() - t17:.1f} s: the fleet")
        finally:
            gc.unfreeze()
        t18 = phase_faults(work, conf, bits_a, smi)
        del bits_a
        gc.collect()
        torch.cuda.empty_cache()
        t21 = phase_tooling(work, conf, tr, batch, smi)
        phase_analyzer(work, smi)
        if any(m in sys.modules for m in ("jax", "difacto_tpu",
                                          "ml_dtypes")):
            raise AssertionError("the smoke imported JAX, difacto_tpu or "
                                 "ml_dtypes")
        # launches on the main paths: phases 3, 4, 7, 9, 10, 12, 13, 15,
        # 16 (p) and (q), 17 (r), 18 (a) and (b), 19 (a), (c) and (d), 20
        # (a) (both ranks) and 21 (a), (b) (both runs) and (d) (both
        # ranks), each read just after its own run
        tl = {c: tr["launches"][c] + td["launches"][c] + tx["launches"][c]
              + ts_launches[c] + tc["launches"][c] + tq["launches"][c]
              + tp["launches"][c] + to["launches"][c] + tf["launches"][c]
              + t18["launches"][c] + t19["launches"][c]
              + t20["launches"][c] + t21["launches"][c]
              for c in COUNTERS}
        kernels = []
        for name, launches, err, t in (
                ("gather_rows", pred_launches + serve_launches
                 + tl["gather_rows_cuda"], gather_err, g),
                ("scatter_epilogue", tl["fm_update_rows_cuda"],
                 scatter_err[True], m["on"]),
                ("scatter_epilogue_off", tl["scatter_rows_cuda"],
                 scatter_err[False], m["off"])):
            lib, replaces = ENTRIES[name]
            kernels.append({
                "name": name, "route": "cuda", "source": KERNELS[lib],
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": "bytes",
                "library_ms": t["library_ms"]})
        # the chunked backward, at each benchmark cell's batch; its error
        # is relative to each element's sum of magnitudes
        for cell, t in cg.items():
            lib, replaces = ENTRIES["fm_chunk_grad"]
            kernels.append({
                "name": "fm_chunk_grad", "cell": cell, "route": "cuda",
                "source": KERNELS[lib], "replaces": replaces,
                "launches": tl["fm_chunk_grad_cuda"],
                "max_err_of_magnitudes": t["err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "bytes", "library_ms": None})
        log(f"smoke wall time {time.monotonic() - T_START:.1f} s")
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
