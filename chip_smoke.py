"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]
                          [--phase cluster|integrity|gossip|operator|resize|
                                   tier]

Builds the port's CUDA kernels (nvcc, sm_90a) from the sources in this
checkout, then runs seventeen phases and prints one JSON line for each:

1. ``kernels``: each hand-written kernel against its plain PyTorch
   version on the card, exact (integer results), at the serving shapes,
   the odd shapes, bit-31 words, a 64-leaf mixed tree, a 1000-child
   Union (a program longer than the expression count stages in shared
   memory), a tree that needs spill slots and the BSI comparison folds
   of phase 6 (22 planes of 256 slices); the expression count at
   S = 1, 10 and 256 rows of 32,768 words and at W = 4; densify at
   G = 0, 1, 8, 32 and 40, T × subs groups that its 32-group tile does
   not divide, a group with lanes 0 and 127 set, bit-31 values and
   all-padding rows; both of them again into an output that
   ``torch.empty`` hands back dirty (a freed all-ones tensor of its
   size), one launch each; and the op count at the benchmark's shape
   [16, 2^25] for every op, at one long row, 1-D, W = 4k+1..3, W below
   one CTA's chunk, all-ones and bit-31 words and views at odd word
   offsets; the expression-words kernel at one slice row of a
   1000-leaf Union, 256 slices of a 16-leaf Union (also into a dirty
   output), a spill-slot tree, W = 4 and the BSI folds; the batched
   expression count at K = 1, 2, 16 (also into a dirty output) and 22.
   Then four times of each kernel at the main path's shapes,
   with the inputs rotated through copies so that the 50 MB L2 does not
   hold what a launch reads (pilosa_tpu_torch/ops/timing.py):
   ``ms``, the device time alone — K wrapper calls captured in one CUDA
   graph, the graph replayed between CUDA events, divided by K;
   ``call_ms``, what a caller pays — CUDA events around a loop of
   wrapper calls (``call_ms - ms`` is the wrapper's host cost);
   ``profiler_ms``, torch.profiler's device time per call (null where
   the profiler records none), a cross-check of ``ms``; and
   ``plain_ms``, CUDA events around calls of the plain version;
   densify's ``library_ms`` is ``torch.zeros`` and ``scatter_add_`` on
   its slots (checked against its words first); the expression-words
   kernel is also timed at configuration 2's one slice row of a
   1000-leaf Union (its leaf-split fold).
2. ``count``: Count queries through ``Executor.execute`` over an index of
   256 slices (268,435,456 columns), cold and then resident.
3. ``topn``: exact TopN through ``Executor.execute`` over 10 slices, the
   resident form (200 candidates) and the streaming form (1,000
   candidates). Phases 2-4 write one data directory (indexes
   ``smoke``, ``smoke_topn`` and ``t3``).
4. ``topn1000``: every form of TopN at BASELINE configuration 3's full
   size — index ``t3``, 100,000 rows × 10 slices, the JAX suite's data
   (rows 0-1999 at counts 1000 down to 21, the rest at 4 bits) in an
   LRU frame ``f`` and a ranked frame ``fr`` — and over phase 3's
   index: ``TopN(frame=f, n=1000)`` (the single pass over complete LRU
   caches), ``TopN(frame=fr, n=1000)`` (two phases, the refetch on the
   host), ``TopN(frame=fr, n=50)`` (two phases, the refetch a device
   top-k: n is lowered until the candidate union fits the resident
   block), a source with no ids, the same with ``threshold=3`` and a
   Tanimoto query whose source holds a sparse leaf (densify); each cold
   and warm (p50 of 5), every answer held to a plain two-phase
   reference over roaring row counts (``_ref_topn``).
5. ``planner``: the planner's decisions over ``t3`` (10 slices, under
   its EXACT_SLICES): a Count whose Intersect holds a proven-empty row
   beside a missing frame answers 0 with no launch (over the 256 slices
   of ``smoke`` it raises the missing frame instead, as the JAX package
   does); a Union with a proven-empty operand answers and launches what
   it does without it; a reordered Intersect answers what the
   planner-off executor answers; a subtree repeated over three queries
   hits the subresult cache on every slice the third time; and the
   warm p50 of ``TopN(frame=f, n=1000)`` and of a Count with the
   planner on and off, in turns. Each query's decisions and launches
   are printed.
6. ``fields``: BSI integer fields, time views and the inverse view
   through ``Executor.execute`` (``phase_fields``): configuration 4's
   256 slices with field ``amount`` of ``b4/v`` in [-10^6, 10^6]
   (depth 21, 4,194,304 values, 704 MiB of plane slabs on the card),
   Count(Range) of each operator and both clamps, Sum plain and
   filtered, Min and Max; time views of ``tv/t`` (YMDH, ~1 M
   timestamped bits through protobuf ``/import`` over 10 slices) under
   Range Counts whose covers mix Y, M, D and H views; ``tv/inv``'s
   inverse view under ``Bitmap(columnID=...)`` and a Count of two
   columns. Every answer held to a numpy reference from the seeded
   data; each Count's program length and device time against its bound.
7. ``batch``: the fused batch and the device materialize leg
   (``phase_batch``): BASELINE configuration 2 (index ``c2``, one
   slice, 1,000 rows of array and bitmap containers) under a Union and
   a Difference of all of them and an Intersect of 8, cold, warm and as
   a result-cache hit, against numpy and the port's host fold; at
   configuration 4 the bitmap Union of ``smoke``'s rows 1-16, the
   Difference of rows 1-8 and two bitmap field Ranges of ``b4``, each
   split into kernel, copy and repack; and the multi-call bodies — 16
   Counts, the filtered Sum, 4 Counts and 2 TopNs over ``t3`` — with
   their launches (1, 1, 3) and host fetches (1 each) a warm run and
   their warm time against the same calls as one-call queries.
8. ``server``: ``pilosa_tpu_torch.server.server.Server`` on
   127.0.0.1:0 on the card over that directory, driven over HTTP with
   urllib: it creates frame ``g`` in ``smoke``, imports row 1 of ``g``
   at density 1/64 over all 256 slices as raw v2 positions and row 2 at
   1/4096 as 256 protobuf ``ImportRequest``s (the port's codec), sets a
   ``category`` row attribute on the 200 resident TopN candidates in
   one query of ``SetRowAttrs`` calls and a ``tag`` on three columns;
   then phase 2's Count queries, two Counts over ``g`` (one with sparse
   leaves, through densify), the resident TopN with and without
   ``field="category", filters=[0, 1]``, one ``Bitmap`` with
   ``columnAttrs=true`` and three of phase 4's TopN queries (the
   reopened ``.cache`` sidecars rank their frames), each cold
   (residency cache empty) and warm,
   with a JSON and with a protobuf answer. Every answer is held to the
   host roaring answer from the server's own fragments; beside the
   client's times, each query's warm time through
   ``server.executor.execute`` in this process (the difference is the
   HTTP front's cost). Then phase 6's queries again (the protobuf
   ``ValCount`` decoded), a new field created over HTTP with its values
   through the protobuf field-import route, and a time quantum set by
   ``PATCH`` under a timestamped SetBit and a Range; phase 7's
   configuration-2 Union again. Last, one keep-alive connection sends
   1,000 pipelined SetBit queries and 64 pipelined Counts (the HTTP
   front's batch lane): every answer checked, requests/s and the
   executor calls counted, and after the server closes every acked bit
   is read back from the reopened fragment files.
9. ``control``: the query lifecycle and the calibrated routing over
   the same directory (``phase_control``). The cost model's
   calibration five times on the card (``sync_s``, ``upload_bps``,
   ``host_bps``, ``pack_bps``, ``device_bps``; parallel/costmodel.py);
   an in-process ``Server`` (its warmup must launch all six kernel
   entries) for the routing table — the warm p50 of phase 2's
   ``Count(Intersect)`` on the host leg, on the pinned device leg and
   as the calibrated routing sends it, at 1, 2, 4, 8, 16, 64 and 256
   slices, with the route taken, every answer equal — and the
   lifecycle's own cost (the warm HTTP p50 of that Count over 200
   requests with the cost ledger and tracing off, then on); then the
   ``server`` verb as a subprocess with one admission slot and no
   queue: phase 3's streaming TopN repeated in one body until it runs
   two seconds, under ``?timeout=100ms`` (504 with the JAX text),
   cancelled by ``DELETE /debug/queries/{id}`` from a second
   connection (409, then a right Count and a right TopN), and twice at
   once (one 200, one 429 with Retry-After); a ``?trace=1`` Count whose
   trace holds ``mesh_dispatch`` spans and whose ``X-Pilosa-Stats``
   reports kernel launches; ``/metrics`` parsed, its request, status
   and admission samples moved; and the tail sampler (on by default):
   ``/debug/traces`` says ``"tail": true`` and the 504's trace is on
   the disk ring (``?source=disk&reason=deadline``).
10. ``durability``: the port's ``server`` verb as a subprocess on the
   card over a fresh directory, seeded by protobuf ``/import`` with
   configuration 4's rows over 128 slices (cut from 256 for the script's time), takes a
   6 s write storm (8 threads of SetBit/ClearBit queries; after a quarter of it 2 threads
   of 65,536-bit ``/import`` batches and one thread that drives slice 0
   past MAX_OP_N so that background snapshots swap its WAL) and is
   killed with SIGKILL.
   A ``Server`` in this process reopens the directory on the card: every
   acked write must be there and every acked ClearBit gone, no bit that
   was never written may appear, and Counts of every touched row over
   HTTP in one body (the batched expression count, densify) and a
   sourced TopN over six of them
   (TopN block count) must equal the reopened fragments' host answers.
   It prints acked writes/s, import bits/s, the ack latency p50/p99
   (also for the writers alone and beside the imports), the
   WAL bytes at the kill, the respawn-to-ready seconds, the launches and
   the card's name and power limit.
11. ``cluster``: BASELINE configuration 5 as a static cluster of three
   node processes of the port on the card (``phase_cluster``): index
   ``c5`` at 64 slices (cut from 954 for the script's time; 2^24 bits,
   the density of the earlier 256-slice cut) with 1,000,000 Zipf(1.1)
   row ids, replicas 2; the data written into each owner's directory with
   the port's storage layer and placement; Counts and three TopNs from
   every coordinator held to the host references, 1,000 SetBits read
   back from both owners, a SIGKILL and the same reads, a restart with
   anti-entropy, and the routed Count on the device leg of every node.
   The nodes are this script's child mode (``--cluster-node``), whose
   launch counters come back on their exit lines.
12. ``integrity``: storage integrity on three node processes of the
   port on the card (``phase_integrity``, the same child mode, pinned,
   replicas 2): configuration 4's ``smoke`` layout at 128 slices
   written into each owner's directory; a clean start (every
   coordinator's 16 Count(Bitmap) and 8 Count(Intersect) in one body
   exact, nothing quarantined, a clean synchronous scrub, timed); bit
   rot across a restart (5 seeded bytes flipped in every fragment file
   of one stopped node: its open quarantines, Counts over random slice
   ranges to all three nodes stay exact with none failed while the
   repairer re-streams the fragments from the replicas, the quarantine
   drains in 60 s, the repaired node's own leg answers exactly on its
   kernels, a second restart is clean); a live scrub (the seeded
   ``storage.read`` corrupt failpoint: detected, exact answers,
   drained, a clean further pass); and disk full (``wal.append``
   ENOSPC: a SetBit answers 507 with Retry-After, ``/debug/vars``
   shows the latch, the retried SetBit acks once it clears and both
   owners hold the bit). No slice re-maps in the clean and disk-full
   steps, and only legs to the corrupted node in the others.
13. ``gossip``: gossip membership on three node processes of the port
   on the card (``phase_gossip``, the same child mode, pinned, replicas
   2), each started from a TOML file with ``server -c FILE`` alone:
   gossip on its own internal port, seeded from node 0's, an HMAC
   secret; configuration 4's ``smoke`` layout at 128 slices (cut from
   256 for the script's time). Ready
   (every ``/health`` 200 with ``3 nodes UP``), a frame created on node
   0 reaching the others over gossip and counted exactly, the Counts
   and two TopNs from every coordinator cold and warm, a SIGKILL of the
   peer that served node 0's legs (each survivor's seconds until its
   membership marks it DOWN, its breaker open for "gossip dead" at that
   moment, ``/health`` 503 naming it, node 0's reads exact again with
   the first Count's ms), and its restart from the same file (the
   seconds until all three are ready again, its reads exact). Each
   node's file arms hedged reads at 50 ms: ``/metrics/cluster`` and
   ``/debug/cluster`` federate the three nodes after the reads; before
   the kill, 8 fresh Counts from node 0 come back exact, through their
   hedges, while the peer serving its legs is SIGSTOPped; after it, with
   the other peer partitioned by an ``rpc.send`` failpoint, a Count
   answers 400 without ``?partial=1`` and with it 200, listing exactly
   the slices node 0 does not own in ``X-Pilosa-Partial``, and
   ``/metrics/cluster`` answers 503, or 200 naming both peers.
14. ``operator``: the operator surface on three port servers (this
   script's child mode, pinned; ``phase_operator``) over configuration
   4's ``smoke`` layout at 128 slices (cut from 256 for the script's time), written into
   three directories
   before any traffic: A on the card with tenants ``wide`` and
   ``quiet``, one fair dispatch slot and ``[capture] mode = "full"``, B
   on the CPU (every kernel's plain version), C on the card. A wide
   tenant's 8 threads of Counts beside a quiet tenant's single Counts
   and a sourced TopN, every answer exact against the host (the fair
   queue's dispatches and waits, the quiet p50); A's capture exported
   (a record for every request, a digest on each) and replayed by the
   ``replay --records F --shadow B C`` verb: rc 0, no mismatch, every
   captured read compared, and C's expression count, densify and TopN
   block count launched during the replay; ``/debug/pprof/profile``
   under load, the query latency in ``/debug/metrics/history`` after
   two collector ticks, ``/debug/sentinel``; the ``mesh.dispatch``
   failpoint as a 2.5 s delay under a Count with ``?timeout=1s`` (the
   watchdog trips ``stuck_query``, ``/debug/blackbox`` lists its dump,
   ``/debug/pprof/flame`` holds the captured stuck query's stacks), an
   exact Count after the disarm, and one more dump at A's SIGTERM. Each
   step's ms is on the line.
15. ``resize``: online cluster resize on four node processes of the
   port on the card (``phase_resize``, the same child mode, pinned,
   replicas 2, each from a TOML file with gossip): configuration 4's
   ``smoke`` layout at 256 slices in the three-node placement, the
   fourth node booted knowing that membership. Grow 3→4 with the
   ``resize`` verb (``--add ... --wait``) and shrink 4→3 with ``POST
   /cluster/resize {"remove": ...}``, each under a load of single Counts
   and SetBits into moving slices from every node, every answer exact
   and none failed; after each, every node's epoch and membership, the
   reads of the gossip phase exact from every member, the written rows
   converged on every owner, and node 0's watchdog without a
   ``resize_stall`` trip; after the grow, node 3 restarted comes back at
   epoch 1 and its expression count and densify launched on its moved
   slices. Each protocol phase's seconds, the slices moved, MB streamed
   and MB/s, the stream passes, the double reads by winner and the
   Count p50 before and during are on the line.
16. ``tier``: tiered storage on one port server on the card
   (``phase_tier``, the same child mode, pinned, the ``server`` verb from
   a TOML file with ``[tier] enabled``, ``blob = "dir"``, ``idle`` 1 ms,
   ``blob-idle`` 2 s and the loop at one hour, each pass driven by
   ``GET /debug/tier?pass=1``): configuration 4's ``smoke`` layout at
   32 slices (a blob push puts each of a fragment's 256 container
   blocks as an object with two fsyncs: ~1 s a fragment on the card's
   host). Warm Counts and TopNs (their p50s); every fragment
   demoted, the first Count after it (ms, block faults, densify and the
   expression count launched); every fragment pushed to the blob store
   (MB, MB/s, only stubs left on local disk), the first Count from it
   (ms, fetches, fetch MB/s) and the TopNs, which promote fully, in the
   hot order with the TopN block count launched; a push, a restart (to
   ready s) and a first Count that fetches from the stubs; a failed
   fetch (``tier.fetch``) answering 500, 503 and, with ``?partial=1``,
   200 naming the slice, healed by the next pass; a rotten cold block
   (``tier.fault`` corrupt) quarantined with no answer wrong; and
   ``check --deep`` over the stopped node's directory at 0 with a
   blob-tier verdict for every stub. Every answer equals the hot one
   and the host reference; wrong and failed answers are 0.
17. ``bench``: the benchmark of record, ``pilosa_tpu_torch.bench``, in
   this process at its default width and rows (16 pairs of 2^30-bit
   rows), with fewer chained dispatches (BENCH_ITERS); its line is the
   phase's line.

Phases 1 and 17 run alone on the card. Phases 11-16 run one after
another in a child process of this script (``--node-phases``) that
starts after phase 1, while phases 2-10 run here: the two halves share
the card and the host, so their host-clocked times (loads, cold and
warm query ms, a node's start) are taken beside each other's work; the
kernel table's times come from phase 1 alone. The child's lines are
printed after phase 10's, and each phase line's end, in seconds from
the script's start, goes to the standard error.

The kernel phases (2-8, the reopen of 10, the cluster's nodes until its
routed pass and the integrity, gossip, operator and resize phases'
nodes) pin every
device leg
(``_pinned``: ``mesh_min_slices=1`` and a cost model that vetoes
nothing), as the tests pin it, so the calibrated routing cannot move
their launches to the host. Every answer of phases 2-5 and 8 is held to
the host roaring answer computed from the port's own fragments, every
answer of phase 6 to numpy, of phase 7 to numpy or to words packed on
the host, of phases 9, 11, 12, 13, 14, 15 and 16 to host roaring or numpy,
and every count of phase 17 to the host ``popcnt_and``. The kernels' launch
counters are set to 0 before phase 2, before phase 6, before phase 7,
before phase 8, before phase 9 and before phase 10's reopen, and read
after phases 5 to 17 (each cluster node's from its
own process, and every node that owns slices must have launched the
expression count, densify and the TopN block count; the integrity
phase's nodes the expression count and densify, the repaired node again
after its repair; each gossip node of its first life all three; the
operator phase's card nodes all three; the resize phase's joiner the
expression count and densify on its moved slices; the tier phase's node
the expression count and densify on demoted and on fetched slices and
the TopN block count after the fetch): every kernel must have
launched on that main path,
the TopN block count in phase 4's device top-k, the TopN block count,
the expression count and densify in its sourced queries, the expression
count (every device Count(Range)), its batched entry (every Sum) and
densify in phase 6, the expression-words kernel, the batched count and
the TopN block count in phase 7, again in the server phase by itself and
again after phase 10's reopen, and the op count in phase 17. Then it
prints the card's name and power limit, the kernel table as one JSON
object, and as its last line
``{"ok": true, "device": {...}}``. Any mismatch or
error exits non-zero before that line. Without a card it exits 1 and
prints no result. ``--phase cluster``, ``--phase integrity``,
``--phase gossip``, ``--phase operator``, ``--phase resize`` or
``--phase tier`` builds
the kernels and runs
that phase alone: its
line and the card's name, no kernel table and no last line.
"""

from __future__ import annotations

import argparse
import datetime as dt
import json
import os
import shutil
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
BENCH_WORDS = 1 << 25      # words of a benchmark row (2^30 bits)
BENCH_ITERS = 64           # chained dispatches a trial in the bench phase
_EPOCH = dt.datetime(2017, 1, 1)  # the time phase's data starts here
_UNIX = dt.datetime(1970, 1, 1)
_PB = "application/x-protobuf"


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.time()  # the script's start; a child mode takes its parent's


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)
    if "phase" in obj:
        print(f"chip_smoke: {obj['phase']} line at"
              f" {time.time() - _T0:.1f} s", file=sys.stderr, flush=True)


def _pinned() -> dict:
    """Executor arguments that pin every device leg, as the tests pin
    them: the slice floor at one and a cost model that vetoes nothing
    (margin 0). The kernel phases run with them, so the calibrated
    routing cannot move their launches to the host."""
    from pilosa_tpu_torch.parallel import costmodel
    return {"mesh_min_slices": 1, "cost_model": costmodel.pinned(0.0)}


def _check_equal(name: str, got, want) -> int:
    """Max abs difference of kernel and plain results; fails unless 0
    (the results are integers)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        _fail(f"{name}: kernel gives {tuple(got.shape)} {got.dtype}, "
              f"plain {tuple(want.shape)} {want.dtype}")
    diff = int((got.long() - want.long()).abs().max().item()) \
        if got.numel() else 0
    if diff:
        _fail(f"{name}: kernel differs from its plain version "
              f"(max abs diff {diff})")
    return diff


def _rand_words(gen, shape, device):
    """Random int32-viewed u32 words (half of them with bit 31 set) and
    one all-ones word."""
    import torch
    w = torch.randint(-2**31, 2**31, shape, generator=gen,
                      dtype=torch.int64).to(torch.int32)
    w.view(-1)[0] = -1
    return w.to(device)


def _op_count_checks(device, seed: int) -> tuple[int, int]:
    """op_count_rows against its plain version, exact, at the shapes of
    the benchmark and the odd ones; returns (checks, max abs error)."""
    import torch
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.ops.kernel_ab import dev_words

    gen = torch.Generator(device=device).manual_seed(seed)
    W = BENCH_WORDS
    cases = [(op, (16, W)) for op in ("and", "or", "xor", "andnot")]
    cases += [("and", (1, W)), ("xor", (W + 3,)), ("or", (3, 4 * 8193 + 1)),
              ("andnot", (3, 4 * 8193 + 2)), ("xor", (3, 4 * 8193 + 3)),
              ("and", (5, 37)), ("andnot", (4, 3))]
    checks = err = 0
    for op, shape in cases:
        a, b = dev_words(gen, shape, device), dev_words(gen, shape, device)
        err = max(err, _check_equal(f"op_count_rows[{op} {list(shape)}]",
                                    ck.op_count_rows(op, a, b),
                                    ck.op_count_rows_torch(op, a, b)))
        checks += 1
        del a, b
    for word in (-1, -2**31):  # all-ones words, bit-31 words
        a = torch.full((4, 4099), word, dtype=torch.int32, device=device)
        for op in ("and", "andnot"):
            err = max(err, _check_equal(f"op_count_rows[{op} {word:#x}]",
                                        ck.op_count_rows(op, a, a),
                                        ck.op_count_rows_torch(op, a, a)))
            checks += 1
    base = dev_words(gen, (2, 8 * 1001 + 4), device)  # rows on the grid
    for off in (1, 2, 3):  # views at 4, 8 and 12 bytes past the grid
        a = base[0, off:off + 8 * 1001].view(8, 1001)
        b = base[1, off:off + 8 * 1001].view(8, 1001)
        err = max(err, _check_equal(f"op_count_rows[offset {off}]",
                                    ck.op_count_rows("xor", a, b),
                                    ck.op_count_rows_torch("xor", a, b)))
        checks += 1
    try:
        ck.op_count_rows("and", base[0, 1:9], base[0, 2:10])
    except ValueError:
        checks += 1
    else:
        _fail("op_count_rows: operands at different 16-byte offsets "
              "neither counted nor refused")
    return checks, err


def _fold(op, n):
    e = ("leaf", 0)
    for i in range(1, n):
        e = (op, e, ("leaf", i))
    return e


def _balanced(lo, hi, ops):
    if hi - lo == 1:
        return ("leaf", lo)
    mid = (lo + hi) // 2
    return (ops[(lo * 7 + hi) % len(ops)], _balanced(lo, mid, ops),
            _balanced(mid, hi, ops))


def _filtered_exprs(k):
    """K programs over one leaf set, each a leaf ∧ leaf 0: a filtered
    Sum's shape (leaf 0 the filter, leaf 1+i plane i)."""
    return tuple(("and", ("leaf", 1 + i), ("leaf", 0)) for i in range(k))


def _dirty_check(name, out_shape, call, want, device) -> int:
    """``call()`` once to warm the wrapper's caches, then again into
    memory that ``torch.empty`` hands back dirty (a freed all-ones tensor
    of the output's size): one launch, and exactly ``want``."""
    import torch
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    call()
    junk = torch.full(out_shape, -1, dtype=torch.int32, device=device)
    del junk
    before = ck.LAUNCHES[name]
    got = call()
    if ck.LAUNCHES[name] != before + 1:
        _fail(f"{name}: {ck.LAUNCHES[name] - before} launches for one call")
    return _check_equal(f"{name}[dirty output {list(out_shape)}]", got,
                        want)


def phase_kernels(device, seed: int, w_serving: int = 32768) -> dict:
    """Each kernel equal to its plain version on the card; times at the
    main path's shapes (rows of ``w_serving`` words)."""
    import numpy as np
    import torch
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.ops import timing
    from pilosa_tpu_torch.ops.kernel_ab import (dev_words, odd_slots,
                                                sparse_slots)

    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    W = w_serving
    checks = 0
    err = dict.fromkeys(ck.LAUNCHES, 0)

    # expr_count_rows: serving shapes, odd shapes, wide trees.
    ops4 = ["and", "or", "xor", "andnot"]
    exprs = {
        "intersect": ("and", ("leaf", 0), ("leaf", 1)),
        "mixed": ("or", ("and", ("leaf", 0), ("leaf", 1)),
                  ("andnot", ("xor", ("leaf", 2), ("leaf", 0)),
                   ("leaf", 1))),
        "union8": _fold("or", 8),
        "mixed64": _balanced(0, 64, ops4),
        "union1000": _fold("or", 1000),
        "spill256": _balanced(0, 256, ops4),  # 7 spill slots
    }
    cases = [("intersect", 2, 256, W), ("union8", 8, 256, W),
             ("mixed", 3, 9, 2048), ("mixed64", 64, 16, 2048),
             ("union1000", 1000, 4, 2048), ("intersect", 2, 1, W),
             ("mixed", 3, 10, W), ("mixed", 3, 7, 4),
             ("spill256", 256, 3, 2048)]
    for name, n_leaves, s, w in cases:
        leaves = _rand_words(gen, (n_leaves, s, w), device)
        err["expr_count_rows"] = max(err["expr_count_rows"], _check_equal(
            f"expr_count_rows[{name} {s}x{w}]",
            ck.expr_count_rows(exprs[name], leaves),
            ck.expr_count_rows_torch(exprs[name], leaves)))
        checks += 1

    # topn_block_count: resident serving shape, odd shape, no expr; the
    # sourceless device top-k (no expression, 163 candidates) and the
    # Tanimoto refetch (an Intersect of two leaves) at 10 slices.
    for s, r, w, expr, n_leaves in ((10, 200, W, ("leaf", 0), 1),
                                    (9, 5, 2048, exprs["mixed"], 3),
                                    (9, 5, 2048, None, 0),
                                    (10, 163, W, None, 0),
                                    (10, 131, W, exprs["intersect"], 2),
                                    (4, 3, 2048, exprs["union1000"], 1000)):
        rows = _rand_words(gen, (s, r, w), device)
        leaves = list(_rand_words(gen, (max(n_leaves, 1), s, w),
                                  device))[:n_leaves]
        err["topn_block_count"] = max(err["topn_block_count"], _check_equal(
            f"topn_block_count[{s}x{r}x{w}]",
            ck.topn_block_count(expr, rows, leaves),
            ck.topn_block_count_torch(expr, rows, leaves)))
        checks += 1

    # densify: serving shape (256 slices, sparse leaf rows), odd shapes
    # through the host bucketing, then slots built directly for any G.
    slot_sets = []
    for t, per_row, w in ((256, W // 128, W), (11, 300, 2048),
                          (11, 0, 2048)):
        slot_sets.append((f"{t}x{w} bucketed",)
                         + sparse_slots(rng, t, per_row, w) + (w,))
    for t, subs, g, empty in ((5, 33, 1, ()), (3, 47, 8, (1,)),
                              (3, 47, 32, (2,)), (2, 16, 40, ()),
                              (4, 16, 0, ()), (2, 1, 32, (1,))):
        slot_sets.append((f"{t}x{subs}x{g}",)
                         + odd_slots(rng, t, subs, g, empty)
                         + (subs * 128,))
    for name, lanes, vals, w in slot_sets:
        lane = torch.from_numpy(lanes.view(np.int32)).to(device)
        val = torch.from_numpy(vals.view(np.int32)).to(device)
        err["densify"] = max(err["densify"], _check_equal(
            f"densify[{name}]", ck.densify(lane, val, w),
            ck.densify_torch(lane, val, w)))
        checks += 1

    # The BSI comparison folds of the fields phase: depth 21 at the
    # serving shape (22 planes of 256 slices); "><" needs a spill slot.
    # The same folds as words (expr_words, the materializing Range).
    from pilosa_tpu_torch.storage import bsi
    planes = _rand_words(gen, (22, 256, W), device)
    for op, upred in (("<", 1_123_456), (">=", 654_321), ("==", 999_999),
                      ("!=", 5), ("><", (333_333, 1_500_000))):
        expr = bsi.compare_fold_expr(
            op, upred, 21, lambda p: ("leaf", 0 if p == bsi.EXISTS_PLANE
                                      else p + 1))
        err["expr_count_rows"] = max(err["expr_count_rows"], _check_equal(
            f"expr_count_rows[bsi {op} 256x{W}]",
            ck.expr_count_rows(expr, planes),
            ck.expr_count_rows_torch(expr, planes)))
        err["expr_words"] = max(err["expr_words"], _check_equal(
            f"expr_words[bsi {op} 256x{W}]", ck.expr_words(expr, planes),
            ck.expr_words_torch(expr, planes)))
        checks += 2

    # The batched count: K = 1, 2 and 16 programs over the planes, each
    # reading leaf 0 (a filter), then K = 16 into a dirty output.
    for k in (1, 2, 16):
        batch = _filtered_exprs(k)
        err["expr_count_batch"] = max(err["expr_count_batch"], _check_equal(
            f"expr_count_batch[K={k} 256x{W}]",
            ck.expr_count_batch(batch, planes),
            ck.expr_count_batch_torch(batch, planes)))
        checks += 1
    err["expr_count_batch"] = max(err["expr_count_batch"], _dirty_check(
        "expr_count_batch", (16, 256),
        lambda: ck.expr_count_batch(batch, planes),
        ck.expr_count_batch_torch(batch, planes), device))
    checks += 1
    del planes

    # expr_words: configuration 2's one slice row of a 1000-leaf Union
    # (the leaf-split fold; a program longer than the kernel stages),
    # the other flat folds there (an Intersect of 9, a Difference of
    # 1000, a Xor of 1100: past the staged instructions), a flat fold
    # whose last CTA is part full, configuration 4's 16-row Union over
    # 256 slices (then into a dirty output), a tree that needs spill
    # slots, W = 4.
    folds = {"union": "or", "intersect": "and", "difference": "andnot",
             "xor": "xor"}
    for name, n_leaves, s, w in (("union1000", 1000, 1, W),
                                 ("intersect9", 9, 1, W),
                                 ("difference1000", 1000, 1, W),
                                 ("xor1100", 1100, 1, W),
                                 ("union20", 20, 3, 2052),
                                 ("union16", 16, 256, W),
                                 ("spill256", 256, 3, 2048),
                                 ("mixed", 3, 7, 4)):
        fold = folds.get(name.rstrip("0123456789"))
        expr = _fold(fold, n_leaves) if fold else exprs[name]
        leaves = _rand_words(gen, (n_leaves, s, w), device)
        want = ck.expr_words_torch(expr, leaves)
        err["expr_words"] = max(err["expr_words"], _check_equal(
            f"expr_words[{name} {s}x{w}]", ck.expr_words(expr, leaves),
            want))
        checks += 1
        if name == "union16":
            err["expr_words"] = max(err["expr_words"], _dirty_check(
                "expr_words", (256, W),
                lambda: ck.expr_words(expr, leaves), want, device))
            checks += 1
        del leaves, want

    # Both redesigned kernels into dirty memory: nothing relies on a
    # memset.
    leaves = _rand_words(gen, (2, 256, W), device)
    want = ck.expr_count_rows_torch(exprs["intersect"], leaves)
    err["expr_count_rows"] = max(err["expr_count_rows"], _dirty_check(
        "expr_count_rows", (256,),
        lambda: ck.expr_count_rows(exprs["intersect"], leaves), want,
        device))
    lanes, vals = odd_slots(rng, 3, 47, 32, (2,))
    lane = torch.from_numpy(lanes.view(np.int32)).to(device)
    val = torch.from_numpy(vals.view(np.int32)).to(device)
    want = ck.densify_torch(lane, val, 47 * 128)
    err["densify"] = max(err["densify"], _dirty_check(
        "densify", (3, 47 * 128), lambda: ck.densify(lane, val, 47 * 128),
        want, device))
    checks += 2
    del leaves, want

    n, err["op_count_rows"] = _op_count_checks(device, seed)
    checks += n

    # Times at the shapes of the main path.
    copies = 4
    inter = [(exprs["intersect"], _rand_words(gen, (2, 256, W), device))
             for _ in range(copies)]
    ec_bytes = 2 * 256 * W * 4 + 256 * 4
    rows_sets = [(("leaf", 0), _rand_words(gen, (10, 200, W), device),
                  [_rand_words(gen, (10, W), device)]) for _ in range(2)]
    tb_bytes = 10 * 200 * W * 4 + 10 * W * 4 + 10 * 200 * 4
    lanes, vals = sparse_slots(rng, 256, W // 128, W)
    dens = [(torch.from_numpy(lanes.view(np.int32)).to(device),
             torch.from_numpy(vals.view(np.int32)).to(device), W)
            for _ in range(copies)]
    de_bytes = lanes.size * 8 + 256 * W * 4
    gen_dev = torch.Generator(device=device).manual_seed(seed + 3)
    bench_ops = [("and", dev_words(gen_dev, (16, BENCH_WORDS), device),
                  dev_words(gen_dev, (16, BENCH_WORDS), device))]
    oc_bytes = 2 * 16 * BENCH_WORDS * 4 + 16 * 4
    long_row = [("and", dev_words(gen_dev, (1, BENCH_WORDS), device),
                 dev_words(gen_dev, (1, BENCH_WORDS), device))]
    lr_bytes = 2 * BENCH_WORDS * 4 + 4
    words_sets = [(_fold("or", 16), _rand_words(gen, (16, 256, W), device))
                  for _ in range(2)]
    ew_bytes = 17 * 256 * W * 4
    c2_sets = [(_fold("or", 1000), _rand_words(gen, (1000, 1, W), device))
               for _ in range(2)]
    c2_bytes = 1001 * W * 4
    sum_exprs = _filtered_exprs(22)
    sum_sets = [(sum_exprs, _rand_words(gen, (23, 256, W), device))
                for _ in range(2)]
    eb_bytes = 23 * 256 * W * 4 + 22 * 256 * 4
    err["expr_count_batch"] = max(err["expr_count_batch"], _check_equal(
        f"expr_count_batch[K=22 256x{W}]",
        ck.expr_count_batch(*sum_sets[0]),
        ck.expr_count_batch_torch(*sum_sets[0])))
    checks += 1

    def times(kern, plain, args, iters, launches):
        try:
            prof_ms, prof_names = timing.profiler_ms(kern, args)
        except Exception as e:  # the profiler is a cross-check only
            prof_ms, prof_names = None, [f"profiler failed: {e}"[:200]]
        return {"ms": timing.graph_ms(kern, args, launches),
                "call_ms": timing.events_ms(kern, args, iters),
                "profiler_ms": prof_ms, "profiler_kernels": prof_names,
                "plain_ms": timing.events_ms(plain, args,
                                             max(3, iters // 20),
                                             warmup=1)}

    table = []
    for name, src, rep, kern, plain, args, nbytes, iters, launches, shape in (
            ("expr_count_rows", "pilosa_tpu_torch/ops/csrc/expr_count.cu",
             "pilosa_tpu/ops/pallas_kernels.py:143", ck.expr_count_rows,
             ck.expr_count_rows_torch, inter, ec_bytes, 200, 20,
             f"Count(Intersect): leaves [2, 256, {W}]"),
            ("topn_block_count",
             "pilosa_tpu_torch/ops/csrc/topn_block_count.cu",
             "pilosa_tpu/ops/pallas_kernels.py:210", ck.topn_block_count,
             ck.topn_block_count_torch, rows_sets, tb_bytes, 50, 20,
             f"resident TopN: rows [10, 200, {W}], 1 leaf"),
            ("densify", "pilosa_tpu_torch/ops/csrc/densify.cu",
             "pilosa_tpu/ops/pallas_kernels.py:323", ck.densify,
             ck.densify_torch, dens, de_bytes, 200, 20,
             f"leaf slab upload: slots {list(lanes.shape)}"),
            ("op_count_rows", "pilosa_tpu_torch/ops/csrc/op_count.cu",
             "pilosa_tpu/ops/pallas_kernels.py:86", ck.op_count_rows,
             ck.op_count_rows_torch, bench_ops, oc_bytes, 20, 4,
             f"bench of record: a, b [16, {BENCH_WORDS}]"),
            ("expr_words", "pilosa_tpu_torch/ops/csrc/expr_words.cu",
             "pilosa_tpu/parallel/programs.py:265", ck.expr_words,
             ck.expr_words_torch, words_sets, ew_bytes, 50, 10,
             f"configuration 4's bitmap Union: leaves [16, 256, {W}]"),
            ("expr_count_batch", "pilosa_tpu_torch/ops/csrc/expr_count.cu",
             "pilosa_tpu/parallel/mesh.py:627", ck.expr_count_batch,
             ck.expr_count_batch_torch, sum_sets, eb_bytes, 50, 10,
             f"filtered Sum: K = 22 over leaves [23, 256, {W}]")):
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": 0, "max_abs_err": err[name],
            **times(kern, plain, args, iters, launches),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None, "shape": shape,
            "bytes": nbytes})
    table[2].update(_densify_library(dens, W, device))
    keys = ("name", "shape", "ms", "call_ms", "profiler_ms", "plain_ms",
            "bound_ms", "library_ms")
    timings = [{k: e[k] for k in keys} for e in table]
    lr = times(ck.op_count_rows, ck.op_count_rows_torch, long_row, 50, 10)
    timings.append({
        "name": "op_count_rows",
        "shape": f"one long row: a, b [1, {BENCH_WORDS}]",
        **{k: lr[k] for k in ("ms", "call_ms", "profiler_ms", "plain_ms")},
        "bound_ms": lr_bytes / HBM_BYTES_PER_S * 1e3, "library_ms": None})
    c2 = times(ck.expr_words, ck.expr_words_torch, c2_sets, 50, 10)
    timings.append({
        "name": "expr_words",
        "shape": f"configuration 2's Union: leaves [1000, 1, {W}]",
        **{k: c2[k] for k in ("ms", "call_ms", "profiler_ms", "plain_ms")},
        "bound_ms": c2_bytes / HBM_BYTES_PER_S * 1e3, "library_ms": None})
    _emit({"phase": "kernels", "checks": checks, "exact": True,
           "library_ms": "null for the expression count, its batched "
                         "entry, the TopN block count and the op count: "
                         "no single PyTorch call computes them (torch has "
                         "no popcount op); null for expr_words: torch has "
                         "no fused n-ary bitwise fold; densify: "
                         "torch.zeros + scatter_add_ on the same slots "
                         "(lane indices built outside the timed region)",
           "densify_library_shape": table[2]["library_shape"],
           "timings": timings})
    return {e["name"]: e for e in table}


def _densify_library(dens, n_words, device) -> dict:
    """densify's yardstick: ``torch.zeros`` of the ``[T, subs, 128]``
    output, then ``scatter_add_`` of the slots' values at their lanes —
    the same words on every slot set bucket_prepared builds (each set
    word has exactly one slot, padding slots hold 0), held to densify's
    words first. The int64 lane indices are built outside the timed
    region."""
    import torch
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.ops import timing

    t_rows, subs, _ = dens[0][0].shape
    lib_args = [((lane & (ck.DENSIFY_LANES - 1)).long(), val)
                for lane, val, _ in dens]

    def library(lane_i64, val):
        out = torch.zeros((t_rows, subs, ck.DENSIFY_LANES),
                          dtype=torch.int32, device=device)
        out.scatter_add_(2, lane_i64, val)
        return out.view(t_rows, n_words)

    saved = dict(ck.LAUNCHES)
    _check_equal("densify[scatter_add_ library]", library(*lib_args[0]),
                 ck.densify(*dens[0]))
    ck.LAUNCHES.update(saved)
    return {"library_ms": timing.graph_ms(library, lib_args, 20),
            "library_shape": f"torch.zeros([{t_rows}, {subs}, 128]) + "
                             f"scatter_add_(2, lane int64 {list(dens[0][0].shape)}, "
                             f"val int32)"}


def _timed_query(ex, index, q, slices=None):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ex.execute(index, q, slices)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _random_row(rng, n_cols, n_bits):
    import numpy as np
    return np.unique(rng.integers(0, n_cols, size=n_bits, dtype=np.uint64))


def _union(f, rows):
    out = f.row(rows[0])
    for r in rows[1:]:
        out = out.union(f.row(r))
    return out


def _count_queries() -> dict:
    """Phase 2's Count queries over index ``smoke``, frame ``f``."""
    u8 = ", ".join(f"Bitmap(rowID={r}, frame=f)" for r in range(1, 9))
    u16 = ", ".join(f"Bitmap(rowID={r}, frame=f)" for r in range(9, 17))
    queries = {
        "intersect": "Count(Intersect(Bitmap(rowID=1, frame=f),"
                     " Bitmap(rowID=2, frame=f)))",
        "union8": f"Count(Union({u8}))",
        "difference": f"Count(Difference(Union({u16}),"
                      " Bitmap(rowID=1, frame=f)))",
    }
    queries["all3"] = " ".join(queries[k] for k in
                               ("intersect", "union8", "difference"))
    return queries


def _count_wants(holder, n_slices: int) -> dict:
    """Host roaring answers of ``_count_queries`` from the holder's own
    fragments (no kernel code)."""
    frags = [holder.fragment("smoke", "f", "standard", s)
             for s in range(n_slices)]

    def host_count(fn):
        return sum(fn(f).count() for f in frags if f is not None)

    want = {
        "intersect": host_count(lambda f: f.row(1).intersect(f.row(2))),
        "union8": host_count(lambda f: _union(f, list(range(1, 9)))),
        "difference": host_count(
            lambda f: _union(f, list(range(9, 17))).difference(f.row(1))),
    }
    want["all3"] = [want["intersect"], want["union8"], want["difference"]]
    return want


def _topn_host_pairs(holder, n_slices: int, src_fn, ids) -> list:
    """Per-candidate exact counts of frame ``t`` against a source of
    frame ``src`` from host roaring, then count-descending, id-ascending
    (ids given: no n-trim)."""
    counts = dict.fromkeys(ids, 0)
    for s in range(n_slices):
        sf = holder.fragment("smoke_topn", "src", "standard", s)
        tf = holder.fragment("smoke_topn", "t", "standard", s)
        if sf is None or tf is None:
            continue
        srow = src_fn(sf)
        for rid in ids:
            counts[rid] += tf.row(rid).intersection_count(srow)
    return sorted(((r, c) for r, c in counts.items() if c > 0),
                  key=lambda p: (-p[1], p[0]))


def phase_count(holder, device, seed: int, n_slices: int = 256) -> dict:
    import numpy as np
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency

    n_cols = n_slices * SLICE_WIDTH
    rng = np.random.default_rng(seed + 1)
    t0 = time.perf_counter()
    frame = holder.create_index("smoke").create_frame("f")
    for row in range(1, 17):
        density = 64 if row <= 8 else 4096
        cols = _random_row(rng, n_cols, n_cols // density)
        frame.import_bits(np.full(len(cols), row, np.uint64), cols)
    load_s = time.perf_counter() - t0

    want = _count_wants(holder, n_slices)
    queries = _count_queries()
    ex = Executor(holder, device=device, **_pinned())
    results = []
    for name, q in queries.items():
        residency.device_cache().clear()
        torch.cuda.reset_peak_memory_stats(device)
        before = dict(ck.LAUNCHES)
        for state in ("cold", "warm"):
            out, ms = _timed_query(ex, "smoke", q)
            got = out if name == "all3" else out[0]
            expect = want[name]
            if got != expect:
                _fail(f"count {name} ({state}): device {got} != host "
                      f"{expect}")
            results.append({"query": name, "state": state, "ms": ms,
                            "answer": got})
        results[-1]["peak_mib"] = torch.cuda.max_memory_allocated(
            device) / 2**20
        results[-1]["launches"] = {k: ck.LAUNCHES[k] - before[k]
                                   for k in before}
    snap = residency.device_cache().snapshot()
    out = {"phase": "count", "slices": n_slices, "columns": n_cols,
           "load_s": load_s, "resident_mib": snap["usedBytes"] / 2**20,
           "queries": results, "launches": dict(ck.LAUNCHES)}
    _emit(out)
    return out


def phase_topn(holder, device, seed: int, n_slices: int = 10,
               n_rows: int = 1000, total_bits: int = 30_000_000
               ) -> tuple[dict, list]:
    """Returns the phase's line and the 200 resident candidates."""
    import numpy as np
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency

    n_cols = n_slices * SLICE_WIDTH
    rng = np.random.default_rng(seed + 2)
    t0 = time.perf_counter()
    idx = holder.create_index("smoke_topn")
    src = idx.create_frame("src")
    for row, density in ((1, 4), (2, 3)):
        cols = _random_row(rng, n_cols, n_cols // density)
        src.import_bits(np.full(len(cols), row, np.uint64), cols)
    t = idx.create_frame("t")
    zipf = 1.0 / np.arange(1, n_rows + 1)
    sizes = np.maximum(1, (zipf / zipf.sum() * total_bits).astype(np.int64))
    order = rng.permutation(n_rows)  # skew not aligned with row id
    t_bits = 0
    for rid in range(n_rows):
        cols = _random_row(rng, n_cols, int(sizes[order[rid]]))
        t_bits += len(cols)
        t.import_bits(np.full(len(cols), rid, np.uint64), cols)
    load_s = time.perf_counter() - t0

    def host_pairs(src_fn, ids):
        return _topn_host_pairs(holder, n_slices, src_fn, ids)

    ids200 = sorted(rng.choice(n_rows, size=min(200, n_rows),
                               replace=False).tolist())
    ids_all = list(range(n_rows))
    queries = [
        ("resident", f"TopN(Bitmap(rowID=1, frame=src), frame=t, n=100,"
                     f" ids={ids200})",
         host_pairs(lambda f: f.row(1), ids200)),
        ("streaming", "TopN(Intersect(Bitmap(rowID=1, frame=src),"
                      " Bitmap(rowID=2, frame=src)), frame=t, n=1000,"
                      f" ids={ids_all})",
         host_pairs(lambda f: f.row(1).intersect(f.row(2)), ids_all)),
    ]
    ex = Executor(holder, device=device, **_pinned())
    results = []
    for name, q, want in queries:
        residency.device_cache().clear()
        torch.cuda.reset_peak_memory_stats(device)
        before = dict(ck.LAUNCHES)
        for state in ("cold", "warm"):
            out, ms = _timed_query(ex, "smoke_topn", q)
            got = [(p.id, p.count) for p in out[0]]
            if got != want:
                _fail(f"topn {name} ({state}): device pairs differ from "
                      f"host (first device {got[:3]}, host {want[:3]})")
            results.append({"query": name, "state": state, "ms": ms,
                            "pairs": len(got), "top": got[:3]})
        results[-1]["peak_mib"] = torch.cuda.max_memory_allocated(
            device) / 2**20
        results[-1]["launches"] = {k: ck.LAUNCHES[k] - before[k]
                                   for k in before}
    out = {"phase": "topn", "slices": n_slices, "columns": n_cols,
           "t_rows": n_rows, "t_bits": t_bits, "load_s": load_s,
           "queries": results, "launches": dict(ck.LAUNCHES)}
    _emit(out)
    return out, ids200


def _build_topn1000_frames(holder, n_rows: int, n_slices: int) -> int:
    """BASELINE configuration 3's frame, made as the JAX suite makes it
    (benchmarks/suite.py _build_topn_frame, ``default_rng(33)``): rows
    0-1999 at counts 1000 down to 21, the rest at 4 bits each, columns
    uniform over ``n_slices`` slices, imported in 20 slice-grouped
    batches — into frame ``f`` (LRU cache, the default) and frame
    ``fr`` (``cacheType=ranked``) of index ``t3``. Returns the bits a
    frame holds."""
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.models.frame import FrameOptions

    rng = np.random.default_rng(33)
    idx = holder.create_index("t3")
    frames = [idx.create_frame("f"),
              idx.create_frame("fr", FrameOptions(cache_type="ranked"))]
    head = min(2000, n_rows)
    counts = np.concatenate([
        np.maximum(21, 1000 - np.arange(head)).astype(np.int64),
        np.full(n_rows - head, 4, dtype=np.int64)])
    rows = np.repeat(np.arange(n_rows, dtype=np.uint64), counts)
    cols = rng.integers(0, n_slices * SLICE_WIDTH, size=len(rows),
                        dtype=np.uint64)
    order = np.argsort(cols // np.uint64(SLICE_WIDTH), kind="stable")
    rows, cols = rows[order], cols[order]
    step = max(1, len(rows) // 20)
    for frame in frames:
        for i in range(0, len(rows), step):
            frame.import_bits(rows[i:i + step], cols[i:i + step])
    return int(counts.sum())


_ROW_SHIFT = 20  # log2(SLICE_WIDTH): a position's row is pos >> 20


def _slice_counts(frag):
    """{row: bit count} of one fragment, from its roaring positions."""
    import numpy as np
    pos = frag.storage.all_positions()
    rows, counts = np.unique(pos >> np.uint64(_ROW_SHIFT),
                             return_counts=True)
    return rows, counts


def _ref_topn(holder, index, frame, n_slices, n, src_cols=None,
              threshold=1, tanimoto=0):
    """Plain reference of ``TopN`` over the port's fragments, from
    roaring row counts, with the reference's two phases
    (executor.go:273-310, fragment.go:490-625): per slice, a walk of the
    rows in rank order (count descending, id ascending) that keeps the
    first n passing rows (all of them without a source) and, with a
    source, every later row whose source count reaches the smallest kept
    one, up to the first row whose own count falls below it; then the
    union's exact sums, each slice's contribution kept only where that
    slice's row count and intersection count pass the threshold (or the
    Tanimoto bounds, as integer inequalities), count descending, id
    ascending, trimmed to n. ``src_cols`` holds each slice's slice-local
    source columns. Returns (pairs, candidate union size)."""
    import numpy as np
    mask = np.uint64((1 << _ROW_SHIFT) - 1)
    cand: set = set()
    per_slice = []
    for s in range(n_slices):
        frag = holder.fragment(index, frame, "standard", s)
        if frag is None:
            continue
        pos = frag.storage.all_positions()
        rows, counts = np.unique(pos >> np.uint64(_ROW_SHIFT),
                                 return_counts=True)
        rc = dict(zip(rows.tolist(), counts.tolist()))
        inter, s_n = rc, 0
        if src_cols is not None:
            hit = pos[np.isin(pos & mask, src_cols[s])]
            irows, icounts = np.unique(hit >> np.uint64(_ROW_SHIFT),
                                       return_counts=True)
            inter = dict(zip(irows.tolist(), icounts.tolist()))
            s_n = len(src_cols[s])
        per_slice.append((rc, inter, s_n))
        order = np.lexsort((rows, -counts))
        kept: list = []  # (count, row)
        low = None  # the smallest kept count once n are kept: every
        # later keep is at least as large, so it stays the minimum
        for rid, cnt in zip(rows[order].tolist(), counts[order].tolist()):
            if tanimoto:
                if not (100 * cnt > s_n * tanimoto
                        and cnt * tanimoto < 100 * s_n):
                    continue
            elif cnt < threshold:
                continue
            if not n or len(kept) < n:
                c = inter.get(rid, 0)
                if c == 0:
                    continue
                if tanimoto:
                    if 100 * c <= tanimoto * (cnt + s_n - c):
                        continue
                elif c < threshold:
                    continue
                kept.append((c, rid))
                if len(kept) == n and src_cols is None:
                    break
                continue
            if low is None:
                low = min(kept)[0]
            if low < threshold or cnt < low:
                break
            c = inter.get(rid, 0)
            if c >= low:
                kept.append((c, rid))
        cand.update(r for _, r in kept)
    totals = {}
    for rid in cand:
        tot = 0
        for rc, inter, s_n in per_slice:
            cnt, c = rc.get(rid, 0), inter.get(rid, 0)
            if tanimoto:
                keep = (100 * cnt > s_n * tanimoto
                        and cnt * tanimoto < 100 * s_n and c > 0
                        and 100 * c > tanimoto * (cnt + s_n - c))
            else:
                keep = cnt >= threshold and c >= threshold
            tot += c if keep else 0
        if tot > 0:
            totals[rid] = tot
    pairs = sorted(totals.items(), key=lambda p: (-p[1], p[0]))
    return (pairs[:n] if n else pairs), len(cand)


def phase_topn1000(holder, device, seed: int, n_rows: int = 100_000,
                   n_slices: int = 10, warm_runs: int = 5
                   ) -> tuple[dict, list]:
    """Every form of TopN at BASELINE configuration 3's full size
    (``t3``: 100,000 rows × 10 slices) and over phase 3's ``smoke_topn``
    index; each query cold (device cache empty) and warm (p50 of
    ``warm_runs``), every answer held to ``_ref_topn``. Returns the
    phase's line and the (name, index, query, answer) list that the
    server phase asks again over HTTP."""
    import numpy as np
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import mesh as mesh_mod
    from pilosa_tpu_torch.parallel import residency

    t_phase = t0 = time.perf_counter()
    t3_bits = _build_topn1000_frames(holder, n_rows, n_slices)
    # A sparse source row (1/4096) and four rows of t near its
    # intersection with row 1, so that a Tanimoto query answers pairs
    # and its source takes densify. Rows 0-999 of t stay as phase 3
    # made them.
    rng = np.random.default_rng(seed + 5)
    n_cols = n_slices * SLICE_WIDTH
    src = holder.frame("smoke_topn", "src")
    sparse = _random_row(rng, n_cols, n_cols // 4096)
    src.import_bits(np.full(len(sparse), 3, np.uint64), sparse)
    sim = np.concatenate([
        holder.fragment("smoke_topn", "src", "standard", s).row(1)
        .intersect(holder.fragment("smoke_topn", "src", "standard", s)
                   .row(3)).bits() for s in range(n_slices)])
    extra = _random_row(rng, n_cols, len(sim))
    near = [sim, np.delete(sim, np.arange(0, len(sim), 10)),
            np.union1d(sim, extra[:len(sim) // 10]),
            np.union1d(sim[::2], extra[:len(sim) // 2])]
    t = holder.frame("smoke_topn", "t")
    for i, cols in enumerate(near):
        t.import_bits(np.full(len(cols), 1000 + i, np.uint64),
                      cols.astype(np.uint64))
    load_s = time.perf_counter() - t0

    def src_cols(rows_of):
        out = []
        for s in range(n_slices):
            fr = holder.fragment("smoke_topn", "src", "standard", s)
            out.append(rows_of(fr).bits().astype(np.uint64)
                       % np.uint64(SLICE_WIDTH))
        return out

    row1 = src_cols(lambda f: f.row(1))
    inter13 = src_cols(lambda f: f.row(1).intersect(f.row(3)))
    # Query 3's n: the largest of these whose candidate union fits the
    # resident block budget, so that the refetch is the device top-k.
    row_bytes = n_slices * SLICE_WIDTH // 8
    for n3 in (50, 40, 30, 20, 10):
        want3, union3 = _ref_topn(holder, "t3", "fr", n_slices, n3)
        if union3 * row_bytes <= mesh_mod.TOPN_BLOCK_BYTES:
            break
    else:
        _fail(f"topn1000: no n gives a union under the block budget "
              f"({union3} rows at n=10)")
    want1, union1 = _ref_topn(holder, "t3", "f", n_slices, 1000)
    want2, union2 = _ref_topn(holder, "t3", "fr", n_slices, 1000)
    src1 = "Bitmap(rowID=1, frame=src)"
    tan_src = f"Intersect({src1}, Bitmap(rowID=3, frame=src))"
    want4, union4 = _ref_topn(holder, "smoke_topn", "t", n_slices, 100,
                              row1)
    want5, union5 = _ref_topn(holder, "smoke_topn", "t", n_slices, 100,
                              row1, threshold=3)
    want6, union6 = _ref_topn(holder, "smoke_topn", "t", n_slices, 10,
                              inter13, tanimoto=50)
    queries = [
        ("lru_n1000", "t3", "TopN(frame=f, n=1000)", want1, union1),
        ("ranked_n1000", "t3", "TopN(frame=fr, n=1000)", want2, union2),
        (f"ranked_n{n3}", "t3", f"TopN(frame=fr, n={n3})", want3, union3),
        ("src", "smoke_topn", f"TopN({src1}, frame=t, n=100)", want4,
         union4),
        ("src_threshold3", "smoke_topn",
         f"TopN({src1}, frame=t, n=100, threshold=3)", want5, union5),
        ("tanimoto50", "smoke_topn",
         f"TopN({tan_src}, frame=t, n=10, tanimotoThreshold=50)", want6,
         union6),
    ]
    if not want6:
        _fail("topn1000: the Tanimoto reference answers no pair")
    ex = Executor(holder, device=device, **_pinned())
    results = []
    for name, index, q, want, union in queries:
        residency.device_cache().clear()
        torch.cuda.reset_peak_memory_stats(device)
        before = dict(ck.LAUNCHES)
        out, cold_ms = _timed_query(ex, index, q)
        warm = []
        for _ in range(warm_runs):
            out_w, ms = _timed_query(ex, index, q)
            warm.append(ms)
            if out_w != out:
                _fail(f"topn1000 {name}: warm answer differs from cold")
        got = [(p.id, p.count) for p in out[0]]
        if got != want:
            _fail(f"topn1000 {name}: pairs differ from the reference "
                  f"({len(got)} vs {len(want)}; first {got[:3]} vs "
                  f"{want[:3]})")
        launches = {k: ck.LAUNCHES[k] - before[k] for k in before}
        results.append({
            "query": name, "pql": q if len(q) < 120 else q[:117] + "...",
            "union": union, "pairs": len(got), "top": got[:3],
            "cold_ms": cold_ms, "warm_p50_ms": sorted(warm)[len(warm) // 2],
            "warm_ms": warm,
            "peak_mib": torch.cuda.max_memory_allocated(device) / 2**20,
            "launches": launches})
    by = {r["query"]: r for r in results}
    if by[f"ranked_n{n3}"]["launches"]["topn_block_count"] <= 0:
        _fail(f"topn1000: topn_block_count did not launch in "
              f"TopN(frame=fr, n={n3})")
    for name in ("topn_block_count", "expr_count_rows", "densify"):
        if sum(by[q]["launches"][name] for q in
               ("src", "src_threshold3", "tanimoto50")) <= 0:
            _fail(f"topn1000: {name} did not launch in the sourced "
                  "queries")
    out = {"phase": "topn1000", "rows": n_rows, "slices": n_slices,
           "columns": n_slices * SLICE_WIDTH, "t3_bits": t3_bits,
           "load_s": load_s, "phase_s": time.perf_counter() - t_phase,
           "n3": n3, "tanimoto_pairs": len(want6),
           "queries": results, "launches": dict(ck.LAUNCHES)}
    _emit(out)
    return out, [(name, index, q, want) for name, index, q, want, _ in
                 queries if name in ("lru_n1000", f"ranked_n{n3}",
                                     "tanimoto50")]


def _http(host: str, path: str, body: bytes, headers=None,
          method: str = "POST"):
    """One request with urllib; fails the run on any status but 200.
    Returns (body, client ms)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method=method, headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            out, status = resp.read(), resp.status
    except urllib.error.HTTPError as e:
        _fail(f"server: {method} {path}: HTTP {e.code}:"
              f" {e.read()[:300]!r}")
    ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        _fail(f"server: {method} {path}: HTTP {status}")
    return out, ms


def _answer_of(kind: str, r):
    """Canonical form of one call's result ``r``: the executor's result,
    a JSON result or a protobuf ``QueryResult``."""
    if hasattr(r, "Pairs"):  # protobuf
        if kind == "count":
            return r.N
        if kind == "valcount":
            return (r.ValCount.Val, r.ValCount.Count)
        if kind == "topn":
            return [(p.Key, p.Count) for p in r.Pairs]
        return r.Bitmap.Bits.tolist()
    if kind == "count":
        return r
    if kind == "valcount":
        return ((r["value"], r["count"]) if isinstance(r, dict)
                else (r.value, r.count))
    if kind == "topn":
        return [(p["id"], p["count"]) if isinstance(p, dict)
                else (p.id, p.count) for p in r]
    return r["bits"] if isinstance(r, dict) else r.bits().tolist()


def phase_server(data_dir, device, seed: int, ids200: list,
                 topn1000=(), fields=(), n_slices: int = 256,
                 n_topn_slices: int = 10) -> dict:
    """The port's server on the card over phases 2-7's directory,
    driven over HTTP; every answer held to the host roaring answer from
    the server's own fragments, each (name, index, query, answer) of
    ``topn1000`` to the answer it gave through the executor in phase 4
    (the reopened ``.cache`` sidecars rank its frames), and each (name,
    index, query, kind, answer) of ``fields`` to phase 6's numpy answer
    (the first JSON ask cold, the rest warm). Then the field routes: a
    new field of ``b4/v``, its values through the protobuf field import,
    a Sum and a Count(Range) over it against numpy, and a time quantum
    set by ``PATCH`` on ``tv/inv`` followed by a timestamped SetBit and
    a Range over it."""
    import numpy as np
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency
    from pilosa_tpu_torch.proto import internal as pb
    from pilosa_tpu_torch.proto import rawimport
    from pilosa_tpu_torch.server.server import Server
    from pilosa_tpu_torch.storage import native_ext

    PB = "application/x-protobuf"
    rng = np.random.default_rng(seed + 4)
    t0 = time.perf_counter()
    srv = Server(data_dir, host="127.0.0.1:0", device=device,
                 warmup=False, executor_options=_pinned())
    srv.open()
    open_s = time.perf_counter() - t0
    try:
        host = srv.host
        holder = srv.holder
        # Writes over HTTP: frame g, row 1 of g at 1/64 as raw v2
        # positions, row 2 at 1/4096 as protobuf ImportRequests.
        _http(host, "/index/smoke/frame/g", b"{}")
        t0 = time.perf_counter()
        raw_bytes = 0
        for s in range(n_slices):
            cols = np.unique(rng.integers(0, SLICE_WIDTH,
                                          size=SLICE_WIDTH // 64,
                                          dtype=np.uint64))
            body = rawimport.encode_positions(
                "smoke", "g", s, np.uint64(SLICE_WIDTH) + cols)
            raw_bytes += len(body)
            _http(host, "/import", body,
                  {"Content-Type": rawimport.CONTENT_TYPE, "Accept": PB})
        raw_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pb_bytes = 0
        for s in range(n_slices):
            cols = np.unique(rng.integers(0, SLICE_WIDTH,
                                          size=SLICE_WIDTH // 4096,
                                          dtype=np.uint64))
            body = pb.ImportRequest(
                Index="smoke", Frame="g", Slice=s,
                RowIDs=np.full(len(cols), 2, np.uint64),
                ColumnIDs=cols + np.uint64(s * SLICE_WIDTH)
            ).SerializeToString()
            pb_bytes += len(body)
            _http(host, "/import", body,
                  {"Content-Type": PB, "Accept": PB})
        pb_s = time.perf_counter() - t0
        # Attributes: a category on each resident TopN candidate (one
        # query of SetRowAttrs calls), a tag on three columns of row 9.
        _http(host, "/index/smoke_topn/query", " ".join(
            f"SetRowAttrs(frame=t, rowID={r}, category={r % 3})"
            for r in ids200).encode())
        f0 = holder.fragment("smoke", "f", "standard", 0)
        tagged = f0.row(9).bits()[:3].tolist()
        _http(host, "/index/smoke/query", " ".join(
            f'SetColumnAttrs(id={c}, tag="c{i}")'
            for i, c in enumerate(tagged)).encode())

        # Host answers from the server's own fragments.
        want = _count_wants(holder, n_slices)
        queries = {k: ("smoke", q, "count")
                   for k, q in _count_queries().items()}
        fg = [(holder.fragment("smoke", "f", "standard", s),
               holder.fragment("smoke", "g", "standard", s))
              for s in range(n_slices)]
        queries["g_intersect"] = (
            "smoke", "Count(Intersect(Bitmap(rowID=1, frame=g),"
                     " Bitmap(rowID=2, frame=g)))", "count")
        want["g_intersect"] = sum(g.row(1).intersect(g.row(2)).count()
                                  for _, g in fg)
        queries["g_union_sparse"] = (
            "smoke", "Count(Union(Bitmap(rowID=2, frame=g),"
                     " Bitmap(rowID=9, frame=f)))", "count")
        want["g_union_sparse"] = sum(g.row(2).union(f.row(9)).count()
                                     for f, g in fg)
        pairs = _topn_host_pairs(holder, n_topn_slices,
                                 lambda f: f.row(1), ids200)
        topn = (f"TopN(Bitmap(rowID=1, frame=src), frame=t, n=100,"
                f" ids={ids200})")
        queries["topn"] = ("smoke_topn", topn, "topn")
        want["topn"] = pairs
        queries["topn_filtered"] = (
            "smoke_topn", topn[:-1] + ', field="category", filters=[0, 1])',
            "topn")
        want["topn_filtered"] = [p for p in pairs if p[0] % 3 in (0, 1)]
        queries["bitmap_column_attrs"] = ("smoke", "Bitmap(rowID=9, frame=f)",
                                          "bitmap")
        want["bitmap_column_attrs"] = np.concatenate(
            [f.row(9).bits() for f, _ in fg]).tolist()
        want_attr_sets = [(c, {"tag": f"c{i}"}) for i, c in
                          enumerate(tagged)]
        for name, index, q, answer in topn1000:
            queries[f"topn1000_{name}"] = (index, q, "topn")
            want[f"topn1000_{name}"] = answer
        warm_from_json = set()
        for name, index, q, kind, answer in fields:
            queries[f"fields_{name}"] = (index, q, kind)
            want[f"fields_{name}"] = answer
            warm_from_json.add(f"fields_{name}")

        results = []
        for name, (index, q, kind) in queries.items():
            expect = want[name]
            n_calls = 3 if name == "all3" else 1
            path = f"/index/{index}/query"
            if name == "bitmap_column_attrs":
                path += "?columnAttrs=true"
            entry = {"query": name, "index": index}
            for fmt in ("json", "protobuf"):
                headers = {"Accept": PB} if fmt == "protobuf" else {}
                if name not in warm_from_json:
                    residency.device_cache().clear()
                for state in ("cold", "warm"):
                    body, ms = _http(host, path, q.encode(), headers)
                    if fmt == "json":
                        doc = json.loads(body)
                        got = [_answer_of(kind, r) for r in doc["results"]]
                        sets = [(c["id"], c.get("attrs", {}))
                                for c in doc.get("columnAttrs", [])]
                    else:
                        resp = pb.QueryResponse.FromString(body)
                        if resp.Err:
                            _fail(f"server {name}: {resp.Err}")
                        got = [_answer_of(kind, r) for r in resp.Results]
                        sets = [(c.ID, {a.Key: a.StringValue
                                        for a in c.Attrs})
                                for c in resp.ColumnAttrSets]
                    got = got if n_calls > 1 else got[0]
                    if got != expect:
                        _fail(f"server {name} ({fmt}, {state}): HTTP answer"
                              f" differs from host ({str(got)[:120]} vs"
                              f" {str(expect)[:120]})")
                    if (name == "bitmap_column_attrs"
                            and sets != want_attr_sets):
                        _fail(f"server {name} ({fmt}): columnAttrs {sets}"
                              f" != {want_attr_sets}")
                    entry[f"{state}_{fmt}_ms"] = ms
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = srv.executor.execute(index, q)
            torch.cuda.synchronize()
            entry["executor_ms"] = (time.perf_counter() - t0) * 1e3
            got = [_answer_of(kind, r) for r in out]
            if (got if n_calls > 1 else got[0]) != expect:
                _fail(f"server {name}: executor answer differs from host")
            entry["front_ms"] = entry["warm_json_ms"] - entry["executor_ms"]
            results.append(entry)
        if fields:
            results += _server_field_routes(host, rng)
        pipeline, acked = _server_pipeline(srv, rng, n_slices)
    finally:
        srv.close()
    pipeline["acked_present_after_reopen"] = _check_acked_after_reopen(
        *acked)
    launches = dict(ck.LAUNCHES)
    for name in ("expr_count_rows", "topn_block_count", "densify"):
        if launches[name] <= 0:
            _fail(f"{name}: no launch in the server phase")
    out = {"phase": "server", "host": host, "device": str(device),
           "open_s": open_s, "raw_import_s": raw_s,
           "raw_import_bytes": raw_bytes, "pb_import_s": pb_s,
           "pb_import_bytes": pb_bytes, "queries": results,
           "pipeline": pipeline, "launches": launches}
    _emit(out)
    return out


def _server_field_routes(host: str, rng) -> list:
    """A new field over HTTP: create it, import its values with the
    protobuf field-import route (one ImportValueRequest a slice), then a
    Sum (JSON and protobuf) and a Count(Range) against numpy; and a time
    quantum set by PATCH, a timestamped SetBit and a Range over it."""
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.proto import internal as pb

    PB = "application/x-protobuf"
    out = []
    _http(host, "/index/b4/frame/v/field/score", b'{"min": 0, "max": 1000}')
    t0 = time.perf_counter()
    all_vals = []
    for s in range(4):
        cols = np.unique(rng.integers(0, SLICE_WIDTH, size=20_000,
                                      dtype=np.uint64))
        vals = rng.integers(0, 1001, size=len(cols))
        body = pb.ImportValueRequest(
            Index="b4", Frame="v", Field="score", Slice=s,
            ColumnIDs=cols + np.uint64(s * SLICE_WIDTH), Values=vals
        ).SerializeToString()
        _http(host, "/index/b4/frame/v/field/score/import", body,
              {"Content-Type": PB, "Accept": PB})
        all_vals.append(vals)
    vals = np.concatenate(all_vals)
    import_ms = (time.perf_counter() - t0) * 1e3
    checks = [("score_sum", "Sum(frame=v, field=score)", "valcount",
               (int(vals.sum()), len(vals))),
              ("score_count_gt", "Count(Range(frame=v, score > 500))",
               "count", int((vals > 500).sum()))]
    for name, q, kind, want in checks:
        for fmt, headers in (("json", {}), ("protobuf", {"Accept": PB})):
            body, ms = _http(host, "/index/b4/query", q.encode(), headers)
            if fmt == "json":
                got = _answer_of(kind, json.loads(body)["results"][0])
            else:
                got = _answer_of(kind, pb.QueryResponse.FromString(
                    body).Results[0])
            if got != want:
                _fail(f"server {name} ({fmt}): {got} != numpy {want}")
            out.append({"query": name, "format": fmt, "ms": ms,
                        "answer": want})
    out[0]["import_ms"] = import_ms
    _http(host, "/index/tv/frame/inv/time-quantum",
          b'{"timeQuantum": "YM"}', method="PATCH")
    _http(host, "/index/tv/query",
          b'SetBit(frame=inv, rowID=5, columnID=7,'
          b' timestamp="2017-05-06T07:08")')
    body, ms = _http(host, "/index/tv/query",
                     b'Count(Range(frame=inv, rowID=5,'
                     b' start="2017-05-01T00:00", end="2017-06-01T00:00"))')
    if json.loads(body)["results"] != [1]:
        _fail(f"server: Range over the patched time quantum gave {body!r}")
    out.append({"query": "patched_time_quantum_range", "ms": ms,
                "answer": 1})
    return out


def phase_planner(holder, device) -> dict:
    """The planner's decisions on the card, over ``t3`` (10 slices, at
    most EXACT_SLICES: the planner proves emptiness only when it
    enumerates every slice). A Count whose Intersect holds a
    proven-empty row beside a missing frame answers 0 with no launch;
    the same query over the 256 slices of ``smoke`` raises the missing
    frame, as the JAX package does; a Union with a proven-empty operand answers and
    launches what it does without that operand; a reordered Intersect
    answers what the planner-off executor and host roaring answer; a
    subtree repeated across three queries hits the subresult cache on
    every slice the third time. Every answer is held to host roaring.
    Last, what planning costs a warm query: ``TopN(frame=f, n=1000)``
    and a device Count, 20 runs each with the planner on and off in
    turns."""
    import numpy as np
    from pilosa_tpu_torch.errors import FrameNotFoundError
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency
    from pilosa_tpu_torch.plan.planner import EXACT_SLICES

    n_slices = holder.index("t3").max_slice() + 1
    if n_slices > EXACT_SLICES:
        _fail(f"planner: t3 has {n_slices} slices > {EXACT_SLICES}")
    frags = [holder.fragment("t3", "f", "standard", s)
             for s in range(n_slices)]
    empty = 200_000  # a row of t3/f with no bit
    if any(f.row_count(empty) for f in frags):
        _fail(f"planner: row {empty} of t3/f is not empty")
    ex = Executor(holder, device=device, **_pinned())
    plain = Executor(holder, device=device, **_pinned())
    plain.planner_enabled = False
    results = []

    def run(name, q, executor=ex):
        residency.device_cache().clear()
        before = dict(ck.LAUNCHES)
        out, ms = _timed_query(executor, "t3", q)
        rec = {"query": name, "pql": q, "ms": ms,
               "launches": {k: ck.LAUNCHES[k] - before[k] for k in before
                            if ck.LAUNCHES[k] != before[k]},
               "planner": executor.planner_enabled}
        if executor.planner_enabled:
            plan = ex.explain("t3", q)
            rec["decisions"] = plan.get("decisions", {})
            rec["plan"] = plan["calls"]
        results.append(rec)
        return out[0], rec

    def host(fn):
        out = None
        for f in frags:
            bm = fn(f)
            out = bm if out is None else out.union(bm)
        return out

    def bf(r):
        return f"Bitmap(rowID={r}, frame=f)"

    # A proven-empty row beside a missing frame: 0 and no launch at
    # ≤ EXACT_SLICES ...
    q32 = f"Count(Intersect({bf(empty)}, Bitmap(rowID=1, frame=nope)))"
    got, rec = run("empty_beside_missing_frame", q32)
    if got != 0 or rec["launches"] or \
            "short_circuit" not in rec["decisions"]:
        _fail(f"planner: the empty-beside-missing-frame Count gave "
              f"{got}, launches {rec['launches']}, decisions "
              f"{rec['decisions']}")
    # ... and the missing frame's error above it (no proof over 256).
    try:
        ex.execute("smoke", q32.replace(f"rowID={empty}", "rowID=999999"))
    except FrameNotFoundError as e:
        results.append({"query": "empty_beside_missing_frame_256_slices",
                        "error": str(e)})
    else:
        _fail("planner: the empty-beside-missing-frame Count answered"
              " over 256 slices")

    # A Union with a proven-empty operand, beside the same Union
    # without it.
    want1 = host(lambda f: f.row(1)).count()
    got_e, rec_e = run("union_with_empty",
                       f"Count(Union({bf(1)}, {bf(empty)}))")
    got_1, rec_1 = run("union_without", f"Count(Union({bf(1)}))")
    if not (got_e == got_1 == want1) or rec_e["launches"] != \
            rec_1["launches"]:
        _fail(f"planner: Union with an empty operand {got_e} with "
              f"launches {rec_e['launches']}, without {got_1} with "
              f"launches {rec_1['launches']}, host {want1}")
    if not rec_1["launches"]:
        _fail("planner: the Union launched no kernel")

    # A reordered Intersect: the larger row first.
    q_re = f"Count(Intersect({bf(0)}, {bf(1500)}))"
    want_re = host(lambda f: f.row(0).intersect(f.row(1500))).count()
    got_re, rec_re = run("reordered_intersect", q_re)
    got_off, _ = run("reordered_intersect_planner_off", q_re, plain)
    if got_re != want_re or got_off != want_re or \
            "reordered" not in rec_re["decisions"]:
        _fail(f"planner: reordered Intersect {got_re}, planner off "
              f"{got_off}, host {want_re}, decisions "
              f"{rec_re['decisions']}")

    # CSE: Intersect(0, 1) in three queries; the third hits per slice.
    # (No query repeats another whole: the bitmap-result cache would
    # answer it without a per-slice fold.)
    inter = f"Intersect({bf(0)}, {bf(1)})"
    cse = [("cse_first", f"Union({inter}, {bf(2)})",
            lambda f: f.row(0).intersect(f.row(1)).union(f.row(2))),
           ("cse_second", f"Difference({inter}, {bf(3)})",
            lambda f: f.row(0).intersect(f.row(1)).difference(f.row(3))),
           ("cse_third", f"Union({inter}, {bf(4)})",
            lambda f: f.row(0).intersect(f.row(1)).union(f.row(4)))]
    sub = ex.planner.subresults
    for name, q, fn in cse:
        hits0 = sub.hits
        got, rec = run(name, q)
        want = host(fn).bits().tolist()
        rec["subresult_hits"] = sub.hits - hits0
        if got.bits().tolist() != want:
            _fail(f"planner: {name} differs from host roaring")
    if results[-1]["subresult_hits"] != n_slices:
        _fail(f"planner: the third CSE query hit "
              f"{results[-1]['subresult_hits']} of {n_slices} slices")

    # What planning costs a warm query: the metric of record's TopN and
    # a device Count, planner on and off in turns (on/off, off/on, ...),
    # warm (device cache kept), the same answer both ways.
    overhead = []
    for name, q in (("topn_n1000", "TopN(frame=f, n=1000)"),
                    ("count_intersect", f"Count(Intersect({bf(0)}, "
                                        f"{bf(1)}))")):
        times = {True: [], False: []}
        answers = set()
        for i in range(21):
            for on in ((True, False) if i % 2 else (False, True)):
                ex.planner_enabled = on
                out, ms = _timed_query(ex, "t3", q)
                answers.add(repr(out))
                if i:  # the first round warms both
                    times[on].append(ms)
        ex.planner_enabled = True
        if len(answers) != 1:
            _fail(f"planner: {name} answers differ with the planner off")
        on_p50 = float(np.median(times[True]))
        off_p50 = float(np.median(times[False]))
        overhead.append({"query": name, "runs": len(times[True]),
                         "on_p50_ms": on_p50, "off_p50_ms": off_p50,
                         "on_minus_off_ms": on_p50 - off_p50})
    out = {"phase": "planner", "index": "t3", "slices": n_slices,
           "queries": results, "overhead": overhead,
           "subresults": sub.stats(),
           "decision_totals": dict(ex.planner.decision_totals)}
    _emit(out)
    return out


FIELD_MIN, FIELD_MAX = -1_000_000, 1_000_000  # configuration 4's field
TIME_QUANTUM = "YMDH"


def _b4_data(rng, n_slices: int):
    """(columns, values, filter columns) of configuration 4's field
    ``amount`` and filter row, drawn from ``rng`` in this order: one
    column in 64 valued, values uniform in [FIELD_MIN, FIELD_MAX], the
    filter an eighth of the valued columns and 1,000 others."""
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH
    n_cols = n_slices * SLICE_WIDTH
    cols = (np.arange(0, n_cols, 64, dtype=np.uint64)
            + rng.integers(0, 64, size=n_cols // 64).astype(np.uint64))
    vals = rng.integers(FIELD_MIN, FIELD_MAX + 1, size=len(cols))
    in_seg = rng.random(len(cols)) < 0.125
    seg_cols = np.concatenate([cols[in_seg], cols[~in_seg][:1000] + 1])
    return cols, vals, seg_cols


def _hour(t):
    return int((t - _EPOCH).total_seconds() // 3600)


def _fields_bsi_queries(vals):
    """(name, PQL, numpy answer) of the BSI Count queries over ``vals``
    (configuration 4's field ``amount`` of frame ``v``)."""
    import numpy as np
    x = int(vals[len(vals) // 3])
    lo, hi = -250_000, 400_000
    ops = {"eq": ("==", np.equal), "ne": ("!=", np.not_equal),
           "lt": ("<", np.less), "le": ("<=", np.less_equal),
           "gt": (">", np.greater), "ge": (">=", np.greater_equal)}
    out = []
    for name, (op, fn) in ops.items():
        p = x if op in ("==", "!=") else 123_456
        out.append((f"count_{name}",
                    f"Count(Range(frame=v, amount {op} {p}))",
                    int(fn(vals, p).sum())))
    out.append(("count_between",
                f"Count(Range(frame=v, amount >< [{lo}, {hi}]))",
                int(((vals >= lo) & (vals <= hi)).sum())))
    out.append(("count_clamp_all", "Count(Range(frame=v, amount < 2000000))",
                len(vals)))
    out.append(("count_clamp_none", "Count(Range(frame=v, amount > 1000000))",
                0))
    return out


def phase_fields(holder, device, seed: int, n_slices: int = 256,
                 n_time_slices: int = 10, time_bits: int = 1_000_000,
                 n_rows: int = 100, n_days: int = 24) -> tuple:
    """BSI integer fields, time views and the inverse view through
    ``Executor.execute`` on the card, every answer held to a numpy
    reference built from the seeded data (no code of the port).

    - Index ``b4``, frame ``v``, field ``amount`` in [-10^6, 10^6]
      (depth 21) at configuration 4's 256 slices: one column in 64
      valued (4,194,304 values through ``import_field_values``), a
      filter row in frame ``seg``; Count(Range) of every operator and
      both clamps, Sum unfiltered and filtered, Min and Max, cold and
      warm. For each Count: its launches, the comparison's program
      length and spill slots, and the expression count's device time
      over the resident plane slabs against its bound (each slab its
      program reads, read once) and the one-pass bound of all 22
      planes; for each Sum the device time of its 22 launches against
      the same bound. Each of those kernel answers is also held to its
      plain version on the same slabs.
    - Index ``tv``, frame ``t`` (timeQuantum YMDH, 100 rows, 10 slices):
      ~1 M timestamped bits over ``n_days`` days of 2017 (two hours a
      day, at minute 0 or 30: 96 distinct timestamps) through protobuf ``/import`` with Timestamps (the port's
      handler, in process) and 50 timestamped SetBit calls;
      Count(Range(...)) over windows whose covers mix Y, M, D and H
      views.
    - Frame ``inv`` of ``tv`` (inverseEnabled, 10 slices):
      ``Bitmap(columnID=c)`` and a Count of an Intersect of two columns.

    Returns the phase's line and the (name, index, query, kind, answer)
    list that the server phase asks again over HTTP."""
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.models.frame import Field, FrameOptions
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency
    from pilosa_tpu_torch.pql.parser import parse
    from pilosa_tpu_torch.proto import internal as pb
    from pilosa_tpu_torch.server.handler import Handler
    from pilosa_tpu_torch.utils import timequantum as tq

    rng = np.random.default_rng(seed + 7)
    t_phase = time.perf_counter()
    slices = tuple(range(n_slices))
    slab_bytes = n_slices * SLICE_WIDTH // 8

    # -- BSI: configuration 4 ------------------------------------------------
    t0 = time.perf_counter()
    idx = holder.create_index("b4")
    v = idx.create_frame("v")
    field = v.create_field(Field("amount", FIELD_MIN, FIELD_MAX))
    cols, vals, seg_cols = _b4_data(rng, n_slices)
    v.import_field_values("amount", cols, vals)
    idx.create_frame("seg").import_bits(
        np.full(len(seg_cols), 1, np.uint64), np.sort(seg_cols))
    bsi_load_s = time.perf_counter() - t0

    ex = Executor(holder, device=device, **_pinned())
    depth = field.bit_depth
    full_bound_ms = (depth + 1) * slab_bytes / HBM_BYTES_PER_S * 1e3
    served = []
    results = []

    def ask(name, index, q, want, kind, device_time=False):
        residency.device_cache().clear()
        entry = {"query": name, "pql": q}
        before = dict(ck.LAUNCHES)
        for state in ("cold", "warm"):
            out, ms = _timed_query(ex, index, q)
            got = _answer_of(kind, out[0])
            if got != want:
                _fail(f"fields {name} ({state}): {str(got)[:120]} !="
                      f" numpy {str(want)[:120]}")
            entry[f"{state}_ms"] = ms
            if state == "cold":
                entry["launches"] = {k: ck.LAUNCHES[k] - before[k]
                                     for k in before
                                     if ck.LAUNCHES[k] != before[k]}
        entry["answer"] = (want if not isinstance(want, list)
                           else f"{len(want)} bits")
        if device_time:
            entry.update(_count_device_time(index, q, name))
        results.append(entry)
        return entry

    def _count_device_time(index, q, name):
        leaves = []
        expr = ex._compile_device_expr(index, parse(q).calls[0].children[0],
                                       leaves)
        if expr is None:
            return {"program": None}
        prog, slots = ck.compile_program(expr)
        arrs = [ex._leaf_device_array(index, leaf, slices)
                for leaf in leaves]
        return {"program": len(prog), "spill_slots": slots,
                **_fields_device_time(name, [expr], arrs, n_slices),
                "full_pass_bound_ms": full_bound_ms}

    for name, q, want in _fields_bsi_queries(vals):
        ask(name, "b4", q, want, "count", device_time=True)
        if name in ("count_eq", "count_lt", "count_between",
                    "count_clamp_all"):
            served.append((name, "b4", q, "count", want))
    seg_vals = vals[np.isin(cols, seg_cols)]
    aggs = [("sum", "Sum(frame=v, field=amount)",
             (int(vals.sum()), len(vals))),
            ("sum_filtered", "Sum(Bitmap(frame=seg, rowID=1), frame=v,"
                             " field=amount)",
             (int(seg_vals.sum()), len(seg_vals))),
            ("min", "Min(frame=v, field=amount)",
             (int(vals.min()), int((vals == vals.min()).sum()))),
            ("max", "Max(frame=v, field=amount)",
             (int(vals.max()), int((vals == vals.max()).sum())))]
    for name, q, want in aggs:
        e = ask(name, "b4", q, want, "valcount")
        served.append((name, "b4", q, "valcount", want))
        if name.startswith("sum"):
            if (e["launches"].get("expr_count_batch") != 1
                    or "expr_count_rows" in e["launches"]):
                _fail(f"fields {name}: {e['launches']} launches, not one "
                      f"batched count of {depth + 1} expressions")
            c = parse(q).calls[0]
            exprs, leaves = ex._sum_exprs("b4", "v", field, (
                c.children[0] if c.children else None))
            arrs = [ex._leaf_device_array("b4", leaf, slices)
                    for leaf in leaves]
            e.update(_fields_device_time(name, exprs, arrs, n_slices))

    # -- time views ----------------------------------------------------------
    t0 = time.perf_counter()
    tv = holder.create_index("tv")
    tv.create_frame("t", FrameOptions(time_quantum=TIME_QUANTUM))
    handler = Handler(holder, ex)
    days = np.sort(rng.choice(365, size=n_days, replace=False))
    stamps = [_EPOCH + dt.timedelta(days=int(d), hours=int(h))
              for d in days for h in rng.choice(24, size=2, replace=False)]
    t_rows, t_cols, t_hours = [], [], []
    per = time_bits // n_time_slices
    for s in range(n_time_slices):
        rows = rng.integers(0, n_rows, size=per).astype(np.uint64)
        c = (rng.integers(0, SLICE_WIDTH, size=per).astype(np.uint64)
             + np.uint64(s * SLICE_WIDTH))
        pick = rng.integers(0, len(stamps), size=per)
        minutes = rng.choice((0, 30), size=per)
        ns = np.array([int((stamps[i] - _UNIX).total_seconds())
                       for i in range(len(stamps))], np.int64)[pick]
        ns = (ns + minutes * 60) * 10**9
        body = pb.ImportRequest(Index="tv", Frame="t", Slice=s, RowIDs=rows,
                                ColumnIDs=c, Timestamps=ns
                                ).SerializeToString()
        status = _wsgi_post(handler, "/import", body)
        if status != 200:
            _fail(f"fields: timestamped /import answered {status}")
        t_rows.append(rows)
        t_cols.append(c)
        t_hours.append(np.array([_hour(stamps[i]) for i in
                                 range(len(stamps))])[pick])
    for k in range(50):
        t = stamps[int(rng.integers(len(stamps)))] + dt.timedelta(minutes=k)
        r, c = int(rng.integers(n_rows)), int(rng.integers(
            n_time_slices * SLICE_WIDTH))
        ex.execute("tv", f'SetBit(frame=t, rowID={r}, columnID={c},'
                         f' timestamp="{t.strftime("%Y-%m-%dT%H:%M")}")')
        t_rows.append(np.array([r], np.uint64))
        t_cols.append(np.array([c], np.uint64))
        t_hours.append(np.array([_hour(t)]))
    t_rows, t_cols = np.concatenate(t_rows), np.concatenate(t_cols)
    t_hours = np.concatenate(t_hours)
    time_load_s = time.perf_counter() - t0
    n_views = len(holder.frame("tv", "t").views)

    windows = [("year", dt.datetime(2017, 1, 1), dt.datetime(2018, 1, 1)),
               ("months", dt.datetime(2017, 3, 1), dt.datetime(2017, 7, 1)),
               ("mixed", stamps[3] - dt.timedelta(hours=5),
                stamps[-4] + dt.timedelta(hours=9)),
               ("days_hours", stamps[10] - dt.timedelta(hours=3),
                stamps[12] + dt.timedelta(hours=2))]
    for wname, a, b in windows:
        a = a.replace(minute=0)
        b = b.replace(minute=0)
        units = {len(vn) - len("standard_")
                 for vn in tq.views_by_time_range("standard", a, b,
                                                  TIME_QUANTUM)}
        for r in (1, int(rng.integers(n_rows))):
            m = ((t_rows == r) & (t_hours >= _hour(a))
                 & (t_hours < _hour(b)))
            want = len(np.unique(t_cols[m]))
            q = (f'Count(Range(frame=t, rowID={r},'
                 f' start="{a.strftime("%Y-%m-%dT%H:%M")}",'
                 f' end="{b.strftime("%Y-%m-%dT%H:%M")}"))')
            e = ask(f"time_{wname}_row{r}", "tv", q, want, "count")
            e["cover_units"] = sorted(units)
            if wname in ("year", "mixed") and r == 1:
                served.append((f"time_{wname}_row{r}", "tv", q, "count",
                               want))

    # -- inverse view ----------------------------------------------------------
    t0 = time.perf_counter()
    inv = tv.create_frame("inv", FrameOptions(inverse_enabled=True))
    hot = rng.integers(0, n_time_slices * SLICE_WIDTH, size=4,
                       dtype=np.uint64)
    i_rows = np.concatenate([rng.integers(0, 1000, size=400_000),
                             rng.integers(0, 1000, size=1200)]
                            ).astype(np.uint64)
    i_cols = np.concatenate([
        rng.integers(0, n_time_slices * SLICE_WIDTH, size=400_000,
                     dtype=np.uint64), hot[rng.integers(0, 4, size=1200)]])
    inv.import_bits(i_rows, i_cols)
    inv_load_s = time.perf_counter() - t0

    def rows_of(c):
        return np.unique(i_rows[i_cols == c]).tolist()

    a, b = int(hot[0]), int(hot[1])
    for name, q, want, kind in (
            ("inverse_bitmap", f"Bitmap(columnID={a}, frame=inv)",
             rows_of(a), "bitmap"),
            ("inverse_count_intersect",
             f"Count(Intersect(Bitmap(columnID={a}, frame=inv),"
             f" Bitmap(columnID={b}, frame=inv)))",
             len(set(rows_of(a)) & set(rows_of(b))), "count")):
        ask(name, "tv", q, want, kind)
        served.append((name, "tv", q, kind, want))
    if results[-1]["launches"].get("expr_count_rows", 0) < 1:
        _fail("fields: the inverse Count launched no expression count")

    out = {"phase": "fields", "slices": n_slices, "values": len(vals),
           "depth": depth, "bsi_load_s": bsi_load_s,
           "plane_slab_mib": (depth + 1) * slab_bytes / 2**20,
           "full_pass_bound_ms": full_bound_ms,
           "time_slices": n_time_slices, "time_bits": int(len(t_rows)),
           "time_views": n_views, "time_load_s": time_load_s,
           "inverse_bits": int(len(i_rows)), "inverse_load_s": inv_load_s,
           "resident_mib": residency.device_cache().snapshot()["usedBytes"]
           / 2**20, "queries": results,
           "phase_s": time.perf_counter() - t_phase,
           "card": _card()}
    _emit(out)
    return out, served


def _fields_device_time(name, exprs, arrs, n_slices) -> dict:
    """The expressions of one query (a Count's one, a Sum's depth+1)
    over its resident slabs ``arrs``: each count held to its plain
    version, then the device time of the query's launch (a Sum's one
    batched count) and of the expressions launched one by one (a Sum
    without the batched entry), each in one CUDA graph, and the plain versions' time, against
    the bound of reading each slab once. Launches made here do not
    count as the main path's."""
    import torch
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.ops import timing
    from pilosa_tpu_torch.parallel import mesh as mesh_mod

    per = []
    for e in exprs:
        ids = mesh_mod.expr_leaf_ids(e)
        per.append((mesh_mod.remap_expr_leaves(
            e, {g: i for i, g in enumerate(ids)}), [arrs[i] for i in ids]))

    def run():
        return [ck.expr_count_rows(e, ls) for e, ls in per]

    def plain():
        return [ck.expr_count_rows_torch(e, ls) for e, ls in per]

    def batched():
        return ck.expr_count_batch(tuple(exprs), arrs)

    saved = dict(ck.LAUNCHES)
    out = {}
    try:
        for got, want in zip(run(), plain()):
            if not torch.equal(got, want):
                _fail(f"fields {name}: expr_count_rows differs from its"
                      " plain version on the resident slabs")
        if len(per) == 1:
            out["device_ms"] = timing.graph_ms(run, [()], 10)
        else:
            if not torch.equal(batched(), torch.stack(plain())):
                _fail(f"fields {name}: expr_count_batch differs from the"
                      " plain counts on the resident slabs")
            out["device_ms"] = timing.graph_ms(batched, [()], 5)
            out["per_expr_device_ms"] = timing.graph_ms(run, [()], 2)
        out["plain_ms"] = timing.events_ms(plain, [()], 3, warmup=1)
    finally:
        ck.LAUNCHES.update(saved)
    n_read = len({i for e in exprs for i in mesh_mod.expr_leaf_ids(e)})
    slab = n_slices * SLICE_WIDTH // 8
    return {"leaves": n_read, **out,
            "bound_ms": (n_read * slab + len(per) * n_slices * 4)
            / HBM_BYTES_PER_S * 1e3}


C2_ROWS = 1000  # BASELINE configuration 2: Union/Difference over 1K rows


def _c2_rows(rng) -> dict:
    """Configuration 2's rows of one slice, as the JAX suite builds them
    (benchmarks/suite.py config2_executor_wide_union): 900 rows of 500
    random columns (array containers) and, every tenth row, half of one
    65,536-column container (bitmap containers: container (r // 10) % 12,
    so 8 or 9 dense rows share each)."""
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH
    rows = {}
    for r in range(C2_ROWS):
        if r % 10 == 0:
            base = ((r // 10) % 12) * 65536
            cols = base + rng.choice(65536, 32768, replace=False)
        else:
            cols = rng.choice(SLICE_WIDTH, 500, replace=False)
        rows[r] = np.sort(cols).astype(np.uint64)
    return rows


def _bitmap_words(bm, n_slices: int):
    """``[n_slices, W]`` u32 dense words of a result Bitmap."""
    import numpy as np
    from pilosa_tpu_torch.ops import packed
    out = np.zeros((n_slices, packed.WORDS_PER_SLICE), dtype=np.uint32)
    for seg in bm.segments:
        idx, vals = packed.sparse_words(
            seg.data, packed.WORDS_PER_SLICE,
            base_word=seg.slice * packed.WORDS_PER_SLICE)
        out[seg.slice, idx] = vals
    return out


def _row_words(holder, index, frame, rows, n_slices: int):
    """``{row: [n_slices, W] u32}`` packed from the fragments (host)."""
    import numpy as np
    from pilosa_tpu_torch.ops import packed
    out = {}
    for r in rows:
        w = np.zeros((n_slices, packed.WORDS_PER_SLICE), dtype=np.uint32)
        for s in range(n_slices):
            frag = holder.fragment(index, frame, "standard", s)
            if frag is not None:
                frag.pack_row(r, out=w[s], cached=False)
        out[r] = w
    return out


def _batch_bitmap(ex, host_ex, index, name, q, check,
                  cold: bool = True) -> dict:
    """One bitmap call: cold (result cache and resident slabs cleared;
    with ``cold``), warm (result cache cleared, slabs resident) and
    resident (a result cache hit where the result fits the cache), each
    answer passed to ``check``; then, with ``host_ex``, the port's host
    path (the device declined by its byte bound: fold_rows for plain
    folds) on the same call."""
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency
    entry = {"query": name}
    if cold:
        residency.device_cache().clear()
    for state in ("cold", "warm", "resident")[0 if cold else 1:]:
        if state != "resident":
            ex.clear_result_cache()
        hits = ex.result_cache_hits
        before = dict(ck.LAUNCHES)
        out, entry[f"{state}_ms"] = _timed_query(ex, index, q)
        check(f"{name} ({state})", out[0])
        entry[f"{state}_launches"] = {k: ck.LAUNCHES[k] - before[k]
                                      for k in before
                                      if ck.LAUNCHES[k] != before[k]}
        if state == "resident":
            entry["cache_hit"] = ex.result_cache_hits > hits
    if entry["warm_launches"] != {"expr_words": 1}:
        _fail(f"batch {name}: warm launches {entry['warm_launches']}, not"
              " one expr_words")
    if host_ex is not None:
        out, entry["host_ms"] = _timed_query(host_ex, index, q)
        check(f"{name} (host path)", out[0])
    entry["bits"] = out[0].count()
    return entry


def _materialize_split(ex, index, q, slices) -> dict:
    """The device leg of one bitmap call in its three parts: the
    expression-words kernel over the resident slabs (device time, CUDA
    graph), the device-to-host copy of the words and the host repack to
    roaring. Launches made here do not count as the main path's."""
    import torch
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.ops import timing
    from pilosa_tpu_torch.parallel import mesh as mesh_mod
    from pilosa_tpu_torch.pql.parser import parse
    leaves = []
    expr = ex._compile_device_expr(index, parse(q).calls[0], leaves)
    arrs = [ex._leaf_device_array(index, leaf, tuple(slices))
            for leaf in leaves]
    saved = dict(ck.LAUNCHES)
    try:
        kernel_ms = timing.graph_ms(
            lambda: mesh_mod.materialize_words(expr, arrs), [()], 5)
        words = mesh_mod.materialize_words(expr, arrs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = mesh_mod.fetch_words(words)
        copy_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ex._repack_words(host, list(slices))
        repack_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _repack_per_container(host)
        per_container_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ck.LAUNCHES.update(saved)
    n_bytes = (len(leaves) + 1) * words.numel() * 4
    return {"leaves": len(leaves), "kernel_ms": kernel_ms,
            "copy_ms": copy_ms, "repack_ms": repack_ms,
            "repack_per_container_ms": per_container_ms,
            "kernel_bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "copy_mib": words.numel() * 4 / 2**20}


def _repack_per_container(words) -> int:
    """The repack as the JAX package does it, one numpy expansion a
    sparse container (roaring.bitmap_words_to_values), for a time beside
    the port's one pass a slice; returns the containers built."""
    import numpy as np
    from pilosa_tpu_torch.storage import roaring
    n = 0
    for row in words:
        w64 = row.view("<u8").reshape(-1, 1024)
        counts = np.bitwise_count(w64).astype(np.int64).sum(axis=1)
        for ci in np.flatnonzero(counts).tolist():
            if counts[ci] > roaring.ARRAY_MAX_SIZE:
                roaring.Container.from_bitmap(w64[ci], n=int(counts[ci]),
                                              mapped=True)
            else:
                roaring.Container.from_array(
                    roaring.bitmap_words_to_values(w64[ci]))
            n += 1
    return n


def _multi_call(ex, index, name, body, singles, want_launches,
                runs: int = 5) -> dict:
    """A multi-call body against the same calls sent one call a query:
    cold once (slabs resident after), then ``runs`` warm runs of each in
    turns; the body's launches a warm run must be ``want_launches`` and
    its answers equal the one-call answers. The body's device-to-host
    fetches (mesh.FETCHES) a warm run must be one."""
    import statistics
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import mesh
    ex.execute(index, body)
    body_ms, single_ms = [], []
    launches = None
    fetches = []
    for _ in range(runs):
        before = dict(ck.LAUNCHES)
        mesh.FETCHES["host"] = 0
        got, ms = _timed_query(ex, index, body)
        body_ms.append(ms)
        fetches.append(mesh.FETCHES["host"])
        launches = {k: ck.LAUNCHES[k] - before[k] for k in before
                    if ck.LAUNCHES[k] != before[k]}
        want, total = [], 0.0
        for q in singles:
            out, ms = _timed_query(ex, index, q)
            want += out
            total += ms
        single_ms.append(total)
        if [_answer_of(_kind(r), r) for r in got] != \
                [_answer_of(_kind(r), r) for r in want]:
            _fail(f"batch {name}: the body's answers differ from the"
                  " one-call answers")
    if sum(launches.values()) != want_launches:
        _fail(f"batch {name}: {launches} launches a warm run, not"
              f" {want_launches}")
    if set(fetches) != {1}:
        _fail(f"batch {name}: {fetches} host fetches a warm run, not 1")
    return {"query": name, "calls": len(singles), "launches": launches,
            "host_fetches": fetches[-1],
            "warm_ms": statistics.median(body_ms),
            "one_call_queries_warm_ms": statistics.median(single_ms),
            "answers": [_answer_of(_kind(r), r) for r in got][:6]}


def _kind(r) -> str:
    if isinstance(r, int):
        return "count"
    if hasattr(r, "value"):
        return "valcount"
    return "topn" if isinstance(r, list) else "bitmap"


def phase_batch(holder, device, seed: int, n_slices: int = 256) -> tuple:
    """The fused batch and the device materialize leg through
    ``Executor.execute``:

    - BASELINE configuration 2: index ``c2``, one slice, 1,000 rows
      (``_c2_rows``); Union and Difference of all 1,000 and an
      Intersect of 8 dense rows, cold, warm and resident, each held to
      numpy and to the port's host path (fold_rows).
    - Configuration 4: over ``smoke`` (256 slices) the bitmap Union of
      rows 1-16 and Difference of rows 1-8, held to words packed from
      the fragments on the host; over ``b4`` a bitmap field Range
      ``>`` and ``><``, held to numpy; each split into kernel, copy
      and repack.
    - Multi-call bodies: the 16 Counts of the count phase's rows, the
      filtered Sum of ``b4`` and, over ``t3``, 4 Counts and 2 TopNs of
      200 ids, each warm against the same calls as one-call queries;
      1, 1 and 3 launches a warm run.

    Returns the phase's line and the (name, index, query, kind, answer)
    list that the server phase asks again over HTTP."""
    import numpy as np
    import torch
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.pql.parser import parse

    rng = np.random.default_rng(seed + 9)
    t_phase = time.perf_counter()
    ex = Executor(holder, device=device, **_pinned())
    host_ex = Executor(holder, device=device, materialize_device_bytes=0,
                       result_cache_bits=-1, **_pinned())
    results, served = [], []

    def bits_check(want):
        def check(what, bm):
            got = bm.bits()
            if not np.array_equal(got, want):
                _fail(f"batch {what}: {len(got)} bits, numpy {len(want)}"
                      " (or their columns differ)")
        return check

    def words_check(want, n):
        def check(what, bm):
            if not np.array_equal(_bitmap_words(bm, n), want):
                _fail(f"batch {what}: words differ from the host's")
        return check

    # -- configuration 2 -----------------------------------------------------
    t0 = time.perf_counter()
    rows = _c2_rows(rng)
    frame = holder.create_index("c2").create_frame("f")
    frame.import_bits(
        np.concatenate([np.full(len(c), r, np.uint64)
                        for r, c in rows.items()]),
        np.concatenate(list(rows.values())))
    c2_load_s = time.perf_counter() - t0
    children = ", ".join(f"Bitmap(rowID={r}, frame=f)"
                         for r in range(C2_ROWS))
    rest = np.unique(np.concatenate([rows[r] for r in range(1, C2_ROWS)]))
    dense8 = [r for r in range(0, C2_ROWS, 10) if (r // 10) % 12 == 0][:8]
    inter = rows[dense8[0]]
    for r in dense8[1:]:
        inter = np.intersect1d(inter, rows[r])
    union = np.union1d(rows[0], rest)
    c2 = [("c2_union", f"Union({children})", union),
          ("c2_difference", f"Difference({children})",
           np.setdiff1d(rows[0], rest)),
          ("c2_intersect8", "Intersect(" + ", ".join(
              f"Bitmap(rowID={r}, frame=f)" for r in dense8) + ")", inter)]
    for name, q, want in c2:
        e = _batch_bitmap(ex, host_ex, "c2", name, q, bits_check(want))
        e.update(_materialize_split(ex, "c2", q, [0]))
        results.append(e)
    served.append(("c2_union", "c2", c2[0][1], "bitmap", union.tolist()))

    # -- configuration 4: bitmap Union, Difference and field Range -----------
    words = _row_words(holder, "smoke", "f", range(1, 17), n_slices)
    u16 = np.zeros_like(words[1])
    for r in range(1, 17):
        u16 |= words[r]
    rest8 = np.zeros_like(words[1])
    for r in range(2, 9):
        rest8 |= words[r]
    diff8 = words[1] & ~rest8
    del words, rest8
    slices = list(range(n_slices))
    # At 256 slices the host path takes seconds a call: configuration 4
    # is held to the host's words and to numpy, and only its first call
    # runs cold.
    for name, q, want in (
            ("c4_union16", "Union(" + ", ".join(
                f"Bitmap(rowID={r}, frame=f)" for r in range(1, 17)) + ")",
             u16),
            ("c4_difference8", "Difference(" + ", ".join(
                f"Bitmap(rowID={r}, frame=f)" for r in range(1, 9)) + ")",
             diff8)):
        e = _batch_bitmap(ex, None, "smoke", name, q,
                          words_check(want, n_slices),
                          cold=name == "c4_union16")
        e.update(_materialize_split(ex, "smoke", q, slices))
        results.append(e)
    del u16, diff8
    cols, vals, seg_cols = _b4_data(np.random.default_rng(seed + 7),
                                    n_slices)
    order = np.argsort(cols)
    cols, vals = cols[order], vals[order]
    for name, q, mask in (
            ("b4_range_gt", "Range(frame=v, amount > 500000)",
             vals > 500_000),
            ("b4_range_between", "Range(frame=v, amount >< [-200000,"
                                 " 600000])",
             (vals >= -200_000) & (vals <= 600_000))):
        e = _batch_bitmap(ex, None, "b4", name, q, bits_check(cols[mask]),
                          cold=False)
        e.update(_materialize_split(ex, "b4", q, slices))
        results.append(e)

    # -- multi-call bodies -----------------------------------------------------
    counts16 = [f"Count(Intersect(Bitmap(rowID={r}, frame=f),"
                f" Bitmap(rowID={r % 16 + 1}, frame=f)))"
                for r in range(1, 17)]
    multi = [_multi_call(ex, "smoke", "counts16", " ".join(counts16),
                         counts16, 1)]
    fsum = "Sum(Bitmap(frame=seg, rowID=1), frame=v, field=amount)"
    e = _multi_call(ex, "b4", "sum_filtered", fsum, [fsum], 1)
    seg_vals = vals[np.isin(cols, seg_cols)]
    if e["answers"] != [(int(seg_vals.sum()), len(seg_vals))]:
        _fail(f"batch sum_filtered: {e['answers']} != numpy")
    field = holder.frame("b4", "v").field("amount")
    exprs, leaves = ex._sum_exprs("b4", "v", field,
                                  parse(fsum).calls[0].children[0])
    arrs = [ex._leaf_device_array("b4", leaf, tuple(slices))
            for leaf in leaves]
    e.update(_fields_device_time("sum_filtered", exprs, arrs, n_slices))
    multi.append(e)
    ids = sorted(rng.choice(2000, size=200, replace=False).tolist())
    mixed = ["Count(Bitmap(rowID=3, frame=f))",
             f"TopN(Bitmap(rowID=1, frame=f), frame=f, ids={ids})",
             "Count(Intersect(Bitmap(rowID=1, frame=f),"
             " Bitmap(rowID=2, frame=f)))",
             "Count(Union(Bitmap(rowID=4, frame=f), Bitmap(rowID=5,"
             " frame=f)))",
             f"TopN(Bitmap(rowID=2, frame=f), frame=f, ids={ids})",
             "Count(Bitmap(rowID=6, frame=f))"]
    multi.append(_multi_call(ex, "t3", "counts4_topn2", " ".join(mixed),
                             mixed, 3))
    torch.cuda.synchronize()
    out = {"phase": "batch", "c2_rows": C2_ROWS, "c2_load_s": c2_load_s,
           "bitmap_calls": results, "multi_call": multi,
           "launches": dict(ck.LAUNCHES),
           "phase_s": time.perf_counter() - t_phase, "card": _card()}
    _emit(out)
    return out, served


def _server_pipeline(srv, rng, n_slices: int = 256, n_writes: int = 1000,
                     n_counts: int = 64) -> dict:
    """The HTTP front's batch lane on the running server: one keep-alive
    connection sends ``n_writes`` pipelined SetBit POSTs (row 100 of
    ``smoke/g``, the last 10 repeating earlier columns, which answer
    false as they would sent alone) in one write, then ``n_counts``
    pipelined Count POSTs; every response checked, requests/s and the
    executor calls they made counted. Returns the line and the acked
    (slice, column) pairs for the reopen check."""
    import socket

    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH

    calls = {"execute_partial": 0, "execute": 0}
    ex = srv.executor
    real = {name: getattr(ex, name) for name in calls}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    cols = rng.choice(n_slices * SLICE_WIDTH, size=n_writes - 10,
                      replace=False).tolist()
    cols += cols[:10]
    writes = [f"SetBit(frame=g, rowID=100, columnID={c})" for c in cols]
    want_w = [b'{"results": [true]}\n'] * (n_writes - 10) + \
        [b'{"results": [false]}\n'] * 10
    reads = ["Count(Bitmap(rowID=100, frame=g))",
             "Count(Intersect(Bitmap(rowID=100, frame=g),"
             " Bitmap(rowID=1, frame=g)))"]
    h, port = srv.host.split(":")

    def pipelined(bodies):
        reqs = b"".join(
            f"POST /index/smoke/query HTTP/1.1\r\nHost: x\r\n"
            f"Content-Length: {len(b)}\r\n\r\n{b}".encode()
            for b in bodies)
        got, buf = [], b""
        t0 = time.perf_counter()
        with socket.create_connection((h, int(port)), timeout=600) as s:
            s.sendall(reqs)
            while len(got) < len(bodies):
                end = buf.find(b"\r\n\r\n")
                if end >= 0:
                    head = buf[:end].decode("latin-1").lower()
                    n = int(head.split("content-length:")[1]
                            .split("\r\n")[0])
                    if len(buf) >= end + 4 + n:
                        if not head.startswith("http/1.1 200"):
                            _fail(f"server pipeline: {head[:40]!r}")
                        got.append(buf[end + 4:end + 4 + n])
                        buf = buf[end + 4 + n:]
                        continue
                chunk = s.recv(1 << 20)
                if not chunk:
                    _fail("server pipeline: connection closed early")
                buf += chunk
        return got, time.perf_counter() - t0

    for name in calls:
        setattr(ex, name, counted(name))
    try:
        got_w, w_s = pipelined(writes)
        w_calls = dict(calls)
        got_r, r_s = pipelined([reads[i % 2] for i in range(n_counts)])
    finally:
        for name in calls:
            setattr(ex, name, real[name])
    if got_w != want_w:
        bad = next(i for i, (a, b) in enumerate(zip(got_w, want_w))
                   if a != b)
        _fail(f"server pipeline: SetBit {bad} answered {got_w[bad]!r}")
    g1 = np.concatenate([srv.holder.fragment("smoke", "g", "standard", s)
                         .row(1).bits() for s in range(n_slices)])
    uniq = set(cols)
    want_r = [len(uniq), int(np.isin(np.fromiter(uniq, np.uint64),
                                     g1).sum())]
    for i, body in enumerate(got_r):
        if json.loads(body) != {"results": [want_r[i % 2]]}:
            _fail(f"server pipeline: Count {i} answered {body!r}, host"
                  f" {want_r[i % 2]}")
    paths = {s: srv.holder.fragment("smoke", "g", "standard", s).path
             for s in {c // SLICE_WIDTH for c in uniq}}
    def executor_calls(c):
        # execute_partial runs through execute: count each call once.
        return {"batched_runs": c["execute_partial"],
                "one_by_one": c["execute"] - c["execute_partial"]}

    line = {"setbit_requests": n_writes, "setbit_s": w_s,
            "setbit_requests_per_s": n_writes / w_s,
            "setbit_executor_calls": executor_calls(w_calls),
            "count_requests": n_counts, "count_s": r_s,
            "count_requests_per_s": n_counts / r_s,
            "count_executor_calls": executor_calls(
                {k: calls[k] - w_calls[k] for k in calls})}
    return line, (paths, sorted(uniq))


def _check_acked_after_reopen(paths: dict, cols: list) -> int:
    """Open each touched fragment file of ``smoke/g`` anew: every acked
    pipelined SetBit of row 100 must be there."""
    from pilosa_tpu_torch import SLICE_WIDTH
    from pilosa_tpu_torch.storage.fragment import Fragment
    have = set()
    for s, path in paths.items():
        frag = Fragment(path, "smoke", "g", "standard", s)
        frag.open()
        try:
            have.update(frag.row(100).bits().tolist())
        finally:
            frag.close()
    lost = [c for c in cols if c not in have]
    if lost:
        _fail(f"server pipeline: {len(lost)} acked SetBits missing after"
              f" the reopen (first column {lost[0]}, slice"
              f" {lost[0] // SLICE_WIDTH})")
    return len(cols)


def _wsgi_post(app, path, body):
    """POST ``body`` (protobuf) to a WSGI app in this process → status."""
    import io
    out = {}

    def start_response(status, headers):
        out["status"] = int(status.split()[0])

    b"".join(app({"REQUEST_METHOD": "POST", "PATH_INFO": path,
                  "QUERY_STRING": "", "CONTENT_LENGTH": str(len(body)),
                  "CONTENT_TYPE": "application/x-protobuf",
                  "HTTP_ACCEPT": "application/x-protobuf",
                  "wsgi.input": io.BytesIO(body)}, start_response))
    return out["status"]


def _card() -> str:
    """``name, power limit`` of the card (nvidia-smi)."""
    from pilosa_tpu_torch import bench
    return bench.card_info()


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_up(host: str, proc, deadline_s: float) -> float:
    """Seconds until ``host`` answers /version; fails if ``proc`` dies
    or the deadline passes."""
    import urllib.request
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < deadline_s:
        if proc.poll() is not None:
            _fail(f"durability: the server exited with {proc.returncode}")
        try:
            with urllib.request.urlopen(f"http://{host}/version",
                                        timeout=5) as r:
                r.read()
            return time.perf_counter() - t0
        except OSError:
            time.sleep(0.2)
    _fail(f"durability: {host} not up in {deadline_s} s")


def _oplog_bytes(path: str) -> tuple[int, int]:
    """(op-log bytes, snapshot bytes) of one fragment data file: what a
    reopen replays past the footered snapshot body."""
    from pilosa_tpu_torch.storage import integrity, roaring
    with open(path, "rb") as f:
        data = f.read()
    buf = memoryview(data)
    hdr, _, _, offs, sizes, ops_offset, body_end = \
        roaring.parse_snapshot_layout(buf)
    info = integrity.parse_and_verify_footer(buf, len(hdr), ops_offset,
                                             offs, sizes, body_end)
    start = body_end + (info.size if info is not None else 0)
    return len(data) - start, start


def phase_durability(device, seed: int, tmp: str, n_slices: int = 128,
                     storm_s: float = 6.0) -> dict:
    """Acked writes survive SIGKILL on the card. The port's ``server``
    verb runs as a subprocess on the card over a fresh directory,
    seeded by protobuf ``/import`` with BASELINE configuration 4's rows
    (1-8 at 1/64, 9-16 at 1/4096 over ``n_slices`` slices). A write
    storm of ``storm_s`` seconds follows, every stream from ``seed``: 8 client
    threads of SetBit/ClearBit queries (rows 100-179) throughout, and
    after its first quarter (the ack latency of each window is printed)
    2 threads of 65,536-bit protobuf ``/import`` batches over random
    slices (rows 200-219) and one thread importing 65,536-bit batches
    into slice 0 (rows 300-309), which drives that fragment past
    MAX_OP_N so that background snapshots swap its WAL (the data file's
    inode changes and it shrinks) mid-storm; the storm runs on, for at
    most 60 s, until one swap has been seen. Each thread records what
    was acked (HTTP 200). The
    server is killed with SIGKILL; a ``Server`` in this process reopens
    the directory on the card and must hold (a) every acked SetBit and
    import bit and none of the acked ClearBits (for bits whose last op
    was acked), (b) no bit of a storm row that was never attempted;
    (c) Count of every touched row over HTTP (the expression count,
    densify for these sparse rows) must equal the reopened fragments'
    host row counts, and a sourced TopN over six touched rows (the TopN
    block count) its host answer."""
    import signal
    import subprocess
    import threading
    import urllib.error
    import urllib.request
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH as SW
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.parallel import residency
    from pilosa_tpu_torch.proto import internal as pb
    from pilosa_tpu_torch.server.server import Server
    from pilosa_tpu_torch.storage import native_ext

    PB = "application/x-protobuf"
    W = np.uint64(SW)
    repo = os.path.dirname(os.path.abspath(__file__))
    data_dir = os.path.join(tmp, "durable")
    frag_dir = os.path.join(data_dir, "c4", "f", "views", "standard",
                            "fragments")
    port = _free_port()
    host = f"127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    log_path = os.path.join(tmp, "durable_server.log")
    halt = threading.Event()
    rng = np.random.default_rng(seed + 17)

    def post(path, body, headers=None, timeout=60.0):
        req = urllib.request.Request(f"http://{host}{path}", data=body,
                                     method="POST", headers=headers or {})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read()

    points: list = []      # [thread, pos (row * 2^28 + col), op, acked]
    batches: list = []     # [row * 2^28 + col positions, acked]
    lat_ms: list = []
    swaps = [0]
    watched = {"max_bytes": 0}
    import_tally: dict = {}   # first row of an import thread -> tally
    cols_total = np.uint64(n_slices * SW)

    def writer(k):
        g = np.random.default_rng(seed * 1000 + k)
        mine = []
        while not halt.is_set():
            if mine and g.random() < 0.3:
                pos, op = mine[int(g.integers(len(mine)))], "clear"
            else:
                pos = (np.uint64(100 + 10 * k + int(g.integers(10)))
                       * cols_total + np.uint64(g.integers(cols_total)))
                op = "set"
                mine.append(pos)
            entry = [k, pos, op, False]
            points.append(entry)
            call = "SetBit" if op == "set" else "ClearBit"
            t0 = time.perf_counter()
            try:
                post("/index/c4/query",
                     f"{call}(frame=f, rowID={int(pos // cols_total)},"
                     f" columnID={int(pos % cols_total)})".encode(),
                     timeout=30)
            except (OSError, urllib.error.URLError):
                continue
            lat_ms.append((t0, (time.perf_counter() - t0) * 1e3))
            entry[3] = True

    def importer(row0, slice_=None):
        g = np.random.default_rng(seed * 1000 + 100 + row0)
        tally = import_tally.setdefault(row0, {"acked": 0, "failed": 0,
                                               "error": None})
        while not halt.is_set():
            s = int(g.integers(n_slices)) if slice_ is None else slice_
            rows = row0 + g.integers(10, size=65536).astype(np.uint64)
            cols = np.uint64(s) * W + g.integers(SW, size=65536
                                                  ).astype(np.uint64)
            entry = [rows * cols_total + cols, False]
            batches.append(entry)
            body = pb.ImportRequest(Index="c4", Frame="f", Slice=s,
                                    RowIDs=rows, ColumnIDs=cols
                                    ).SerializeToString()
            try:
                post("/import", body, {"Content-Type": PB, "Accept": PB},
                     timeout=120)
            except (OSError, urllib.error.URLError) as e:
                tally["failed"] += 1
                tally["error"] = repr(e)[:200]
                continue
            tally["acked"] += 1
            entry[1] = True

    def watcher():
        # A snapshot swap renames a new file over the data file (a new
        # inode) and folds the WAL tail into the body (the file shrinks:
        # the log only grows between swaps). Either sign counts, since
        # a file system may reuse or synthesize inode numbers.
        path = os.path.join(frag_dir, "0")
        st = os.stat(path)
        last, size = (st.st_dev, st.st_ino), st.st_size
        while not halt.is_set():
            try:
                st = os.stat(path)
            except FileNotFoundError:
                time.sleep(0.02)  # mid-rename
                continue
            ident = (st.st_dev, st.st_ino)
            if ident != last or st.st_size < size:
                swaps[0] += 1
            last, size = ident, st.st_size
            watched["max_bytes"] = max(watched["max_bytes"], size)
            time.sleep(0.02)

    t_spawn = time.perf_counter()
    with open(log_path, "w") as log:
        # On the card the verb runs with no --device (its default);
        # "--device cpu" only where the phase itself runs on the host.
        dev_args = [] if device.type == "cuda" else ["--device", "cpu"]
        proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
             "-d", data_dir, "-b", host] + dev_args, cwd=repo, env=env,
            stdout=log, stderr=subprocess.STDOUT)
    threads = []
    try:
        spawn_s = _wait_up(host, proc, 300)
        post("/index/c4", b"{}")
        post("/index/c4/frame/f", b"{}")
        t0 = time.perf_counter()
        seed_bits = 0
        for s in range(n_slices):
            rows, cols = [], []
            for row in range(1, 17):
                density = 64 if row <= 8 else 4096
                c = np.unique(rng.integers(0, SW, size=SW // density,
                                           dtype=np.uint64))
                rows.append(np.full(len(c), row, np.uint64))
                cols.append(c + np.uint64(s) * W)
            rows, cols = np.concatenate(rows), np.concatenate(cols)
            seed_bits += len(rows)
            post("/import", pb.ImportRequest(
                Index="c4", Frame="f", Slice=s, RowIDs=rows,
                ColumnIDs=cols).SerializeToString(),
                {"Content-Type": PB, "Accept": PB}, timeout=300)
        seed_s = time.perf_counter() - t0
        writers = [threading.Thread(target=writer, args=(k,))
                   for k in range(8)]
        loaders = [threading.Thread(target=importer, args=(200,)),
                   threading.Thread(target=importer, args=(210,)),
                   threading.Thread(target=importer, args=(300, 0)),
                   threading.Thread(target=watcher)]
        threads = writers + loaders
        # The point writers alone for the first quarter of the storm,
        # then the import threads join: the ack latency of each window.
        t_storm = time.perf_counter()
        for t in writers:
            t.start()
        time.sleep(storm_s / 4)
        t_loaded = time.perf_counter()
        for t in loaders:
            t.start()
        time.sleep(storm_s * 3 / 4)
        # The kill must land after at least one snapshot swapped slice
        # 0's WAL: on a slow host or disk the storm runs on until one
        # has, for at most 60 s more.
        t_end = time.perf_counter() + 60.0
        while not swaps[0] and time.perf_counter() < t_end:
            if proc.poll() is not None:
                break
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        storm_wall = time.perf_counter() - t_storm
        halt.set()
        proc.wait(timeout=60)
    finally:
        halt.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        for t in threads:
            t.join(timeout=150)
    if any(t.is_alive() for t in threads):
        _fail("durability: a storm thread did not stop")
    if not swaps[0]:
        try:
            with open(log_path, errors="replace") as f:
                tail = f.read()[-2000:]
        except OSError:
            tail = ""
        print(f"durability: server log tail:\n{tail}", file=sys.stderr)
        free = shutil.disk_usage(tmp).free
        _fail("durability: no snapshot swapped slice 0's WAL mid-storm "
              f"(slice 0 imports {import_tally.get(300)}, data file at "
              f"most {watched['max_bytes']} B, {free} B free under "
              f"{tmp}, server rc {proc.returncode})")

    wal_bytes = snap_bytes = 0
    for name in os.listdir(frag_dir):
        if name.isdigit():
            w, b = _oplog_bytes(os.path.join(frag_dir, name))
            wal_bytes += w
            snap_bytes += b

    # What the reopened directory must hold.
    acked_points = [e for e in points if e[3]]
    last = {}
    for k, pos, op, acked in points:
        last[pos] = (op, acked)
    must = [np.asarray([p for p, (op, a) in last.items()
                        if a and op == "set"], dtype=np.uint64)]
    must_not = np.asarray([p for p, (op, a) in last.items()
                           if a and op == "clear"], dtype=np.uint64)
    attempted = [np.asarray(list(last), dtype=np.uint64)]
    import_bits = 0
    for pos, acked in batches:
        attempted.append(pos)
        if acked:
            must.append(pos)
            import_bits += len(pos)
    must = np.unique(np.concatenate(must))
    attempted = np.unique(np.concatenate(attempted))
    if not len(acked_points) or not import_bits:
        _fail("durability: the storm acked no write")

    ck.reset_launches()
    residency.device_cache().clear()
    t0 = time.perf_counter()
    srv = Server(data_dir, host="127.0.0.1:0", device=device,
                 warmup=False, executor_options=_pinned())
    srv.open()
    ready_s = time.perf_counter() - t0
    try:
        frags = [srv.holder.fragment("c4", "f", "standard", s)
                 for s in range(n_slices)]
        present = []
        for s, f in enumerate(frags):
            if f is None:
                continue
            p = f.positions()
            rows = p // W
            keep = rows >= 100
            present.append(rows[keep] * cols_total + np.uint64(s) * W
                           + p[keep] % W)
        present = np.unique(np.concatenate(present))
        missing = np.setdiff1d(must, present)
        if len(missing):
            _fail(f"durability: {len(missing)} acked writes missing "
                  f"after SIGKILL, e.g. {missing[:3].tolist()}")
        back = np.intersect1d(must_not, present)
        if len(back):
            _fail(f"durability: {len(back)} acked clears came back")
        stray = np.setdiff1d(present, attempted)
        if len(stray):
            _fail(f"durability: {len(stray)} bits were never written")

        touched = np.unique(attempted // cols_total).tolist()
        rows_p, counts_p = np.unique(present // cols_total,
                                     return_counts=True)
        have = dict(zip(rows_p.tolist(), counts_p.tolist()))
        host_counts = [have.get(r, 0) for r in touched]
        q = " ".join(f"Count(Bitmap(rowID={r}, frame=f))" for r in touched)
        body, count_ms = _http(srv.host, "/index/c4/query", q.encode())
        got = json.loads(body)["results"]
        if got != host_counts:
            _fail(f"durability: Count over HTTP {got[:5]} != host "
                  f"{host_counts[:5]}")
        ids = [touched[0], touched[7], touched[-21], touched[-20],
               touched[-10], touched[-1]]
        src_cols = [f.row(1).bits().astype(np.uint64) if f else None
                    for f in frags]
        pairs = []
        for r in ids:
            n = 0
            for s, f in enumerate(frags):
                if f is not None:
                    n += len(np.intersect1d(f.row(r).bits(), src_cols[s]))
            if n:
                pairs.append([r, n])
        pairs.sort(key=lambda p: (-p[1], p[0]))
        body, topn_ms = _http(
            srv.host, "/index/c4/query",
            f"TopN(Bitmap(rowID=1, frame=f), frame=f, ids={ids})".encode())
        got_topn = [[p["id"], p["count"]]
                    for p in json.loads(body)["results"][0]]
        if got_topn != pairs:
            _fail(f"durability: TopN {got_topn} != host {pairs}")
        launches = dict(ck.LAUNCHES)
        # The Counts of the touched rows are one body: its runs take the
        # batched expression count.
        for name in ("expr_count_batch", "densify", "topn_block_count"):
            if not launches[name]:
                _fail(f"durability: {name} did not launch after the reopen")
    finally:
        t0 = time.perf_counter()
        srv.close()
        close_s = time.perf_counter() - t0
    alone = np.asarray([ms for t0, ms in lat_ms if t0 < t_loaded])
    loaded = np.asarray([ms for t0, ms in lat_ms if t0 >= t_loaded])
    both = np.concatenate([alone, loaded])
    import_s = storm_wall - (t_loaded - t_storm)
    out = {"phase": "durability", "slices": n_slices,
           "columns": n_slices * SW, "seed_bits": seed_bits,
           "seed_s": seed_s, "spawn_to_ready_s": spawn_s,
           "storm_s": storm_wall, "acked_writes": len(acked_points),
           "acked_writes_per_s": len(acked_points) / storm_wall,
           "unacked_writes": len(points) - len(acked_points),
           "acked_import_batches": sum(1 for _, a in batches if a),
           "import_bits_per_s": import_bits / import_s,
           "ack_ms_p50": float(np.percentile(both, 50)),
           "ack_ms_p99": float(np.percentile(both, 99)),
           "acks_alone": len(alone),
           "ack_ms_p50_alone": float(np.percentile(alone, 50)),
           "ack_ms_p99_alone": float(np.percentile(alone, 99)),
           "acks_with_imports": len(loaded),
           "ack_ms_p50_with_imports": float(np.percentile(loaded, 50)),
           "ack_ms_p99_with_imports": float(np.percentile(loaded, 99)),
           "import_s": import_s,
           "slice0_imports_acked": import_tally[300]["acked"],
           "wal_swaps_seen": swaps[0], "wal_bytes_at_kill": wal_bytes,
           "snapshot_bytes_at_kill": snap_bytes,
           "respawn_to_ready_s": ready_s, "oplog_bytes_replayed": wal_bytes,
           "bits_checked": int(len(must)), "clears_checked":
           int(len(must_not)), "rows_counted": len(touched),
           "count_ms": count_ms, "topn_ms": topn_ms, "close_s": close_s,
           "mutate_ext": native_ext.EXT is not None,
           "launches": launches, "card": _card()}
    _emit(out)
    return out


_ROUTE_SLICES = (1, 2, 4, 8, 16, 64, 256)
_CAL_KEYS = ("sync_s", "upload_bps", "host_bps", "pack_bps", "device_bps")


def _median(vals):
    v = sorted(vals)
    return v[len(v) // 2]


def _request(host: str, method: str, path: str, body: bytes = b"",
             headers=None, timeout: float = 120.0):
    """(status, headers, body, client ms) of one request over a fresh
    connection; any status is returned, none fails the run."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://{host}{path}",
                                 data=body if method != "GET" else None,
                                 method=method, headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = (resp.status, dict(resp.headers), resp.read())
    except urllib.error.HTTPError as e:
        out = (e.code, dict(e.headers), e.read())
    return out + ((time.perf_counter() - t0) * 1e3,)


def _scrape(host: str) -> dict:
    """GET /metrics parsed into {sample name with labels: value};
    fails on a line that is not a comment or a sample."""
    status, _, body, _ = _request(host, "GET", "/metrics")
    if status != 200:
        _fail(f"control: /metrics answered {status}")
    return _samples(body.decode())


def _samples(text: str) -> dict:
    """A 0.0.4 exposition parsed into {sample name with labels: value}."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, sep, value = line.rpartition(" ")
        if not sep:
            _fail(f"control: /metrics line does not parse: {line!r}")
        try:
            out[name] = float(value)
        except ValueError:
            _fail(f"control: /metrics value does not parse: {line!r}")
    return out


def _family_sum(samples: dict, family: str, **labels) -> float:
    total = 0.0
    for name, v in samples.items():
        base = name.split("{", 1)[0]
        if base != family:
            continue
        if all(f'{k}="{val}"' in name for k, val in labels.items()):
            total += v
    return total


def phase_control(data_dir, device, seed: int, tmp: str,
                  n_slices: int = 256, n_requests: int = 200) -> dict:
    """The query lifecycle and the H100-calibrated routing (see the
    module docstring): the calibration, the routing table, the
    lifecycle's own cost in this process, then a ``server`` subprocess
    with one admission slot and no queue for the deadline, the cancel,
    the overload and the scrape. The two servers serve copies of the
    two indexes the phase queries (``smoke`` and ``smoke_topn``), one
    copy each (a fragment file is locked while open): opening the whole
    directory takes ~20 s a process. The subprocess starts first, so
    its start overlaps the work in this process."""
    import signal
    import subprocess

    t_phase = time.perf_counter()
    card = _card()
    dirs = {}
    for name in ("inproc", "sub"):
        dirs[name] = os.path.join(tmp, f"control_{name}")
        for index in ("smoke", "smoke_topn"):
            shutil.copytree(os.path.join(data_dir, index),
                            os.path.join(dirs[name], index))
    cal_dir = os.path.join(tmp, "costcal")
    repo = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    host = f"127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    dev_args = ["--device", "cpu"] if device.type == "cpu" else []
    log_path = os.path.join(tmp, "control_server.log")
    t_spawn = time.perf_counter()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
             "-d", dirs["sub"], "-b", host, "--query.concurrency", "1",
             "--query.queue-depth", "0", "--cost.dir", cal_dir]
            + dev_args, cwd=repo, env=env, stdout=log,
            stderr=subprocess.STDOUT)
    try:
        return _control_run(dirs["inproc"], device, n_requests, t_phase,
                            card, cal_dir, host, proc, t_spawn)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)


def _control_run(data_dir, device, n_requests, t_phase, card, cal_dir,
                 host, proc, t_spawn) -> dict:
    """``phase_control``'s checks and measurements, with the subprocess
    ``proc`` serving ``host`` (started at ``t_spawn``)."""
    import http.client
    import re
    import threading
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.parallel import costmodel
    from pilosa_tpu_torch.server.server import Server

    # 1. The calibration, five times, through the port's own code.
    runs = [costmodel.calibrate(device).to_dict() for _ in range(5)]
    cal = {k: _median([r[k] for r in runs]) for k in _CAL_KEYS}
    if not cal["device_bps"] < HBM_BYTES_PER_S:
        _fail(f"control: device_bps {cal['device_bps']} past the card's"
              f" {HBM_BYTES_PER_S}")

    # 2. The routing table and the lifecycle's cost, in this process.
    count_q = _count_queries()["intersect"]
    ids_all = list(range(1000))
    slow_q = ("TopN(Intersect(Bitmap(rowID=1, frame=src), Bitmap(rowID=2,"
              f" frame=src)), frame=t, n=1000, ids={ids_all})").encode()
    srv = Server(data_dir, host="127.0.0.1:0", device=device,
                 cal_dir=cal_dir)
    t0 = time.perf_counter()
    srv.open()
    open_s = time.perf_counter() - t0
    try:
        srv.warmup.wait(300)
        warm = srv.warmup.to_json()
        if device.type == "cuda" and (warm["state"] != "done"
                                      or warm["coverage"]["missing"]):
            _fail(f"control: warmup {warm}")
        want_slow = _topn_host_pairs(
            srv.holder, 10, lambda f: f.row(1).intersect(f.row(2)), ids_all)
        host_ex = Executor(srv.holder, device=device,
                           mesh_min_slices=1 << 30)
        dev_ex = Executor(srv.holder, device=device, **_pinned())
        routed = srv.executor
        table = []
        for width in _ROUTE_SLICES:
            slices = list(range(width))
            row = {"slices": width}
            answers = {}
            for name, ex in (("host", host_ex), ("device", dev_ex),
                             ("routed", routed)):
                vetoes = ex.cost_vetoes
                ex.execute("smoke", count_q, slices)  # warm the leg
                ms = []
                for _ in range(7):
                    out, t = _timed_query(ex, "smoke", count_q, slices)
                    ms.append(t)
                answers[name] = out[0]
                row[f"{name}_p50_ms"] = _median(ms)
                if name == "routed":
                    row["vetoes"] = ex.cost_vetoes - vetoes
                    row["route"] = ("host" if width < ex.mesh_min_slices
                                    or row["vetoes"] else "device")
            if len(set(answers.values())) != 1:
                _fail(f"control: Count at {width} slices: {answers}")
            row["answer"] = answers["host"]
            row["equal"] = True
            table.append(row)
        # The smallest width from which the device leg is never slower.
        floor = None
        for i, row in enumerate(table):
            if all(r["device_p50_ms"] <= r["host_p50_ms"] for r in table[i:]):
                floor = row["slices"]
                break
        want_count = table[-1]["answer"]
        # The lifecycle's own cost: the same requests with the ledger
        # and tracing off, then both on.
        conn = http.client.HTTPConnection(srv.host, timeout=120)

        def p50(path: str) -> dict:
            ms = []
            for i in range(20 + n_requests):
                t0 = time.perf_counter()
                conn.request("POST", path, count_q.encode())
                resp = conn.getresponse()
                body = resp.read()
                if resp.status != 200 or \
                        json.loads(body)["results"] != [want_count]:
                    _fail(f"control: {path}: {resp.status} {body[:200]!r}")
                if i >= 20:
                    ms.append((time.perf_counter() - t0) * 1e3)
            ms.sort()
            return {"p50_ms": ms[len(ms) // 2],
                    "p99_ms": ms[int(0.99 * (len(ms) - 1))]}

        srv.handler.accounting = False
        lifecycle_off = p50("/index/smoke/query")
        srv.handler.accounting = True
        lifecycle_on = p50("/index/smoke/query?trace=1")
        conn.close()
    finally:
        srv.close()

    # 3. The server subprocess with one slot and no queue.
    _wait_up(host, proc, 300)
    spawn_s = time.perf_counter() - t_spawn
    t_end = time.perf_counter() + 300
    while time.perf_counter() < t_end:
        st = json.loads(_request(host, "GET", "/status")[2])
        if st.get("warmup", {}).get("state") in ("done", "failed",
                                                 "disabled"):
            break
        time.sleep(0.2)
    if device.type == "cuda" and st["warmup"]["state"] != "done":
        _fail(f"control: subprocess warmup {st.get('warmup')}")
    path = "/index/smoke_topn/query"

    def slow_ok(status, body, k) -> bool:
        if status != 200:
            return False
        rs = json.loads(body)["results"]
        return len(rs) == k and all(
            [(p["id"], p["count"]) for p in r] == want_slow
            for r in rs)

    topn_ms = []
    for _ in range(2):  # cold, then warm
        status, _, body, ms = _request(host, "POST", path, slow_q)
        if not slow_ok(status, body, 1):
            _fail(f"control: the streaming TopN answers {status}"
                  f" {body[:200]!r}")
        topn_ms.append(ms)
    # The slow query: the TopN k times in one body, k such that it
    # runs two seconds or more whichever leg the routing takes.
    k = max(1, min(40, -int(-2000.0 // max(topn_ms[-1], 1.0))))
    slow_q = b" ".join([slow_q] * k)
    status, _, body, slow_ms = _request(host, "POST", path, slow_q)
    if not slow_ok(status, body, k):
        _fail(f"control: the slow query answers {status}")
    # Deadline: 504 with the JAX text, well before the query's time.
    status, _, body, ms = _request(host, "POST",
                                   path + "?timeout=100ms", slow_q)
    err = json.loads(body).get("error", "")
    if status != 504 or not re.fullmatch(
            r"query [0-9a-f]{16}: deadline exceeded after \d+\.\d{3}s",
            err):
        _fail(f"control: deadline answered {status} {err!r}")
    deadline = {"status": status, "error": err, "answer_ms": ms,
                "past_deadline_ms": ms - 100.0, "query_ms": slow_ms}
    # Tail sampling (on by default): the deadline's trace is kept, and
    # its record is on the disk ring under the reason "deadline".
    st_t, _, body_t, _ = _request(host, "GET", "/debug/traces")
    st_d, _, body_d, _ = _request(
        host, "GET", "/debug/traces?source=disk&reason=deadline")
    disk = json.loads(body_d) if st_d == 200 else {}
    if (st_t != 200 or json.loads(body_t).get("tail") is not True
            or disk.get("total", 0) < 1):
        _fail(f"control: the deadline's trace is not on the disk ring:"
              f" {st_t} {body_t[:200]!r} {st_d} {body_d[:300]!r}")
    deadline["tail"] = True
    deadline["disk_kept"] = disk["total"]
    deadline["disk_ring"] = disk.get("disk")

    def in_flight(qid: str, within_s: float = 30.0) -> None:
        t_end = time.perf_counter() + within_s
        while time.perf_counter() < t_end:
            qs = json.loads(_request(host, "GET", "/debug/queries")[2])
            if any(q["id"] == qid and q["state"] == "running"
                   for q in qs["queries"]):
                return
            time.sleep(0.01)
        _fail(f"control: query {qid} never ran")

    # Cancel from a second connection: 409 with the JAX text, then a
    # Count and the same TopN answer right (no torn cache or slab).
    res: dict = {}
    qid = "control-cancel"
    th = threading.Thread(target=lambda: res.setdefault(
        "r", _request(host, "POST", path, slow_q,
                      {"X-Pilosa-Query-Id": qid})))
    th.start()
    in_flight(qid)
    time.sleep(0.2)
    t_del = time.perf_counter()
    st_del, _, body_del, _ = _request(host, "DELETE",
                                      f"/debug/queries/{qid}")
    th.join(120)
    cancel_ms = (time.perf_counter() - t_del) * 1e3
    status, _, body, ms = res["r"]
    err = json.loads(body).get("error", "")
    if (st_del != 200 or json.loads(body_del) != {"id": qid,
                                                  "cancelled": 1}
            or status != 409
            or err != f"query {qid} cancelled: cancelled via API"):
        _fail(f"control: cancel answered {status} {err!r}"
              f" (DELETE {st_del} {body_del!r})")
    # The Count twice: a cold leg the model vetoes once takes the
    # device at its second sighting (Executor._device_pays).
    for _ in range(2):
        status, _, body, _ = _request(host, "POST",
                                      "/index/smoke/query",
                                      count_q.encode())
        if status != 200 or \
                json.loads(body)["results"] != [want_count]:
            _fail(f"control: Count after the cancel: {status}"
                  f" {body!r}")
    status, _, body, _ = _request(host, "POST", path, slow_q)
    if not slow_ok(status, body, k):
        _fail("control: the TopN after the cancel differs")
    cancel = {"status": 409, "error": err, "answer_ms": ms,
              "after_delete_ms": cancel_ms, "count_after": want_count}

    # Overload: one slot, no queue — one 200 and one 429.
    res = {}
    qid = "control-hold"
    th = threading.Thread(target=lambda: res.setdefault(
        "a", _request(host, "POST", path, slow_q,
                      {"X-Pilosa-Query-Id": qid})))
    th.start()
    in_flight(qid)
    during = _scrape(host)
    st_b, hd_b, body_b, ms_b = _request(host, "POST", path, slow_q)
    th.join(120)
    st_a, _, body_a, _ = res["a"]
    retry = hd_b.get("Retry-After")
    text_b = body_b.decode(errors="replace").strip()
    if (not slow_ok(st_a, body_a, k) or st_b != 429
            or not retry or not retry.isdigit()
            or text_b != "too many requests: admission queue full"
            " (0 waiting, 1 in flight)"):
        _fail(f"control: overload answered {st_a} and {st_b}"
              f" (Retry-After {retry!r}, {body_b[:200]!r})")
    overload = {"statuses": [st_a, st_b], "retry_after": retry,
                "error": text_b,
                "reject_ms": ms_b}

    # Scrape and trace.
    qid = "control-trace"
    status, hdrs, body, _ = _request(
        host, "POST", "/index/smoke/query?trace=1", count_q.encode(),
        {"X-Pilosa-Query-Id": qid})
    stats = json.loads(hdrs.get("X-Pilosa-Stats", "{}"))
    if (status != 200 or json.loads(body)["results"] != [want_count]
            or hdrs.get("X-Pilosa-Query-Id") != qid
            or not stats.get("devicePrograms", 0) > 0):
        _fail(f"control: traced Count {status}, stats {stats}")
    status, _, body, _ = _request(host, "GET", f"/debug/traces/{qid}")
    events = json.loads(body).get("traceEvents", []) \
        if status == 200 else []
    spans = [e for e in events if e.get("name") == "mesh_dispatch"]
    if not spans:
        _fail(f"control: trace {qid} holds no mesh_dispatch span"
              f" ({status})")
    after = _scrape(host)
    requests = _family_sum(after, "pilosa_query_requests_total")
    rejected = _family_sum(after, "pilosa_admission_rejections_total",
                           lane="read")
    inflight_during = _family_sum(during,
                                  "pilosa_admission_inflight_queries")
    inflight_after = _family_sum(after,
                                 "pilosa_admission_inflight_queries")
    by_status = {str(code): _family_sum(
        after, "pilosa_query_requests_total", status=str(code))
        for code in (200, 409, 429, 504)}
    if (requests <= 0 or rejected < 1 or inflight_during != 1
            or inflight_after != 0
            or min(by_status.values()) < 1):
        _fail(f"control: /metrics did not move: requests {requests},"
              f" rejected {rejected}, in flight {inflight_during} →"
              f" {inflight_after}, by status {by_status}")
    scrape = {"requests_total": requests, "by_status": by_status,
              "admission_rejections": rejected,
              "inflight_during": inflight_during,
              "inflight_after": inflight_after,
              "samples": len(after),
              "stats_header": stats,
              "mesh_dispatch_spans": [
                  {"kind": s.get("args", {}).get("kind"),
                   "dur_us": s["dur"]} for s in spans]}
    dvars = json.loads(_request(host, "GET", "/debug/vars")[2])
    out = {"phase": "control", "card": card, "calibration": cal,
           "calibration_runs": runs, "routing": table,
           "floor_measured": floor, "floor_default":
           Executor.MESH_MIN_SLICES, "open_s": open_s, "warmup": warm,
           "lifecycle_off": lifecycle_off, "lifecycle_on": lifecycle_on,
           "lifecycle_requests": n_requests, "spawn_s": spawn_s,
           "topn_ms": topn_ms, "slow_repeats": k,
           "slow_query_ms": slow_ms, "deadline": deadline,
           "cancel": cancel, "overload": overload, "scrape": scrape,
           "subprocess_vetoes": dvars.get("costModelVetoes"),
           "subprocess_cold_admits": dvars.get("coldAdmits"),
           "subprocess_cost_model": dvars.get("costModel"),
           "phase_s": time.perf_counter() - t_phase}
    _emit(out)
    return out


# -- the static cluster (BASELINE configuration 5) ----------------------------

_C5_SEG = 1_000_000  # frame f's segment row, past the Zipf row ids


def _c5_data(rng, n_slices: int, n_rows: int, total_bits: int,
             device) -> dict:
    """Configuration 5's data, made from ``rng``: frame ``f`` with
    ``n_rows`` row ids whose bit counts follow Zipf(1.1) (at least 2
    bits each, ``total_bits`` or more in all; a row's bits fall in a
    window of consecutive slices about 64 bits a slice deep, and in
    each slice within one 65,536-column container of its own, so each
    slice holds the rows whose window covers it, one container each),
    the segment row ``_C5_SEG`` of ``f`` at density 1/64, and
    configuration 4's rows 1-16 of frame ``c`` (1-8 at 1/64, 9-16 at
    1/4096). Returns ``{"f": [positions per slice], "c": [...], "seg":
    [slice-local columns per slice], "c_cols": {row: [columns per
    slice]}}``."""
    import numpy as np
    import torch
    W = 1 << _ROW_SHIFT
    w = np.arange(1, n_rows + 1, dtype=np.float64) ** -1.1
    counts = np.maximum(2, np.floor(w * (total_bits / w.sum()))).astype(
        np.int64)
    win = np.clip(-(-counts // 64), 1, n_slices)
    start = rng.integers(0, n_slices - win + 1)
    block = rng.integers(0, W >> 16, size=n_rows)  # the row's container
    # The bits themselves are drawn on the card (a generator seeded from
    # ``rng``), and their (slice, position) keys sorted and deduplicated
    # there.
    dev = device if device.type == "cuda" else torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(
        int(rng.integers(0, 2**62)))
    ct = torch.from_numpy(counts).to(dev)
    rows = torch.repeat_interleave(
        torch.arange(n_rows, dtype=torch.int64, device=dev), ct)
    slices = (torch.repeat_interleave(torch.from_numpy(start).to(dev), ct)
              + (torch.rand(len(rows), generator=gen, device=dev,
                            dtype=torch.float64)
                 * torch.repeat_interleave(torch.from_numpy(win).to(dev),
                                           ct)).long())
    cols = (torch.repeat_interleave(torch.from_numpy(block).to(dev), ct)
            << 16) + torch.randint(0, 1 << 16, (len(rows),), generator=gen,
                                   device=dev)
    keys = (slices << 40) | (rows << _ROW_SHIFT) | cols
    del rows, slices, cols
    keys = torch.unique(keys).cpu().numpy()
    bounds = np.searchsorted(keys >> 40, np.arange(n_slices + 1))
    mask = np.int64((1 << 40) - 1)
    out = {"f": [], "c": [], "seg": [], "c_cols": {r: [] for r in
                                                   range(1, 17)}}
    for s in range(n_slices):
        seg = np.unique(rng.integers(0, W, size=W // 64, dtype=np.uint64))
        pos = (keys[bounds[s]:bounds[s + 1]] & mask).astype(np.uint64)
        pos = np.concatenate((pos, np.uint64(_C5_SEG) * np.uint64(W) + seg))
        out["f"].append(pos)
        out["seg"].append(seg)
        parts = []
        for r in range(1, 17):
            c = np.unique(rng.integers(0, W, size=W // (64 if r <= 8
                                                        else 4096),
                                       dtype=np.uint64))
            out["c_cols"][r].append(c)
            parts.append(np.uint64(r) * np.uint64(W) + c)
        out["c"].append(np.concatenate(parts))
    return out


def _c5_write(task) -> None:
    """One fragment file of ``phase_cluster``: the slice's sorted
    positions as a footered roaring snapshot (the port's storage layer)
    at the first path, copied to the others (a worker of a process pool:
    the container loop is Python)."""
    positions, paths = task
    from pilosa_tpu_torch.storage import roaring
    with open(paths[0], "wb") as f:
        roaring.Bitmap.from_sorted(positions).write_to(f, footer=True)
    for path in paths[1:]:
        shutil.copyfile(paths[0], path)


class _FragSet:
    """``holder.fragment`` over {slice: sorted positions} of one frame —
    what ``_ref_topn`` reads (``frag.storage.all_positions()``)."""

    def __init__(self, positions: dict):
        import types
        self.frags = {
            s: types.SimpleNamespace(storage=types.SimpleNamespace(
                all_positions=(lambda p=p: p)))
            for s, p in positions.items()}

    def fragment(self, index, frame, view, slice):
        return self.frags.get(slice)


def _node_proc(repo, tmp, i, host, hosts, data_dir, pinned, device,
               extra=(), env_extra=None):
    """One node of the cluster: this script's child mode, which runs
    the ``server`` verb's code with the pins (or without) and prints its
    launch counters and peak device memory at exit (and writes them to
    ``node{i}.counters`` in ``tmp`` on SIGUSR1)."""
    import subprocess
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    env.update(env_extra or {})
    args = [sys.executable, os.path.abspath(__file__), "--cluster-node",
            "1" if pinned else "0", os.path.join(tmp, f"node{i}.counters"),
            "server", "-d", data_dir, "-b", host,
            "--cluster.hosts", ",".join(hosts), "--cluster.replicas", "2",
            "--cluster.type", "http", "--cluster.poll-interval", "1s",
            "--cost.dir", os.path.join(tmp, f"cal{i}")] + list(extra)
    if device.type == "cpu":
        args += ["--device", "cpu"]
    log = open(os.path.join(tmp, f"node{i}.log"), "ab")
    return subprocess.Popen(args, cwd=repo, env=env,
                            stdout=subprocess.PIPE, stderr=log)


def _node_up(hosts: list, procs: list, deadline_s: float,
             max_slice: int, index: str = "c5") -> float:
    """Seconds until every node answers and knows every slice of
    ``index`` (its own fragments, then the peers' max slices from the
    1 s poll)."""
    import urllib.request
    t0 = time.perf_counter()
    for host, proc in zip(hosts, procs):
        while True:
            if proc.poll() is not None:
                _fail(f"cluster: node {host} exited with {proc.returncode}")
            try:
                with urllib.request.urlopen(f"http://{host}/slices/max",
                                            timeout=5) as r:
                    if json.loads(r.read())["maxSlices"].get(
                            index, -1) >= max_slice:
                        break
            except OSError:
                pass
            if time.perf_counter() - t0 > deadline_s:
                _fail(f"cluster: {host} not up in {deadline_s} s")
            time.sleep(0.1)
    return time.perf_counter() - t0


def _node_counters(proc, tmp: str, i: int) -> dict:
    """A running node's launch counters and peak device MiB so far (its
    SIGUSR1 snapshot): what a node about to be SIGKILLed ran."""
    import signal
    path = os.path.join(tmp, f"node{i}.counters")
    if os.path.exists(path):
        os.remove(path)
    proc.send_signal(signal.SIGUSR1)
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > 10:
            _fail(f"cluster: node {i} wrote no counters on SIGUSR1")
        time.sleep(0.02)
    with open(path) as f:
        return json.load(f)


def _nodes_stop(procs: list, hosts: list) -> list:
    """SIGTERM every node at once; each one's launch counters and peak
    device MiB, from the line it prints at exit."""
    import signal
    import subprocess
    for proc in procs:
        proc.send_signal(signal.SIGTERM)
    lines = []
    for proc, host in zip(procs, hosts):
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            _fail(f"cluster: node {host} did not stop on SIGTERM")
        for line in out.decode().splitlines():
            if line.startswith("cluster-node "):
                lines.append(json.loads(line[len("cluster-node "):]))
                break
        else:
            _fail(f"cluster: node {host} printed no counters (rc"
                  f" {proc.returncode})")
    return lines


def _pairs_json(r) -> list:
    return [(p["id"], p["count"]) for p in r]


def phase_cluster(device, seed: int, tmp: str, n_slices: int = 64,
                  n_rows: int = 1_000_000, total_bits: int = 1 << 24,
                  n_writes: int = 1000, warm_runs: int = 5) -> dict:
    """BASELINE configuration 5 (a cluster TopN over 1 B columns ×
    1 M rows) on one card as three node processes of the port (the
    ``server`` verb, ``--cluster.type http --cluster.replicas 2``) on
    127.0.0.1, index ``c5`` cut from 954 to ``n_slices`` slices (the
    whole script's time limit). This process writes each slice's
    fragments into its two owners' data directories with the port's
    storage layer and placement (cluster.topology), and computes the
    references from them: the host popcount of each Count and
    ``_ref_topn`` of each TopN. Then, from every node as coordinator,
    the eight Count(Intersect) pairs of rows 1-16 of ``c`` in one
    body, ``TopN(frame=f, n=1000)`` (the pushdown) and
    ``TopN(Bitmap(rowID=seg, frame=f), frame=f, n=50)``: cold, warm
    (cluster result cache hits) and warm after a write to a peer's slice
    (the map-reduce again); ``n_writes`` SetBits through one
    coordinator, each read back from both owners of its slice with a
    Remote query; a SIGKILL of the peer that served the coordinator's
    pushdown, the same reads from the coordinator (the survivor serves
    the victim's slices, the breaker opens); no slice re-mapped on any
    node outside that step. Then every node restarted without the pins,
    the victim with a 5 s anti-entropy interval: one replica made to
    diverge by a Remote SetBit and the seconds until both owners' block
    checksums agree (polled while the victim answers the reads again
    and the Count is routed by the calibrated cost model, which must
    take the device leg on every node). Each pinned node's launch counters (the victim's from
    its snapshot just before the kill) must show the expression count,
    densify and the TopN block count."""
    import http.client
    import shutil
    import signal
    import threading
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from pilosa_tpu_torch.cluster.topology import new_cluster
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.proto import internal as pb
    from pilosa_tpu_torch.server import codec

    t_phase = time.perf_counter()
    marks: dict = {}  # seconds since the phase began, at each step's end

    def mark(step):
        marks[step] = time.perf_counter() - t_phase

    W = 1 << _ROW_SHIFT
    repo = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(seed + 50)
    ports = [_free_port() for _ in range(3)]
    hosts = [f"127.0.0.1:{p}" for p in ports]
    cl = new_cluster(hosts, replica_n=2)
    owners = [[n.host for n in cl.fragment_nodes("c5", s)]
              for s in range(n_slices)]
    dirs = [os.path.join(tmp, f"c5node{i}") for i in range(3)]
    idx_of = {h: i for i, h in enumerate(hosts)}
    not_owned = {h: next(s for s in range(n_slices) if h not in owners[s])
                 for h in hosts}

    # -- data: each slice's fragment files written once, as footered
    # roaring snapshots (a node rebuilds the count caches at open), into
    # the first owner's directory, then copied to the second owner's.
    t0 = time.perf_counter()
    data = _c5_data(rng, n_slices, n_rows, total_bits, device)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for d in dirs:
        h = Holder(d)
        h.open()
        idx = h.create_index("c5")
        for fname in ("f", "c", "w"):
            idx.create_frame(fname).create_view_if_not_exists("standard")
        h.close()
    import multiprocessing
    tasks = []
    for s in range(n_slices):
        for fname in ("f", "c"):
            rel = os.path.join("c5", fname, "views", "standard",
                               "fragments", str(s))
            tasks.append((data[fname][s],
                          [os.path.join(dirs[idx_of[h]], rel)
                           for h in owners[s]]))
    with multiprocessing.get_context("spawn").Pool(8) as pool:
        pool.map(_c5_write, tasks, chunksize=4)
    del tasks
    import_s = time.perf_counter() - t0
    load_s = time.perf_counter() - t0
    mark("data")

    def query(host, body, qs="", timeout=300.0):
        status, hdrs, out, ms = _request(host, "POST", f"/index/c5/query{qs}",
                                         body.encode(), timeout=timeout)
        if status != 200:
            _fail(f"cluster: {host} {body[:60]}: HTTP {status}:"
                  f" {out[:300]!r}")
        return json.loads(out)["results"], ms, hdrs

    def check(name, host, res, state):
        body, want = queries[name]
        got = res if name == "counts" else _pairs_json(res[0])
        if name != "counts":
            want = [tuple(p) for p in want]
        if got != want:
            _fail(f"cluster: {name} from {host} ({state}) differs from"
                  f" the host reference: {str(got)[:200]} !="
                  f" {str(want)[:200]}")

    n_bumps = [0]

    def bump(host):
        """A SetBit through ``host`` into a slice it does not own (frame
        ``w``, which no read touches): the peers' generation tokens
        change, so ``host``'s next read misses its cluster result
        cache and runs the map-reduce again."""
        n_bumps[0] += 1
        query(host, f"SetBit(frame=w, rowID=3, columnID="
                    f"{not_owned[host] * W + n_bumps[0]})")

    def cache_hits(host) -> float:
        return _family_sum(_scrape(host),
                           "pilosa_executor_cluster_cache_requests_total",
                           outcome="hit")

    def read_all(coords, label):
        """Every query from every coordinator: the cold ms, the warm
        p50 of ``warm_runs`` repeats (cluster result cache hits: one
        /generations probe a peer) and the warm p50 of three runs each
        after a ``bump`` (the map-reduce over warm legs)."""
        out = {}
        for host in coords:
            row = {}
            for name, (body, _) in queries.items():
                res, cold, _ = query(host, body)
                check(name, host, res, f"{label} cold")
                warm = []
                for _ in range(warm_runs):
                    res, ms, _ = query(host, body)
                    check(name, host, res, f"{label} warm")
                    warm.append(ms)
                row[name] = {"cold_ms": cold, "warm_p50_ms": _median(warm)}
                # The sourced TopN's uncached run repeats its host walk
                # over 17 K candidates (seconds each): for the phase's
                # limit its one uncached sample is the first read after
                # the kill.
                if name == "topn_src":
                    continue
                hits0 = cache_hits(host)
                uncached = []
                for _ in range(3):
                    bump(host)
                    res, ms, _ = query(host, body)
                    check(name, host, res, f"{label} uncached")
                    uncached.append(ms)
                if cache_hits(host) != hits0:
                    _fail(f"cluster: {name} from {host} hit the cluster"
                          f" result cache after a write to a peer")
                row[name]["uncached_p50_ms"] = _median(uncached)
            out[host] = row
        return out

    def rpcs(host) -> dict:
        samples = _scrape(host)
        return {peer: _family_sum(samples, "pilosa_cluster_rpc_seconds_count",
                                  peer=peer, kind="query")
                for peer in hosts if peer != host}

    def failovers(host) -> float:
        """Slices ``host`` re-mapped onto another replica after a leg
        failed: a peer's transport, query or device error alike."""
        return _family_sum(_scrape(host),
                           "pilosa_cluster_failover_slices_total")

    def remote_bits(host, frame, row, slice) -> set:
        body = codec.encode_query_request(
            f"Bitmap(rowID={row}, frame={frame})", [slice], remote=True)
        status, _, out, _ = _request(host, "POST", "/index/c5/query", body,
                                     {"Content-Type": _PB, "Accept": _PB})
        if status != 200:
            _fail(f"cluster: remote read {host} slice {slice}: {status}")
        bm = codec.decode_query_results(pb.QueryResponse.FromString(out),
                                        ["Bitmap"])[0]
        return set(bm.bits().tolist())

    procs = [None, None, None]
    try:
        # -- pinned nodes (opening while the references compute), reads
        # from every coordinator -------------------------------------------
        t0 = time.perf_counter()
        for i in range(3):
            procs[i] = _node_proc(repo, tmp, i, hosts[i], hosts, dirs[i],
                                  True, device)
        t_ref = time.perf_counter()
        n_bits = int(sum(len(p) for p in data["f"]))
        # References, from the positions the fragments were written
        # from.
        pairs = [(2 * k + 1, 2 * k + 2) for k in range(8)]
        count_body = " ".join(
            f"Count(Intersect(Bitmap(rowID={a}, frame=c),"
            f" Bitmap(rowID={b}, frame=c)))" for a, b in pairs)
        want_counts = [int(sum(len(np.intersect1d(data["c_cols"][a][s],
                                                  data["c_cols"][b][s],
                                                  assume_unique=True))
                               for s in range(n_slices))) for a, b in pairs]
        fs = _FragSet(dict(enumerate(data["f"])))
        want_top, n_cand = _ref_topn(fs, "c5", "f", n_slices, 1000)
        want_src, n_cand_src = _ref_topn(fs, "c5", "f", n_slices, 50,
                                         src_cols=data["seg"])
        # The refetch form of the sourced TopN (explicit ids, the TopN block
        # count on every node): its top 10 rows, a block every leg keeps
        # resident.
        ids10 = sorted(r for r, _ in want_src[:10])
        queries = {
            "counts": (count_body, want_counts),
            "topn1000": ("TopN(frame=f, n=1000)", want_top),
            "topn_src": (f"TopN(Bitmap(rowID={_C5_SEG}, frame=f), frame=f,"
                         f" n=50)", want_src),
            "topn_ids": (f"TopN(Bitmap(rowID={_C5_SEG}, frame=f), frame=f,"
                         f" ids={json.dumps(ids10).replace(' ', '')})",
                         want_src[:10]),
        }
        del data, fs
        ref_s = time.perf_counter() - t_ref
        up_s = _node_up(hosts, procs, 300, n_slices - 1)
        mark("up")
        t0 = time.perf_counter()
        reads = read_all(hosts, "pinned")
        reads_s = time.perf_counter() - t0
        mark("reads")
        # The pushdown's round trips: a write changes the tokens, so the
        # next TopN misses the cluster result cache and runs the
        # pushdown with the warm hint memo.
        coord = hosts[0]
        slice_remote = not_owned[coord]
        query(coord, f"SetBit(frame=w, rowID=1, columnID="
                     f"{slice_remote * W + 1})")
        before = rpcs(coord)
        res, pushdown_ms, _ = query(coord, queries["topn1000"][0])
        check("topn1000", coord, res, "pushdown")
        after = rpcs(coord)
        # One a peer when the hints (the last merge's top 1,024) cover
        # the candidate union, two when a peer must refetch the rest.
        round_trips = {p: after[p] - before[p] for p in after}

        # -- acked writes land on both owners -----------------------------
        wcols = np.unique(rng.integers(0, n_slices * W, size=n_writes,
                                       dtype=np.int64)).tolist()

        def writer(cols):
            conn = http.client.HTTPConnection(coord, timeout=120)
            for c in cols:
                conn.request("POST", "/index/c5/query",
                             f"SetBit(frame=w, rowID=7, columnID={c})"
                             .encode())
                r = conn.getresponse()
                body = r.read()
                if r.status != 200 or json.loads(body)["results"] != [True]:
                    return f"SetBit {c}: {r.status} {body[:200]!r}"
            conn.close()
            return None

        t0w = time.perf_counter()
        with ThreadPoolExecutor(4) as wp:  # four client connections
            errs = [e for e in wp.map(writer, [wcols[k::4]
                                               for k in range(4)]) if e]
        if errs:
            _fail(f"cluster: {errs[0]}")
        write_s = time.perf_counter() - t0w
        by_slice: dict = {}
        for c in wcols:
            by_slice.setdefault(c // W, set()).add(c)

        def missing(task):
            s, host = task
            return s, host, by_slice[s] - remote_bits(host, "w", 7, s)

        with ThreadPoolExecutor(8) as rp:
            for s, host, lost in rp.map(missing, [(s, h) for s in by_slice
                                                  for h in owners[s]]):
                if lost:
                    _fail(f"cluster: acked SetBits missing on owner"
                          f" {host} of slice {s}: {sorted(lost)[:5]}")

        mark("writes")

        # -- failover: SIGKILL the peer that serves the coordinator's
        # remote legs, read from the coordinator ---------------------------
        # No node has re-mapped a slice so far: a peer's device or query
        # error would have failed over to the other replica unseen.
        for host in hosts:
            if failovers(host):
                _fail(f"cluster: {host} re-mapped slices before the kill")
        victim_host = max(round_trips, key=round_trips.get)
        if round_trips[victim_host] <= 0:
            _fail(f"cluster: no peer served {coord}'s pushdown: "
                  f"{round_trips}")
        victim = idx_of[victim_host]
        survivor = next(h for h in hosts if h not in (coord, victim_host))
        victim_line = _node_counters(procs[victim], tmp, victim)
        before = rpcs(coord)
        breaker: dict = {}

        def watch_breaker():
            """Seconds from the kill until ``coord``'s breaker for the
            victim reads open (2)."""
            while time.perf_counter() - t_kill < 15:
                if _family_sum(_scrape(coord), "pilosa_fault_breaker_state",
                               peer=victim_host) == 2:
                    breaker["open_s"] = time.perf_counter() - t_kill
                    return
                time.sleep(0.05)

        procs[victim].send_signal(signal.SIGKILL)
        t_kill = time.perf_counter()
        watcher = threading.Thread(target=watch_breaker, daemon=True)
        watcher.start()
        procs[victim].wait(30)
        procs[victim].stdout.close()
        procs[victim] = None
        kill_reaped_s = time.perf_counter() - t_kill
        # Each first read after the kill misses the cluster result cache
        # (the writes above changed its tokens) and fans out: a leg sent
        # to the victim is refused and re-mapped onto the survivor,
        # unless a failed max-slice poll (1 s) has already ranked the
        # survivor first.
        failover = {"victim": victim_host, "survivor": survivor,
                    "kill_reaped_s": kill_reaped_s}
        for i, name in enumerate(queries):
            res, ms, _ = query(coord, queries[name][0])
            check(name, coord, res, "after SIGKILL")
            if i == 0:
                failover["first_ms"] = ms
                failover["first_failover_slices"] = failovers(coord)
            failover[f"{name}_first_ms"] = ms
            warm = []
            for _ in range(warm_runs):
                res, ms, _ = query(coord, queries[name][0])
                check(name, coord, res, "after SIGKILL warm")
                warm.append(ms)
            failover[f"{name}_warm_p50_ms"] = _median(warm)
        after = rpcs(coord)
        watcher.join()
        failover["survivor_legs"] = after[survivor] - before[survivor]
        failover["victim_health"] = _family_sum(
            _scrape(coord), "pilosa_cluster_peer_health", peer=victim_host)
        failover["failover_slices"] = failovers(coord)
        failover["breaker_open_s"] = breaker.get("open_s")
        if failover["survivor_legs"] <= 0:
            _fail(f"cluster: the survivor {survivor} served no leg after"
                  f" the kill: {failover}")
        if (failover["failover_slices"] <= 0
                and failover["victim_health"] >= 1.0):
            _fail(f"cluster: {coord} did not see {victim_host} die:"
                  f" {failover}")
        if failover["breaker_open_s"] is None:
            _fail(f"cluster: {coord}'s breaker for {victim_host} did not"
                  f" open in 15 s")
        mark("failover")
        node_lines = _nodes_stop([p for p in procs if p is not None],
                                 [h for h in hosts if h != victim_host])
        node_lines.insert(victim, victim_line)
        procs = [None, None, None]
        mark("stopped")

        # -- every node restarted without the pins, the victim with a 5 s
        # anti-entropy interval; one replica made to diverge --------------
        for i in range(3):
            procs[i] = _node_proc(
                repo, tmp, i, hosts[i], hosts, dirs[i], False, device,
                ("--anti-entropy.interval", "5s") if i == victim else ())
        restart_s = _node_up(hosts, procs, 300, n_slices - 1)
        mark("restart")
        s_div = next(s for s in range(n_slices)
                     if hosts[victim] in owners[s])
        other = next(h for h in owners[s_div] if h != hosts[victim])
        col = s_div * W + 4242
        body = codec.encode_query_request(
            f"SetBit(frame=w, rowID=9, columnID={col})", None, remote=True)
        status, _, out, _ = _request(other, "POST", "/index/c5/query", body,
                                     {"Content-Type": _PB, "Accept": _PB})
        if status != 200:
            _fail(f"cluster: diverging SetBit: {status} {out[:200]!r}")
        t_div = time.perf_counter()

        def blocks(host):
            st, _, out, _ = _request(
                host, "GET", f"/fragment/blocks?index=c5&frame=w"
                             f"&view=standard&slice={s_div}")
            return json.loads(out)["blocks"] if st == 200 else None

        converged: dict = {}

        def watch_sync():
            """Seconds from the divergence until both owners' block
            checksums of the fragment agree (polled in the background
            while the reads below run)."""
            while time.perf_counter() - t_div < 120:
                a, b = blocks(other), blocks(hosts[victim])
                if a is not None and a == b:
                    converged["s"] = time.perf_counter() - t_div
                    return
                time.sleep(0.25)

        syncw = threading.Thread(target=watch_sync, daemon=True)
        syncw.start()
        # The restarted victim answers again, as the coordinator.
        for name in ("counts", "topn_ids"):
            res, _, _ = query(victim_host, queries[name][0])
            check(name, victim_host, res, "after the restart")
        mark("reads_after_restart")

        # -- routed: the calibrated cost model must take the device leg ----
        routed_q = ("Count(Intersect(Bitmap(rowID=1, frame=c),"
                    " Bitmap(rowID=2, frame=c)))")
        # A cold leg's second sighting at the latest; a write into a
        # peer's slice before each run makes the cluster result cache
        # miss, so every run fans out.
        for _ in range(3):
            bump(coord)
            st, _, raw, routed_ms = _request(
                coord, "POST", "/index/c5/query?profile=1",
                routed_q.encode())
            payload = json.loads(raw)
            if st != 200 or payload["results"] != [want_counts[0]]:
                _fail(f"cluster: routed Count {st} {raw[:200]!r} !="
                      f" {want_counts[0]}")
        tree = payload["profile"]
        legs = [tree] + tree.get("children", [])
        routed = {leg["node"]: leg["devicePrograms"] for leg in legs}
        if len(legs) < 2 or any(v <= 0 for v in routed.values()):
            _fail(f"cluster: the routed Count took a host leg: {routed}")
        # No slice re-mapped after the restart, on any node.
        for host in hosts:
            if failovers(host):
                _fail(f"cluster: {host} re-mapped slices after the"
                      f" restart")
        mark("routed")
        syncw.join()
        converge_s = converged.get("s")
        if converge_s is None:
            _fail("cluster: the replicas did not converge in 120 s")
        for host in owners[s_div]:
            if col not in remote_bits(host, "w", 9, s_div):
                _fail(f"cluster: the diverged bit is missing on {host}")
        mark("converged")
        routed_lines = _nodes_stop(procs, hosts)
        procs = [None, None, None]
        mark("stopped_unpinned")
    finally:
        for p in procs:
            if p is not None:
                p.kill()
                p.communicate()
    launches: dict = {}
    nodes = []
    for line, host in zip(node_lines, hosts):
        owned = sum(host in o for o in owners)
        if owned and (line["launches"].get("expr_count_rows", 0) <= 0
                      or line["launches"].get("densify", 0) <= 0
                      or line["launches"].get("topn_block_count", 0) <= 0):
            _fail(f"cluster: node {host} owns {owned} slices and launched"
                  f" {line['launches']}")
        for k, v in line["launches"].items():
            launches[k] = launches.get(k, 0) + v
        nodes.append({"host": host, "owned_slices": owned,
                      "peak_mib": line["peak_mib"],
                      "launches": line["launches"]})
    for line in routed_lines:
        for k, v in line["launches"].items():
            launches[k] = launches.get(k, 0) + v
    phase_s = time.perf_counter() - t_phase
    out = {"phase": "cluster", "config": "BASELINE configuration 5",
           "nodes": 3, "replicas": 2, "slices": n_slices,
           "columns": n_slices * W, "row_ids": n_rows, "bits_f": n_bits,
           "reduced": [f"slices: 954 -> {n_slices} (the whole script's"
                       " 1200 s limit)"],
           "gen_s": gen_s, "import_s": import_s, "ref_s": ref_s,
           "load_s": load_s, "spawn_s": up_s, "reads_s": reads_s,
           "candidates": {"topn1000": n_cand, "topn_src": n_cand_src},
           "reads": reads, "pushdown_round_trips": round_trips,
           "pushdown_ms": pushdown_ms,
           "writes": {"n": len(wcols), "seconds": write_s,
                      "per_s": len(wcols) / write_s,
                      "slices": len(by_slice), "on_both_owners": True},
           "failover": failover, "restart_s": restart_s,
           "converge_s": converge_s, "routed_device_programs": routed,
           "routed_ms": routed_ms, "per_node": nodes,
           "launches": launches, "marks_s": marks, "card": _card(),
           "seconds": phase_s}
    _emit(out)
    if device.type == "cuda" and phase_s > 180:
        _fail(f"cluster: the phase took {phase_s:.1f} s, over 180 s")
    return out


# -- storage integrity on the static cluster ----------------------------------

def _smoke_rows(rng, n_slices: int):
    """Configuration 4's ``smoke`` layout (rows 1-8 at 1/64, 9-16 at
    1/4096), made from ``rng``: (sorted positions of each slice, the
    columns of each row in each slice)."""
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH as W
    cols = {r: [] for r in range(1, 17)}
    positions = []
    for _ in range(n_slices):
        parts = []
        for r in range(1, 17):
            c = np.unique(rng.integers(0, W, size=W // (64 if r <= 8
                                                         else 4096),
                                       dtype=np.uint64))
            cols[r].append(c)
            parts.append(np.uint64(r) * np.uint64(W) + c)
        positions.append(np.concatenate(parts))
    return positions, cols


def phase_integrity(device, seed: int, tmp: str, n_slices: int = 128,
                    n_flips: int = 5, drain_limit_s: float = 60.0) -> dict:
    """Storage integrity on three node processes of the port on the card
    (this script's child mode, pinned, replicas 2, a ``--cost.dir``
    each, the scrubber unpaced so a pass times the verification alone,
    the repairer's rescan at 1 s):
    configuration 4's ``smoke`` layout at ``n_slices`` slices, written
    into each owner's directory with the port's storage layer and
    placement, every answer held to a host reference of those bits.

    1. Clean start: every coordinator answers the 16 Count(Bitmap) and 8
       Count(Intersect) pairs in one body; ``/debug/integrity`` lists
       nothing; a synchronous scrub finds nothing, over at least the
       node's owned fragments (its seconds and MiB/s).
    2. Bit rot across a restart: one node stopped, ``n_flips`` seeded
       bytes flipped in every fragment file it owns, restarted. Its open
       quarantines (``/debug/integrity``, the detection counter); a
       thread sends Counts over random slice ranges (so the coordinators'
       cluster result caches miss) to all three nodes until the
       repairer has drained the quarantine — every answer exact, none
       failed — within ``drain_limit_s``; the repairs counter reaches
       the quarantined count; the repaired node's own leg over its owned
       slices (a remote leg, as a coordinator sends it) answers exactly
       and its expression count and densify launch; a second restart
       finds nothing quarantined.
    3. Live scrub: ``storage.read`` ``corrupt(8)*1`` armed on another
       node over ``/debug/failpoints``; a synchronous scrub reports it,
       answers stay exact under the same load, the quarantine drains,
       and a further pass is clean.
    4. Disk full: ``wal.append`` ``enospc`` armed on the third node; a
       SetBit into a slice it owns answers 507 with ``Retry-After``,
       ``/debug/vars``' ``writeReady`` shows the latch; disarmed, the
       retried SetBit acks once the latch's probe clears it, and both
       owners read the bit back.

    ``pilosa_cluster_failover_slices_total`` stays 0 on every node in
    steps 1 and 4; in steps 2-3 only legs sent to the corrupted node
    re-map (its 503 for a quarantined slice)."""
    import random
    import threading
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH as W
    from pilosa_tpu_torch.cluster.topology import new_cluster
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.proto import internal as pb
    from pilosa_tpu_torch.server import codec

    t_phase = time.perf_counter()
    marks: dict = {}

    def mark(step):
        marks[step] = time.perf_counter() - t_phase

    repo = os.path.dirname(os.path.abspath(__file__))
    itmp = os.path.join(tmp, "integrity")
    os.makedirs(itmp, exist_ok=True)
    rng = np.random.default_rng(seed + 60)
    hosts = [f"127.0.0.1:{_free_port()}" for _ in range(3)]
    cl = new_cluster(hosts, replica_n=2)
    owners = [[n.host for n in cl.fragment_nodes("smoke", s)]
              for s in range(n_slices)]
    owned = {h: [s for s in range(n_slices) if h in owners[s]]
             for h in hosts}
    dirs = [os.path.join(itmp, f"node{i}data") for i in range(3)]

    def frag_path(i, s):
        return os.path.join(dirs[i], "smoke", "f", "views", "standard",
                            "fragments", str(s))

    t0 = time.perf_counter()
    for d in dirs:
        h = Holder(d)
        h.open()
        h.create_index("smoke").create_frame("f") \
            .create_view_if_not_exists("standard")
        h.close()
    positions, cols = _smoke_rows(rng, n_slices)
    for s in range(n_slices):
        _c5_write((positions[s], [frag_path(hosts.index(h), s)
                                  for h in owners[s]]))
    n_bits = int(sum(len(p) for p in positions))
    del positions
    pairs = [(2 * k + 1, 2 * k + 2) for k in range(8)]
    inter = {p: [len(np.intersect1d(cols[p[0]][s], cols[p[1]][s],
                                    assume_unique=True))
                 for s in range(n_slices)] for p in pairs}
    row_n = {r: [len(c) for c in cols[r]] for r in cols}
    del cols

    def want_for(slices) -> list:
        return ([int(sum(row_n[r][s] for s in slices))
                 for r in range(1, 17)]
                + [int(sum(inter[p][s] for s in slices)) for p in pairs])

    want = want_for(range(n_slices))
    body = " ".join(
        [f"Count(Bitmap(rowID={r}, frame=f))" for r in range(1, 17)]
        + [f"Count(Intersect(Bitmap(rowID={a}, frame=f),"
           f" Bitmap(rowID={b}, frame=f)))" for a, b in pairs])
    data_s = time.perf_counter() - t0
    mark("data")

    def spawn(i):
        # The scrubber unpaced (a pass times the verification alone) and
        # the repairer's rescan at 1 s (default 15 s): an open-time
        # quarantine waits for the first rescan, so the drain then times
        # the re-stream and not the cadence.
        return _node_proc(repo, itmp, i, hosts[i], hosts, dirs[i], True,
                          device, env_extra={
                              "PILOSA_SCRUB_PACE": "0s",
                              "PILOSA_SCRUB_REPAIR_RESCAN": "1s"})

    def query(host, q, qs=""):
        st, _, out, ms = _request(host, "POST", f"/index/smoke/query{qs}",
                                  q.encode(), timeout=300)
        if st != 200:
            _fail(f"integrity: {host} {q[:60]}: HTTP {st}: {out[:300]!r}")
        return json.loads(out)["results"], ms

    def get_json(host, path):
        st, _, out, _ = _request(host, "GET", path)
        if st != 200:
            _fail(f"integrity: GET {path} on {host}: {st}")
        return json.loads(out)

    def post(host, path, payload=b""):
        st, hd, out, ms = _request(host, "POST", path, payload)
        if st != 200:
            _fail(f"integrity: POST {path} on {host}: {st} {out[:200]!r}")
        return json.loads(out), ms

    def failovers(host, **labels) -> float:
        return _family_sum(_scrape(host),
                           "pilosa_cluster_failover_slices_total", **labels)

    def metric(host, family, **labels) -> float:
        return _family_sum(_scrape(host), family, **labels)

    def only_to(node, label):
        """Step ``label``'s re-maps: only legs sent to ``node``."""
        for h in hosts:
            other = failovers(h) - failovers(h, peer=node)
            if other:
                _fail(f"integrity: {h} re-mapped {other} slices of legs"
                      f" to nodes other than {node} ({label})")

    def drain(host, t_from) -> float:
        while time.perf_counter() - t_from < drain_limit_s:
            if not get_json(host, "/debug/integrity")["quarantined"]:
                return time.perf_counter() - t_from
            time.sleep(0.25)
        _fail(f"integrity: the quarantine on {host} did not drain in"
              f" {drain_limit_s} s: {get_json(host, '/debug/integrity')}")

    lat: dict = {h: {} for h in hosts}
    violations: list = []

    class Load:
        """Counts of one of rows 1-8 over a random slice range, to a
        random node, until stopped; every answer checked."""

        def __init__(self, label, k):
            self.label, self.stop = label, threading.Event()
            self.n = 0
            self.lrng = random.Random(seed + k)
            self.th = threading.Thread(target=self.run, daemon=True)
            self.th.start()

        def run(self):
            while not self.stop.is_set():
                h = hosts[self.lrng.randrange(3)]
                r = 1 + self.lrng.randrange(8)
                span = max(1, min(32, n_slices // 2))
                lo = self.lrng.randrange(n_slices - span + 1)
                hi = self.lrng.randrange(lo + span, n_slices + 1)
                qs = "?slices=" + ",".join(map(str, range(lo, hi)))
                st, _, out, ms = _request(
                    h, "POST", f"/index/smoke/query{qs}",
                    f"Count(Bitmap(rowID={r}, frame=f))".encode(),
                    timeout=120)
                got = json.loads(out).get("results") if st == 200 else None
                exp = [int(sum(row_n[r][lo:hi]))]
                if got != exp:
                    violations.append((self.label, h, r, lo, hi, st,
                                       got, exp, out[:160]))
                    continue
                self.n += 1
                lat[h].setdefault(self.label, []).append(ms)

        def end(self):
            self.stop.set()
            self.th.join(180)
            if violations:
                _fail(f"integrity: {len(violations)} wrong or failed"
                      f" answers ({self.label}): {violations[:3]}")
            if not self.n:
                _fail(f"integrity: no Count answered ({self.label})")
            return self.n

    procs = [None, None, None]
    lines = []
    try:
        # -- 1. clean start ---------------------------------------------------
        t0 = time.perf_counter()
        for i in range(3):
            procs[i] = spawn(i)
        up_s = _node_up(hosts, procs, 300, n_slices - 1, "smoke")
        mark("spawn")
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(3) as pool:
            cold = dict(zip(hosts, pool.map(lambda h: query(h, body),
                                            hosts)))
        cold_ms = {}
        for h, (res, cold_ms[h]) in cold.items():
            if res != want:
                _fail(f"integrity: {h} clean: {res} != {want}")
        scrub = {}
        for i, h in enumerate(hosts):
            if get_json(h, "/debug/integrity")["quarantined"]:
                _fail(f"integrity: {h} quarantined at a clean start")
            out, ms = post(h, "/debug/integrity/scrub?sync=1")
            if out["corrupt"] != 0 or out["fragments"] < len(owned[h]):
                _fail(f"integrity: clean scrub on {h}: {out}")
            mib = sum(os.path.getsize(frag_path(i, s))
                      for s in owned[h]) / 2**20
            scrub[h] = {"fragments": out["fragments"],
                        "blocks": out["blocks"], "mib": mib,
                        "seconds": out["seconds"], "request_ms": ms,
                        "mib_per_s": (mib / out["seconds"]
                                      if out["seconds"] else None)}
        for h in hosts:
            if failovers(h):
                _fail(f"integrity: {h} re-mapped slices at a clean start")
        mark("clean")

        # -- 2. bit rot across a restart --------------------------------------
        victim = 1
        vh = hosts[victim]
        lines += _nodes_stop([procs[victim]], [vh])
        procs[victim] = None
        frng = random.Random(seed + 61)
        for s in owned[vh]:
            path = frag_path(victim, s)
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                for _ in range(n_flips):
                    off = frng.randrange(size)
                    f.seek(off)
                    b = f.read(1)[0]
                    f.seek(off)
                    f.write(bytes([b ^ (1 << frng.randrange(8))]))
        t_spawn = time.perf_counter()
        procs[victim] = spawn(victim)
        restart_corrupt_s = _node_up([vh], [procs[victim]], 300,
                                     n_slices - 1, "smoke")
        t_ready = time.perf_counter()
        n_q = len(get_json(vh, "/debug/integrity")["quarantined"])
        detected = metric(vh, "pilosa_storage_corruption_detected_total")
        if not n_q or detected < 1:
            _fail(f"integrity: the restart quarantined {n_q} fragments,"
                  f" detected {detected}")
        counters0 = _node_counters(procs[victim], itmp, victim)
        load = Load("quarantine", 62)
        drained_s = drain(vh, t_ready)
        load.label = "after"
        time.sleep(2.0)
        n_load = load.end()
        repaired = metric(vh, "pilosa_storage_repairs_total",
                          outcome="repaired")
        if repaired < n_q:
            _fail(f"integrity: {repaired} repairs for {n_q} quarantined")
        leg = codec.encode_query_request(body, owned[vh], remote=True)
        st, _, out, leg_ms = _request(vh, "POST", "/index/smoke/query", leg,
                                      {"Content-Type": _PB, "Accept": _PB})
        got = (codec.decode_query_results(pb.QueryResponse.FromString(out),
                                          ["Count"] * len(want))
               if st == 200 else None)
        if got != want_for(owned[vh]):
            _fail(f"integrity: the repaired node's leg: {st} {got}")
        counters1 = _node_counters(procs[victim], itmp, victim)
        for k in ("expr_count_rows", "densify"):
            if counters1["launches"][k] <= counters0["launches"][k]:
                _fail(f"integrity: {k} did not launch on the repaired"
                      f" node: {counters0} → {counters1}")
        only_to(vh, "bit rot")
        mark("bit_rot")
        lines += _nodes_stop([procs[victim]], [vh])
        procs[victim] = None
        procs[victim] = spawn(victim)
        restart_clean_s = _node_up([vh], [procs[victim]], 300,
                                   n_slices - 1, "smoke")
        if get_json(vh, "/debug/integrity")["quarantined"]:
            _fail("integrity: a repaired fragment quarantined again at"
                  " the next restart")
        res, _ = query(vh, body)
        if res != want:
            _fail(f"integrity: after the clean restart: {res} != {want}")
        mark("clean_restart")

        # -- 3. live scrub ----------------------------------------------------
        ch = hosts[2]
        fo0 = {h: failovers(h) - failovers(h, peer=ch) for h in hosts}
        post(ch, "/debug/failpoints", json.dumps(
            {"site": "storage.read", "spec": "corrupt(8)*1"}).encode())
        load = Load("live", 63)
        t0 = time.perf_counter()
        out, live_scrub_ms = post(ch, "/debug/integrity/scrub?sync=1")
        if out["corrupt"] < 1:
            _fail(f"integrity: the armed scrub found nothing: {out}")
        live = {"corrupt": out["corrupt"], "scrub_ms": live_scrub_ms,
                "drained_s": drain(ch, t0)}
        n_load += load.end()
        if metric(ch, "pilosa_storage_corruption_detected_total") < 1:
            _fail("integrity: no detection counted on the scrubbed node")
        again, _ = post(ch, "/debug/integrity/scrub?sync=1")
        if again["corrupt"]:
            _fail(f"integrity: a further scrub found {again}")
        for h in hosts:
            res, _ = query(h, body)
            if res != want:
                _fail(f"integrity: {h} after the live scrub: {res}")
            if failovers(h) - failovers(h, peer=ch) != fo0[h]:
                _fail(f"integrity: {h} re-mapped slices of legs to nodes"
                      f" other than {ch} (live scrub)")
        mark("live_scrub")

        # -- 4. disk full -----------------------------------------------------
        ah = hosts[0]
        fo0 = {h: failovers(h) for h in hosts}
        s_w = owned[ah][0]
        col = s_w * W + 4242
        setbit = f"SetBit(frame=f, rowID=30, columnID={col})".encode()
        post(ah, "/debug/failpoints", json.dumps(
            {"site": "wal.append", "spec": "enospc"}).encode())
        st, hd, out, ms_507 = _request(ah, "POST", "/index/smoke/query",
                                       setbit)
        retry_after = hd.get("Retry-After")
        if st != 507 or not retry_after:
            _fail(f"integrity: SetBit under ENOSPC answered {st}"
                  f" (Retry-After {retry_after!r}): {out[:200]!r}")
        latch = get_json(ah, "/debug/vars")["writeReady"]
        if latch["writeReady"] or latch["site"] != "wal.append":
            _fail(f"integrity: /debug/vars writeReady {latch}")
        events = metric(ah, "pilosa_storage_enospc_events_total")
        post(ah, "/debug/failpoints", json.dumps(
            {"site": "wal.append", "spec": "off"}).encode())
        t0 = time.perf_counter()
        statuses = []
        while True:
            st, _, out, _ = _request(ah, "POST", "/index/smoke/query",
                                     setbit)
            statuses.append(st)
            if st == 200:
                break
            if st != 507 or time.perf_counter() - t0 > 15:
                _fail(f"integrity: the retried SetBit answered {st}"
                      f" {out[:200]!r}")
            time.sleep(0.25)
        write_ready_s = time.perf_counter() - t0
        for owner in owners[s_w]:
            q = codec.encode_query_request("Bitmap(rowID=30, frame=f)",
                                           [s_w], remote=True)
            st, _, out, _ = _request(owner, "POST", "/index/smoke/query",
                                     q, {"Content-Type": _PB,
                                         "Accept": _PB})
            bm = codec.decode_query_results(
                pb.QueryResponse.FromString(out), ["Bitmap"])[0] \
                if st == 200 else None
            if bm is None or col not in set(bm.bits().tolist()):
                _fail(f"integrity: the acked bit is missing on {owner}")
        if not get_json(ah, "/debug/vars")["writeReady"]["writeReady"]:
            _fail("integrity: the node stayed write-unready")
        for h in hosts:
            if failovers(h) != fo0[h]:
                _fail(f"integrity: {h} re-mapped slices in the disk-full"
                      " step")
        mark("disk_full")
        lines += _nodes_stop(procs, hosts)
        procs = [None, None, None]
        mark("stopped")
    finally:
        for p in procs:
            if p is not None:
                p.kill()
                p.communicate()
    launches: dict = {}
    for line in lines:
        for k, v in line["launches"].items():
            launches[k] = launches.get(k, 0) + v
    # lines: the victim's two stops, then the three nodes at the end.
    peak = {h: lines[2 + i]["peak_mib"] for i, h in enumerate(hosts)}
    peak[vh] = max(peak[vh], lines[0]["peak_mib"], lines[1]["peak_mib"])
    for name in ("expr_count_rows", "densify"):
        if launches.get(name, 0) <= 0:
            _fail(f"integrity: {name} did not launch on the nodes")

    def p50(h, label):
        v = lat[h].get(label)
        return _median(v) if v else None

    phase_s = time.perf_counter() - t_phase
    out = {"phase": "integrity", "config": "BASELINE configuration 4",
           "nodes": 3, "replicas": 2, "slices": n_slices, "bits": n_bits,
           "owned_slices": {h: len(owned[h]) for h in hosts},
           "data_s": data_s, "spawn_s": up_s, "cold_ms": cold_ms,
           "scrub": scrub,
           "restart_to_ready_s": {"corrupted": restart_corrupt_s,
                                  "clean": restart_clean_s,
                                  "spawn_to_quarantined_s":
                                  t_ready - t_spawn},
           "quarantined": n_q, "detected": detected,
           "quarantine_to_drained_s": drained_s, "repaired": repaired,
           "count_p50_ms": {h: {"quarantine": p50(h, "quarantine"),
                                "after": p50(h, "after"),
                                "live_scrub": p50(h, "live")}
                            for h in hosts},
           "load_answers": n_load, "repaired_leg_ms": leg_ms,
           "live_scrub": live,
           "disk_full": {"status": 507, "ms": ms_507,
                         "retry_after": retry_after, "latch": latch,
                         "enospc_events": events,
                         "retries": statuses,
                         "write_ready_s": write_ready_s},
           "launches": launches, "peak_mib": peak, "marks_s": marks,
           "card": _card(), "seconds": phase_s}
    _emit(out)
    if device.type == "cuda" and phase_s > 150:
        _fail(f"integrity: the phase took {phase_s:.1f} s, over 150 s")
    return out


GOSSIP_HEDGE = "50ms"     # the gossip phase's [fault] hedge floor
# Longest SIGSTOP of the hedge step, well under the failure detector's
# ~14 s to DOWN. The hedge legs land on the replica whose slabs for
# those slices are cold: all 8 Counts took 1.9-2.4 s on an NVIDIA H100
# 80GB HBM3 at 700 W, too near a 3 s bound.
GOSSIP_STOP_S = 6.0


def _gossip_toml(path: str, data_dir: str, host: str, hosts: list,
                 internal_port: int, seed: str, secret: str) -> None:
    """One node's TOML configuration for ``phase_gossip``: gossip
    membership on ``internal_port`` (seeded from ``seed`` unless empty),
    the HMAC ``secret`` and the placement over ``hosts`` with replicas 2.
    The max-slice poll is at 5 minutes: the gossip push/pull carries the
    peers' max slices, and no request of this node reaches a dead peer
    before its membership declares it dead. Hedged reads are armed at a
    50 ms floor (``[fault] hedge``)."""
    hosts_toml = ", ".join(f'"{h}"' for h in hosts)
    with open(path, "w") as f:
        f.write(f"""data-dir = "{data_dir}"
host = "{host}"

[cluster]
replicas = 2
type = "gossip"
hosts = [{hosts_toml}]
polling-interval = "5m"
internal-port = "{internal_port}"
gossip-seed = "{seed}"
gossip-secret = "{secret}"

[fault]
hedge = "{GOSSIP_HEDGE}"
""")


def phase_gossip(device, seed: int, tmp: str, n_slices: int = 128,
                 warm_runs: int = 5, up_limit_s: float = 120.0) -> dict:
    """Gossip membership on three node processes of the port on the card
    (this script's child mode, pinned), each started from a TOML file
    this phase writes (``server -c FILE`` and nothing else on the card):
    ``cluster.type = "gossip"``, an internal port each, nodes 1 and 2
    seeded from node 0's, an HMAC secret, the placement over the three
    HTTP hosts with replicas 2, hedged reads at a 50 ms floor. Configuration 4's ``smoke`` layout at
    ``n_slices`` slices (16 rows, rows 1-8 at 1/64, 9-16 at 1/4096) is
    written into each owner's directory with the port's storage layer
    and placement; every answer is held to a host reference of those
    bits.

    1. Ready: the seconds from spawn until every ``/health`` answers 200
       with its gossip check ``3 nodes UP`` (and every node knows every
       slice).
    2. Schema over gossip: frame ``g`` created on node 0, the seconds
       until nodes 1 and 2 list it; bits imported to it through node 1
       (to every owner) and counted exactly on node 2.
    3. Reads: from each node as coordinator, the 16 Count(Bitmap) and 8
       Count(Intersect) in one body, ``TopN(frame=f, n=50)`` and the
       sourced ``TopN(Bitmap(rowID=1, frame=f), frame=f, n=50)`` (the
       TopN block count on every owner's refetch leg), cold and warm.
       The victim-to-be is the peer that served the most of node 0's
       legs; the other peer is the "other".
    4. Federation: node 0's ``/metrics/cluster`` answers 200 with
       ``X-Pilosa-Federated-Nodes: 3`` and its merged
       ``pilosa_query_requests_total`` lies between the sum of the three
       nodes' own ``/metrics`` scraped just before and just after;
       ``/debug/cluster`` has the three blocks, one epoch and
       ``versionSkew: false``.
    5. Hedge: 8 Count(Intersect) over pairs not asked before (so the
       cluster result cache has no entry whose validation would probe
       the stopped peer) from node 0, one after another (the unstopped
       uncached p50). The peer that served those legs (replicas are
       consecutive nodes of the placement, so one peer is first on
       every slice node 0 does not own) is SIGSTOPped for at most ``GOSSIP_STOP_S`` (under the detector's
       ~14 s to DOWN) and 8 more such Counts go at once: each exact,
       each back before the SIGCONT, node 0's ``hedge_won`` up, the
       other peer (which serves the hedge legs) having launched the
       expression count meanwhile, and neither node 0 nor it marking the
       stopped peer DOWN. The delay is the larger of the hedge floor and
       node 0's latency tail of the stopped peer, read just before.
    6. Death: the victim-to-be is SIGKILLed (its launch counters read
       just before). Each survivor's seconds until its ``/status`` marks
       it DOWN; its breaker for it must then be open for the reason
       "gossip dead" once the membership's state-change callback has run
       (read for at most 2 s after DOWN; the lag is on the line as
       ``breaker_lag_ms``), then its ``/health`` 503 with
       ``down: <victim>``. Node 0's reads again, exact, with the first
       Count's ms, the survivor's legs and the re-mapped slices.
    7. Partial: node 0's ``rpc.send`` failpoint armed to partition the
       other peer (``POST /debug/failpoints``), so no owner of the
       slices node 0 does not own is reachable. A Count(Intersect) over
       a fresh pair fails without ``?partial=1`` (400: the client error
       of the last replica tried, in both packages) and answers 200 with
       it, ``X-Pilosa-Partial`` exactly those slices from the placement
       and the count the host reference over node 0's slices;
       ``/metrics/cluster`` answers 503, and 200 under ``?partial=1``
       with ``X-Pilosa-Partial-Nodes`` naming both peers. Disarmed; node
       0's breaker for the other peer closes again.
    8. Rejoin: the victim restarted from its file; the seconds until all
       three ``/health`` answer 200 again; its reads exact.
    9. Kernels: each node of the first life (the victim's snapshot)
       launched the expression count, densify and the TopN block
       count."""
    import signal
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH as W
    from pilosa_tpu_torch.cluster.client import Client
    from pilosa_tpu_torch.cluster.topology import new_cluster
    from pilosa_tpu_torch.models.holder import Holder

    t_phase = time.perf_counter()
    marks: dict = {}

    def mark(step):
        marks[step] = time.perf_counter() - t_phase

    repo = os.path.dirname(os.path.abspath(__file__))
    gtmp = os.path.join(tmp, "gossip")
    os.makedirs(gtmp, exist_ok=True)
    rng = np.random.default_rng(seed + 70)
    hosts = [f"127.0.0.1:{_free_port()}" for _ in range(3)]
    gports = [_free_port() for _ in range(3)]
    cl = new_cluster(hosts, replica_n=2)
    owners = [[n.host for n in cl.fragment_nodes("smoke", s)]
              for s in range(n_slices)]
    dirs = [os.path.join(gtmp, f"node{i}data") for i in range(3)]
    tomls = [os.path.join(gtmp, f"node{i}.toml") for i in range(3)]
    for i in range(3):
        _gossip_toml(tomls[i], dirs[i], hosts[i], hosts, gports[i],
                     f"127.0.0.1:{gports[0]}" if i else "", "smoke-gossip")

    def frag_path(i, s):
        return os.path.join(dirs[i], "smoke", "f", "views", "standard",
                            "fragments", str(s))

    t0 = time.perf_counter()
    for d in dirs:
        h = Holder(d)
        h.open()
        h.create_index("smoke").create_frame("f") \
            .create_view_if_not_exists("standard")
        h.close()
    positions, cols = _smoke_rows(rng, n_slices)
    for s in range(n_slices):
        _c5_write((positions[s], [frag_path(hosts.index(h), s)
                                  for h in owners[s]]))
    n_bits = int(sum(len(p) for p in positions))
    del positions
    pairs = [(2 * k + 1, 2 * k + 2) for k in range(8)]
    row_total = {r: int(sum(len(c) for c in cols[r])) for r in cols}
    want = ([row_total[r] for r in range(1, 17)]
            + [int(sum(len(np.intersect1d(cols[a][s], cols[b][s],
                                          assume_unique=True))
                       for s in range(n_slices))) for a, b in pairs])
    src = {r: int(sum(len(np.intersect1d(cols[1][s], cols[r][s],
                                         assume_unique=True))
                      for s in range(n_slices))) for r in cols}
    # Pairs that step 3 does not ask, for the hedge step (16 drawn) and
    # the partial step (two dense rows): each pair's count in each slice.
    fresh = [(a, b) for a in range(1, 17) for b in range(a + 1, 17)
             if (a, b) not in pairs and (a, b) != (1, 3)]
    fresh = [fresh[int(k)] for k in rng.choice(len(fresh), size=16,
                                                replace=False)] + [(1, 3)]
    fresh_counts = {p: np.array([len(np.intersect1d(
        cols[p[0]][s], cols[p[1]][s], assume_unique=True))
        for s in range(n_slices)]) for p in fresh}
    del cols
    body = " ".join(
        [f"Count(Bitmap(rowID={r}, frame=f))" for r in range(1, 17)]
        + [f"Count(Intersect(Bitmap(rowID={a}, frame=f),"
           f" Bitmap(rowID={b}, frame=f)))" for a, b in pairs])
    # TopN's reference: n = 50 keeps every row of every slice, so the
    # answer is each row's exact total, count descending, id ascending.
    reads = {
        "count": (body, want),
        "topn": ("TopN(frame=f, n=50)",
                 sorted(row_total.items(), key=lambda p: (-p[1], p[0]))),
        "topn_src": ("TopN(Bitmap(rowID=1, frame=f), frame=f, n=50)",
                     sorted(((r, c) for r, c in src.items() if c),
                            key=lambda p: (-p[1], p[0]))),
    }
    data_s = time.perf_counter() - t0
    mark("data")

    def spawn(i):
        args = [sys.executable, os.path.abspath(__file__),
                "--cluster-node", "1",
                os.path.join(gtmp, f"node{i}.counters"),
                "server", "-c", tomls[i]]
        if device.type == "cpu":
            args += ["--device", "cpu"]
        import subprocess
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = repo
        log = open(os.path.join(gtmp, f"node{i}.log"), "ab")
        return subprocess.Popen(args, cwd=repo, env=env,
                                stdout=subprocess.PIPE, stderr=log)

    def get_json(host, path, ok=(200,)):
        st, _, out, _ = _request(host, "GET", path, timeout=30)
        if st not in ok:
            _fail(f"gossip: GET {path} on {host}: {st} {out[:200]!r}")
        return st, json.loads(out)

    def health(host):
        try:
            return get_json(host, "/health", ok=(200, 503))
        except OSError:
            return None, None

    def ready(targets, procs_, t_from):
        """Seconds from ``t_from`` until every target's /health is 200
        with ``3 nodes UP`` and it knows every slice of ``smoke``."""
        while True:
            for p in procs_:
                if p is not None and p.poll() is not None:
                    _fail(f"gossip: a node exited with {p.returncode}")
            done = True
            for h in targets:
                st, out = health(h)
                if (st != 200 or out["checks"]["gossip"]["detail"]
                        != "3 nodes UP"):
                    done = False
                    break
                if get_json(h, "/slices/max")[1]["maxSlices"].get(
                        "smoke", -1) < n_slices - 1:
                    done = False
                    break
            if done:
                return time.perf_counter() - t_from
            if time.perf_counter() - t_from > up_limit_s:
                _fail(f"gossip: not ready in {up_limit_s} s:"
                      f" {[health(h) for h in targets]}")
            time.sleep(0.1)

    def query(host, q):
        st, _, out, ms = _request(host, "POST", "/index/smoke/query",
                                  q.encode(), timeout=300)
        if st != 200:
            _fail(f"gossip: {host} {q[:60]}: HTTP {st}: {out[:300]!r}")
        return json.loads(out)["results"], ms

    def check(name, host, label):
        q, w = reads[name]
        res, ms = query(host, q)
        got = res if name == "count" else _pairs_json(res[0])
        if got != w:
            _fail(f"gossip: {name} from {host} ({label}): {got} != {w}")
        return ms

    def rpcs(host) -> dict:
        samples = _scrape(host)
        return {peer: _family_sum(samples,
                                  "pilosa_cluster_rpc_seconds_count",
                                  peer=peer, kind="query")
                for peer in hosts if peer != host}

    def failovers(host) -> float:
        return _family_sum(_scrape(host),
                           "pilosa_cluster_failover_slices_total")

    def hedged(host) -> dict:
        samples = _scrape(host)
        return {o: _family_sum(samples,
                               "pilosa_cluster_hedged_requests_total",
                               outcome=o)
                for o in ("fired", "primary_won", "hedge_won")}

    def fresh_q(p):
        return (f"Count(Intersect(Bitmap(rowID={p[0]}, frame=f),"
                f" Bitmap(rowID={p[1]}, frame=f)))")

    def fresh_check(p, st, body, label):
        want_p = int(fresh_counts[p].sum())
        got = json.loads(body)["results"] if st == 200 else None
        if got != [want_p]:
            _fail(f"gossip: {label} {p}: HTTP {st} {got} != [{want_p}]"
                  f" {body[:200]!r}")

    def requests_total() -> float:
        return sum(_family_sum(_scrape(h), "pilosa_query_requests_total")
                   for h in hosts)

    procs = [None, None, None]
    lines: list = []
    try:
        # -- 1. ready ---------------------------------------------------------
        # The seed first: a node whose join finds no seed listening
        # stays alone (the periodic push/pull targets known members).
        t0 = time.perf_counter()
        procs[0] = spawn(0)
        _wait_up(hosts[0], procs[0], up_limit_s)
        procs[1:] = [spawn(1), spawn(2)]
        ready_s = ready(hosts, procs, t0)
        mark("ready")

        # -- 2. schema over gossip -------------------------------------------
        t0 = time.perf_counter()
        st, _, out, _ = _request(hosts[0], "POST", "/index/smoke/frame/g",
                                 b"{}")
        if st != 200:
            _fail(f"gossip: create frame g: {st} {out[:200]!r}")
        schema_s = {}
        while len(schema_s) < 2:
            for h in hosts[1:]:
                if h in schema_s:
                    continue
                frames = [f["name"] for ix in get_json(h, "/schema")[1][
                    "indexes"] if ix["name"] == "smoke"
                    for f in ix.get("frames", [])]
                if "g" in frames:
                    schema_s[h] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 30:
                _fail(f"gossip: frame g not on {hosts[1:]} in 30 s")
            time.sleep(0.02)
        g_rows = rng.integers(1, 5, size=200_000).astype(np.uint64)
        g_cols = rng.integers(0, n_slices * W, size=200_000).astype(
            np.uint64)
        c = Client(hosts[1])
        try:
            c.import_arrays("smoke", "g", g_rows, g_cols)
        finally:
            c.close()
        g_want = [len(np.unique(g_cols[g_rows == r])) for r in range(1, 5)]
        g_got, _ = query(hosts[2], " ".join(
            f"Count(Bitmap(rowID={r}, frame=g))" for r in range(1, 5)))
        if g_got != g_want:
            _fail(f"gossip: frame g counted on {hosts[2]}: {g_got} !="
                  f" {g_want}")
        mark("schema")

        # -- 3. reads from every coordinator ---------------------------------
        rpcs0 = rpcs(hosts[0])
        lat: dict = {}
        for h in hosts:
            row = lat[h] = {}
            for name in reads:
                cold = check(name, h, "cold")
                warm = [check(name, h, "warm") for _ in range(warm_runs)]
                row[name] = {"cold_ms": cold, "warm_p50_ms": _median(warm)}
        legs = {p: v - rpcs0[p] for p, v in rpcs(hosts[0]).items()}
        victim_host = max(legs, key=legs.get)
        if legs[victim_host] <= 0:
            _fail(f"gossip: no peer served {hosts[0]}'s legs: {legs}")
        for h in hosts:
            if failovers(h):
                _fail(f"gossip: {h} re-mapped slices before the kill")
        victim = hosts.index(victim_host)
        survivors = [h for h in hosts if h != victim_host]
        other = next(h for h in survivors if h != hosts[0])
        mark("reads")

        # -- 4. federation ----------------------------------------------------
        sum_before = requests_total()
        st, hs, out, fed_ms = _request(hosts[0], "GET", "/metrics/cluster",
                                       timeout=30)
        sum_after = requests_total()
        merged = (_family_sum(_samples(out.decode()),
                              "pilosa_query_requests_total")
                  if st == 200 else None)
        if (st != 200 or hs.get("X-Pilosa-Federated-Nodes") != "3"
                or not sum_before <= merged <= sum_after):
            _fail(f"gossip: /metrics/cluster: {st}"
                  f" {hs.get('X-Pilosa-Federated-Nodes')} merged {merged}"
                  f" not in [{sum_before}, {sum_after}]")
        st, hs, out, roll_ms = _request(hosts[0], "GET", "/debug/cluster",
                                        timeout=30)
        roll = json.loads(out) if st == 200 else {}
        epochs = {b.get("epoch") for b in roll.get("nodes", {}).values()}
        if (st != 200 or sorted(roll["nodes"]) != sorted(hosts)
                or len(epochs) != 1 or roll["versionSkew"] is not False):
            _fail(f"gossip: /debug/cluster: {st} {out[:300]!r}")
        federation = {"metrics_cluster_ms": fed_ms,
                      "debug_cluster_ms": roll_ms, "federated_nodes": 3,
                      "requests_total": [sum_before, merged, sum_after],
                      "epochs": sorted(epochs)}
        mark("federation")

        # -- 5. hedge ---------------------------------------------------------
        base_ms = []
        rpcs_base = rpcs(hosts[0])
        for p in fresh[:8]:
            st, _, out, ms = _request(hosts[0], "POST", "/index/smoke/query",
                                      fresh_q(p).encode(), timeout=60)
            fresh_check(p, st, out, "unstopped Count")
            base_ms.append(ms)
        base_legs = {h: v - rpcs_base[h] for h, v in rpcs(hosts[0]).items()}
        # The peer node 0 sends these legs to is stopped; the other one
        # serves the hedges.
        stop_host = max(base_legs, key=base_legs.get)
        serve_host = next(h for h in base_legs if h != stop_host)
        if base_legs[stop_host] <= 0:
            _fail(f"gossip: no leg left {hosts[0]} for the fresh Counts:"
                  f" {base_legs}")
        o, sv = hosts.index(stop_host), hosts.index(serve_host)
        fault0 = get_json(hosts[0], "/status")[1]["fault"]
        floor_ms = fault0["hedgeS"] * 1e3
        tail_ms = fault0["peers"].get(stop_host, {}).get("latencyTailMs",
                                                         0.0)
        hedged0 = hedged(hosts[0])
        served0 = _node_counters(procs[sv], gtmp, sv)["launches"]
        rpcs_stop = rpcs(hosts[0])[stop_host]
        from concurrent.futures import ThreadPoolExecutor
        from concurrent.futures import wait as fwait
        tp = ThreadPoolExecutor(8)
        procs[o].send_signal(signal.SIGSTOP)
        t_stop = time.perf_counter()
        try:
            futs = {tp.submit(_request, hosts[0], "POST",
                              "/index/smoke/query", fresh_q(p).encode(),
                              None, 60): p for p in fresh[8:16]}
            done, pending = fwait(futs, timeout=GOSSIP_STOP_S)
            back_s = time.perf_counter() - t_stop
        finally:
            procs[o].send_signal(signal.SIGCONT)
            stopped_s = time.perf_counter() - t_stop
            tp.shutdown(wait=True)
        if pending:
            _fail(f"gossip: {len(pending)} of 8 Counts not back within"
                  f" {GOSSIP_STOP_S} s of the SIGSTOP of {stop_host}")
        hedged_ms = []
        for fut, p in futs.items():
            st, _, out, ms = fut.result()
            fresh_check(p, st, out, "hedged Count")
            hedged_ms.append(ms)
        hedged1 = hedged(hosts[0])
        served1 = _node_counters(procs[sv], gtmp, sv)["launches"]
        # The abandoned primaries answer once the peer runs again: wait
        # for them, so that none is still in flight at a later SIGKILL
        # of that peer (its reset connections would feed the breaker).
        fired = int(hedged1["fired"] - hedged0["fired"])
        t0 = time.perf_counter()
        while rpcs(hosts[0])[stop_host] - rpcs_stop < fired:
            if time.perf_counter() - t0 > 30:
                _fail(f"gossip: the {fired} hedged primaries to"
                      f" {stop_host} did not finish in 30 s after the"
                      f" SIGCONT")
            time.sleep(0.02)
        primaries_s = time.perf_counter() - t0
        seen = {}
        for h in (hosts[0], serve_host):
            st_json = get_json(h, "/status")[1]
            seen[h] = {n["host"]: n["state"]
                       for n in st_json["status"]["nodes"]}.get(stop_host)
            if seen[h] == "DOWN":
                _fail(f"gossip: {h} marked {stop_host} DOWN during a"
                      f" {stopped_s:.2f} s SIGSTOP")
        won = hedged1["hedge_won"] - hedged0["hedge_won"]
        served = (served1.get("expr_count_rows", 0)
                  - served0.get("expr_count_rows", 0))
        if won <= 0 or served <= 0:
            _fail(f"gossip: hedge: hedge_won +{won}, {serve_host}'s"
                  f" expression count +{served} ({hedged0} -> {hedged1})")
        hedge = {"stopped": stop_host, "served": serve_host,
                 "unstopped_legs": base_legs, "hedge_floor_ms": floor_ms,
                 "latency_tail_ms": tail_ms,
                 "delay_ms": max(floor_ms, tail_ms),
                 "unstopped_p50_ms": _median(base_ms),
                 "unstopped_ms": base_ms, "hedged_ms": sorted(hedged_ms),
                 "all_back_s": back_s, "stopped_s": stopped_s,
                 "outcomes": {k: hedged1[k] - hedged0[k] for k in hedged1},
                 "server_expr_count_launches": served,
                 "primaries_done_s": primaries_s,
                 "state_seen": seen}
        mark("hedge")

        # -- 6. death ---------------------------------------------------------
        victim_line = _node_counters(procs[victim], gtmp, victim)
        before = rpcs(hosts[0])
        procs[victim].send_signal(signal.SIGKILL)
        t_kill = time.perf_counter()
        procs[victim].wait(30)
        procs[victim].stdout.close()
        procs[victim] = None
        dead_s, breaker_at_dead, breaker_lag_ms = {}, {}, {}

        def opened(b):
            return (b.get("gossip") == "dead" and b.get("state") == "open"
                    and b.get("reason") == "gossip dead")

        while len(breaker_at_dead) < 2:
            for h in survivors:
                if h in breaker_at_dead:
                    continue
                out = get_json(h, "/status")[1]
                state = {n["host"]: n["state"]
                         for n in out["status"]["nodes"]}
                b = {"gossip": out["fault"]["peers"].get(
                         victim_host, {}).get("gossip"),
                     **out["fault"]["breakers"].get(victim_host, {})}
                now = time.perf_counter()
                if h not in dead_s and state.get(victim_host) == "DOWN":
                    dead_s[h] = now - t_kill
                # The membership table shows DOWN a moment before its
                # state-change callback reaches the fault layer (the
                # callback runs after the table's lock is released):
                # the breaker is read until it shows the death, for at
                # most 2 s after DOWN.
                if h in dead_s and (opened(b)
                                    or now - t_kill - dead_s[h] > 2.0):
                    breaker_at_dead[h] = b
                    breaker_lag_ms[h] = (now - t_kill - dead_s[h]) * 1e3
            if time.perf_counter() - t_kill > 60:
                _fail(f"gossip: {victim_host} not marked dead in 60 s:"
                      f" {dead_s}")
            time.sleep(0.02)
        for h, b in breaker_at_dead.items():
            if (b.get("gossip") != "dead" or b.get("state") != "open"
                    or b.get("reason") != "gossip dead"):
                _fail(f"gossip: {h}'s breaker for {victim_host} when its"
                      f" membership marked it dead: {b}")
        health_dead = {}
        for h in survivors:
            st, out = health(h)
            detail = out["checks"]["gossip"] if out else None
            if st != 503 or detail != {"ok": False,
                                       "detail": f"down: {victim_host}"}:
                _fail(f"gossip: {h}'s /health after the death: {st}"
                      f" {out}")
            health_dead[h] = detail
        breaker_gauge = {h: _family_sum(_scrape(h),
                                        "pilosa_fault_breaker_state",
                                        peer=victim_host)
                         for h in survivors}
        after_kill = {}
        for name in reads:
            after_kill[name + "_first_ms"] = check(name, hosts[0],
                                                   "after the death")
        after = rpcs(hosts[0])
        after_kill["other_legs"] = after[other] - before[other]
        after_kill["failover_slices"] = failovers(hosts[0])
        if after_kill["other_legs"] <= 0:
            _fail(f"gossip: {other} served none of the victim's slices"
                  f" for {hosts[0]}: {after_kill}")
        mark("death")

        # -- 7. partial -------------------------------------------------------
        def arm(spec):
            st, _, out, _ = _request(
                hosts[0], "POST", "/debug/failpoints",
                json.dumps({"site": "rpc.send", "spec": spec}).encode())
            if st != 200:
                _fail(f"gossip: arm rpc.send={spec}: {st} {out[:200]!r}")

        arm(f"partition({other})")
        p = fresh[16]
        q = fresh_q(p).encode()
        st_strict, hs_strict, out_strict, strict_ms = _request(
            hosts[0], "POST", "/index/smoke/query", q, timeout=60)
        st, hs, out, partial_ms = _request(
            hosts[0], "POST", "/index/smoke/query?partial=1", q, timeout=60)
        kept = [s for s in range(n_slices) if hosts[0] in owners[s]]
        lost = [s for s in range(n_slices) if hosts[0] not in owners[s]]
        want_p = int(fresh_counts[p][kept].sum())
        got = json.loads(out)["results"] if st == 200 else None
        if (st_strict != 400 or "X-Pilosa-Partial" in hs_strict
                or st != 200 or got != [want_p]
                or hs.get("X-Pilosa-Partial") != ",".join(map(str, lost))):
            _fail(f"gossip: partial Count: strict {st_strict}"
                  f" {out_strict[:200]!r}; partial {st} {got} != [{want_p}]"
                  f" header {hs.get('X-Pilosa-Partial')!r}")
        st_fed, _, out_fed, _ = _request(hosts[0], "GET", "/metrics/cluster",
                                         timeout=30)
        st_fp, hs_fp, _, fed_partial_ms = _request(
            hosts[0], "GET", "/metrics/cluster?partial=1", timeout=30)
        gone = ",".join(sorted([victim_host, other]))
        if (st_fed != 503 or st_fp != 200
                or hs_fp.get("X-Pilosa-Partial-Nodes") != gone
                or hs_fp.get("X-Pilosa-Federated-Nodes") != "1"):
            _fail(f"gossip: /metrics/cluster with {gone} unreachable:"
                  f" {st_fed} {out_fed[:200]!r}; partial {st_fp} {hs_fp}")
        arm("off")
        t0 = time.perf_counter()
        while get_json(hosts[0], "/status")[1]["fault"]["breakers"].get(
                other, {}).get("state", "closed") != "closed":
            if time.perf_counter() - t0 > 30:
                _fail(f"gossip: {hosts[0]}'s breaker for {other} still"
                      f" open 30 s after the disarm")
            time.sleep(0.05)
        partial = {"strict_status": st_strict, "strict_ms": strict_ms,
                   "partial_ms": partial_ms, "missing_slices": len(lost),
                   "count": want_p, "metrics_cluster_strict": st_fed,
                   "metrics_cluster_partial_ms": fed_partial_ms,
                   "partial_nodes": gone,
                   "breaker_closed_s": time.perf_counter() - t0}
        mark("partial")

        # -- 8. rejoin --------------------------------------------------------
        t0 = time.perf_counter()
        procs[victim] = spawn(victim)
        rejoin_s = ready(hosts, procs, t0)
        rejoin_ms = {name: check(name, victim_host, "after the rejoin")
                     for name in reads}
        mark("rejoin")
        lines = _nodes_stop([p for p in procs], hosts)
        procs = [None, None, None]
        mark("stopped")
    finally:
        for p in procs:
            if p is not None:
                p.kill()
                p.communicate()

    # -- 9. kernels: each node's first life ------------------------------
    first_life = list(lines)
    first_life[victim] = victim_line
    need = ("expr_count_rows", "densify", "topn_block_count")
    for h, line in zip(hosts, first_life):
        for k in need:
            if line["launches"].get(k, 0) <= 0:
                _fail(f"gossip: {k} did not launch on {h}: {line}")
    launches: dict = {}
    for line in lines + [victim_line]:
        for k, v in line["launches"].items():
            launches[k] = launches.get(k, 0) + v
    peak = {h: max(line["peak_mib"] for line in (lines[i],) + (
        (victim_line,) if i == victim else ())) for i, h in enumerate(hosts)}
    phase_s = time.perf_counter() - t_phase
    out = {"phase": "gossip", "config": "BASELINE configuration 4",
           "nodes": 3, "replicas": 2, "slices": n_slices, "bits": n_bits,
           "data_s": data_s, "ready_s": ready_s, "schema_s": schema_s,
           "reads": lat, "victim": victim_host, "legs_before": legs,
           "federation": federation, "hedge": hedge, "partial": partial,
           "dead_s": dead_s, "breaker_at_dead": breaker_at_dead,
           "breaker_lag_ms": breaker_lag_ms,
           "health_after_death": health_dead,
           "breaker_gauge": breaker_gauge, "after_death": after_kill,
           "rejoin_s": rejoin_s, "rejoin_ms": rejoin_ms,
           "launches": launches, "peak_mib": peak, "marks_s": marks,
           "card": _card(), "seconds": phase_s}
    _emit(out)
    return out


def _operator_toml(path: str, capture: bool, tenants: bool) -> None:
    """The operator phase's node config: the runtime collector and the
    metric history at a 500 ms cadence, the watchdog at 100 ms with a
    500 ms deadline grace, workload capture (``full`` when ``capture``)
    and a tenant table (a wide and a quiet tenant) when ``tenants``. The
    blackbox, the sentinel, the continuous profiler (10 Hz) and the
    rest keep their defaults (on)."""
    text = ('[metrics]\nruntime-interval = "500ms"\n'
            '[history]\nresolutions = "500ms:400,5s:100,1m:60"\n'
            '[watchdog]\ninterval = "100ms"\ndeadline-grace = "500ms"\n'
            f'[capture]\nmode = "{"full" if capture else "off"}"\n')
    if tenants:
        text += ('[tenants.default]\nweight = 1\n'
                 '[tenants.wide]\nweight = 1\n'
                 '[tenants.quiet]\nweight = 4\n')
    with open(path, "w") as f:
        f.write(text)


def phase_operator(device, seed: int, tmp: str, n_slices: int = 128,
                   n_wide: int = 8, wide_rounds: int = 2,
                   n_quiet: int = 4, fair_slots: int = 1) -> dict:
    """The operator surface on three port servers (this script's child
    mode, pinned): configuration 4's ``smoke`` layout at ``n_slices``
    slices written into three directories before any traffic, every
    answer held to a host reference of those bits. Server A (the card)
    runs with tenants ``wide`` and ``quiet`` (weights 1 and 4), the fair
    dispatch queue at ``fair_slots`` slots and ``[capture] mode =
    "full"``; the blackbox, the watchdog, the history, the sentinel and
    the continuous profiler keep their defaults (on), at the cadences of
    ``_operator_toml``. B (``--device cpu``, every kernel's plain
    version) and C (the card) open the other two copies meanwhile.

    1. Traffic with tenants: the quiet tenant counts the 16 rows one at
       a time (their slabs load), then ``n_wide`` threads of the wide
       tenant send ``wide_rounds`` Counts each (Intersect, Union and
       Difference of row pairs) while the quiet tenant sends
       ``n_quiet`` single-row Counts and a sourced TopN over listed ids,
       one at a time (the burst again, at most three in all, until the
       queue has seen a wait); every answer equals the host's. The
       queue's dispatches and waits and the quiet tenant's p50 are
       printed (no latency asserted).
    2. Capture and shadow replay: A's ``/debug/capture/records`` holds
       one record for every request, each 200 with a digest; the
       ``replay --records F --shadow B C`` verb (a subprocess) exits 0
       with no mismatch and every captured read compared, and C's
       launch counters show the expression count, densify and the TopN
       block count launched during the replay.
    3. Profiler, history, sentinel: ``/debug/pprof/profile?seconds=1``
       (under load) returns collapsed stacks; after two collector ticks
       ``/debug/metrics/history`` holds the query-latency series;
       ``/debug/sentinel`` answers.
    4. Watchdog and blackbox: ``mesh.dispatch`` armed as a 2.5 s delay
       (once) under a Count with ``?timeout=1s``: the watchdog trips
       ``stuck_query`` (its counter and ``/status``) and
       ``/debug/blackbox`` lists a ``watchdog:stuck_query`` dump; the
       stuck query is in the capture and ``/debug/pprof/flame?query=``
       its id holds its stacks; after the disarm a Count answers
       exactly; A's SIGTERM leaves one more dump (``sigterm``)."""
    import signal
    import subprocess
    import threading
    import numpy as np
    from pilosa_tpu_torch.models.holder import Holder

    t_phase = time.perf_counter()
    marks: dict = {}
    step_ms: dict = {}

    def mark(step):
        marks[step] = time.perf_counter() - t_phase
        # On stderr as it happens: a failed run still shows its steps.
        print(f"operator: {step} at {marks[step]:.1f} s", file=sys.stderr,
              flush=True)

    repo = os.path.dirname(os.path.abspath(__file__))
    otmp = os.path.join(tmp, "operator")
    os.makedirs(otmp, exist_ok=True)
    rng = np.random.default_rng(seed + 90)
    names = ("a", "b", "c")
    dirs = {n: os.path.join(otmp, f"{n}data") for n in names}

    # -- data: three copies, written before any traffic ----------------------
    t0 = time.perf_counter()
    for d in dirs.values():
        h = Holder(d)
        h.open()
        h.create_index("smoke").create_frame("f") \
            .create_view_if_not_exists("standard")
        h.close()
    positions, cols = _smoke_rows(rng, n_slices)
    n_bits = int(sum(len(p) for p in positions))
    for s in range(n_slices):
        _c5_write((positions[s], [os.path.join(
            dirs[n], "smoke", "f", "views", "standard", "fragments",
            str(s)) for n in names]))
    del positions
    row_n = {r: int(sum(len(c) for c in cols[r])) for r in cols}
    pairs = [(1, r) for r in range(2, 17)]
    while len(pairs) < 24:
        a, b = (int(x) for x in rng.choice(np.arange(2, 17), 2,
                                           replace=False))
        if (a, b) not in pairs:
            pairs.append((a, b))
    stuck_pair, after_pair = (9, 10), (11, 12)
    inter = {p: int(sum(len(np.intersect1d(cols[p[0]][s], cols[p[1]][s],
                                           assume_unique=True))
                        for s in range(n_slices)))
             for p in pairs + [stuck_pair, after_pair]}
    del cols

    def pair_q(op, a, b):
        return (f"Count({op}(Bitmap(rowID={a}, frame=f),"
                f" Bitmap(rowID={b}, frame=f)))")

    def pair_want(op, a, b):
        i = inter[(a, b)]
        return {"Intersect": i, "Union": row_n[a] + row_n[b] - i,
                "Difference": row_n[a] - i}[op]

    # Four ids: the baseline's plain TopN block count on the CPU reads
    # every listed row's slices.
    ids = list(range(2, 6))
    topn_q = (f"TopN(Bitmap(rowID=1, frame=f), frame=f, ids={ids})")
    topn_want = sorted(([r, inter[(1, r)]] for r in ids
                        if inter[(1, r)]), key=lambda p: (-p[1], p[0]))
    data_s = time.perf_counter() - t0
    mark("data")

    # -- the three servers ----------------------------------------------------
    hosts = {n: f"127.0.0.1:{_free_port()}" for n in names}
    procs: dict = {}

    def spawn(n):
        cfg = os.path.join(otmp, f"{n}.toml")
        _operator_toml(cfg, capture=(n == "a"), tenants=(n == "a"))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = repo
        if n == "a":
            # The replay's nodes keep the default slots: one slot would
            # serialize B's plain counts on the CPU.
            env["PILOSA_MESH_FAIR_SLOTS"] = str(fair_slots)
        if device.type == "cpu":
            # A rehearsal's CPU nodes share the host's cores: each of
            # their concurrent requests must not take them all.
            env["OMP_NUM_THREADS"] = "2"
        args = [sys.executable, os.path.abspath(__file__), "--cluster-node",
                "1", os.path.join(otmp, f"node{n}.counters"), "server",
                "-c", cfg, "-d", dirs[n], "-b", hosts[n],
                "--cost.dir", os.path.join(otmp, f"cal{n}")]
        if n == "b" or device.type == "cpu":
            args += ["--device", "cpu"]
        log = open(os.path.join(otmp, f"node{n}.log"), "ab")
        return subprocess.Popen(args, cwd=repo, env=env,
                                stdout=subprocess.PIPE, stderr=log)

    def counters(n) -> dict:
        path = os.path.join(otmp, f"node{n}.counters")
        if os.path.exists(path):
            os.remove(path)
        procs[n].send_signal(signal.SIGUSR1)
        t1 = time.perf_counter()
        while not os.path.exists(path):
            if time.perf_counter() - t1 > 10:
                _fail(f"operator: node {n} wrote no counters on SIGUSR1")
            time.sleep(0.02)
        with open(path) as f:
            return json.load(f)["launches"]

    def query(n, q, qs="", headers=None, want_status=200):
        st, hd, out, ms = _request(hosts[n], "POST",
                                   f"/index/smoke/query{qs}", q.encode(),
                                   headers=headers, timeout=300)
        if want_status is not None and st != want_status:
            _fail(f"operator: {n} {q[:60]}: HTTP {st}: {out[:300]!r}")
        return (json.loads(out) if st == 200 else None), ms, st, hd

    def get(n, path, raw=False):
        st, hd, out, _ = _request(hosts[n], "GET", path, timeout=60)
        if st != 200:
            _fail(f"operator: GET {path} on {n}: HTTP {st}: {out[:200]!r}")
        return (out, hd) if raw else json.loads(out)

    try:
        t0 = time.perf_counter()
        for n in names:
            procs[n] = spawn(n)
        ready_s = _node_up([hosts[n] for n in names],
                           [procs[n] for n in names], 240.0,
                           n_slices - 1, index="smoke")
        mark("ready")

        # -- 1. traffic with tenants ------------------------------------------
        t0 = time.perf_counter()
        wrong: list = []
        sent = [0]
        sent_mu = threading.Lock()
        wide_jobs = [(op, a, b) for a, b in pairs
                     for op in ("Intersect", "Union", "Difference")]
        rng.shuffle(wide_jobs)

        wide_ms: list = []

        def wide(k):
            for j in range(wide_rounds):
                op, a, b = wide_jobs[(k * wide_rounds + j) % len(wide_jobs)]
                st, _, out, ms = _request(
                    hosts["a"], "POST", "/index/smoke/query",
                    pair_q(op, a, b).encode(),
                    headers={"X-Pilosa-Tenant": "wide"}, timeout=300)
                with sent_mu:
                    sent[0] += 1
                    wide_ms.append(ms)
                got = json.loads(out)["results"][0] if st == 200 else st
                if got != pair_want(op, a, b):
                    wrong.append((op, a, b, got))

        def quiet_count(r):
            res, ms, _, _ = query("a", f"Count(Bitmap(rowID={r}, frame=f))",
                                  headers={"X-Pilosa-Tenant": "quiet"})
            with sent_mu:
                sent[0] += 1
            if res["results"][0] != row_n[r]:
                wrong.append(("Bitmap", r, res["results"][0], row_n[r]))
            return ms

        # The quiet tenant's first pass loads the 16 rows, one at a time
        # (concurrent cold requests for one row would each build its
        # slab: parallel.residency builds outside its lock).
        t1 = time.perf_counter()
        cold_ms = [quiet_count(r) for r in range(1, 17)]
        cold_s = time.perf_counter() - t1
        quiet_ms: list = []
        for burst in range(3):
            threads = [threading.Thread(target=wide, args=(k,))
                       for k in range(n_wide)]
            for t in threads:
                t.start()
            for j in range(n_quiet):
                quiet_ms.append(quiet_count(1 + j % 16))
            if burst == 0:
                res, topn_ms, _, _ = query(
                    "a", topn_q, headers={"X-Pilosa-Tenant": "quiet"})
                with sent_mu:
                    sent[0] += 1
                got_topn = [[p["id"], p["count"]]
                            for p in res["results"][0]]
                if got_topn != topn_want:
                    wrong.append(("TopN", got_topn, topn_want))
            for t in threads:
                t.join()
            # One slot and 8 wide threads make waits near certain; a
            # burst with none is sent again (at most three in all).
            # /status carries the collector's last sample (500 ms).
            time.sleep(0.6)
            if (get("a", "/status")["runtime"].get("fairDispatch")
                    or {}).get("waits"):
                break
        if wrong:
            _fail(f"operator: traffic answers differ from the host: "
                  f"{wrong[:3]}")
        fair = get("a", "/status")["runtime"].get("fairDispatch")
        if not fair or fair["slots"] != fair_slots:
            _fail(f"operator: no fair dispatch queue in /status: {fair}")
        if device.type == "cuda" and not fair["waits"]:
            _fail(f"operator: the fair queue saw no wait: {fair}")
        traffic = {"requests": sent[0], "wide_threads": n_wide,
                   "bursts": burst + 1, "fair_dispatch": fair,
                   "cold_rows_s": cold_s, "cold_max_ms": max(cold_ms),
                   "quiet_p50_ms": _median(quiet_ms),
                   "quiet_max_ms": max(quiet_ms),
                   "wide_p50_ms": _median(wide_ms),
                   "wide_max_ms": max(wide_ms), "topn_ms": topn_ms}
        print(f"operator: traffic {json.dumps(traffic)}", file=sys.stderr,
              flush=True)
        step_ms["traffic"] = (time.perf_counter() - t0) * 1e3
        mark("traffic")

        # -- 2. capture and shadow replay -------------------------------------
        t0 = time.perf_counter()
        records: list = []
        since = 0
        while True:
            page = get("a", f"/debug/capture/records?since={since}"
                            "&limit=1000")
            records += page["records"]
            if not page["records"]:
                break
            since = page["next"]
        queries = [r for r in records if r.get("kind") == "query"]
        if len(queries) != sent[0] or len(records) != sent[0]:
            _fail(f"operator: {len(records)} capture records for"
                  f" {sent[0]} requests")
        bad = [r for r in queries if r["status"] != 200
               or len(r.get("digest", "")) != 16]
        if bad:
            _fail(f"operator: capture records without a digest: {bad[:2]}")
        rec_path = os.path.join(otmp, "records.jsonl")
        with open(rec_path, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
        before_c = counters("c")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = repo
        # One read at a time: the baseline's plain counts on the CPU then
        # take every core (concurrent ones contend for memory bandwidth).
        rp = subprocess.run(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "replay",
             "--records", rec_path, "--shadow", hosts["b"], hosts["c"],
             "--senders", "1"], cwd=repo, env=env, capture_output=True,
            text=True, timeout=600)
        try:
            summary = json.loads(rp.stdout)
        except ValueError:
            summary = None
        reads = [r for r in queries if r["lane"] == "read"]
        if (rp.returncode != 0 or summary is None
                or summary["mismatches"]
                or summary["reads_compared"] != len(reads)):
            _fail(f"operator: replay --shadow rc {rp.returncode},"
                  f" {len(reads)} captured reads: {rp.stdout[-1500:]}"
                  f" {rp.stderr[-600:]}")
        after_c = counters("c")
        replay_launches = {k: after_c.get(k, 0) - before_c.get(k, 0)
                           for k in after_c}
        for k in ("expr_count_rows", "densify", "topn_block_count"):
            if replay_launches.get(k, 0) <= 0:
                _fail(f"operator: {k} did not launch on the candidate"
                      f" during the replay: {replay_launches}")
        shadow = {"records": len(records),
                  "reads_compared": summary["reads_compared"],
                  "writes_replayed": summary["writes_replayed"],
                  "mismatches": summary["mismatches"],
                  "candidate_launches": replay_launches}
        step_ms["replay"] = (time.perf_counter() - t0) * 1e3
        mark("replay")

        # -- 3. profiler, history, sentinel -----------------------------------
        t0 = time.perf_counter()
        halt = threading.Event()

        def load():
            k = 0
            while not halt.is_set():
                op, a, b = wide_jobs[k % len(wide_jobs)]
                _request(hosts["a"], "POST", "/index/smoke/query",
                         pair_q(op, a, b).encode(), timeout=300)
                k += 1

        lt = threading.Thread(target=load)
        lt.start()
        try:
            prof, _ = get("a", "/debug/pprof/profile?seconds=1", raw=True)
        finally:
            halt.set()
            lt.join()
        prof_lines = prof.decode().splitlines()
        if (not prof_lines or not prof_lines[0].startswith("# cpu profile")
                or len(prof_lines) < 2):
            _fail(f"operator: /debug/pprof/profile: {prof[:300]!r}")
        time.sleep(1.2)  # two collector ticks at 500 ms
        hist = get("a", "/debug/metrics/history?family="
                        "pilosa_query_duration_seconds&window=60s")
        series = [s for s in hist.get("series") or []
                  if s.get("points")]
        if not any(s["name"].startswith("pilosa_query_duration_seconds:")
                   for s in series):
            _fail(f"operator: no query-latency history: {hist!s:.300}")
        sentinel = get("a", "/debug/sentinel")
        if not sentinel.get("enabled"):
            _fail(f"operator: /debug/sentinel: {sentinel}")
        observe = {"profile_lines": len(prof_lines) - 1,
                   "history_series": len(series),
                   "history_points": sum(len(s["points"]) for s in series),
                   "sentinel_checks": sentinel.get("checks")}
        step_ms["observe"] = (time.perf_counter() - t0) * 1e3
        mark("observe")

        # -- 4. watchdog and blackbox -----------------------------------------
        t0 = time.perf_counter()
        st, _, out, _ = _request(hosts["a"], "POST", "/debug/failpoints",
                                 json.dumps({"site": "mesh.dispatch",
                                             "spec": "delay(2500ms)*1"}
                                            ).encode())
        if st != 200:
            _fail(f"operator: arming mesh.dispatch: {st} {out[:200]!r}")
        _, stuck_ms, stuck_st, _ = query(
            "a", pair_q("Intersect", *stuck_pair), qs="?timeout=1s",
            headers={"X-Pilosa-Query-Id": "operator-stuck"},
            want_status=None)
        st, _, out, _ = _request(hosts["a"], "POST", "/debug/failpoints",
                                 json.dumps({"site": "mesh.dispatch",
                                             "spec": "off"}).encode())
        if st != 200:
            _fail(f"operator: disarming mesh.dispatch: {st}")
        status = get("a", "/status")
        trips = status.get("watchdog", {}).get("trips", 0)
        bb = get("a", "/debug/blackbox")
        stuck_dumps = [d for d in bb.get("dumps", [])
                       if d.endswith("-watchdog_stuck_query.json")]
        samples = _samples(get("a", "/metrics", raw=True)[0].decode())
        trip_metric = _family_sum(samples, "pilosa_watchdog_trips_total",
                                  cause="stuck_query")
        if not trips or not stuck_dumps or trip_metric < 1:
            _fail(f"operator: the watchdog did not trip stuck_query"
                  f" (trips {trips}, dumps {bb.get('dumps')}, metric"
                  f" {trip_metric}, the query {stuck_st} in"
                  f" {stuck_ms:.0f} ms)")
        res, after_ms, _, _ = query("a", pair_q("Intersect", *after_pair))
        if res["results"][0] != inter[after_pair]:
            _fail(f"operator: Count after the disarm {res['results']}"
                  f" != {inter[after_pair]}")
        # The stuck query is a captured one: its record and its stacks
        # (a card Count of a few ms falls between the 100 Hz samples;
        # this one held its dispatch for 2.5 s).
        tail = get("a", f"/debug/capture/records?since={since}")
        if not any(r.get("qid") == "operator-stuck"
                   for r in tail["records"]):
            _fail(f"operator: the stuck query was not captured: {tail}")
        flame_stuck, _ = get("a", "/debug/pprof/flame?query=operator-stuck",
                             raw=True)
        flame_stacks = len(flame_stuck.decode().splitlines()) - 1
        if flame_stacks < 1:
            _fail("operator: /debug/pprof/flame holds no sample of the"
                  f" captured query: {flame_stuck[:300]!r}")
        a_launches = None
        n_before = len([f for f in os.listdir(os.path.join(
            dirs["a"], "blackbox")) if f.startswith("dump-")])
        a_line = _nodes_stop([procs["a"]], [hosts["a"]])[0]
        procs["a"] = None
        a_launches = a_line["launches"]
        dumps_after = sorted(f for f in os.listdir(os.path.join(
            dirs["a"], "blackbox")) if f.startswith("dump-"))
        if (len(dumps_after) != n_before + 1
                or not dumps_after[-1].endswith("-sigterm.json")):
            _fail(f"operator: SIGTERM left no dump: {dumps_after}")
        watchdog = {"stuck_status": stuck_st, "stuck_ms": stuck_ms,
                    "trips": trips, "dump": stuck_dumps[0],
                    "flame_stacks": flame_stacks,
                    "after_disarm_ms": after_ms,
                    "sigterm_dump": dumps_after[-1]}
        step_ms["watchdog"] = (time.perf_counter() - t0) * 1e3
        mark("watchdog")
        lines = _nodes_stop([procs["b"], procs["c"]],
                            [hosts["b"], hosts["c"]])
        procs["b"] = procs["c"] = None
        mark("stopped")
    except SystemExit:
        # A failed step: the nodes' log tails beside the failure.
        for n in names:
            try:
                with open(os.path.join(otmp, f"node{n}.log"), "rb") as f:
                    tail = f.read()[-3000:].decode(errors="replace")
            except OSError:
                continue
            print(f"operator: node {n} log tail:\n{tail}", file=sys.stderr,
                  flush=True)
        raise
    finally:
        for p in procs.values():
            if p is not None:
                p.kill()
                p.communicate()

    launches: dict = {}
    for line in (a_launches, lines[1]["launches"]):
        for k, v in line.items():
            launches[k] = launches.get(k, 0) + v
    for k in ("expr_count_rows", "densify", "topn_block_count"):
        if a_launches.get(k, 0) <= 0:
            _fail(f"operator: {k} did not launch on server A: {a_launches}")
    out = {"phase": "operator", "config": "BASELINE configuration 4",
           "slices": n_slices, "bits": n_bits, "data_s": data_s,
           "ready_s": ready_s, "traffic": traffic, "shadow": shadow,
           "observe": observe, "watchdog": watchdog, "step_ms": step_ms,
           "launches": launches, "marks_s": marks, "card": _card(),
           "seconds": time.perf_counter() - t_phase}
    _emit(out)
    return out


RESIZE_SECRET = "smoke-resize"  # the resize phase's gossip HMAC key


def phase_resize(device, seed: int, tmp: str, n_slices: int = 256,
                 up_limit_s: float = 180.0, pre_load_s: float = 2.0,
                 settle_limit_s: float = 400.0) -> dict:
    """Online resize of a gossip cluster of port nodes on the card: grow
    3→4, then shrink 4→3, each under live Counts and SetBits.

    Four node processes of this script's child mode (pinned), each
    started from a TOML file (``server -c FILE``): ``cluster.type =
    "gossip"``, replicas 2, the placement over nodes 0-2, nodes 1-3
    seeded from node 0's internal port. Node 3 boots knowing that current
    membership: it owns nothing until the grow adds it. Configuration 4's
    ``smoke`` layout at ``n_slices`` slices (16 rows, rows 1-8 at 1/64,
    9-16 at 1/4096) is written into the owners' directories for the
    three-node placement; every answer is held to a host reference of
    those bits.

    1. Ready: every node answers and knows every slice; frame ``w`` (the
       load's writes) created on node 0 reaches every node over gossip.
    2. Before: from each node as coordinator, the 16 Count(Bitmap) and 8
       Count(Intersect) in one body, ``TopN(frame=f, n=50)`` and the
       sourced TopN, exact.
    3. Grow 3→4 with the ``resize`` verb (``--add node3 --wait``) on
       node 0, while a load runs from every node as coordinator: one
       reader sending single Counts over all slices (moving and not),
       each exact, and two writers each sending SetBits of its own row
       of ``w`` into moving slices and reading the row's Count back,
       exact against its acked SetBits (each of the three threads one
       request after another, 20 ms apart). Recorded: each protocol phase's
       seconds (polled), slices moved, MB streamed and MB/s, stream
       passes, double reads by winner, the load's Count p50 before and
       during, wrong answers and failed requests (both must be 0).
    4. After the grow: every node at epoch 1 with four members and no
       resize; node 3 SIGTERMed and restarted from its file (whose
       membership is the old one) comes back at epoch 1; every read of
       step 2 exact from all four nodes; the writers' rows counted alike
       from every node and every moving slice's ``w`` fragment with the
       same block checksums on both its owners; node 3's expression
       count and densify launch counters rose over its first life (it
       served moved slices on the card); node 0's watchdog tripped no
       ``resize_stall``.
    5. Shrink 4→3: ``POST /cluster/resize {"remove": node1}`` on node 0
       under the same load, with the same checks; epoch 2 and three
       members. Node 1 stopped, the reads stay exact from nodes 0, 2
       and 3."""
    import threading
    import numpy as np
    from pilosa_tpu_torch import SLICE_WIDTH as W
    from pilosa_tpu_torch.cluster.topology import movement, new_cluster
    from pilosa_tpu_torch.models.holder import Holder

    t_phase = time.perf_counter()
    marks: dict = {}

    def mark(step):
        marks[step] = time.perf_counter() - t_phase
        print(f"resize: {step} at {marks[step]:.1f} s", file=sys.stderr,
              flush=True)

    repo = os.path.dirname(os.path.abspath(__file__))
    rtmp = os.path.join(tmp, "resize")
    os.makedirs(rtmp, exist_ok=True)
    rng = np.random.default_rng(seed + 90)
    hosts = [f"127.0.0.1:{_free_port()}" for _ in range(4)]
    gports = [_free_port() for _ in range(4)]
    old = hosts[:3]
    cl = new_cluster(old, replica_n=2)
    owners = [[n.host for n in cl.fragment_nodes("smoke", s)]
              for s in range(n_slices)]
    dirs = [os.path.join(rtmp, f"node{i}data") for i in range(4)]
    tomls = [os.path.join(rtmp, f"node{i}.toml") for i in range(4)]
    for i in range(4):
        _gossip_toml(tomls[i], dirs[i], hosts[i], old, gports[i],
                     f"127.0.0.1:{gports[0]}" if i else "", RESIZE_SECRET)

    t0 = time.perf_counter()
    for d in dirs:
        h = Holder(d)
        h.open()
        h.create_index("smoke").create_frame("f") \
            .create_view_if_not_exists("standard")
        h.close()
    positions, cols = _smoke_rows(rng, n_slices)
    for s in range(n_slices):
        _c5_write((positions[s], [
            os.path.join(dirs[hosts.index(h)], "smoke", "f", "views",
                         "standard", "fragments", str(s))
            for h in owners[s]]))
    n_bits = int(sum(len(p) for p in positions))
    del positions
    pairs = [(2 * k + 1, 2 * k + 2) for k in range(8)]
    row_total = {r: int(sum(len(c) for c in cols[r])) for r in cols}
    pair_total = {p: int(sum(len(np.intersect1d(
        cols[p[0]][s], cols[p[1]][s], assume_unique=True))
        for s in range(n_slices))) for p in pairs}
    src = {r: int(sum(len(np.intersect1d(cols[1][s], cols[r][s],
                                         assume_unique=True))
                      for s in range(n_slices))) for r in cols}
    del cols
    singles = ([(f"Count(Bitmap(rowID={r}, frame=f))", row_total[r])
                for r in range(1, 17)]
               + [(f"Count(Intersect(Bitmap(rowID={a}, frame=f),"
                   f" Bitmap(rowID={b}, frame=f)))", pair_total[(a, b)])
                  for a, b in pairs])
    reads = {
        "count": (" ".join(q for q, _ in singles), [w for _, w in singles]),
        "topn": ("TopN(frame=f, n=50)",
                 sorted(row_total.items(), key=lambda p: (-p[1], p[0]))),
        "topn_src": ("TopN(Bitmap(rowID=1, frame=f), frame=f, n=50)",
                     sorted(((r, c) for r, c in src.items() if c),
                            key=lambda p: (-p[1], p[0]))),
    }
    data_s = time.perf_counter() - t0
    mark("data")

    def spawn(i):
        import subprocess
        args = [sys.executable, os.path.abspath(__file__),
                "--cluster-node", "1",
                os.path.join(rtmp, f"node{i}.counters"),
                "server", "-c", tomls[i]]
        if device.type == "cpu":
            args += ["--device", "cpu"]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = repo
        if device.type == "cpu":
            # CPU rehearsal: the plain versions' intra-op threads of
            # four nodes would oversubscribe the cores.
            env["OMP_NUM_THREADS"] = "2"
        log = open(os.path.join(rtmp, f"node{i}.log"), "ab")
        return subprocess.Popen(args, cwd=repo, env=env,
                                stdout=subprocess.PIPE, stderr=log)

    def get_json(host, path):
        st, _, out, _ = _request(host, "GET", path, timeout=30)
        if st != 200:
            _fail(f"resize: GET {path} on {host}: {st} {out[:200]!r}")
        return json.loads(out)

    def knows_all(host):
        try:
            return get_json(host, "/slices/max")["maxSlices"].get(
                "smoke", -1) >= n_slices - 1
        except OSError:
            return False

    def wait_ready(targets, t_from):
        while not all(knows_all(h) for h in targets):
            for i, p in enumerate(procs):
                if p is not None and p.poll() is not None:
                    _fail(f"resize: node {i} exited with {p.returncode}")
            if time.perf_counter() - t_from > up_limit_s:
                _fail(f"resize: not ready in {up_limit_s} s")
            time.sleep(0.1)
        return time.perf_counter() - t_from

    def query(host, q):
        st, _, out, ms = _request(host, "POST", "/index/smoke/query",
                                  q.encode(), timeout=300)
        if st != 200:
            _fail(f"resize: {host} {q[:60]}: HTTP {st}: {out[:300]!r}")
        return json.loads(out)["results"], ms

    def check_reads(targets, label):
        """The reads of step 2 from each target in turn (one at a time:
        concurrent first reads of cold rows each build the rows' slabs,
        ROADMAP §2)."""
        ms = {}
        for h in targets:
            for name, (q, want) in reads.items():
                res, ms[f"{hosts.index(h)}:{name}"] = query(h, q)
                got = res if name == "count" else _pairs_json(res[0])
                if got != want:
                    _fail(f"resize: {name} from {h} ({label}): {got} !="
                          f" {want}")
        return ms

    def topology(h):
        return get_json(h, "/debug/topology")

    def double_reads(targets) -> dict:
        out = {"source": 0.0, "target": 0.0}
        for h in targets:
            samples = _scrape(h)
            for w in out:
                out[w] += _family_sum(
                    samples, "pilosa_cluster_resize_double_reads_total",
                    winner=w)
        return out

    # -- the load: one reader and two writers, every node a coordinator --
    load = {"stop": threading.Event(), "coords": list(hosts),
            "moving": [], "wrong": [], "failed": [], "lat": []}
    acked = {1: set(), 2: set()}

    def reader():
        k = 0
        while not load["stop"].is_set():
            q, want = singles[k % len(singles)]
            coords = load["coords"]
            host = coords[k % len(coords)]
            k += 1
            try:
                st, _, out, ms = _request(host, "POST",
                                          "/index/smoke/query", q.encode(),
                                          timeout=120)
            except OSError as e:
                load["failed"].append((host, q, repr(e)))
                continue
            if st != 200:
                load["failed"].append((host, q, st, out[:200]))
                continue
            got = json.loads(out)["results"][0]
            if got != want:
                load["wrong"].append((host, q, got, want))
            load["lat"].append((time.perf_counter(), ms))
            time.sleep(0.02)

    def writer(row, wseed):
        wrng = np.random.default_rng(wseed)
        k = row
        while not load["stop"].is_set():
            moving = load["moving"]
            coords = load["coords"]
            s = moving[int(wrng.integers(len(moving)))]
            col = s * W + int(wrng.integers(W))
            q = f"SetBit(rowID={row}, frame=w, columnID={col})"
            host = coords[k % len(coords)]
            k += 1
            try:
                st, _, out, _ = _request(host, "POST", "/index/smoke/query",
                                         q.encode(), timeout=120)
                if st != 200:
                    load["failed"].append((host, q, st, out[:200]))
                    continue
                acked[row].add(col)
                host = coords[k % len(coords)]
                q = f"Count(Bitmap(rowID={row}, frame=w))"
                st, _, out, _ = _request(host, "POST", "/index/smoke/query",
                                         q.encode(), timeout=120)
            except OSError as e:
                load["failed"].append((host, q, repr(e)))
                continue
            if st != 200:
                load["failed"].append((host, q, st, out[:200]))
                continue
            got = json.loads(out)["results"][0]
            if got != len(acked[row]):
                load["wrong"].append((host, q, got, len(acked[row])))
            time.sleep(0.02)

    def load_start(coords, moving):
        load["stop"].clear()
        load["coords"] = list(coords)
        load["moving"] = list(moving)
        threads = [threading.Thread(target=reader, daemon=True)] + [
            threading.Thread(target=writer, args=(r, seed + 900 + r),
                             daemon=True) for r in acked]
        for t in threads:
            t.start()
        return threads

    def load_stop(threads):
        load["stop"].set()
        for t in threads:
            t.join(120)
            if t.is_alive():
                _fail("resize: a load thread did not stop in 120 s")
        if load["wrong"] or load["failed"]:
            _fail(f"resize: {len(load['wrong'])} wrong answers"
                  f" {load['wrong'][:3]}, {len(load['failed'])} failed"
                  f" requests {load['failed'][:3]}")

    def p50_between(t_a, t_b):
        ms = [m for t, m in load["lat"] if t_a <= t < t_b]
        return (_median(ms) if ms else None), len(ms)

    def moving_slices(a, b):
        mv = movement(a, b, cl.partition_n, 2)
        return [s for s in range(n_slices)
                if cl.partition("smoke", s) in mv]

    def run_step(label, coord, start, members, coords, moving):
        """One resize under the load: its op, the protocol phases'
        seconds, the double reads and the Count p50s."""
        threads = load_start(coords, moving)
        time.sleep(pre_load_s)
        dr0 = double_reads(coords)
        t_start = time.perf_counter()
        waiter = start()
        seen = {}
        op = None
        while True:
            st, _, out, _ = _request(coord, "GET", "/cluster/resize",
                                     timeout=30)
            op = json.loads(out).get("op") if st == 200 else None
            if op:
                seen.setdefault(op["phase"], time.perf_counter() - t_start)
                if op["phase"] in ("done", "aborted"):
                    break
            if time.perf_counter() - t_start > settle_limit_s:
                _fail(f"resize: {label} not settled in {settle_limit_s} s:"
                      f" {op}")
            time.sleep(0.05)
        t_end = time.perf_counter()
        verb = waiter() if waiter is not None else None
        dr1 = double_reads(coords)
        load_stop(threads)
        if op["phase"] != "done":
            _fail(f"resize: {label} ended {op['phase']}: {op}")
        order = ["preparing", "streaming", "flipping", "draining",
                 "finalizing", "done"]
        at = [(p, seen[p]) for p in order if p in seen]
        phase_s = {p: at[k + 1][1] - t for k, (p, t) in enumerate(at[:-1])}
        stream_s = phase_s.get("streaming", 0.0) + phase_s.get("draining",
                                                               0.0)
        before = p50_between(t_start - pre_load_s, t_start)
        during = p50_between(t_start, t_end)
        for h in members:
            topo = topology(h)
            if (topo["epoch"] != epoch_want[label]
                    or sorted(topo["nodes"]) != sorted(members_want[label])
                    or topo["resize"] is not None):
                _fail(f"resize: {h} after the {label}: epoch"
                      f" {topo['epoch']} nodes {topo['nodes']} resize"
                      f" {topo['resize']}")
        return {"seconds": t_end - t_start, "phases_s": phase_s,
                "seen_at_s": seen, "slices_moved": op["slicesMoved"],
                "moving_slices": len(moving),
                "mb_streamed": op["bytesStreamed"] / 1e6,
                "mb_per_s": (op["bytesStreamed"] / 1e6 / stream_s
                             if stream_s else None),
                "stream_passes": op["streamPasses"],
                "double_reads": {w: dr1[w] - dr0[w] for w in dr1},
                "count_p50_ms_before": before[0],
                "count_p50_ms_during": during[0],
                "counts_before": before[1], "counts_during": during[1],
                "writes_acked": {r: len(c) for r, c in acked.items()},
                "wrong": len(load["wrong"]),
                "failed": len(load["failed"]), "verb": verb}

    def converged(targets, moving, members):
        """The writers' rows alike from every node, and each moving
        slice's ``w`` fragment with one block checksum set on all its
        owners."""
        for h in targets:
            for r, c in acked.items():
                got, _ = query(h, f"Count(Bitmap(rowID={r}, frame=w))")
                if got != [len(c)]:
                    _fail(f"resize: row {r} of w on {h}: {got} !="
                          f" [{len(c)}]")
        from concurrent.futures import ThreadPoolExecutor
        placed = new_cluster(members, replica_n=2)
        written = sorted({c // W for cs in acked.values() for c in cs}
                         & set(moving))

        def blocks(s):
            sums = set()
            for n in placed.fragment_nodes("smoke", s):
                st, _, out, _ = _request(
                    n.host, "GET", f"/fragment/blocks?index=smoke&frame=w"
                    f"&view=standard&slice={s}", timeout=30)
                if st != 200:
                    return f"w/{s} on {n.host}: {st} {out[:200]!r}"
                sums.add(json.dumps(json.loads(out)["blocks"],
                                    sort_keys=True))
            return None if len(sums) == 1 else (
                f"w/{s} differs between its owners")

        # Checksum reads only (no slab is built): all at once.
        with ThreadPoolExecutor(8) as tp:
            bad = [e for e in tp.map(blocks, written) if e]
        if bad:
            _fail(f"resize: {bad[:3]}")
        return len(written)

    def stall_trips(h):
        wd = get_json(h, "/status").get("watchdog") or {}
        return ("resize_stall" in wd.get("lastTrip", {}),
                _family_sum(_scrape(h), "pilosa_watchdog_trips_total",
                            cause="resize_stall"))

    procs = [None, None, None, None]
    lines = []
    node3_first = node1_line = None
    try:
        # -- 1. ready ---------------------------------------------------------
        t0 = time.perf_counter()
        procs[0] = spawn(0)
        _wait_up(hosts[0], procs[0], up_limit_s)
        for i in (1, 2, 3):
            procs[i] = spawn(i)
        ready_s = wait_ready(hosts, t0)
        st, _, out, _ = _request(hosts[0], "POST", "/index/smoke/frame/w",
                                 b"{}")
        if st != 200:
            _fail(f"resize: create frame w: {st} {out[:200]!r}")
        while not all(any(f["name"] == "w" for ix in get_json(
                h, "/schema")["indexes"] if ix["name"] == "smoke"
                for f in ix.get("frames", [])) for h in hosts):
            if time.perf_counter() - t0 > up_limit_s:
                _fail("resize: frame w did not reach every node")
            time.sleep(0.05)
        mark("ready")

        # -- 2. before --------------------------------------------------------
        before_ms = check_reads(hosts, "before")
        node3_before = _node_counters(procs[3], rtmp, 3)["launches"]
        mark("before")

        # -- 3. grow 3 -> 4 (the resize verb) -------------------------------
        epoch_want = {"grow": 1, "shrink": 2}
        members_want = {"grow": hosts,
                        "shrink": [hosts[0], hosts[2], hosts[3]]}
        grow_moving = moving_slices(old, hosts)

        def start_grow():
            import subprocess
            env = {k: v for k, v in os.environ.items()
                   if k != "PYTHONPATH"}
            env["PYTHONPATH"] = repo
            p = subprocess.Popen(
                [sys.executable, "-m", "pilosa_tpu_torch.cli", "resize",
                 "--host", hosts[0], "--add", hosts[3], "--wait"],
                cwd=repo, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)

            def wait():
                out, err = p.communicate(timeout=120)
                last = out.decode().strip().splitlines()[-1:]
                if p.returncode != 0:
                    _fail(f"resize: the resize verb exited"
                          f" {p.returncode}: {out[-500:]!r} {err[-500:]!r}")
                return {"rc": p.returncode, "last_line": last}
            return wait

        grow = run_step("grow", hosts[0], start_grow, hosts, hosts,
                        grow_moving)
        mark("grow")

        # -- 4. after the grow ------------------------------------------------
        node3_first = _nodes_stop([procs[3]], [hosts[3]])[0]
        procs[3] = None
        t0 = time.perf_counter()
        procs[3] = spawn(3)
        _wait_up(hosts[3], procs[3], up_limit_s)
        topo3 = topology(hosts[3])
        if topo3["epoch"] != 1 or sorted(topo3["nodes"]) != sorted(hosts):
            _fail(f"resize: node 3 restarted at epoch {topo3['epoch']}"
                  f" with {topo3['nodes']}")
        restart_s = wait_ready([hosts[3]], t0)
        after_grow_ms = check_reads(hosts, "after the grow")
        w_slices = converged(hosts, grow_moving, hosts)
        rose = {k: node3_first["launches"].get(k, 0) - node3_before.get(
            k, 0) for k in ("expr_count_rows", "densify")}
        if min(rose.values()) <= 0:
            _fail(f"resize: node 3 launched no moved-slice kernels: {rose}")
        stall = stall_trips(hosts[0])
        if stall[0] or stall[1]:
            _fail(f"resize: node 0's watchdog tripped resize_stall: {stall}")
        grow.update({"node3_restart_s": restart_s,
                     "node3_launches_rose": rose,
                     "w_slices_checked": w_slices,
                     "after_ms": after_grow_ms})
        mark("after_grow")

        # -- 5. shrink 4 -> 3 (POST /cluster/resize) --------------------------
        shrink_members = members_want["shrink"]
        shrink_moving = moving_slices(hosts, shrink_members)

        def start_shrink():
            st, _, out, _ = _request(
                hosts[0], "POST", "/cluster/resize",
                json.dumps({"remove": hosts[1]}).encode(), timeout=30)
            if st != 202:
                _fail(f"resize: POST remove: {st} {out[:300]!r}")
            return None

        shrink = run_step("shrink", hosts[0], start_shrink, hosts, hosts,
                          shrink_moving)
        node1_line = _nodes_stop([procs[1]], [hosts[1]])[0]
        procs[1] = None
        after_shrink_ms = check_reads(shrink_members, "after the shrink")
        shrink["w_slices_checked"] = converged(shrink_members,
                                               shrink_moving,
                                               shrink_members)
        stall = stall_trips(hosts[0])
        if stall[0] or stall[1]:
            _fail(f"resize: node 0's watchdog tripped resize_stall: {stall}")
        shrink["after_ms"] = after_shrink_ms
        mark("shrink")
        lines = _nodes_stop([procs[i] for i in (0, 2, 3)],
                            [hosts[i] for i in (0, 2, 3)])
        procs = [None, None, None, None]
        mark("stopped")
    except SystemExit:
        for i in range(4):
            try:
                with open(os.path.join(rtmp, f"node{i}.log"), "rb") as f:
                    tail = f.read()[-3000:].decode(errors="replace")
            except OSError:
                continue
            print(f"resize: node {i} log tail:\n{tail}", file=sys.stderr,
                  flush=True)
        raise
    finally:
        load["stop"].set()
        for p in procs:
            if p is not None:
                p.kill()
                p.communicate()

    launches: dict = {}
    for line in lines + [node3_first, node1_line]:
        for k, v in line["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out = {"phase": "resize", "config": "BASELINE configuration 4",
           "nodes": "3->4->3", "replicas": 2, "slices": n_slices,
           "bits": n_bits, "data_s": data_s, "ready_s": ready_s,
           "before_ms": before_ms, "grow": grow, "shrink": shrink,
           "launches": launches, "marks_s": marks, "card": _card(),
           "seconds": time.perf_counter() - t_phase}
    _emit(out)
    return out


TIER_BLOB_IDLE_S = 2.0  # the tier phase's [tier] blob-idle


def _tier_toml(path: str) -> None:
    """The tier phase's node config: the tier manager with the local-dir
    blob store, its loop at one hour (the phase drives each pass through
    ``GET /debug/tier?pass=1``), ``idle`` at 1 ms and ``blob-idle`` at
    ``TIER_BLOB_IDLE_S``: a pass demotes every fragment not read in the
    last millisecond and pushes every cold one not read for that long."""
    with open(path, "w") as f:
        f.write('[tier]\nenabled = true\nblob = "dir"\nidle = "1ms"\n'
                f'blob-idle = "{TIER_BLOB_IDLE_S:g}s"\ninterval = "1h"\n'
                'pace = "0s"\n')


def phase_tier(device, seed: int, tmp: str, n_slices: int = 32) -> dict:
    """Tiered storage on one port server on the card (this script's
    child mode, pinned, the ``server`` verb from ``_tier_toml``'s file):
    configuration 4's ``smoke`` layout at ``n_slices`` slices, every
    answer held to a host reference of those bits and to the answer the
    node gave hot at the start.

    1. Warm: two Counts (a dense row ∩ a sparse row, two dense rows), a
       plain ``TopN(frame=f, n=8)`` and a sourced TopN over listed ids,
       cold once and then five times each (p50).
    2. Cold: a pass demotes every fragment (``/debug/tier`` shows none
       hot, none pushed); the first Count after it (ms, block faults,
       the node's densify and expression-count launches) and a second.
    3. Blob: after ``blob-idle`` a pass pushes every fragment (MB, MB/s;
       only ``.blob`` stubs left beside the fragments); the first Count
       from the blob tier (ms, fetches, fetch MB/s from
       ``pilosa_tier_fault_wait_seconds``); the two TopNs, which promote
       fully, in the hot order, and the TopN block count launches.
    4. Restart: a pass pushes everything again, the node restarts (to
       ready s) with only stubs, and its first Count (all slices but the
       last) fetches from them, exact.
    5. A failed fetch: ``tier.fetch`` armed as ``partition(fetch)``; a
       Count over the last slice (still blob) answers 500, then 503 (the
       slice is blocked), and with ``?partial=1`` 200 naming the slice;
       disarmed, the next pass unblocks it and the Count is exact.
    6. A rotten cold block: index ``rot`` (one fragment) demoted, then
       ``tier.fault`` armed as ``corrupt*1``: its Count fails and the
       fragment is quarantined (``/debug/integrity``), no answer wrong;
       the index is deleted.
    7. After a last push the node stops and ``check --deep`` over its
       data directory exits 0 with a blob-tier verdict for every stub."""
    import signal
    import subprocess
    import numpy as np
    from pilosa_tpu_torch.models.holder import Holder

    t_phase = time.perf_counter()
    marks: dict = {}

    def mark(step, detail=None):
        marks[step] = time.perf_counter() - t_phase
        print(f"tier: {step} at {marks[step]:.1f} s"
              + (f" {json.dumps(detail)}" if detail else ""),
              file=sys.stderr, flush=True)

    repo = os.path.dirname(os.path.abspath(__file__))
    ttmp = os.path.join(tmp, "tier")
    os.makedirs(ttmp, exist_ok=True)
    rng = np.random.default_rng(seed + 110)
    data = os.path.join(ttmp, "data")
    frag_dir = os.path.join(data, "smoke", "f", "views", "standard",
                            "fragments")

    # -- data, and the host references ----------------------------------------
    t0 = time.perf_counter()
    h = Holder(data)
    h.open()
    h.create_index("smoke").create_frame("f") \
        .create_view_if_not_exists("standard")
    h.close()
    positions, cols = _smoke_rows(rng, n_slices)
    n_bits = int(sum(len(p) for p in positions))
    for s in range(n_slices):
        _c5_write((positions[s], [os.path.join(frag_dir, str(s))]))
    del positions
    row_n = {r: int(sum(len(c) for c in cols[r])) for r in cols}

    def inter(a, b, slices=range(n_slices)):
        return int(sum(len(np.intersect1d(cols[a][s], cols[b][s],
                                          assume_unique=True))
                       for s in slices))

    pairs = ((1, 9), (2, 3))
    last = n_slices - 1
    count_qs = [f"Count(Intersect(Bitmap(rowID={a}, frame=f),"
                f" Bitmap(rowID={b}, frame=f)))" for a, b in pairs]
    count_wants = [[inter(a, b)] for a, b in pairs]
    head_want = [inter(1, 9, range(last))]
    last_want = [inter(1, 9, [last])]
    ids = [2, 3, 4, 5]
    topn_q = "TopN(frame=f, n=8)"
    topn_want = sorted(((r, row_n[r]) for r in range(1, 9)),
                       key=lambda p: (-p[1], p[0]))
    src_q = f"TopN(Bitmap(rowID=1, frame=f), frame=f, ids={ids})"
    src_want = sorted(((r, inter(1, r)) for r in ids if inter(1, r)),
                      key=lambda p: (-p[1], p[0]))
    del cols
    data_s = time.perf_counter() - t0
    mark("data")

    host = f"127.0.0.1:{_free_port()}"
    cfg = os.path.join(ttmp, "node.toml")
    _tier_toml(cfg)
    counters_path = os.path.join(ttmp, "node.counters")
    proc = [None]
    wrong: list = []
    failed: list = []
    lives: list = []
    touched = [0.0]

    def spawn():
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = repo
        args = [sys.executable, os.path.abspath(__file__), "--cluster-node",
                "1", counters_path, "server", "-c", cfg, "-d", data, "-b",
                host, "--cost.dir", os.path.join(ttmp, "cal")]
        if device.type == "cpu":
            args += ["--device", "cpu"]
        log = open(os.path.join(ttmp, "node.log"), "ab")
        return subprocess.Popen(args, cwd=repo, env=env,
                                stdout=subprocess.PIPE, stderr=log)

    def counters() -> dict:
        if os.path.exists(counters_path):
            os.remove(counters_path)
        proc[0].send_signal(signal.SIGUSR1)
        t1 = time.perf_counter()
        while not os.path.exists(counters_path):
            if time.perf_counter() - t1 > 10:
                _fail("tier: the node wrote no counters on SIGUSR1")
            time.sleep(0.02)
        with open(counters_path) as f:
            return json.load(f)["launches"]

    def query(q, want=None, qs="", index="smoke", label=""):
        """One read that must answer 200 (else it counts as failed) and,
        with ``want``, exactly (else wrong); it stamps the fragments'
        last touch."""
        st, hd, out, ms = _request(host, "POST", f"/index/{index}/query{qs}",
                                   q.encode(), timeout=300)
        touched[0] = time.perf_counter()
        if st != 200:
            failed.append((label, q[:60], st, out[:200]))
            return None, ms
        res = json.loads(out)["results"]
        if want is not None:
            got = ([_pairs_json(r) for r in res] if q.startswith("TopN")
                   else res)
            if got != want:
                wrong.append((label, q[:60], got, want))
        return res, ms

    def raw(method, path, body=b""):
        st, hd, out, ms = _request(host, method, path, body, timeout=300)
        if method != "POST" or "/query" not in path:
            if st != 200:
                _fail(f"tier: {method} {path}: HTTP {st}: {out[:200]!r}")
        return st, hd, out, ms

    def tier(qs=""):
        return json.loads(raw("GET", f"/debug/tier{qs}")[2])

    def tier_pass():
        """One manager pass; (its summary, seconds, the state after)."""
        t1 = time.perf_counter()
        summary = tier("?pass=1")["pass"]
        return summary, time.perf_counter() - t1, tier()

    def idle_until_pushable():
        # blob-idle since the last read that reached a fragment.
        wait = touched[0] + TIER_BLOB_IDLE_S + 0.2 - time.perf_counter()
        if wait > 0:
            time.sleep(wait)

    def failpoint(site, spec):
        raw("POST", "/debug/failpoints",
            json.dumps({"site": site, "spec": spec}).encode())

    def metric(family, **labels) -> float:
        return _family_sum(_scrape(host), family, **labels)

    def stop() -> dict:
        line = _nodes_stop([proc[0]], [host])[0]
        proc[0] = None
        lives.append(line["launches"])
        return line

    def delta(c1, c0, name):
        return c1.get(name, 0) - c0.get(name, 0)

    try:
        # -- 1. warm ------------------------------------------------------------
        t0 = time.perf_counter()
        proc[0] = spawn()
        ready_s = _node_up([host], [proc[0]], 240.0, last, index="smoke")
        mark("ready")
        hot = {}
        warm_ms = {}
        for q, want in (list(zip(count_qs, count_wants))
                        + [(topn_q, [topn_want]), (src_q, [src_want])]):
            res, cold_ms = query(q, want, label="warm")
            hot[q] = res
            warm_ms[q] = {"cold_ms": cold_ms, "p50_ms": _median(
                [query(q, want, label="warm")[1] for _ in range(5)])}
        mark("warm")

        # -- 2. cold --------------------------------------------------------------
        # A read of an empty row through every fragment stamps them all
        # now, so this pass demotes (idle 1 ms) and pushes none
        # (blob-idle).
        query("Bitmap(rowID=1000, frame=f)", label="touch")
        time.sleep(0.01)
        summary, demote_s, st = tier_pass()
        tiers = st["tiers"]
        if (tiers["hot"]["fragments"] or tiers["blob"]["fragments"]
                or tiers["cold"]["fragments"] != n_slices):
            _fail(f"tier: the demotion pass left {tiers} ({summary})")
        c0, f0 = counters(), metric("pilosa_tier_block_faults_total",
                                    outcome="ok")
        _, cold_first_ms = query(count_qs[0], count_wants[0], label="cold")
        c1, f1 = counters(), metric("pilosa_tier_block_faults_total",
                                    outcome="ok")
        _, cold_second_ms = query(count_qs[0], count_wants[0], label="cold")
        cold = {"demote_pass_s": demote_s, "demoted": summary["demoted"],
                "first_count_ms": cold_first_ms,
                "second_count_ms": cold_second_ms,
                "block_faults": f1 - f0,
                "densify": delta(c1, c0, "densify"),
                "expr_count_rows": delta(c1, c0, "expr_count_rows")}
        if cold["densify"] <= 0 or cold["expr_count_rows"] <= 0:
            _fail(f"tier: the first Count after the demotion launched"
                  f" no densify or expression count: {cold}")
        mark("cold", cold)

        # -- 3. blob --------------------------------------------------------------
        idle_until_pushable()
        summary, push_s, st = tier_pass()
        tiers = st["tiers"]
        if tiers["blob"]["fragments"] != n_slices:
            _fail(f"tier: the push pass left {tiers} ({summary})")
        left = sorted(os.listdir(frag_dir))
        if left != sorted(f"{s}.blob" for s in range(n_slices)):
            _fail(f"tier: beside the stubs on local disk: {left[:8]}")
        push_mb = tiers["blob"]["bytes"] / 1e6
        c0 = counters()
        f0 = metric("pilosa_tier_blob_transfers_total", direction="fetch",
                    outcome="ok")
        w0 = metric("pilosa_tier_fault_wait_seconds_sum")
        _, blob_first_ms = query(count_qs[0], count_wants[0], label="blob")
        fetches = metric("pilosa_tier_blob_transfers_total",
                         direction="fetch", outcome="ok") - f0
        fetch_s = metric("pilosa_tier_fault_wait_seconds_sum") - w0
        c1 = counters()
        topn_ms = {}
        for q, want in ((topn_q, topn_want), (src_q, src_want)):
            res, topn_ms[q] = query(q, [want], label="blob topn")
            if res is not None and res != hot[q]:
                wrong.append(("blob topn order", q, res, hot[q]))
        c2 = counters()
        promoted = tier()["tiers"]
        blob = {"push_pass_s": push_s, "pushed": summary["pushed"],
                "push_mb": push_mb, "push_mb_per_s": push_mb / push_s,
                "first_count_ms": blob_first_ms, "fetches": fetches,
                "fetch_and_fault_s": fetch_s,
                "fetch_mb_per_s": push_mb / fetch_s if fetch_s else None,
                "densify": delta(c1, c0, "densify"),
                "expr_count_rows": delta(c1, c0, "expr_count_rows"),
                "topn_ms": list(topn_ms.values()),
                "topn_block_count": delta(c2, c1, "topn_block_count"),
                "hot_after_topn": promoted["hot"]["fragments"]}
        if fetches != n_slices or blob["densify"] <= 0 \
                or blob["expr_count_rows"] <= 0:
            _fail(f"tier: the first Count from the blob tier: {blob}")
        if blob["topn_block_count"] <= 0 or \
                blob["hot_after_topn"] != n_slices:
            _fail(f"tier: the TopNs after the fetch: {blob}")
        mark("blob", blob)

        # -- 4. restart ---------------------------------------------------------
        idle_until_pushable()
        summary, push2_s, st = tier_pass()
        if st["tiers"]["blob"]["fragments"] != n_slices:
            _fail(f"tier: the second push left {st['tiers']}")
        stop()
        t0 = time.perf_counter()
        proc[0] = spawn()
        ready2_s = _node_up([host], [proc[0]], 240.0, last, index="smoke")
        after = tier()["tiers"]
        if after["blob"]["fragments"] != n_slices:
            _fail(f"tier: the restarted node opened {after}")
        f0 = metric("pilosa_tier_blob_transfers_total", direction="fetch",
                    outcome="ok")
        head = "?slices=" + ",".join(map(str, range(last)))
        _, restart_first_ms = query(count_qs[0], [head_want[0]], qs=head,
                                    label="restart")
        restart = {"push_pass_s": push2_s, "pushed": summary["pushed"],
                   "ready_s": ready2_s, "first_count_ms": restart_first_ms,
                   "fetches": metric("pilosa_tier_blob_transfers_total",
                                     direction="fetch", outcome="ok") - f0}
        if restart["fetches"] != last:
            _fail(f"tier: the first Count after the restart: {restart}")
        mark("restart", restart)

        # -- 5. a failed fetch --------------------------------------------------
        one = f"?slices={last}"
        failpoint("tier.fetch", "partition(fetch)")
        strict = raw("POST", f"/index/smoke/query{one}",
                     count_qs[0].encode())
        again = raw("POST", f"/index/smoke/query{one}",
                    count_qs[0].encode())
        blocked_state = tier()["blocked"]
        partial = raw("POST", f"/index/smoke/query{one}&partial=1",
                      count_qs[0].encode())
        failpoint("tier.fetch", "off")
        summary, _, st = tier_pass()
        _, healed_ms = query(count_qs[0], last_want, qs=one, label="healed")
        blocked = {"strict_status": strict[0], "again_status": again[0],
                   "blocked_slices": sorted(b["slice"]
                                            for b in blocked_state),
                   "partial_status": partial[0],
                   "partial_slices": partial[1].get("X-Pilosa-Partial"),
                   "partial_results": json.loads(partial[2]).get(
                       "results"),
                   "retried": summary["retried"],
                   "blocked_after": len(st["blocked"]),
                   "healed_ms": healed_ms}
        if (strict[0] != 500 or again[0] != 503
                or blocked["blocked_slices"] != [last]
                or partial[0] != 200
                or blocked["partial_slices"] != str(last)
                or blocked["partial_results"] != [0]
                or blocked["retried"] < 1 or blocked["blocked_after"]):
            _fail(f"tier: the failed fetch did not degrade and heal as"
                  f" the JAX server does: {blocked}")
        mark("blocked", blocked)

        # -- 6. a rotten cold block ---------------------------------------------
        raw("POST", "/index/rot", b"{}")
        raw("POST", "/index/rot/frame/f", b"{}")
        rot_cols = sorted(set(int(c) for c in rng.integers(
            0, 1 << 20, size=3000)))
        st_w = raw("POST", "/index/rot/query", "\n".join(
            f"SetBit(rowID=1, frame=f, columnID={c})"
            for c in rot_cols).encode())[0]
        if st_w != 200:
            _fail(f"tier: the rot index's SetBits answered {st_w}")
        # The first pass tracks the new fragment; a read then stamps it,
        # so the second demotes it (idle 1 ms) and pushes none of it
        # (blob-idle), however long the first took.
        tier_pass()
        query("Bitmap(rowID=2, frame=f)", index="rot", label="touch")
        time.sleep(0.01)
        tier_pass()
        cold_rot = [e for e in tier("?entries=1&tier=cold")["entries"]
                    if e["index"] == "rot"]
        if len(cold_rot) != 1:
            _fail(f"tier: the rot fragment is not cold: {cold_rot}")
        failpoint("tier.fault", "corrupt*1")
        rq = "Count(Bitmap(rowID=1, frame=f))"
        rot1 = raw("POST", "/index/rot/query", rq.encode())
        rot2 = raw("POST", "/index/rot/query", rq.encode())
        failpoint("tier.fault", "off")
        quarantined = [e for e in json.loads(raw(
            "GET", "/debug/integrity")[2])["quarantined"]
            if e.get("index") == "rot"]
        for st_r in (rot1, rot2):
            if st_r[0] == 200 and json.loads(st_r[2])["results"] != [
                    len(rot_cols)]:
                wrong.append(("rot", json.loads(st_r[2])))
        corrupt = {"first_status": rot1[0], "again_status": rot2[0],
                   "quarantined": len(quarantined)}
        if rot1[0] == 200 or rot2[0] == 200 or len(quarantined) != 1:
            _fail(f"tier: the rotten cold block was served: {corrupt}")
        raw("DELETE", "/index/rot")
        mark("corrupt", corrupt)

        # -- 7. check --deep ----------------------------------------------------
        idle_until_pushable()
        _, _, st = tier_pass()
        if st["tiers"]["blob"]["fragments"] != n_slices:
            _fail(f"tier: the last push left {st['tiers']}")
        stop()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = repo
        t1 = time.perf_counter()
        chk = subprocess.run([sys.executable, "-m", "pilosa_tpu_torch.cli",
                              "check", "--deep", data], cwd=repo, env=env,
                             capture_output=True, text=True, timeout=600)
        verdicts = chk.stdout.count("ok (blob tier,")
        check = {"rc": chk.returncode, "blob_verdicts": verdicts,
                 "seconds": time.perf_counter() - t1,
                 "last_line": chk.stdout.strip().splitlines()[-1:]}
        if chk.returncode != 0 or verdicts != n_slices:
            _fail(f"tier: check --deep: {check} {chk.stdout[-600:]!r}"
                  f" {chk.stderr[-600:]!r}")
        mark("check", check)
    except SystemExit:
        try:
            with open(os.path.join(ttmp, "node.log"), "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            print(f"tier: node log tail:\n{tail}", file=sys.stderr,
                  flush=True)
        except OSError:
            pass
        raise
    finally:
        if proc[0] is not None:
            proc[0].kill()
            proc[0].communicate()

    if wrong or failed:
        _fail(f"tier: {len(wrong)} wrong and {len(failed)} failed answers:"
              f" {(wrong + failed)[:3]}")
    launches: dict = {}
    for line in lives:
        for k, v in line.items():
            launches[k] = launches.get(k, 0) + v
    out = {"phase": "tier", "config": "BASELINE configuration 4",
           "slices": n_slices, "bits": n_bits, "data_s": data_s,
           "ready_s": ready_s,
           "warm": {q[:40]: v for q, v in warm_ms.items()},
           "cold": cold, "blob": blob, "restart": restart,
           "blocked": blocked, "corrupt": corrupt, "check": check,
           "wrong": len(wrong), "failed": len(failed),
           "launches": launches, "marks_s": marks, "card": _card(),
           "seconds": time.perf_counter() - t_phase}
    _emit(out)
    return out


def _cluster_node(argv: list) -> None:
    """Child mode of ``phase_cluster``: one node, the ``server`` verb's
    code (pilosa_tpu_torch/cli/commands.py) with ``argv[0]`` "1" adding
    the kernel phases' pins (``_pinned``) and, either way, no warmup (its
    launches would count). At exit it prints its launch counters and
    peak device MiB on one ``cluster-node {...}`` line; on SIGUSR1 it
    writes them to the file ``argv[1]``."""
    import signal
    import torch
    if not torch.cuda.is_available() and "--device" not in argv:
        _fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pilosa_tpu_torch.cli import commands
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    from pilosa_tpu_torch.server import server as server_mod
    pinned, counters_path = argv[0] == "1", argv[1]
    init = server_mod.Server.__init__

    def counters() -> dict:
        return {"launches": dict(ck.LAUNCHES),
                "peak_mib": (torch.cuda.max_memory_allocated() / 2**20
                             if torch.cuda.is_available() else 0.0)}

    def snapshot(signum, frame):
        with open(counters_path + ".tmp", "w") as f:
            json.dump(counters(), f)
        os.replace(counters_path + ".tmp", counters_path)

    signal.signal(signal.SIGUSR1, snapshot)

    def pinned_init(self, *a, **kw):
        kw["warmup"] = False
        if pinned:
            kw["executor_options"] = _pinned()
        init(self, *a, **kw)

    server_mod.Server.__init__ = pinned_init
    rc = commands.main(argv[2:])
    print("cluster-node " + json.dumps(counters()), flush=True)
    sys.exit(rc)


def phase_bench(device) -> dict:
    """The benchmark of record in this process, at its default width and
    rows; ``bench.run`` raises when a device count differs from the
    host's."""
    from pilosa_tpu_torch import bench
    knobs = {"PILOSA_BENCH_BITS": str(BENCH_WORDS * 32),
             "PILOSA_BENCH_ROWS": "16",
             "PILOSA_BENCH_ITERS": str(BENCH_ITERS),
             "PILOSA_BENCH_TRIALS": "3"}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        line = bench.run(device)
    except RuntimeError as e:
        _fail(f"bench: {e}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if (line["metric"] != "intersect_count_1024Mbit_rows"
            or line["rows"] != 16 or line["platform"] != "gpu"):
        _fail(f"bench: unexpected line {line}")
    _emit({"phase": "bench", **line})
    return line


def _local_phases(device, seed: int, tmp: str) -> dict:
    """Phases 2-10 in this process; their launch counters summed."""
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.ops import cuda_kernels as ck
    data_dir = os.path.join(tmp, "data")
    holder = Holder(data_dir)
    holder.open()
    phase_count(holder, device, seed)
    _, ids200 = phase_topn(holder, device, seed)
    _, topn1000 = phase_topn1000(holder, device, seed)
    phase_planner(holder, device)
    launches = dict(ck.LAUNCHES)
    ck.reset_launches()
    _, fields = phase_fields(holder, device, seed)
    for name in ("expr_count_rows", "densify"):
        if ck.LAUNCHES[name] <= 0:
            _fail(f"{name}: no launch in the fields phase")
    for name, n in ck.LAUNCHES.items():
        launches[name] += n
    ck.reset_launches()
    _, batch_served = phase_batch(holder, device, seed)
    for name in ("expr_words", "expr_count_batch", "topn_block_count"):
        if ck.LAUNCHES[name] <= 0:
            _fail(f"{name}: no launch in the batch phase")
    for name, n in ck.LAUNCHES.items():
        launches[name] += n
    holder.close()
    ck.reset_launches()
    phase_server(data_dir, device, seed, ids200, topn1000,
                 fields + batch_served)
    for name, n in ck.LAUNCHES.items():
        launches[name] += n
    ck.reset_launches()
    phase_control(data_dir, device, seed, tmp)
    for name, n in ck.LAUNCHES.items():
        launches[name] += n
    # Nothing reads the earlier phases' directory again: free its
    # disk for the durability storm's WAL.
    shutil.rmtree(data_dir)
    phase_durability(device, seed, tmp)
    for name, n in ck.LAUNCHES.items():
        launches[name] += n
    return launches


# Phases 11-16 in their order: each alone with ``--phase``, all of them
# in the ``--node-phases`` child of the whole run.
NODE_PHASES = {"cluster": phase_cluster, "integrity": phase_integrity,
               "gossip": phase_gossip, "operator": phase_operator,
               "resize": phase_resize, "tier": phase_tier}


def _node_phases(argv: list) -> None:
    """Child mode of the whole run: phases 11-16 one after another, in
    one temporary directory of their own; ``argv`` is the file that gets
    their nodes' launch counters summed, the seed and the parent's start
    (``time.time()``). A SIGTERM ends it through each phase's own
    teardown, which stops that phase's nodes."""
    import signal
    import torch
    global _T0
    if not torch.cuda.is_available():
        _fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pilosa_tpu_torch.device import resolve_device
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(1))
    out_path, seed, _T0 = argv[0], int(argv[1]), float(argv[2])
    device = resolve_device()
    launches: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for phase in NODE_PHASES.values():
            for k, n in phase(device, seed, tmp)["launches"].items():
                launches[k] = launches.get(k, 0) + n
    with open(out_path + ".tmp", "w") as f:
        json.dump(launches, f)
    os.replace(out_path + ".tmp", out_path)


def _node_phases_start(tmp: str, seed: int):
    """Starts ``--node-phases`` with its standard output in ``tmp``."""
    import subprocess
    with open(os.path.join(tmp, "node_phases.out"), "wb") as out:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--node-phases",
             os.path.join(tmp, "node_phases.json"), str(seed), repr(_T0)],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out)


def _node_phases_join(proc, tmp: str) -> dict:
    """Waits for the child, prints its phase lines and returns its
    nodes' launch counters; fails if it failed."""
    rc = proc.wait()
    with open(os.path.join(tmp, "node_phases.out")) as f:
        sys.stdout.write(f.read())
    sys.stdout.flush()
    if rc != 0:
        _fail(f"the node phases exited with {rc}")
    with open(os.path.join(tmp, "node_phases.json")) as f:
        return json.load(f)


def _node_phases_stop(proc) -> None:
    """SIGTERM a child still running (its phases stop their nodes),
    then SIGKILL it if it outlives two minutes."""
    import subprocess
    if proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--cluster-node":
        _cluster_node(sys.argv[2:])
        return
    if len(sys.argv) > 1 and sys.argv[1] == "--node-phases":
        _node_phases(sys.argv[2:])
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=tuple(NODE_PHASES),
                    help="build the kernels and run this one phase"
                         " alone (its line only: no kernel table, no"
                         " last line)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from pilosa_tpu_torch import bench
        from pilosa_tpu_torch.device import resolve_device
        from pilosa_tpu_torch.ops import build
        from pilosa_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        _fail(f"the port is not importable here: {e}")
    device = resolve_device()

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.libraries()
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "torch": torch.__version__, "cuda": torch.version.cuda})
    if args.phase:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            NODE_PHASES[args.phase](device, args.seed, tmp)
        print(f"nvidia-smi: {_card()}", flush=True)
        return

    table = phase_kernels(device, args.seed)
    ck.reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        nodes = _node_phases_start(tmp, args.seed)
        try:
            launches = _local_phases(device, args.seed, tmp)
            for name, n in _node_phases_join(nodes, tmp).items():
                launches[name] += n
        finally:
            _node_phases_stop(nodes)
    before_bench = ck.LAUNCHES["op_count_rows"]
    phase_bench(device)
    if ck.LAUNCHES["op_count_rows"] <= before_bench:
        _fail("op_count_rows: no launch in the bench phase")
    launches["op_count_rows"] += ck.LAUNCHES["op_count_rows"] - before_bench
    for name, n in launches.items():
        if n <= 0:
            _fail(f"{name}: no launch on the main path")
        table[name]["launches"] = n

    print(f"nvidia-smi: {_card()}", flush=True)
    _emit({"kernels": list(table.values())})
    _emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
