#!/usr/bin/env python3
"""Drive the PyTorch port of SlimSell BFS on one CUDA card, end to end.

    python3 chip_smoke.py        # from the repository root, one H100

Phases, each of which must pass (any failure ends the run with a nonzero
exit and no result line):

1. the card's name and power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (ten
   entry points in seven sources, and the semiring probe);
3. every kernel against its plain PyTorch version on the card, exactly
   (all values are integers or +-inf), on a scale-14 Kronecker graph:
   4 semirings x {SpMV, SpMM B=1/5/64} x 4 tile masks (none given, all
   kept, none kept, random with whole chunks dropped), and 4 semirings x
   {pull, pull_mm B=1/5/64} x the same masks x not-final bits (random,
   all, none); then the three SpMM entries on a hub graph (an Erdos-Renyi
   graph of 2^14 vertices and a vertex joined to all, whose chunk of 128
   tiles the SpMM cuts into 64 pieces and folds): the implicit SpMM in 4
   semirings and the stored-weight SpMM exactly, the GCN SpMM within
   1e-5, at B=1/5/16/33/64/97/160 x the five masks of 7a; and both SpMV
   entries on the same graph at C=8, L=128 and C=3, L=1, whose hub chunk
   they cut into pieces of their own: the implicit SpMV in 4 semirings and
   the stored-weight SpMV (the layout's weights and padding weights
   poisoned to -1000) exactly, x the five masks and one keeping a single
   tile of the hub, and over the same pieces the packed SpMV (5) at both
   layouts x 2 frontier densities and the single-source pull (3) at C=8,
   L=128 in 4 semirings x not-final bits random and all, exactly; then
   the batched pull (4) on the same graph at C=8, L=128, whose hub chunk
   the SpMV's list cuts into 16 pieces, exactly: 4 semirings x
   B=1/5/33/64/97/160 x the five masks x not-final bits random
   and all, and the hub's first hit only in the first, a middle or the
   last piece of its chunk, or in a middle and the last with other values
   (the pieces are folded by their first hit, not the semiring add), and
   the single-source pull (3) on the first column of those hit cases; and
   the packed SpMM (6) over the SpMV's items at C=8, L=128 and C=3, L=1,
   B=1/5/33/64/97/160 x the five masks x 2 frontier densities, exactly;
4. (a) the kernel path against the plain path at scale 14: single- and
   multi-source BFS in push, pull and auto, and single-source hostloop
   auto: distances, parents, iterations, work and direction logs equal;
   (b) single-source BFS at scale 20 in all four semirings, push and
   auto, and one hostloop auto run, each tree validated (Graph500 §5.2);
5. the Graph500 harness, 64 roots in one batch of 64, on the same graph,
   through a ``GraphSession`` (``bfs_many``): push (all 64 trees validated
   against the oracle; the batch bit-equal, distances and parents, to a
   direct ``multi_source_bfs`` of the roots timed beside it, with as many
   launches of kernel 2), then auto and pull (the pull batch through the
   pull_mm kernel, its launches over the harness call nonzero): their
   TEPS, and their distances bit-equal to the push batch's with all 64
   trees validated;
6. at the scale-20 shapes, every kernel against its plain version again:
   SpMV and SpMM (4 semirings x 4 masks), pull and pull_mm at a real pull
   state (the BFS state just before an iteration that pulls, 4
   semirings); then each kernel timed beside its plain version, a
   library call and its bound, and the SpMM's and SpMV's times over parts
   of the layout (``profile_spmm.chunk_split``: the heaviest chunk alone,
   the rest, no tile; for the SpMV also the chunks of at least and of
   fewer than 10 tiles), ``adj @ x`` timed in the same call; each pull
   beside the push sweep of its iteration (the single-source pull also
   beside the batched pull at B=1 on its state), over the same parts each
   within its state's mask and with no pending row or (row, column) (its
   floor, ``profile_spmm.pull_split``), with the slots its first hits need
   and at most those its pieces read past the hits;
7. SlimSell-B, the bit-packed boolean path: (a) at scale 14 both packed
   kernels against their plain versions, exactly (5 masks x the SpMV and
   the SpMM at B=1/5/33/64/97/160 x 2 frontier densities; 97 and 160 fill
   4 and 5 word planes, so the SpMM's second grid-y block runs partly
   used), then packed ``bfs``
   and ``multi_source_bfs``, fused and hostloop, on the card against the
   same on the CPU; (b) at scale 20, packed ``bfs`` from the phase-4b root,
   fused and hostloop, bit-equal to lane-boolean push (distances,
   iterations, work log) with a valid DP-parent tree, and the packed batch
   of the phase-5 roots, distances equal to the push batch's and all 64
   trees valid, timed with and without parents beside push in turns, with
   TEPS under ``run_graph500``'s accounting, and packed ``bfs`` timed in
   turns with lane-boolean push; (c) each packed kernel at the
   real state of the iteration with the most tiles, with that iteration's
   mask and with every tile kept, against its plain version and timed
   beside it, the lane kernel, a library call and its bound, and each
   packed kernel over the parts of the layout as in phase 6, beside the
   SpMV (1) of phase 6; (d) the paper's storage accounting at scale 20;
8. weighted SSSP (delta-stepping) through the stored-weight (min-plus)
   kernel: (a) at scale 14 the kernel against its plain version, exactly
   (the full ``wts`` and its light and heavy views at the default delta x
   the five masks of 7a x frontiers all +inf, sparse and dense), then
   ``sssp`` on the card against ``sssp`` on the CPU, fused and hostloop, at
   the default delta, at inf and at 0.05: distances, parents, sweeps,
   buckets and work log equal; (b) at scale 20, ``sssp`` from the phase-4b
   root, fused and hostloop (bit-equal to each other, timed), its distances
   checked against scipy's Dijkstra and its tree validated; then
   ``run_graph500_sssp`` over the phase-5 roots through a session, each
   root a width-1 slot of the batched min-plus path (kernel 2w at B=1,
   its launches over the harness nonzero), timed without validation, its
   64 results (distances, parents, sweeps, buckets, delta) bit-equal to
   the direct ``sssp`` of each root, and those trees validated against one
   scipy Dijkstra call (all 64, or the first 16 when 64 would not fit the
   time limit: the count is printed); (c) the kernel at the real state of
   the sweep with the most
   tiles, with that sweep's mask and with every tile kept, against its
   plain version, timed beside it, the implicit-value SpMV on the same
   frontier, a library call and its bound; then over parts of the layout
   as in phase 6, and at every sweep of the phase-8b root (each state
   rebuilt, each result against the plain version), with their sum;
9. batched multi-source SSSP through the stored-weight (min-plus) SpMM
   kernel: (a) at scale 14 the kernel against its plain version, exactly
   (the five masks of 7a x B=1/5/33/64/97/160 x frontiers sparse and
   dense, each with the layout's weights and with every padding slot's
   weight poisoned to -1000; 160 takes a second, partly used block along
   grid y), then ``multi_source_sssp`` on the card against the CPU, fused
   and hostloop; (b) at scale 20, ``multi_source_sssp`` over the 64
   phase-5 roots in one batch of 64, default delta, parents on, fused and
   hostloop: fused == hostloop, and each row's distances, parents, sweeps
   and buckets == phase 8b's per-root ``sssp`` of that root; (c)
   ``run_graph500_sssp(batched=True, batch_size=64)`` through a session
   with and without parents, its sweeps and buckets == the per-root
   harness's, its rows (distances, parents, sweeps, buckets) == 9b's, and
   the batch's trees validated against the per-root distances (all 64, or the
   first 16 when 64 would not fit the time limit: the count is printed);
   (d) the kernel at the real state of the batch's sweep with the most
   tiles, with that sweep's mask and with every tile kept, against its
   plain version, timed beside it, the implicit-value SpMM on the same
   frontier, a library call and its bound, and over parts of the layout
   as in phase 6;
10. GCN inference (gcn-cora, 2 layers 1433 -> 16 -> 16) on the SlimSell-W
   aggregation through the GCN-weighted SpMM kernel: (a) the kernel
   against its plain version, rtol = atol = 1e-5 and no NaN, on an
   Erdos-Renyi graph of Cora's shape (2,708 nodes, average degree 3.9) at
   C=8, L=16 and the scale-14 graph (isolated vertices) at C=8, L=128 and
   L=16, x B=1/5/16/33/64/160 x the five masks of 7a (160 takes a second
   block along grid y); then ``gcn_forward`` on the card against the CPU,
   both aggregations, at d_in 1433 on the first two graphs, atol = rtol =
   1e-4; (b) at scale 20, N(0, 1) features from a seeded card generator
   (6.01 GB): three requests (``aggregation="slimsell"`` forwards under
   ``torch.inference_mode()``), equal to each other and to the segment
   aggregation within atol = rtol = 1e-3, then the warm forward of each
   aggregation timed (median of 5) with its ``x @ w`` and aggregation
   shares and nodes/s; (c) the kernel at d = 16 with every tile kept
   against a float64 run of its plain version (atol = rtol = 1e-4), timed
   beside the plain version, the implicit real SpMM on the same X,
   ``torch.sparse.mm`` on the GCN-normalised CSR (the same function) and
   its bound, and over parts of the layout as in phase 6;
12. (run after phase 10 and before 11, which frees the scale-20 layout)
   connected components, k-hop and PageRank through the ported sweeps:
   (a) on the scale-14 graph and five small graphs (a star, a path, two
   components, a sparse Erdos-Renyi graph with isolated vertices, an
   edgeless graph), the card against the CPU's plain path: ``cc``
   sel-max and boolean (lane push, pull and auto, packed push), fused
   and hostloop, labels, counts, iterations and work logs equal and the
   labels equal to scipy's; ``khop`` at k = 0, 1, 2, 3 and None and
   ``khop_many`` over 12 roots, lane and packed, masks, distances and
   iterations equal; ``pagerank`` fused and hostloop within the bounds
   ``PR_*`` of the CPU's (sweep counts equal, or one apart where the
   plain residual lies within ``PR_RESID_ULPS * sum_i ulp(r_i)`` of tol);
   (b) at scale 20, each run warm, median of 3:
   ``cc`` sel-max fused and hostloop, equal to each other and to scipy's
   canonical labels; boolean lane push and auto and packed, equal to
   sel-max's; ``khop`` from the phase-4b root at k = 1, 2, 3, None equal
   to phase 4b's boolean distances clipped at k; ``khop_many`` over the
   64 phase-5 roots at k = 2, lane push, auto and pull and packed, equal
   to the push batch's distances clipped at 2; ``pagerank`` fused and
   hostloop (three runs and the two modes bit-equal) within ``PR_L1_F64``
   of a float64 power iteration and within the bounds of the same call
   with the plain sweeps on the card, mass 1 within 1e-5; (c) kernel 1 at
   PageRank's second sweep (real, x = r/deg) within the bounds of plain,
   timed beside plain, ``adj @ x`` and its bound, and at CC's first
   sweep (sel-max, every label) exactly, timed beside the phase-6
   sel-max operand;
13. (run after phase 12 and before 11) Brandes betweenness through kernel
   2's real mode (path counts forward, the fractions (1 + delta) / sigma
   backward): (a) exact betweenness (all sources) on a star, a path, two
   components and a sparse Erdos-Renyi graph, and 16 sampled sources on
   the scale-14 graph, fused and hostloop x SlimWork on and off x one
   batch and batches of 5, the card against the CPU's plain path within
   the bounds ``BC_*`` (sweeps and depths equal, path counts bit-equal
   below 2^24, scores within rtol 1e-4 and 1e-6 of the largest) and
   against a float64 Brandes (scipy products level by level) within the
   tests' betweenness tolerances; (b) at scale 20 the 64 phase-5 roots in
   one batch of 64: fused, warm, median of 3, timed with the SpMM calls'
   share (CUDA events) and the host fold's; hostloop once; the three
   fused runs and the hostloop run bit-equal; depths equal to the phase-5
   push batch's distances; within the ``BC_*`` bounds of the same call
   with the plain sweeps on the card; eight roots against a float64
   Brandes over phase 5's depths; the largest path count and how many
   pass 2^24;
14. (run after phase 13 and before 11) the serving dispatcher
   (``repro_torch.serving``: ``Batcher``, ``Dispatcher`` on cached
   ``FixpointHandle``s, ``ServingMetrics``): (a) on kronecker(10, 8),
   star(64) and two_components(7, 8), one mixed stream each of all six
   algorithms (BFS in 4 semirings with parents on some roots and packed,
   SSSP at two deltas, CC sel-max, boolean lane and packed, PageRank at two
   dampings, k-hop at k = 1 and 2 lane and packed, betweenness) under
   ``EngineConfig()``, direction "auto" and mode "hostloop", x
   ``max_inflight`` 0 and 2: every result bit-equal to the card's front
   doors for its slot, and to the dispatcher on the CPU (integers
   bit-equal, PageRank within ``PR_*``, betweenness within ``BC_*``, sel-max
   parents under "auto" validated), the counters equal; the queries the
   JAX package refuses under "auto" (packed sweeps, betweenness) left out
   of its stream and refused on both devices with one error type; (b) at
   scale 20 one stream through ``Batcher(max_batch=64)`` and
   ``Dispatcher(max_inflight=2)``: the 64 phase-5 roots tropical (parents
   for 32), 16 sel-max with parents, 32 packed, 64 SSSP at the default
   delta, CC sel-max, PageRank, k-hop at k = 2, equal bit for bit to phase
   5's push batch and the front door's parents, phase 9b's rows, phase
   12b's labels, fused ranks and ``khop_many``; submitted twice, the second
   pass all handle hits and bit-equal to the first; the metrics' snapshot,
   the passes' wall time against the same front-door calls one by one;
15. (run after phase 14 and before 11) the serving session and router
   (``GraphSession``, ``Router``, the flush thread, backpressure): (a) a
   ``Router(background=True, max_inflight=2)`` over weighted
   kronecker(10, 8) and erdos_renyi(150, 5), and the first layout again
   (not copied) under direction "auto": 208 mixed queries from four
   producer threads (BFS tropical and sel-max with parents on some roots,
   packed BFS, SSSP, k-hop lane and packed, CC sel-max, boolean and
   packed, PageRank; roots without replacement per graph and kind), every
   result bit-equal to the card's front door for its query (PageRank
   within ``PR_*``), the counters reconciled per graph and in total; then
   ``on_full="shed"`` and ``"raise"`` at ``max_pending=4``, a ``close()``
   that drains the work in flight and ends the flush thread,
   ``SessionClosed`` after close and ``UnknownGraph`` for an unknown name;
   (b) at scale 20 ``GraphSession(tiled, max_batch=64, max_inflight=2)``
   on the resident layout (its ``cols`` storage, not a copy): phase 14b's
   242 queries from four producers under a flush thread, twice, and
   submitted then drained without one, twice; every value, parents,
   bucket count and delta bit-equal to 14b's first pass (sweeps too, but
   for batched BFS and k-hop under the flush thread, whose slot cuts
   follow its timing: printed); the drained passes in 14b's slots at fill
   1.0, the second all handle hits; each pass's wall time beside 14b's;
16. (run after phase 15 and before 11) the 2D-distributed strategy
   (``core.dist_bfs`` on ``distributed.Grid``), ranks as processes that
   share the card over gloo (collectives through the host): (a) the
   scale-20 graph cut into a 2 x 2 partition (timed); on blocks (0, 0)
   and (1, 1), kernel 1 in 4 semirings, 1w, 2, 2w, 3, 4 and 6 at the BFS
   state before iteration 3 (the phase-4b root, the phase-5 batch, phase
   8b's and 9b's distances) against their plain versions on the shard,
   exactly; (b) a 2 x 2 world of four processes: ``make_dist_bfs``
   tropical push and auto, ``make_dist_multi_bfs`` over the 64 phase-5
   roots lane (tropical push) and packed, ``make_dist_sssp`` from the 8b
   root at its delta, ``make_dist_multi_sssp`` over the 64 roots at 9b's
   delta, ``make_dist_cc`` and ``make_dist_pagerank``, each equal to
   phases 4b, 5, 8b, 9b and 12b (distances, levels, labels, iterations,
   sweeps and buckets bit-equal; PageRank within ``PR_*``), each with its
   time, collective time and launches per rank; (c) in the same world, on
   kronecker(10, 8) (C=8, L=32), every factory under both comm modes and
   every direction it takes, Brandes, k-hop lane and packed and the sliced
   BFS in float32, bfloat16 and int16, each equal to the single-device
   port on the card, then the same cases (BFS in tropical only) in a 1 x 1
   world on NCCL, the route of a run with one rank a card;
17. (run after phase 16 and before 11) the analysis layer and the
   sanitizer (``repro_torch.analysis``, ``core.debug``): (a) the entry
   ``semiring_probe`` evaluates the CUDA semiring table on the card,
   exactly equal to the port's table for every code it defines, the laws
   held on its own tables (associativity and distributivity through
   second launches over the first one's results), an unknown code
   refused, and the source's enum, structs and dispatch cases held to the
   port's table; (b) the kernel contracts on the work lists the kernels
   read: the scale-20 layout's ``spmm_work`` and ``spmv_work`` and those of
   blocks (0, 0) and (1, 1) of phase 16's partition, timed; (c) at scale
   20, BFS push, auto and hostloop auto, packed BFS, multi-BFS over the 64
   phase-5 roots lane, pull and packed, SSSP, multi-SSSP, CC and PageRank,
   each sanitized and unsanitized, bit-equal (PageRank within ``PR_*``)
   and timed beside each other, and one ``check_layout`` timed; the GCN
   and bag kernels sanitized at scale 14; corrupt copies of the scale-14
   layout (a column n + 7, a NaN weight, a ``tile_ptr`` entry past T)
   refused with ``SanitizerError`` under fused and hostloop, with the
   launch counts unchanged; (d) a 2 x 2 gloo world on kronecker(10, 8),
   each case unsanitized and sanitized, equal on every rank, and a block
   with a column >= n_x failing its sanitized launch with the rank's
   message;
11. DLRM inference at the dlrm-mlperf widths through the embedding-bag
   kernel (7), after freeing what phases 4-10 hold: (a) the kernel against
   its plain version, bit-equal (sum and mean; the JAX package's (V, d, B,
   K) sweep, d = 16 and 130, B = 1 and 13; pads none, random and whole
   bags; the bags a strided field and contiguous), on a table of 2^24 +
   2^20 rows (past 2^31 elements) read to its last row, ids past V giving
   NaN bags (one table: a launch with T = 1); five tables in one launch
   against its plain version and against one launch a table, bit-equal
   (tables of different rows, one of them the big table read to its last rows;
   sum and mean; pads; an id past V in one table only; the output new or
   the stacked slice DLRM writes), then ``dlrm_forward`` on the card
   against the CPU within 1e-4 (``reduced_config()``, and the MLPerf
   widths with 1,000-row tables at multi_hot 1 and 3 with pads); (b)
   ``capped_config()`` (every table cut to 2^24 rows, 45.03 GB,
   initialised on the card): three requests at ``serve_p99`` (B=512) and
   ``serve_bulk`` (B=262,144), each bit-equal to the first, then warm
   forwards timed (median of 20 and of 5), one launch a forward (all 26
   tables in it), the logits bit-equal to those with the plain
   lookups, the forward split by CUDA events (bottom MLP, lookups,
   interaction, top MLP), peak memory, and ``retrieval_cand`` (the user
   tower and 10^6 candidate scores); (c) the kernel at both serving
   shapes on one 2^24-row table, K = 1 and K = 3 with pads, beside its
   plain version, ``F.embedding_bag`` and its bound; then the launch over
   all 26 tables at both shapes, K = 1 and K = 3 with pads, beside its
   plain version, 26 launches of one table, 26 ``F.embedding_bag`` calls
   and its bound (the bytes of each distinct row read once);
18. training (``optim``, ``train.make_train_step``, ``checkpoint``, kernels
   7 and 2g under autograd, ``kernels.autograd``); (a) and (b) run after
   phase 10, while the scale-20 layout stands, (c) and (d) after phase 11:
   (a) 2g's X gradient (the same sweep over the output's gradient) against
   autograd of its plain version on the card within 1e-5 on phase 10a's
   three layouts at B = 1/16/33, one launch forward and one backward, a
   ``deg`` that requires grad refused; kernel 7's table gradients
   (``index_add_``) within ``TRAIN_BAG_TOL`` of autograd of its plain
   version over ``BAG_CASES`` (sum and mean, pads) and five tables in one
   launch with an id past its table, the forward bit-equal; one Muon step
   of a stacked [3, 64, 32] leaf against the CPU; (b) gcn-cora (1433 ->
   16 -> 16) trained at scale 20 on phase 10b's features, labels uniform
   on [0, 16) and a seeded 5% of the vertices in ``train_mask``, AdamW,
   clip 1.0: 5 SlimSell steps, 2g launched exactly 4 times a step and no
   other kernel, losses finite, step 1's loss, gradient norm and weights
   within ``TRAIN_GCN_TOL`` of the same step on the segment aggregation,
   the warm step's median time, nodes/s and TFLOP/s
   (``gcn_model_flops``); (c) DLRM at ``train_batch`` (B = 65,536) on
   ``capped_config(2**22)`` initialised on the card, ``CriteoPipeline``
   batches, AdamW, clip 1.0: step 1's loss and gradient norm with the
   plain lookups first, then 5 steps, kernel 7 launched exactly once a
   step and no other kernel, step 1 within ``TRAIN_DLRM_*`` of the plain
   lookups', the warm step's median time, samples/s, TFLOP/s
   (``train_flops``), peak memory, and 3 more steps split by CUDA events
   (forward, backward, clip, optimiser); (d) a gcn-cora GCN on a graph of
   Cora's shape and a DLRM at the MLPerf widths with 1,000-row tables:
   saved after 2 steps, restored with ``device="cuda"`` (every tensor
   bit-equal to the one saved), 2 more steps, against 4 uninterrupted
   steps: the GCN bit-equal, the DLRM within ``TRAIN_DLRM_*`` (the
   gradients' ``index_add_`` adds in no fixed order on the card).

The graphs carry the Graph500 SSSP weights (uniform on [2^-8, 1]); one
weighted layout per scale serves every phase (the BFS phases never read
the weights). The launch counts of each main path must be nonzero: the
four lane kernels over phases 4b and 5, the two packed kernels over phase
7b, the stored-weight SpMV over phase 8b, the stored-weight SpMM over
phases 9b and 9c, the GCN SpMM over phase 10b, each counted from zero;
kernels 1 (its sel-max, boolean and real modes), 2, 3, 4, 5 and 6 over
phase 12b; kernel 2 (its real mode under betweenness) over phase 13b;
kernels 3 and 5 over the card's streams of phase 14a, kernels 1, 2, 2w and
6 over the two passes of 14b; kernels 3 and 5 over phase 15a, kernels 1,
2, 2w and 6 over the four passes of 15b; kernels 1, 1w, 2, 2w, 3 and 6
over phase 16b's calls and those and 4 over 16c's, summed over the ranks
(each rank's counted from zero a call); kernels 1, 1w, 2, 2w, 3, 4, 5 and
6 over phase 17c's sanitized runs, 1, 1w and 2 over 17d's, and the probe
over 17a; kernel 4 over phase 5's pull
harness batch and kernel 2w over phase 8b's per-root harness; the
embedding bag over phase 11b, exactly once a forward; the GCN SpMM over
phase 18b, exactly four times a training step, and the embedding bag over
phase 18c, exactly once a training step.
The last lines are the kernel table, the card, and ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEMIRINGS = ("tropical", "real", "boolean", "selmax")
SCALE, EDGE_FACTOR, SMALL_SCALE = 20, 16, 14
# the whole run must end within 1200 s; phase 8b validates 64 SSSP trees
# only if that still ends by this mark, else the first 16; phase 9c the
# same by its own mark; both leave phases 10, 12, 13, 14, 15, 16, 17, 11
# and 18 their reserves
GCN_RESERVE_S = 60.0
DLRM_RESERVE_S = 90.0
GRAPH_RESERVE_S = 90.0
BC_RESERVE_S = 120.0
SERVE_RESERVE_S = 60.0
SESSION_RESERVE_S = 60.0
DIST_RESERVE_S = 120.0
ANALYSIS_RESERVE_S = 60.0
TRAIN_RESERVE_S = 60.0
VALIDATE_ALL_BY_S = 900.0 - GCN_RESERVE_S - DLRM_RESERVE_S \
    - GRAPH_RESERVE_S - BC_RESERVE_S - SERVE_RESERVE_S - SESSION_RESERVE_S \
    - DIST_RESERVE_S - ANALYSIS_RESERVE_S - TRAIN_RESERVE_S
VALIDATE_BATCH_BY_S = 1000.0 - GCN_RESERVE_S - DLRM_RESERVE_S \
    - GRAPH_RESERVE_S - BC_RESERVE_S - SERVE_RESERVE_S - SESSION_RESERVE_S \
    - DIST_RESERVE_S - ANALYSIS_RESERVE_S - TRAIN_RESERVE_S
# PageRank with the kernels against the same call with the plain sweeps
# (phase 12): kernel 1 adds a row in another order than the plain version,
# so the ranks are held to bounds fixed before the first card run
PR_RTOL, PR_ATOL = 1e-4, 1e-9  # ranks, per vertex
PR_L1 = 1e-5                   # L1 between the two runs
# sweeps one apart only where the plain run's residual at the shorter run's
# last sweep lies within PR_RESID_ULPS * sum_i ulp(r_i) of tol (in float64
# over the plain ranks), else the run fails: the residual is a float32 sum
# of n differences of ranks, each of which another order of adds moves by
# an ulp or two of its own rank (star(64): 1.77e-7; the looser 2 n ulp(max
# rank) it replaced, 3.8e-6 there and 1.221e-4 at scale 20, is printed
# beside it)
PR_RESID_ULPS = 2
PR_L1_F64 = 2e-5               # L1 to a float64 power iteration
# betweenness with the kernels against the same call on the plain path
# (phase 13): kernel 2 adds each row in its own fixed order, not the plain
# version's, so path counts past 2^24 and the scores are held to bounds
# fixed before the first card run; depths and sweep counts bit-equal
BC_SIGMA_EXACT = 2 ** 24       # path counts bit-equal below this
BC_SIGMA_RTOL = 1e-5           # path counts at or past it, relative
BC_RTOL, BC_ATOL_REL = 1e-4, 1e-6  # scores: rtol; atol x the largest score
# against a float64 Brandes: the tests' TOLERANCES["betweenness"], the
# atol taken relative to the largest score at scale 20
BC_F64_RTOL, BC_F64_ATOL = 2e-3, 1e-3
KERNEL_INFO = {
    "slimsell_spmv": ("src/repro_torch/kernels/csrc/slimsell_spmv.cu",
                      "src/repro/kernels/slimsell_spmv.py:66"),
    "slimsell_spmv_wts": ("src/repro_torch/kernels/csrc/slimsell_spmv.cu",
                          "src/repro/kernels/slimsell_spmv.py:66"),
    "slimsell_spmm": ("src/repro_torch/kernels/csrc/slimsell_spmm.cu",
                      "src/repro/kernels/slimsell_spmm.py:44"),
    "slimsell_spmm_wts": ("src/repro_torch/kernels/csrc/slimsell_spmm.cu",
                          "src/repro/kernels/slimsell_spmm.py:44"),
    "slimsell_spmm_gcn": ("src/repro_torch/kernels/csrc/slimsell_spmm.cu",
                          "src/repro/kernels/slimsell_spmm.py:44"),
    "slimsell_pull": ("src/repro_torch/kernels/csrc/slimsell_pull.cu",
                      "src/repro/kernels/slimsell_pull.py:53"),
    "slimsell_pull_mm": ("src/repro_torch/kernels/csrc/slimsell_pull_mm.cu",
                         "src/repro/kernels/slimsell_pull.py:155"),
    "slimsell_spmv_packed": (
        "src/repro_torch/kernels/csrc/slimsell_spmv_packed.cu",
        "src/repro/kernels/slimsell_packed.py:43"),
    "slimsell_spmm_packed": (
        "src/repro_torch/kernels/csrc/slimsell_spmm_packed.cu",
        "src/repro/kernels/slimsell_packed.py:134"),
    "embedding_bag_grouped": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                              "src/repro/kernels/embedding_bag.py:23"),
    # not a ported TPU kernel: the analysis layer's probe of the CUDA
    # semiring table, the counterpart of the JAX package's check of its
    # kernel-side table
    "semiring_probe": ("src/repro_torch/kernels/csrc/semiring_probe.cu",
                       "src/repro/kernels/slimsell_spmv.py:33"),
}
LANE_KERNELS = ("slimsell_spmv", "slimsell_spmm", "slimsell_pull",
                "slimsell_pull_mm")
PACKED_KERNELS = ("slimsell_spmv_packed", "slimsell_spmm_packed")
NF_KINDS = ("random", "all", "none")
# (V, d, B, K) of kernel 7's checks: the JAX package's sweep, then d = 16
# and 130 (the scalar path), B = 1 and 13 (not multiples of 8)
BAG_CASES = ((500, 128, 16, 1), (1000, 128, 32, 8), (200, 256, 8, 4),
             (64, 16, 13, 3), (50, 130, 1, 5), (300, 128, 13, 1))
SERVE_SHAPES = ("serve_p99", "serve_bulk")
# the parts of the layout the SpMM is timed over (profile_spmm.chunk_masks):
# is one block's walk over the longest chunk back on the critical path,
# and the floor of a sweep that keeps no tile
SPLIT_PARTS = ("heaviest chunk", "all but the heaviest", "none")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def frontier(sr, shape, rng, device) -> torch.Tensor:
    """Integer-valued sweep operands: sums and minima stay exact."""
    if sr.name == "boolean":
        x = rng.integers(0, 2, size=shape).astype(np.int32)
    else:
        x = rng.integers(0, 4, size=shape).astype(np.float32)
        if sr.name == "tropical":
            x[rng.random(shape) < 0.5] = np.inf
        if sr.name == "selmax":
            x *= rng.integers(1, 1000, size=shape)
    return torch.from_numpy(x).to(device)


def not_final(kind, shape, rng, device) -> torch.Tensor:
    if kind == "random":
        return torch.from_numpy(rng.random(shape) < 0.6).to(device)
    return torch.full(shape, kind == "all", dtype=torch.bool, device=device)


def masks(tiled, rng, device) -> dict:
    T = tiled.n_tiles
    keep_chunk = torch.from_numpy(rng.random(tiled.n_chunks) < 0.6).to(device)
    random = torch.from_numpy(rng.random(T) < 0.5).to(device) \
        & keep_chunk[tiled.row_block.long()]
    return {"none_given": None,
            "all_kept": torch.ones(T, dtype=torch.bool, device=device),
            "none_kept": torch.zeros(T, dtype=torch.bool, device=device),
            "random": random}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    same = a == b  # equal infinities count as no error
    diff = (a.double() - b.double()).abs()
    return float(torch.where(same, 0.0, diff).max()) if a.numel() else 0.0


def sssp_frontier(shape, finite, rng, device) -> torch.Tensor:
    """Float32 distances on a ``finite`` share of the vertices (of each
    column for an [n, B] shape), +inf on the rest."""
    x = rng.uniform(0.0, 8.0, shape).astype(np.float32)
    x[rng.random(shape) >= finite] = np.inf
    return torch.from_numpy(x).to(device)


def hmean(x) -> float:
    return float(1.0 / np.mean(1.0 / np.asarray(x)))


@contextlib.contextmanager
def plain_sweeps(engine, spmv_plain, spmm_plain, pull_plain, pull_mm_plain):
    """Route the engine's sweeps to the plain versions: the reference run."""
    names = ("slimsell_spmv", "slimsell_spmm", "slimsell_pull",
             "slimsell_pull_mm")
    saved = [getattr(engine, n) for n in names]
    engine.slimsell_spmv = lambda sr, t, x, *, tile_mask=None: spmv_plain(sr, t, x, tile_mask)
    engine.slimsell_spmm = lambda sr, t, x, *, tile_mask=None: spmm_plain(sr, t, x, tile_mask)
    engine.slimsell_pull = lambda sr, t, x, *, row_mask, tile_mask=None: \
        pull_plain(sr, t, x, row_mask, tile_mask)
    engine.slimsell_pull_mm = lambda sr, t, x, *, row_mask, tile_mask=None: \
        pull_mm_plain(sr, t, x, row_mask, tile_mask)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(engine, n, fn)


def check_equal(kern, got, want, errs, what):
    errs[kern] = max(errs[kern], max_abs_err(got, want))
    if not torch.equal(got, want):
        raise AssertionError(f"{kern} != plain: {what}")


def check_close(kern, got, want, errs, what, tol):
    """Float sums in another order: within rtol = atol = ``tol``, no NaN."""
    if torch.isnan(got).any() or torch.isnan(want).any():
        raise AssertionError(f"{kern}: NaN: {what}")
    err = max_abs_err(got, want)
    if errs is not None:
        errs[kern] = max(errs[kern], err)
    if not torch.allclose(got.double(), want.double(), rtol=tol, atol=tol):
        raise AssertionError(f"{kern}: not within {tol} of the reference: "
                             f"{what}; max abs err {err}")


def gcn_batch(csr, feat: torch.Tensor, tiled, device) -> dict:
    """A GCN batch of a graph: features, edge list, degrees, layout."""
    src = np.repeat(np.arange(csr.n, dtype=np.int32), np.diff(csr.indptr))
    edge_index = np.stack([src, csr.indices.astype(np.int32)])
    return {"node_feat": feat.to(device),
            "edge_index": torch.from_numpy(edge_index).to(device),
            "deg": torch.from_numpy(csr.deg.astype(np.int32)).to(device),
            "tiled": tiled}


@contextlib.contextmanager
def plain_lookups(dlrm, embedding_bag_grouped_ref):
    """Route DLRM's lookups to the plain embedding bag: the reference run."""
    saved = dlrm._lookup_all
    dlrm._lookup_all = lambda tables, sparse, out=None: \
        embedding_bag_grouped_ref(tables, sparse, "sum", out)
    try:
        yield
    finally:
        dlrm._lookup_all = saved


def bag_ids(V, shape, pad_share, rng) -> np.ndarray:
    """int32 ids on 0..V-1, a ``pad_share`` of them -1."""
    ids = rng.integers(0, V, size=shape).astype(np.int32)
    ids[rng.random(shape) < pad_share] = -1
    return ids


def library_bags(ids: np.ndarray, device):
    """The 1-D ids and offsets ``F.embedding_bag`` takes for bags [B, K]."""
    keep = ids >= 0
    offsets = np.concatenate([[0], np.cumsum(keep.sum(axis=1))[:-1]])
    return (torch.from_numpy(ids[keep].astype(np.int64)).to(device),
            torch.from_numpy(offsets.astype(np.int64)).to(device))


def bag_rows(sets) -> float:
    """The distinct rows that bag sets [B, K] of one table name (pads
    aside), on average over the sets: the rows a lookup must read."""
    return sum(np.unique(s_[s_ >= 0]).size for s_ in sets) / len(sets)


def check_equal_nan(kern, got, want, errs, what):
    """Bit-equal where the reference is a number, NaN where it is NaN."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{kern}: NaN elsewhere than plain: {what}")
    check_equal(kern, got[~nan], want[~nan], errs, what)


def split_line(split: dict) -> str:
    """``profile_spmm.chunk_split``'s times on one line."""
    return ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()
                     if k != "layout") + f" | {split['layout']}"


def canonical_labels(csr):
    """scipy's connected components, each labelled by its largest vertex
    id (the port's canonical labels), and their count."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    A = csr_matrix((np.ones(csr.nnz, np.int8), csr.indices, csr.indptr),
                   shape=(csr.n, csr.n))
    count, lab = connected_components(A, directed=False)
    top = np.zeros(count, np.int64)
    np.maximum.at(top, lab, np.arange(csr.n))
    return top[lab].astype(np.int32), count


def pagerank_f64(csr, damping: float, tol: float = 1e-12) -> np.ndarray:
    """float64 power iteration on the host with the port's dangling rule
    (a degree-0 vertex's rank spread uniformly), to an L1 residual of
    ``tol``."""
    from scipy.sparse import csr_matrix
    n = csr.n
    A = csr_matrix((np.ones(csr.nnz), csr.indices, csr.indptr), shape=(n, n))
    deg = csr.deg.astype(np.float64)
    dangling = deg == 0
    inv_deg = np.where(dangling, 0.0, 1.0 / np.maximum(deg, 1.0))
    r = np.full(n, 1.0 / n)
    for _ in range(100_000):
        r_new = (1.0 - damping) / n + damping * (
            A @ (r * inv_deg) + r[dangling].sum() / n)
        resid = np.abs(r_new - r).sum()
        r = r_new
        if resid <= tol:
            return r
    raise AssertionError("the float64 PageRank did not converge")


def pagerank_resid_bound(ref) -> float:
    """``PR_RESID_ULPS * sum_i ulp(r_i)`` of a PageRank result, summed in
    float64 over its float32 ranks: how far its float32 residual, a sum of
    n differences of ranks each of which another order of adds moves by an
    ulp or two of its own rank, may move."""
    ranks = np.abs(np.asarray(ref.ranks, dtype=np.float32))
    return PR_RESID_ULPS * float(np.spacing(ranks).astype(np.float64).sum())


def pagerank_resid_bound_max(ref) -> float:
    """The looser bound the sweep rule used before,
    ``PR_RESID_ULPS * n * ulp(max rank)``, printed beside the one it
    uses."""
    return PR_RESID_ULPS * ref.ranks.size * float(
        np.spacing(np.float32(ref.ranks.max())))


def pagerank_gap(got, ref, tol: float) -> float:
    """How far the plain run's residual at the shorter run's last sweep
    lies from ``tol``."""
    k = min(got.iterations, ref.iterations)
    return abs(float(ref.residuals[k - 1]) - tol)


def pagerank_close(got, ref, tol: float, what: str):
    """PageRank with the kernels (``got``) against the same call with the
    plain sweeps (``ref``), within the bounds fixed before the first card
    run: ranks per vertex within ``PR_RTOL``, ``PR_ATOL`` and L1 at most
    ``PR_L1``; sweeps equal, or one apart where the plain run's residual at
    the shorter run's last sweep lies within ``pagerank_resid_bound(ref)``
    of ``tol`` (the residual could then land on either side of ``tol``).
    Anything else raises, two or more sweeps apart always. Returns the L1
    and, for sweeps one apart that the bound admits, a line saying so (else
    None)."""
    l1 = float(np.abs(got.ranks.astype(np.float64) - ref.ranks).sum())
    if not np.allclose(got.ranks, ref.ranks, rtol=PR_RTOL, atol=PR_ATOL) \
            or l1 > PR_L1:
        raise AssertionError(f"pagerank {what}: ranks not within the bounds "
                             f"of the plain run (L1 {l1:.3e})")
    if got.iterations == ref.iterations:
        return l1, None
    k = min(got.iterations, ref.iterations)
    gap = pagerank_gap(got, ref, tol)
    bound = pagerank_resid_bound(ref)
    said = (f"{got.iterations} sweeps, plain {ref.iterations}; the plain "
            f"residual at sweep {k} {float(ref.residuals[k - 1])!r} is "
            f"{gap:.3e} from tol, bound {bound:.3e} (2 n ulp(max rank): "
            f"{pagerank_resid_bound_max(ref):.3e})")
    if abs(got.iterations - ref.iterations) > 1 or gap > bound:
        raise AssertionError(f"pagerank {what}: {said}")
    return l1, f"{what}: {said}"


def same_fields(a, b, fields, what: str) -> None:
    for f in fields:
        if not np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))):
            raise AssertionError(f"{what}: {f} differs")


def median_run(fn, reps: int = 3):
    """``reps`` warm calls of ``fn`` (the kernels built, the layout's work
    lists made in phase 4), each timed by the host clock around a
    synchronised call: the results and the median seconds."""
    out, secs = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(fn())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, float(np.median(secs)), secs


def graph_workloads(*, dev, card, csr, tiled, root, lane_boolean, roots,
                    push, small_csr, small_cpu, small, root0, adj, full,
                    layout_bytes, errs, table):
    """Phase 12: connected components, k-hop and PageRank through the
    ported sweeps. (a) small graphs, the card against the CPU's plain
    path; (b) scale 20, checked against scipy, the phase-4b and phase-5
    results and the plain sweeps on the card, timed, the launches counted
    from zero; (c) kernel 1 at the PageRank and CC payloads. Returns the
    phase's main-path launch counts and the scale-20 results phase 14 is
    held to: fused sel-max CC, fused PageRank and lane push ``khop_many``
    at k = 2."""
    from repro_torch.core import engine, semiring
    from repro_torch.core.cc import cc
    from repro_torch.core.formats import build_csr, build_slimsell
    from repro_torch.core.khop import khop, khop_many
    from repro_torch.core.options import EngineConfig
    from repro_torch.core.pagerank import (pagerank, pagerank_spec,
                                           pagerank_views)
    from repro_torch.core.spmv import (pull_mm_plain, pull_plain, spmm_plain,
                                       spmv_plain)
    from repro_torch.graphs.generators import (erdos_renyi, star,
                                               two_components)
    from repro_torch.kernels import ops
    from repro_torch.profile_spmm import time_ms

    plain = (spmv_plain, spmm_plain, pull_plain, pull_mm_plain)
    damping, tol = 0.85, 1e-6
    cc_fields = ("labels", "n_components", "iterations", "work_log")
    khop_fields = ("mask", "distances", "iterations")
    pr_fields = ("ranks", "iterations", "residuals", "converged")
    modes = ("fused", "hostloop")
    # (semiring, packed, direction) of the CC runs: the peeling BFSes lane
    # in the three directions and packed (push only)
    cc_kinds = [("selmax", False, "push")] + [
        ("boolean", False, d) for d in ("push", "pull", "auto")] + [
        ("boolean", True, "push")]

    # (a) the scale-14 graph and the CC families of the JAX package's tests
    path = np.stack([np.arange(95), np.arange(1, 96)], axis=1)
    graphs = {f"kronecker({SMALL_SCALE})": (small_csr, small_cpu, small)}
    for name, g in (("star(64)", star(64)), ("path(96)", build_csr(path, 96)),
                    ("two_components(7, 8)", two_components(7, 8, seed=0)),
                    ("erdos_renyi(512, 1.5)", erdos_renyi(512, 1.5, seed=2)),
                    ("edgeless(37)",
                     build_csr(np.empty((0, 2), np.int64), 37))):
        host = build_slimsell(g, C=8, L=32)
        graphs[name] = (g, host.to_torch("cpu"), host.to_torch(dev))
    n_runs, pr_l1, pr_one_apart = 0, 0.0, []
    for gname, (g, gcpu, gdev) in graphs.items():
        want_labels, want_count = canonical_labels(g)
        for (sr_name, packed, direction), mode in itertools.product(
                cc_kinds, modes):
            kw = dict(semiring=sr_name, packed=packed, log_work=True,
                      config=EngineConfig(direction=direction, mode=mode))
            ref = cc(gcpu, device="cpu", **kw)
            got = cc(gdev, device=dev, **kw)
            what = f"cc {sr_name} packed={packed} {direction} {mode} on {gname}"
            same_fields(ref, got, cc_fields, f"{what}, card vs CPU")
            if not (np.array_equal(got.labels, want_labels)
                    and got.n_components == want_count):
                raise AssertionError(f"{what}: labels != scipy's")
            n_runs += 1
        kroot = root0 if g is small_csr else int(np.argmax(g.deg))
        many = np.random.default_rng(12).choice(g.n, min(12, g.n),
                                                replace=False)
        for packed in (False, True):
            for k in (0, 1, 2, 3, None):
                ref = khop(gcpu, kroot, k, packed=packed, device="cpu")
                got = khop(gdev, kroot, k, packed=packed, device=dev)
                same_fields(ref, got, khop_fields, f"khop k={k} packed="
                            f"{packed} on {gname}, card vs CPU")
                n_runs += 1
            ref = khop_many(gcpu, many, 2, packed=packed, device="cpu")
            got = khop_many(gdev, many, 2, packed=packed, device=dev)
            same_fields(ref, got, khop_fields, f"khop_many k=2 packed="
                        f"{packed} on {gname}, card vs CPU")
            n_runs += 1
        for mode in modes:
            cfg = EngineConfig(mode=mode)
            ref = pagerank(gcpu, damping=damping, tol=tol, config=cfg,
                           device="cpu")
            got = pagerank(gdev, damping=damping, tol=tol, config=cfg,
                           device=dev)
            l1, one_apart = pagerank_close(got, ref, tol,
                                           f"{mode} on {gname}")
            pr_l1 = max(pr_l1, l1)
            pr_one_apart += [one_apart] if one_apart else []
            n_runs += 1
    log(f"[12a] card == CPU on {len(graphs)} graphs ({', '.join(graphs)}), "
        f"{n_runs} runs: cc selmax and boolean (lane push / pull / auto, "
        f"packed push), fused and hostloop, labels == scipy's (labels, "
        f"n_components, iterations, work_log equal); khop k=0/1/2/3/None and "
        f"khop_many k=2 over 12 roots, lane and packed (mask, distances, "
        f"iterations equal); pagerank fused and hostloop within the bounds "
        f"(largest L1 {pr_l1:.3e}); sweeps one apart within the residual "
        f"bound: {pr_one_apart or 'none'}")

    # (b) scale 20, the launches counted from zero
    n = tiled.n
    ops.reset_launches()
    counts = {}

    def spmv_launches(fn):
        """``fn()`` and the launches of kernel 1 it made."""
        before = ops.launch_counts()["slimsell_spmv"]
        out = fn()
        return out, ops.launch_counts()["slimsell_spmv"] - before

    t0 = time.perf_counter()
    want_labels, want_count = canonical_labels(csr)
    scipy_s = time.perf_counter() - t0
    n_isolated = int((csr.deg == 0).sum())
    selmax = {}
    for mode in modes:
        cfg = EngineConfig(mode=mode)
        (runs, med, secs), k1 = spmv_launches(lambda: median_run(
            lambda: cc(tiled, log_work=True, config=cfg, device=dev)))
        res = runs[0]
        for r in runs[1:]:
            same_fields(res, r, cc_fields, f"cc selmax {mode}, repeated")
        if not (np.array_equal(res.labels, want_labels)
                and res.n_components == want_count):
            raise AssertionError(f"cc selmax {mode} at scale {SCALE}: labels "
                                 "!= scipy's")
        selmax[mode] = res
        counts[f"cc selmax {mode}"] = k1
        log(f"[12b] cc selmax {mode}: {res.n_components} components "
            f"({n_isolated} isolated), sweeps={res.iterations} tiles per "
            f"sweep={res.work_log.tolist()} median {med * 1e3:.1f} ms of "
            f"{[round(s * 1e3, 1) for s in secs]}; slimsell_spmv launches "
            f"{k1} on {card}")
    same_fields(selmax["fused"], selmax["hostloop"], cc_fields,
                "cc selmax fused vs hostloop")
    log(f"[12b] cc selmax: labels == scipy's canonical labels (scipy "
        f"{scipy_s:.1f} s), count equal; fused == hostloop (labels, "
        f"iterations, work_log)")
    for packed, direction in ((False, "push"), (False, "auto"),
                              (True, "push")):
        cfg = EngineConfig(direction=direction)
        (runs, med, secs), k1 = spmv_launches(lambda: median_run(
            lambda: cc(tiled, semiring="boolean", packed=packed, config=cfg,
                       device=dev)))
        res = runs[0]
        if not all(np.array_equal(r.labels, selmax["fused"].labels)
                   for r in runs):
            raise AssertionError(f"cc boolean packed={packed} {direction}: "
                                 "labels != selmax's")
        kind = f"cc boolean {'packed' if packed else 'lane'} {direction}"
        counts[kind] = k1
        log(f"[12b] {kind}: labels == selmax's, {res.n_components - n_isolated}"
            f" BFSes (isolated vertices labelled up front), {res.iterations} "
            f"BFS iterations, median {med * 1e3:.1f} ms of "
            f"{[round(s * 1e3, 1) for s in secs]}; slimsell_spmv launches {k1}"
            f" on {card}")
    d_root = lane_boolean.distances  # phase 4b's boolean push BFS, validated
    for k in (1, 2, 3, None):
        res = khop(tiled, root, k, device=dev)
        cap = n if k is None else k
        want = np.where((d_root >= 0) & (d_root <= cap), d_root, -1)
        if not np.array_equal(res.distances, want):
            raise AssertionError(f"khop k={k} from {root} != phase 4b's "
                                 "distances clipped at k")
    log(f"[12b] khop from root {root} at k=1/2/3/None == phase 4b's boolean "
        f"BFS distances clipped at k (count at k=2: "
        f"{int(((d_root >= 0) & (d_root <= 2)).sum())})")
    want2 = np.where((push.distances >= 0) & (push.distances <= 2),
                     push.distances, -1)
    for packed, direction in ((False, "push"), (True, "push"),
                              (False, "auto"), (False, "pull")):
        before = ops.launch_counts()
        (runs, med, secs) = median_run(lambda: khop_many(
            tiled, roots, 2, packed=packed,
            config=EngineConfig(direction=direction), device=dev))
        for r in runs:
            if not np.array_equal(r.distances, want2):
                raise AssertionError(f"khop_many packed={packed} {direction}"
                                     " != the phase-5 push batch clipped at 2")
        kind = f"khop_many {'packed' if packed else 'lane'} {direction}"
        counts[kind] = {k: v - before[k] for k, v in ops.launch_counts().items()
                        if v != before[k]}
        if kind == "khop_many lane push":
            khop_push = runs[0]
        log(f"[12b] {kind} k=2 over the 64 phase-5 roots: == the push batch's "
            f"distances clipped at 2; median {med * 1e3:.1f} ms of "
            f"{[round(s * 1e3, 1) for s in secs]}; launches {counts[kind]} on "
            f"{card}")
    t0 = time.perf_counter()
    ref64 = pagerank_f64(csr, damping)
    f64_s = time.perf_counter() - t0
    pr = {}
    for mode in modes:
        cfg = EngineConfig(mode=mode)
        (runs, med, secs), k1 = spmv_launches(lambda: median_run(
            lambda: pagerank(tiled, damping=damping, tol=tol, config=cfg,
                             device=dev)))
        res = runs[0]
        for r in runs[1:]:
            same_fields(res, r, pr_fields, f"pagerank {mode}, three runs")
        with plain_sweeps(engine, *plain):
            ref = pagerank(tiled, damping=damping, tol=tol, config=cfg,
                           device=dev)
        l1, one_apart = pagerank_close(res, ref, tol,
                                       f"{mode} at scale {SCALE}")
        pr_one_apart += [one_apart] if one_apart else []
        l1_64 = float(np.abs(res.ranks - ref64).sum())
        mass = float(res.ranks.astype(np.float64).sum())
        if not (res.converged and l1_64 <= PR_L1_F64
                and abs(mass - 1.0) <= 1e-5):
            raise AssertionError(f"pagerank {mode} at scale {SCALE}: "
                                 f"converged={res.converged}, L1 to float64 "
                                 f"{l1_64:.3e}, mass {mass!r}")
        pr[mode] = res
        counts[f"pagerank {mode}"] = k1
        log(f"[12b] pagerank {mode} (a={damping}, tol={tol}): "
            f"sweeps={res.iterations} (plain sweeps {ref.iterations}) "
            f"residuals={[float(f'{x:.4g}') for x in res.residuals]}; median "
            f"{med * 1e3:.1f} ms of {[round(s * 1e3, 1) for s in secs]}, "
            f"{med * 1e3 / res.iterations:.2f} ms a sweep; three runs "
            f"bit-equal; L1 to the plain sweeps {l1:.3e}, to float64 "
            f"{l1_64:.3e} (bound {PR_L1_F64}); sweeps one apart: "
            f"{one_apart}; the plain residual at sweep "
            f"{min(res.iterations, ref.iterations)} "
            f"{pagerank_gap(res, ref, tol):.3e} from tol, residual bound "
            f"2 sum ulp(r_i) {pagerank_resid_bound(ref):.3e}, 2 n ulp(max "
            f"rank) {pagerank_resid_bound_max(ref):.3e}; "
            f"mass - 1 = {mass - 1.0:.3e}; "
            f"slimsell_spmv launches {k1} on {card}")
    same_fields(pr["fused"], pr["hostloop"], pr_fields,
                "pagerank fused vs hostloop")
    main_path = ops.launch_counts()
    log(f"[12b] pagerank fused == hostloop bit for bit; float64 reference "
        f"{f64_s:.1f} s. Main-path launches of phase 12b: "
        f"{ {k: v for k, v in main_path.items() if v} }; kernel 1 by run: "
        f"{ {k: v for k, v in counts.items() if not isinstance(v, dict)} }")
    needed = ("slimsell_spmv", "slimsell_spmm", "slimsell_pull",
              "slimsell_spmv_packed", "slimsell_spmm_packed")
    if min(main_path[k] for k in needed) == 0 or min(
            counts[k] for k in ("cc selmax fused", "cc boolean lane push",
                                "pagerank fused")) == 0 \
            or "slimsell_spmm_packed" not in counts["khop_many packed push"] \
            or "slimsell_pull_mm" not in counts["khop_many lane pull"]:
        raise AssertionError(f"a kernel never ran on phase 12's path: "
                             f"{main_path}, {counts}")

    # (c) kernel 1 at the new payloads, every tile kept
    real, selmax_sr = semiring.get("real"), semiring.get("selmax")
    spec = pagerank_spec(n, damping, tol, *pagerank_views(tiled.deg))
    xr = spec.frontier(engine.run_fused(spec, tiled, 0, max_iters=1).state, 2)
    got = ops.spmv(real, tiled, xr, tile_mask=full)
    want = spmv_plain(real, tiled, xr, full)
    err = max_abs_err(got, want)
    errs["slimsell_spmv"] = max(errs["slimsell_spmv"], err)
    if not torch.allclose(got, want, rtol=PR_RTOL, atol=PR_ATOL) \
            or not all(torch.equal(got, ops.spmv(real, tiled, xr,
                                                 tile_mask=full))
                       for _ in range(2)):
        raise AssertionError("kernel 1 real at PageRank's second sweep: not "
                             "within the bounds of plain, or not repeatable")
    ms = time_ms(lambda: ops.spmv(real, tiled, xr, tile_mask=full), 20)
    plain_ms = time_ms(lambda: spmv_plain(real, tiled, xr, full), 3)
    library_ms = time_ms(lambda: adj @ xr, 20)
    lib_err = max_abs_err(got, adj @ xr)
    edges = int((tiled.cols >= 0).sum())
    moved = layout_bytes + 2 * 4 * n
    bound_ms = 1e3 * max(moved / HBM_BYTES_PER_S, 2 * edges / F32_OPS_PER_S)
    payloads = {"pagerank_real": {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "max_abs_err": err,
        "max_abs_err_vs_library": lib_err,
        "library_call": "sparse CSR @ x (real; the same function)",
        "pagerank_sweeps_one_apart": len(pr_one_apart)}}
    log(f"[12c] slimsell_spmv real at PageRank's second sweep (x = r/deg), "
        f"every tile kept: kernel {ms:.4f} ms plain {plain_ms:.3f} ms adj @ x "
        f"(the same function) {library_ms:.4f} ms bound {bound_ms:.4f} ms "
        f"({moved / 1e9:.4f} GB); max abs err vs plain {err:.3e}, vs adj @ x "
        f"{lib_err:.3e}, three calls bit-equal on {card}")
    xs = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    got = ops.spmv(selmax_sr, tiled, xs, tile_mask=full)
    check_equal("slimsell_spmv", got, spmv_plain(selmax_sr, tiled, xs, full),
                errs, f"scale {SCALE} selmax, every label")
    ms = time_ms(lambda: ops.spmv(selmax_sr, tiled, xs, tile_mask=full), 20)
    plain_ms = time_ms(lambda: spmv_plain(selmax_sr, tiled, xs, full), 3)
    # the phase-6 operand: integers times 1..999 (random sel-max payloads)
    x6 = frontier(selmax_sr, (n,), np.random.default_rng(6), dev)
    ms6 = time_ms(lambda: ops.spmv(selmax_sr, tiled, x6, tile_mask=full), 20)
    payloads["cc_selmax"] = {"ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "max_abs_err": 0.0,
                             "phase6_operand_ms": ms6, "library_ms": None}
    log(f"[12c] slimsell_spmv selmax at CC's first sweep (x = every label), "
        f"every tile kept: kernel {ms:.4f} ms == plain ({plain_ms:.3f} ms); "
        f"the phase-6 sel-max operand in the same call {ms6:.4f} ms; bound "
        f"{bound_ms:.4f} ms on {card}")
    for r in table:
        if r["name"] == "slimsell_spmv":
            r["payloads"] = payloads
            r["max_abs_err"] = errs["slimsell_spmv"]  # with 12c's real sums
        if r["name"] in main_path:
            r["phase12_launches"] = main_path[r["name"]]
    return main_path, {"cc": selmax["fused"], "pagerank": pr["fused"],
                       "khop_many": khop_push}


def brandes_f64(csr, roots, d=None):
    """float64 Brandes on the host from each of ``roots`` (one column
    each), level by level with scipy CSR products: ``(d, sigma, delta)``,
    each [n, k]. ``d``, the roots' BFS depths (-1 unreached), is found by
    the same products unless given."""
    from scipy.sparse import csr_matrix
    n, k = csr.n, len(roots)
    A = csr_matrix((np.ones(csr.nnz), csr.indices, csr.indptr), shape=(n, n))
    cols = np.arange(k)
    if d is None:
        d = np.full((n, k), -1, np.int64)
        d[roots, cols] = 0
        level = 0
        while True:
            new = ((A @ (d == level).astype(np.float64)) > 0) & (d < 0)
            if not new.any():
                break
            level += 1
            d[new] = level
    sigma = np.zeros((n, k))
    sigma[roots, cols] = 1.0
    depth = int(d.max())
    for level in range(1, depth + 1):
        y = A @ np.where(d == level - 1, sigma, 0.0)
        sigma = np.where(d == level, y, sigma)
    delta = np.zeros((n, k))
    for level in range(depth, 0, -1):
        on = d == level
        y = A @ np.where(on, (1.0 + delta) / np.where(on, sigma, 1.0), 0.0)
        delta += np.where(d == level - 1, sigma * y, 0.0)
    return d, sigma, delta


def bc_from_delta(delta: np.ndarray, roots) -> np.ndarray:
    """Unnormalised BC over ``roots`` from their dependency columns: each
    source's own row left out, the sum halved (undirected pairs)."""
    delta = np.array(delta, np.float64)
    delta[np.asarray(roots), np.arange(len(roots))] = 0.0
    return delta.sum(axis=1) / 2.0


@contextlib.contextmanager
def brandes_probe(engine, bc_module):
    """Observe ``betweenness`` calls: each forward run's ``(d, sigma,
    sweeps)`` and each backward run's ``(delta, sweeps)`` (the tensors, no
    copy), CUDA events around each SpMM the engine calls, and the host
    clock around each host fold."""
    probe = {"forward": [], "backward": [], "spmm": [], "fold_s": 0.0}
    saved = (engine.run_fused, engine.run_hostloop, engine.slimsell_spmm,
             bc_module.brandes_accumulate)

    def watch(run):
        def watched(spec, tiled, arg, **kw):
            res = run(spec, tiled, arg, **kw)
            if spec.name == "betweenness/forward":
                probe["forward"].append((res.state["d"], res.state["sigma"],
                                         res.iterations))
            elif spec.name == "betweenness/backward":
                probe["backward"].append((res.state["delta"], res.iterations))
            return res
        return watched

    def spmm(*args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        y = saved[2](*args, **kw)
        end.record()
        probe["spmm"].append((start, end))
        return y

    def fold(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved[3](*args, **kw)
        probe["fold_s"] += time.perf_counter() - t0
        return out

    engine.run_fused, engine.run_hostloop = watch(saved[0]), watch(saved[1])
    engine.slimsell_spmm, bc_module.brandes_accumulate = spmm, fold
    try:
        yield probe
    finally:
        (engine.run_fused, engine.run_hostloop, engine.slimsell_spmm,
         bc_module.brandes_accumulate) = saved


def bc_close(got, ref, what: str) -> dict:
    """Betweenness with the kernels against the same call on the plain
    path, each a ``(result, probe)``, within the bounds fixed before the
    first card run: sweeps and depths equal; path counts bit-equal where
    the plain count is below ``BC_SIGMA_EXACT`` (every partial sum of it
    then was too, and float32 adds such whole numbers exactly in any
    order), within ``BC_SIGMA_RTOL`` at or above it; scores within
    ``BC_RTOL`` and ``BC_ATOL_REL`` x the plain run's largest. Raises
    otherwise; returns the largest errors."""
    (res, probe), (res0, probe0) = got, ref
    if res.iterations != res0.iterations \
            or len(probe["forward"]) != len(probe0["forward"]):
        raise AssertionError(f"betweenness {what}: {res.iterations} sweeps, "
                             f"plain {res0.iterations}")
    sigma_err = 0.0
    for b, ((d, s, it), (d0, s0, it0)) in enumerate(
            zip(probe["forward"], probe0["forward"])):
        d0, s0 = d0.to(d.device), s0.to(s.device)
        exact = s0 < BC_SIGMA_EXACT
        if it != it0 or not torch.equal(d, d0) \
                or not torch.equal(s[exact], s0[exact]):
            raise AssertionError(f"betweenness {what}, batch {b}: forward "
                                 f"sweeps {it} (plain {it0}), depths or path "
                                 f"counts below 2^24 differ")
        if not bool(exact.all()):
            rel = ((s - s0).abs() / s0)[~exact]
            sigma_err = max(sigma_err, float(rel.max()))
    top = float(res0.scores.max())
    score_err = float(np.abs(res.scores - res0.scores).max())
    if sigma_err > BC_SIGMA_RTOL or not np.allclose(
            res.scores, res0.scores, rtol=BC_RTOL, atol=BC_ATOL_REL * top):
        raise AssertionError(f"betweenness {what}: path counts past 2^24 "
                             f"{sigma_err:.3e} apart (bound {BC_SIGMA_RTOL}) "
                             f"or scores {score_err:.3e} apart (largest "
                             f"{top:.6e})")
    return {"sigma_rel_err": sigma_err, "score_abs_err": score_err,
            "score_rel_to_max": score_err / top if top else 0.0}


def bc_f64_close(scores, ref, atol: float, what: str) -> float:
    """Scores within ``BC_F64_RTOL`` and ``atol`` of a float64 Brandes;
    returns the largest error over the largest reference score."""
    if not np.allclose(scores, ref, rtol=BC_F64_RTOL, atol=atol):
        raise AssertionError(f"betweenness {what}: not within the bounds of "
                             f"the float64 Brandes (max abs err "
                             f"{np.abs(scores - ref).max():.3e})")
    top = float(np.abs(ref).max())
    return float(np.abs(scores - ref).max()) / top if top else 0.0


def betweenness_phase(*, dev, card, csr, tiled, roots, push, small_csr,
                      small_cpu, small, table):
    """Phase 13: Brandes betweenness through kernel 2's real mode. (a)
    small graphs, exact BC (and 16 sampled sources on the scale-14 graph),
    the card against the CPU's plain path and a float64 Brandes; (b)
    scale 20, the 64 phase-5 roots in one batch, fused (warm, median of 3)
    and hostloop, against the plain sweeps on the card and, for 8 roots, a
    float64 Brandes over phase 5's depths; kernel 2's launches counted from
    zero. Returns them."""
    from repro_torch.core import betweenness as bc_module
    from repro_torch.core import engine
    from repro_torch.core.formats import build_csr, build_slimsell
    from repro_torch.core.options import EngineConfig
    from repro_torch.core.spmv import (pull_mm_plain, pull_plain, spmm_plain,
                                       spmv_plain)
    from repro_torch.graphs.generators import (erdos_renyi, star,
                                               two_components)
    from repro_torch.kernels import ops

    betweenness = bc_module.betweenness
    plain = (spmv_plain, spmm_plain, pull_plain, pull_mm_plain)

    def call(fn):
        with brandes_probe(engine, bc_module) as probe:
            res = fn()
        return res, probe

    # (a) small graphs: all sources, and 16 sampled on the scale-14 graph
    t0 = time.perf_counter()
    path = np.stack([np.arange(95), np.arange(1, 96)], axis=1)
    graphs = {}
    for name, g in (("star(64)", star(64)), ("path(96)", build_csr(path, 96)),
                    ("two_components(7, 8)", two_components(7, 8, seed=0)),
                    ("erdos_renyi(512, 1.5)", erdos_renyi(512, 1.5, seed=2))):
        host = build_slimsell(g, C=8, L=32)
        graphs[name] = (g, None, host.to_torch("cpu"), host.to_torch(dev))
    sampled = np.sort(np.random.default_rng(13).choice(
        small_csr.n, 16, replace=False))
    graphs[f"kronecker({SMALL_SCALE})"] = (small_csr, sampled, small_cpu,
                                          small)
    n_runs, worst, largest = 0, {}, 0.0
    for gname, (g, src, gcpu, gdev) in graphs.items():
        srcs = np.arange(g.n) if src is None else src
        ref64 = bc_from_delta(brandes_f64(g, srcs)[2], srcs)
        for mode, slimwork, batch_size in itertools.product(
                ("fused", "hostloop"), (True, False), (None, 5)):
            kw = dict(sources=src, batch_size=batch_size, slimwork=slimwork,
                      config=EngineConfig(mode=mode))
            what = (f"{mode} slimwork={slimwork} batch={batch_size} on "
                    f"{gname}")
            ref = call(lambda: betweenness(gcpu, device="cpu", **kw))
            got = call(lambda: betweenness(gdev, device=dev, **kw))
            errs = bc_close(got, ref, f"{what}, card vs CPU")
            bc_f64_close(got[0].scores, ref64, BC_F64_ATOL, what)
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
            largest = max(largest, max(float(s_.max())
                                       for _, s_, _ in got[1]["forward"]))
            n_runs += 1
    log(f"[13a] betweenness card == CPU on {len(graphs)} graphs "
        f"({', '.join(graphs)}; all sources, 16 sampled on the scale-"
        f"{SMALL_SCALE} graph), {n_runs} runs (fused and hostloop x SlimWork "
        f"on and off x batch None and 5): sweeps, depths and path counts "
        f"equal (largest count {largest:.0f}), scores within "
        f"rtol {BC_RTOL} atol {BC_ATOL_REL} x max (largest errors {worst}); "
        f"every run within rtol {BC_F64_RTOL} atol {BC_F64_ATOL} of a "
        f"float64 Brandes, in {time.perf_counter() - t0:.1f} s")

    # (b) scale 20: the 64 phase-5 roots in one batch of 64
    ops.reset_launches()
    B = roots.size
    runs, med, secs = median_run(lambda: call(lambda: betweenness(
        tiled, roots, batch_size=B, device=dev)))
    (res, probe) = runs[0]
    d, sigma, fwd_sweeps = probe["forward"][0]
    for r, p in runs[1:]:
        rd, rs, _ = p["forward"][0]
        if r.iterations != res.iterations \
                or not np.array_equal(r.scores, res.scores) \
                or not torch.equal(rd, d) or not torch.equal(rs, sigma):
            raise AssertionError("betweenness fused at scale 20: three runs "
                                 "not bit-equal")
    bwd_sweeps = probe["backward"][0][1]
    torch.cuda.synchronize()
    k2_ms = [float(sum(s_.elapsed_time(e) for s_, e in p["spmm"]))
             for _, p in runs]
    fold_s = [p["fold_s"] for _, p in runs]
    del runs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, host_probe = call(lambda: betweenness(
        tiled, roots, batch_size=B, config=EngineConfig(mode="hostloop"),
        device=dev))
    host_s = time.perf_counter() - t0
    hd, hs, _ = host_probe["forward"][0]
    if host.iterations != res.iterations \
            or not np.array_equal(host.scores, res.scores) \
            or not torch.equal(hd, d) or not torch.equal(hs, sigma):
        raise AssertionError("betweenness hostloop at scale 20 != fused")
    del host_probe, hd, hs
    launches = ops.launch_counts()["slimsell_spmm"]
    if launches == 0:
        raise AssertionError("kernel 2 never ran on phase 13b's path")
    with plain_sweeps(engine, *plain):
        ref = call(lambda: betweenness(tiled, roots, batch_size=B,
                                       device=dev))
    errs = bc_close((res, probe), ref, f"fused at scale {SCALE}")
    del ref
    if not torch.equal(d, torch.from_numpy(
            np.ascontiguousarray(push.distances.T)).to(dev)):
        raise AssertionError("betweenness depths != the phase-5 push batch's "
                             "distances")
    past = int((sigma >= BC_SIGMA_EXACT).sum())
    top_sigma = float(sigma.max())
    # eight roots against a float64 Brandes over phase 5's depths
    t0 = time.perf_counter()
    eight = roots[:8]
    _, sigma64, delta64 = brandes_f64(
        csr, eight, d=push.distances[:8].T.astype(np.int64))
    f64_s = time.perf_counter() - t0
    sig8 = sigma[:, :8].double().cpu().numpy()
    sigma64_err = float(np.max(np.abs(sig8 - sigma64)
                               / np.maximum(sigma64, 1.0)))
    ref8 = bc_from_delta(delta64, eight)
    got8 = bc_from_delta(probe["backward"][0][0][:, :8].cpu().numpy(), eight)
    f64_err = bc_f64_close(got8, ref8, BC_F64_ATOL * float(ref8.max()),
                           f"8 roots at scale {SCALE}")
    log(f"[13b] betweenness over the 64 phase-5 roots, one batch of {B}, "
        f"fused: {fwd_sweeps} forward + {bwd_sweeps} backward sweeps "
        f"({res.iterations}); median {med * 1e3:.1f} ms of "
        f"{[round(s * 1e3, 1) for s in secs]}; the SpMM calls (kernel 2, "
        f"CUDA events) {[round(x, 3) for x in k2_ms]} ms; the host fold "
        f"{[round(x * 1e3, 1) for x in fold_s]} ms; hostloop (once) "
        f"{host_s * 1e3:.1f} ms on {card}")
    log(f"[13b] three fused runs and the hostloop run bit-equal (scores, "
        f"sweeps, depths, path counts); depths == the phase-5 push batch's "
        f"distances; largest path count {top_sigma:.6e}, {past} of "
        f"{sigma.numel()} counts at or past 2^24; against the plain sweeps "
        f"on the card: {errs}; 8 roots against a float64 Brandes ({f64_s:.1f}"
        f" s): path counts {sigma64_err:.3e} relative, scores "
        f"{f64_err:.3e} of the largest; slimsell_spmm launches over 13b "
        f"{launches}; largest score {float(res.scores.max()):.6e}")
    for r in table:
        if r["name"] == "slimsell_spmm":
            r["phase13_launches"] = launches
            r["betweenness"] = {
                "median_ms": med * 1e3, "spmm_ms": k2_ms, "fold_ms":
                [x * 1e3 for x in fold_s], "hostloop_ms": host_s * 1e3,
                "forward_sweeps": fwd_sweeps,
                "backward_sweeps": bwd_sweeps, "sigma_past_2_24": past,
                "largest_sigma": top_sigma, **errs,
                "f64_rel_to_max": f64_err}
    return launches


def serving_queries(n: int, seed: int, delta: float, config):
    """Phase 14a's mixed stream on a graph of ``n`` vertices, as Query
    fields (dicts) by ``config``: BFS in the four semirings (parents on
    every other root) and packed, SSSP at ``delta`` and twice it, CC
    sel-max, boolean lane and packed, PageRank at two dampings, k-hop at
    k = 1 and 2 lane and at 2 packed, betweenness. Returns ``(stream,
    refused)``: the queries the JAX package refuses under ``config`` (the
    packed sweeps and betweenness under direction "auto") make up
    ``refused``, one slot each, and are left out of ``stream``."""
    roots = [int(r) for r in np.random.default_rng(seed).choice(
        n, min(6, n), replace=False)]
    qs = []

    def add(**kw):
        q = dict(qid=len(qs), algorithm="bfs", semiring="tropical",
                 root=None, delta=None, need_parents=False, deadline_at=None,
                 submitted_at=0.0)
        q.update(kw)
        qs.append(q)

    for sem in SEMIRINGS:
        for i, r in enumerate(roots[:5]):
            add(semiring=sem, root=r, need_parents=i % 2 == 0)
    for r in roots[:5]:
        add(semiring="boolean", root=r, packed=True, need_parents=True)
    for d in (delta, 2 * delta):
        for i, r in enumerate(roots[:4]):
            add(algorithm="sssp", semiring="minplus", root=r, delta=d,
                need_parents=i % 2 == 1)
    add(algorithm="cc", semiring="selmax")
    add(algorithm="cc", semiring="boolean")
    add(algorithm="cc", semiring="boolean", packed=True)
    for damping in (0.85, 0.7):
        add(algorithm="pagerank", semiring="real", damping=damping, tol=1e-6)
    for k, packed in ((1, False), (2, False), (2, True)):
        for r in roots[:3]:
            add(algorithm="khop", semiring="boolean", root=r, k=k,
                packed=packed)
    add(algorithm="betweenness", semiring="real")
    if config.direction != "auto":
        return qs, []
    refused = [q for q in qs if q.get("packed")
               or q["algorithm"] == "betweenness"]
    return [q for q in qs if q not in refused], refused


def serve(tiled, config, qs, *, max_inflight, dev):
    """``qs`` through a ``Batcher`` and a ``Dispatcher`` on ``dev``: the
    results by qid, the metrics' snapshot and the slots."""
    from repro_torch.serving import Batcher, Dispatcher, Query, ServingMetrics
    metrics = ServingMetrics()
    disp = Dispatcher(tiled, config, metrics, max_inflight=max_inflight,
                      device=dev)
    batcher = Batcher(max_batch=8)
    for q in qs:
        batcher.add(Query(**dict(q, submitted_at=time.monotonic())))
    slots, expired = batcher.drain(time.monotonic())
    if expired:
        raise AssertionError(f"{len(expired)} queries without a deadline "
                             "expired")
    for slot in slots:
        disp.dispatch(slot)
    disp.drain()
    return disp.results, metrics.snapshot(), slots


def same_served(got, want, what: str, *, across: bool = False,
                pr_ref=None, csr=None) -> None:
    """Two serving results of one query, bit-equal (dtypes included) unless
    ``across`` devices (the card against the CPU): then PageRank is held by
    ``pagerank_close`` to ``pr_ref = (the CPU's front-door run, tol)``,
    whose residual log decides sweeps one apart, and betweenness within
    ``BC_RTOL`` and ``BC_ATOL_REL`` x the largest score with equal sweeps.
    With ``csr`` the sel-max parents are validated (Graph500 §5.2) instead
    of compared: the pull's first hit may pick another parent."""
    from repro_torch.graph500 import validate_bfs_tree
    if (got.status, got.buckets, got.delta, got.n_components) != \
            (want.status, want.buckets, want.delta, want.n_components) \
            or got.values.dtype != want.values.dtype:
        raise AssertionError(f"{what}: status, buckets, delta, count or "
                             "dtype differ")
    if across and got.algorithm == "pagerank":
        ref, tol = pr_ref
        pagerank_close(types.SimpleNamespace(ranks=got.values,
                                             iterations=got.sweeps),
                       ref, tol, what)
    elif across and got.algorithm == "betweenness":
        if got.sweeps != want.sweeps or not np.allclose(
                got.values, want.values, rtol=BC_RTOL,
                atol=BC_ATOL_REL * float(want.values.max())):
            raise AssertionError(f"{what}: betweenness not within BC_*")
    elif got.sweeps != want.sweeps or got.residual != want.residual \
            or not np.array_equal(got.values, want.values):
        raise AssertionError(f"{what}: values, sweeps or residual differ")
    if (got.parents is None) != (want.parents is None):
        raise AssertionError(f"{what}: parents on one side only")
    if got.parents is None:
        return
    if csr is not None and got.semiring == "selmax":
        validate_bfs_tree(csr, int(np.flatnonzero(got.values == 0)[0]),
                          got.values, got.parents)
    elif got.parents.dtype != want.parents.dtype \
            or not np.array_equal(got.parents, want.parents):
        raise AssertionError(f"{what}: parents differ")


def same_counters(got: dict, want: dict, pagerank_gap: int, what: str):
    """Two metrics snapshots: every counter and ratio equal, latencies
    aside, and the sweep total apart by the PageRank sweeps' gap alone."""
    skip = ("sweeps_total", "sweeps_per_query")

    def counters(snap):
        return {k: v for k, v in snap.items()
                if not k.startswith("latency") and k not in skip}
    if got["sweeps_total"] - want["sweeps_total"] != pagerank_gap \
            or counters(got) != counters(want):
        raise AssertionError(f"{what}: counters differ")


def serving_phase(*, dev, card, tiled, roots, push, msssp, workloads, table):
    """Phase 14: the serving dispatcher (``repro_torch.serving``). (a) small
    graphs, three configs x ``max_inflight`` 0 and 2, the card against its
    own front doors and the dispatcher on the CPU; (b) scale 20, one mixed
    stream of 64-root buckets through ``Batcher(max_batch=64)`` and
    ``Dispatcher(max_inflight=2)`` twice, against phases 5, 9b and 12b and
    the front doors, timed, the launches counted from zero. Returns the
    launch counts of 14a and 14b, the passes' numbers, and for phase 15 the
    14b stream (``stream``, its query dicts), its slot count (``slots``)
    and its first pass's results by qid (``first``)."""
    from repro_torch.configs.sssp_graph500 import WEIGHT_HIGH, WEIGHT_LOW
    from repro_torch.core.cc import cc
    from repro_torch.core.formats import build_slimsell
    from repro_torch.core.khop import khop_many
    from repro_torch.core.multi_bfs import multi_source_bfs
    from repro_torch.core.multi_sssp import multi_source_sssp
    from repro_torch.core.options import EngineConfig
    from repro_torch.core.pagerank import pagerank
    from repro_torch.core.sssp import default_delta
    from repro_torch.graphs.generators import (kronecker, star, two_components,
                                               with_random_weights)
    from repro_torch.kernels import ops
    from repro_torch.serving import Batcher, Dispatcher, Query, ServingMetrics

    # (a) small graphs: the card against its own front doors (the
    # dispatcher's synchronous path, which calls them with the slot's
    # roots, width and config) and against the dispatcher on the CPU
    t0 = time.perf_counter()
    configs = {"push fused": EngineConfig(), "auto fused":
               EngineConfig(direction="auto"),
               "push hostloop": EngineConfig(mode="hostloop")}
    launches_a = {k: 0 for k in ops.launch_counts()}
    n_streams = n_results = 0
    refusals = []
    for gname, g in (("kronecker(10, 8)", kronecker(10, 8, seed=1)),
                     ("star(64)", star(64)),
                     ("two_components(7, 8)", two_components(7, 8, seed=0))):
        g = with_random_weights(g, low=WEIGHT_LOW, high=WEIGHT_HIGH, seed=2)
        host = build_slimsell(g, C=8, L=32)
        gcpu, gdev = host.to_torch("cpu"), host.to_torch(dev)
        delta = default_delta(gcpu)
        for cname, cfg in configs.items():
            qs, refused = serving_queries(g.n, 14, delta, cfg)
            ref, ref_snap, _ = serve(gcpu, cfg, qs, max_inflight=2,
                                     dev="cpu")
            # the fused handles run sel-max CC, PageRank and SSSP push
            # under any direction, as the JAX package's dispatcher does
            push_cfg = EngineConfig(mode=cfg.mode)
            pr_ref = {}
            for q in qs:
                if q["algorithm"] == "pagerank":
                    pr = pagerank(gcpu, damping=q["damping"], tol=q["tol"],
                                  config=push_cfg, device="cpu")
                    if not np.array_equal(pr.ranks, ref[q["qid"]].values):
                        raise AssertionError("the CPU dispatcher's PageRank "
                                             "!= its front door")
                    pr_ref[q["qid"]] = (pr, q["tol"])
            for max_inflight in (0, 2):
                before = ops.launch_counts()
                got, snap, slots = serve(gdev, cfg, qs,
                                         max_inflight=max_inflight, dev=dev)
                for k, v in ops.launch_counts().items():
                    launches_a[k] += v - before[k]
                # the front doors with each slot's roots, width and config:
                # the dispatcher's synchronous path
                doors = {c: Dispatcher(gdev, c, ServingMetrics(), device=dev)
                         for c in (cfg, push_cfg)}
                for slot in slots:
                    own = slot.key.algorithm in ("bfs", "khop") \
                        or slot.key.semiring == "boolean"
                    doors[cfg if own else push_cfg]._dispatch_sync(slot)
                doors = {**doors[push_cfg].results, **doors[cfg].results}
                what = f"{cname} max_inflight={max_inflight} on {gname}"
                for q in qs:
                    qid = q["qid"]
                    same_served(got[qid], doors[qid],
                                f"qid {qid} {what}, card vs its front doors")
                    same_served(got[qid], ref[qid],
                                f"qid {qid} {what}, card vs CPU", across=True,
                                pr_ref=pr_ref.get(qid),
                                csr=g if cfg.direction == "auto" else None)
                    n_results += 1
                same_counters(snap, ref_snap, sum(
                    got[qid].sweeps - ref[qid].sweeps for qid in pr_ref),
                    f"{what}, card vs CPU")
                n_streams += 1
            for q in refused:
                errors = []
                for tiled_, d in ((gcpu, "cpu"), (gdev, dev)):
                    b = Batcher()
                    b.add(Query(**q))
                    try:
                        Dispatcher(tiled_, cfg, ServingMetrics(),
                                   device=d).dispatch(b.drain(0.0)[0][0])
                    except (ValueError, TypeError, NotImplementedError) as e:
                        errors.append(type(e))
                if len(errors) != 2 or errors[0] is not errors[1]:
                    raise AssertionError(f"{q['algorithm']} packed="
                                         f"{q.get('packed', False)} under "
                                         f"{cname}: refused {errors}")
                packed = " packed" if q.get("packed") else ""
                refusals.append(f"{q['algorithm']}{packed} "
                                f"{errors[0].__name__}")
    log(f"[14a] dispatcher on the card == its front doors bit for bit and == "
        f"the dispatcher on the CPU (integers bit-equal, PageRank within "
        f"PR_*, betweenness within BC_*, sel-max parents under auto "
        f"validated, counters equal) on kronecker(10, 8), star(64), "
        f"two_components(7, 8) x {', '.join(configs)} x max_inflight 0 and "
        f"2: {n_streams} streams, {n_results} results; refused under auto "
        f"on both devices alike: {sorted(set(refusals))}; launches "
        f"{ {k: v for k, v in launches_a.items() if v} } in "
        f"{time.perf_counter() - t0:.1f} s")
    needed_a = ("slimsell_pull", "slimsell_spmv_packed")
    if min(launches_a[k] for k in needed_a) == 0:
        raise AssertionError(f"a kernel never ran on phase 14a's path: "
                             f"{launches_a}")

    # (b) scale 20: one mixed stream through one dispatcher, twice
    delta = default_delta(tiled)
    roots = [int(r) for r in roots]
    kinds = {}

    def stream(base):
        qs = []

        def add(kind, **kw):
            q = dict(qid=base + len(qs), algorithm="bfs", semiring="tropical",
                     root=None, delta=None, need_parents=False,
                     deadline_at=None, submitted_at=0.0)
            q.update(kw)
            if not base:   # the first pass's qids by kind
                kinds.setdefault(kind, []).append(q["qid"])
            qs.append(q)

        for i, r in enumerate(roots):
            add("tropical", root=r, need_parents=i < 32)
        for r in roots[:16]:
            add("selmax", semiring="selmax", root=r, need_parents=True)
        for r in roots[:32]:
            add("packed", semiring="boolean", root=r, packed=True)
        for r in roots:
            add("sssp", algorithm="sssp", semiring="minplus", root=r,
                delta=delta)
        add("cc", algorithm="cc", semiring="selmax")
        add("pagerank", algorithm="pagerank", semiring="real", damping=0.85,
            tol=1e-6)
        for r in roots:
            add("khop", algorithm="khop", semiring="boolean", root=r, k=2)
        return qs

    metrics = ServingMetrics()
    disp = Dispatcher(tiled, EngineConfig(), metrics, max_inflight=2,
                      device=dev)
    batcher = Batcher(max_batch=64)

    def one_pass(qs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for q in qs:
            batcher.add(Query(**dict(q, submitted_at=time.monotonic())))
        slots, expired = batcher.drain(time.monotonic())
        if expired:
            raise AssertionError("a query without a deadline expired")
        for slot in slots:
            disp.dispatch(slot)
        disp.drain()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, len(slots)

    first = stream(0)
    second = stream(len(first))
    ops.reset_launches()
    wall1, n_slots = one_pass(first)
    snap1 = metrics.snapshot()
    wall2, _ = one_pass(second)
    snap2 = metrics.snapshot()
    launches_b = ops.launch_counts()
    needed_b = ("slimsell_spmv", "slimsell_spmm", "slimsell_spmm_wts",
                "slimsell_spmm_packed")
    if min(launches_b[k] for k in needed_b) == 0:
        raise AssertionError(f"a kernel never ran on phase 14b's path: "
                             f"{launches_b}")
    if snap2["compile_cache_misses"] != snap1["compile_cache_misses"] \
            or snap2["compile_cache_hits"] - snap1["compile_cache_hits"] \
            != n_slots:
        raise AssertionError(f"the second pass was not all handle hits: "
                             f"{snap1} then {snap2}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    fd = {"tropical": timed(lambda: multi_source_bfs(
              tiled, roots, "tropical", need_parents=True, device=dev)),
          "tropical without parents": timed(lambda: multi_source_bfs(
              tiled, roots, "tropical", device=dev)),
          "selmax": timed(lambda: multi_source_bfs(
              tiled, roots[:16], "selmax", need_parents=True, device=dev)),
          "packed": timed(lambda: multi_source_bfs(
              tiled, roots[:32], "boolean", packed=True, device=dev)),
          "sssp": timed(lambda: multi_source_sssp(tiled, roots, delta=delta,
                                                  device=dev)),
          "cc": timed(lambda: cc(tiled, device=dev)),
          "pagerank": timed(lambda: pagerank(tiled, device=dev)),
          "khop": timed(lambda: khop_many(tiled, roots, 2, device=dev))}
    res = disp.results

    def check(cond, what):
        if not cond:
            raise AssertionError(f"phase 14b: {what}")

    def equal(a, b):
        return a.dtype == b.dtype and np.array_equal(a, b)

    for i, qid in enumerate(kinds["tropical"]):
        check(equal(res[qid].distances, push.distances[i]),
              f"tropical root {roots[i]} != the phase-5 push batch")
        if i < 32:
            check(equal(res[qid].parents, fd["tropical"][0].parents[i]),
                  f"tropical parents of root {roots[i]} != the front door's")
        else:
            check(res[qid].parents is None, "parents nobody asked for")
    for i, qid in enumerate(kinds["selmax"]):
        check(equal(res[qid].distances, push.distances[i])
              and equal(res[qid].parents, fd["selmax"][0].parents[i]),
              f"selmax root {roots[i]} != phase 5 / the front door")
    for i, qid in enumerate(kinds["packed"]):
        check(equal(res[qid].distances, push.distances[i]),
              f"packed root {roots[i]} != the phase-5 push batch")
    for i, qid in enumerate(kinds["sssp"]):
        r = res[qid]
        check(equal(r.distances, msssp.distances[i])
              and (r.sweeps, r.buckets, r.delta)
              == (msssp.sweeps[i], msssp.buckets[i], msssp.delta)
              and equal(r.distances, fd["sssp"][0].distances[i]),
              f"sssp root {roots[i]} != phase 9b's row / the front door")
    r, want = res[kinds["cc"][0]], workloads["cc"]
    check(equal(r.labels, want.labels) and r.n_components == want.n_components
          and r.sweeps == want.iterations, "cc != phase 12b's labels")
    r, want = res[kinds["pagerank"][0]], workloads["pagerank"]
    check(equal(r.ranks, want.ranks) and r.sweeps == want.iterations
          and r.residual == float(want.residuals[-1]),
          "pagerank != phase 12b's fused ranks bit for bit")
    for i, qid in enumerate(kinds["khop"]):
        check(equal(res[qid].distances, workloads["khop_many"].distances[i]),
              f"khop k=2 root {roots[i]} != phase 12b's khop_many")
    for q in second:
        same_served(res[q["qid"]], res[q["qid"] - len(first)],
                    f"phase 14b qid {q['qid']}, second pass vs first")
    with_parents = sum(t for k, (_, t) in fd.items()
                       if k != "tropical without parents")
    without = sum(t for k, (_, t) in fd.items() if k != "tropical")
    keys = ("batches_dispatched", "columns_total", "columns_real",
            "batch_fill_ratio", "compile_cache_hits", "compile_cache_misses",
            "sweeps_total", "latency_p50_ms", "latency_p99_ms")
    log(f"[14b] scale {SCALE}: {len(first)} queries in {n_slots} slots "
        f"(Batcher(max_batch=64), Dispatcher(max_inflight=2)): tropical 64 "
        f"roots (parents for 32) == the phase-5 push batch and the front "
        f"door's parents; selmax 16 with parents and packed 32 == phase 5; "
        f"sssp 64 (delta {delta:.6g}) == phase 9b's rows (distances, sweeps, "
        f"buckets); cc == phase 12b's labels; pagerank == phase 12b's fused "
        f"ranks bit for bit ({workloads['pagerank'].iterations} sweeps); "
        f"khop k=2 == phase 12b's khop_many; the second pass all handle hits"
        f" and bit-equal to the first")
    log(f"[14b] pass 1 {wall1 * 1e3:.1f} ms, pass 2 {wall2 * 1e3:.1f} ms; "
        f"the same front doors one by one: {with_parents * 1e3:.1f} ms (the "
        f"tropical call with parents for all 64), {without * 1e3:.1f} ms (its "
        f"call without parents): "
        f"{ {k: round(t * 1e3, 1) for k, (_, t) in fd.items()} } on {card}")
    log(f"[14b] after pass 1: { {k: snap1[k] for k in keys} }")
    log(f"[14b] after pass 2: { {k: snap2[k] for k in keys} }")
    log(f"[14b] launches over both passes, counted from zero: "
        f"{ {k: v for k, v in launches_b.items() if v} }")
    for r in table:
        if launches_a.get(r["name"]):
            r["phase14a_launches"] = launches_a[r["name"]]
        if launches_b.get(r["name"]):
            r["phase14b_launches"] = launches_b[r["name"]]
    return {"14a": launches_a, "14b": launches_b, "serving": {
        "pass_ms": [wall1 * 1e3, wall2 * 1e3],
        "front_doors_ms": with_parents * 1e3,
        "front_doors_without_parents_ms": without * 1e3,
        "after_pass_1": {k: snap1[k] for k in keys},
        "after_pass_2": {k: snap2[k] for k in keys}},
        "stream": first, "slots": n_slots,
        "first": {q["qid"]: res[q["qid"]] for q in first}}


# every thread the run starts is joined within this, then must have ended
JOIN_TIMEOUT_S = 120.0
# phase 15a's plan: the query kinds each router graph serves; the push
# graphs everything, the "auto" graph (the kronecker layout under direction
# "auto") what that direction serves with kernel 3 on its path
SESSION_KINDS = {
    "bfs tropical": ("bfs", "tropical", False, None),
    "bfs selmax": ("bfs", "selmax", False, None),
    "bfs packed": ("bfs", "boolean", True, None),
    "sssp": ("sssp", "minplus", False, None),
    "khop 2": ("khop", "boolean", False, 2),
    "khop 1 packed": ("khop", "boolean", True, 1),
    "cc selmax": ("cc", "selmax", False, None),
    "cc boolean": ("cc", "boolean", False, None),
    "cc packed": ("cc", "boolean", True, None),
    "pagerank": ("pagerank", "real", False, None),
}
PUSH_KINDS = tuple(SESSION_KINDS)
AUTO_KINDS = ("bfs tropical", "khop 2", "cc boolean")


@contextlib.contextmanager
def recorded(owner, name: str):
    """Keep what ``owner.name`` returns while the block runs: the
    harnesses' session calls, whose results their reports do not hold."""
    orig = getattr(owner, name)
    out = []

    def wrapper(*args, **kwargs):
        res = orig(*args, **kwargs)
        out.append(res)
        return res

    setattr(owner, name, wrapper)
    try:
        yield out
    finally:
        setattr(owner, name, orig)


def joined(threads, what: str) -> None:
    """Join every thread within ``JOIN_TIMEOUT_S`` in all; fail if one is
    still running."""
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [th.name for th in threads if th.is_alive()]
    if alive:
        raise AssertionError(f"{what}: {alive} still running after "
                             f"{JOIN_TIMEOUT_S:.0f} s")


def produced(submit, plan, what: str, n_threads: int = 4) -> list:
    """Submit ``plan`` (``(args, kwargs)`` of ``submit`` each) from
    ``n_threads`` producer threads, thread t taking every n_threads-th
    entry from t and then waiting on its handles; the results in plan
    order. A producer's exception fails the run."""
    results = [None] * len(plan)
    errors = []

    def producer(t):
        try:
            handles = [(i, submit(*plan[i][0], **plan[i][1]))
                       for i in range(t, len(plan), n_threads)]
            for i, h in handles:
                results[i] = h.result()
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(t,), daemon=True,
                                name=f"{what} producer {t}")
               for t in range(n_threads)]
    for th in threads:
        th.start()
    joined(threads, what)
    if errors:
        raise errors[0]
    return results


def session_plan(seed: int, n_queries: int, graphs: dict) -> list:
    """Phase 15a's mixed plan over ``graphs`` (name -> (n, kinds)): one
    query in twenty whole-graph (CC, PageRank), the rest rooted (BFS
    tropical and sel-max with parents on about half, packed BFS, SSSP,
    k-hop lane and packed), roots drawn without replacement per (graph,
    kind), as the JAX package's concurrent test draws them. Entries are
    ``(graph, kind, root, need_parents)``."""
    rng = np.random.default_rng(seed)
    names = sorted(graphs)
    pools, plan = {}, []
    for _ in range(n_queries):
        g = names[int(rng.integers(len(names)))]
        n, kinds = graphs[g]
        whole = [k for k in kinds if SESSION_KINDS[k][0] in ("cc", "pagerank")]
        rooted = [k for k in kinds if k not in whole]
        if int(rng.integers(20)) == 19:
            plan.append((g, whole[int(rng.integers(len(whole)))], None, False))
            continue
        kind = rooted[int(rng.integers(len(rooted)))]
        pool = pools.setdefault((g, kind), list(rng.permutation(n)))
        parents = kind in ("bfs tropical", "bfs selmax") \
            and bool(rng.integers(2))
        plan.append((g, kind, int(pool.pop()), parents))
    return plan


def session_submit(kind: str, root, parents: bool) -> tuple:
    """``(args, kwargs)`` of ``submit`` for one query of ``kind``."""
    alg, sem, packed, k = SESSION_KINDS[kind]
    kw = {}
    if alg in ("bfs", "cc"):
        kw["semiring"] = sem
    if packed:
        kw["packed"] = True
    if k is not None:
        kw["k"] = k
    if parents:
        kw["need_parents"] = True
    return ((alg,) if root is None else (alg, root)), kw


def stream_submit(q: dict) -> tuple:
    """``(args, kwargs)`` of ``submit`` for one of phase 14b's query dicts."""
    kw = {k: q[k] for k in ("semiring", "delta", "need_parents", "packed",
                            "k", "damping", "tol") if q.get(k) is not None}
    args = (q["algorithm"],) if q["root"] is None \
        else (q["algorithm"], q["root"])
    return args, kw


def session_phase(*, dev, card, tiled, served, table):
    """Phase 15: the serving session and router (``GraphSession``,
    ``Router``, the flush thread, backpressure). (a) a router over two small
    graphs (and the first again under direction "auto"), four producer
    threads, every result against the card's front door for its query, then
    the lifecycle; (b) scale 20, phase 14b's stream through one session
    with a flush thread from four producers, twice, and through one without
    (submit, then drain), twice, every query against 14b's first pass.
    Returns the launch counts of 15a and 15b."""
    from repro_torch.configs.sssp_graph500 import WEIGHT_HIGH, WEIGHT_LOW
    from repro_torch.core.bfs import bfs
    from repro_torch.core.cc import cc
    from repro_torch.core.formats import build_slimsell
    from repro_torch.core.khop import khop
    from repro_torch.core.options import EngineConfig
    from repro_torch.core.pagerank import pagerank
    from repro_torch.core.sssp import sssp
    from repro_torch.graphs.generators import (erdos_renyi, kronecker,
                                               with_random_weights)
    from repro_torch.kernels import ops
    from repro_torch.serving import (GraphSession, QueryShed, QueueFull,
                                     Router, SessionClosed, UnknownGraph)

    def check(cond, what):
        if not cond:
            raise AssertionError(f"phase 15: {what}")

    def equal(a, b):
        return a is not None and b is not None and a.dtype == b.dtype \
            and np.array_equal(a, b)

    # (a) small graphs through a router, four producers
    t0 = time.perf_counter()
    before = ops.launch_counts()
    push, auto = EngineConfig(), EngineConfig(direction="auto")
    layouts = {
        "kron": build_slimsell(with_random_weights(
            kronecker(10, 8, seed=1), low=WEIGHT_LOW, high=WEIGHT_HIGH,
            seed=2), C=8, L=32).to_torch(dev),
        "er": build_slimsell(with_random_weights(
            erdos_renyi(150, 5, seed=3), low=WEIGHT_LOW, high=WEIGHT_HIGH,
            seed=4), C=8, L=16).to_torch(dev)}
    layouts["kron auto"] = layouts["kron"]
    configs = {"kron": push, "er": push, "kron auto": auto}
    plan = session_plan(15, 208, {
        g: (t.n, AUTO_KINDS if configs[g] is auto else PUSH_KINDS)
        for g, t in layouts.items()})
    with Router(background=True, max_inflight=2, max_batch=16,
                flush_interval=0.001, device=dev) as router:
        for g, t in layouts.items():
            router.add_graph(g, t, config=configs[g])
        check(router.session("kron auto").tiled is layouts["kron"]
              and router.session("kron").tiled is layouts["kron"],
              "the router copied a layout on the card")
        sigs = router.signatures()
        check(sigs["kron"] == sigs["kron auto"] != sigs["er"],
              f"layout signatures {sigs}")
        calls = [session_submit(kind, r, p) for _, kind, r, p in plan]
        got = produced(router.submit, [((g,) + args, kw) for (g, *_), (
            args, kw) in zip(plan, calls)], "15a")
        stats = router.stats()
        try:
            router.bfs("missing", 0)
            check(False, "an unknown graph name served")
        except UnknownGraph:
            pass
    # the router's stream is 15a's main path: the front doors below and the
    # lifecycle's sessions launch kernels of their own
    launches_a = {k: v - before[k] for k, v in ops.launch_counts().items()}
    check(router.closed, "the router did not close")
    for fn in (lambda: router.submit("kron", "bfs", 0),
               lambda: router.add_graph("x", layouts["er"])):
        try:
            fn()
            check(False, "a closed router took work")
        except SessionClosed:
            pass
    for name, st in [*stats["graphs"].items(), ("total", stats["total"])]:
        check(st["submitted"] == st["completed"] + st["timeouts"] + st["shed"]
              and st["queue_depth"] == 0, f"{name}'s counters {st}")
    check(stats["total"]["submitted"] == len(plan) == stats["total"][
        "completed"], f"the router's total {stats['total']}")

    # every result against the card's front door for its query
    twins = {}
    for (g, kind, root, parents), res in zip(plan, got):
        t, cfg = layouts[g], configs[g]
        alg, sem, packed, k = SESSION_KINDS[kind]
        what = f"15a {g} {kind} root {root}"
        check(res is not None and res.status == "ok", f"{what}: {res}")
        key = (g, kind, root, parents)
        if key not in twins:
            if alg == "bfs":
                twins[key] = bfs(t, root, sem, need_parents=parents,
                                 packed=packed, config=cfg, device=dev)
            elif alg == "khop":
                twins[key] = khop(t, root, k, packed=packed, config=cfg,
                                  device=dev)
            elif alg == "sssp":
                twins[key] = sssp(t, root, config=push, device=dev)
            elif alg == "cc":
                twins[key] = cc(t, semiring=sem, packed=packed,
                                config=cfg if sem == "boolean" else push,
                                device=dev)
            else:
                twins[key] = pagerank(t, config=push, device=dev)
        want = twins[key]
        if alg == "pagerank":
            pagerank_close(types.SimpleNamespace(ranks=res.values,
                                                 iterations=res.sweeps),
                           want, 1e-6, what)
            continue
        if alg == "cc":
            check(equal(res.labels, want.labels)
                  and res.n_components == want.n_components
                  and res.sweeps == want.iterations, what)
            continue
        check(equal(res.distances, want.distances), f"{what}: distances")
        if alg == "sssp":
            check((res.sweeps, res.buckets, res.delta)
                  == (want.sweeps, want.buckets, want.delta),
                  f"{what}: sweeps, buckets or delta")
        check(equal(res.parents, want.parents) if parents
              else res.parents is None, f"{what}: parents")
    kinds_run = sorted({kind for _, kind, _, _ in plan})

    # the lifecycle on the card: shed, raise, close under load, typed errors
    kron = layouts["kron"]
    with GraphSession(kron, max_pending=4, on_full="shed",
                      device=dev) as s:
        hs = [s.submit("bfs", r) for r in range(10)]
        out = [h.result() for h in hs]
        st = s.stats()
    shed = [r for r in out if r.status == "shed"]
    check(len(shed) == 6 and all(r.values is None for r in shed)
          and st["shed"] == 6 and st["submitted"] == 10 == st["completed"]
          + st["timeouts"] + st["shed"], f"on_full='shed': {st}")
    try:
        shed[0].raise_for_status()
        check(False, "a shed result raised nothing")
    except QueryShed:
        pass
    for root, r in enumerate(out):
        if r.ok:
            check(equal(r.distances, bfs(kron, root, config=push,
                                         device=dev).distances),
                  f"on_full='shed': served root {root}")
    with GraphSession(kron, max_pending=4, on_full="raise",
                      device=dev) as s:
        for r in range(4):
            s.submit("bfs", r)
        try:
            s.submit("bfs", 4)
            check(False, "a full queue took a fifth query")
        except QueueFull:
            pass
        s.flush()
        check(s.submit("bfs", 4).result().ok, "the retry after a flush")
    s = GraphSession(kron, background=True, max_inflight=2, device=dev)
    hs = [s.submit("bfs", r) for r in range(5)] + [s.submit("sssp", 0)]
    flusher = s._flush_thread
    s.close()
    st = s.stats()
    check(not flusher.is_alive() and st["completed"] == 6 == st["submitted"]
          and st["inflight"] == 0 and st["queue_depth"] == 0,
          f"close() with work in flight: {st}")
    s.close()
    for fn in (lambda: s.submit("bfs", 7), lambda: hs[0].result()):
        try:
            fn()
            check(False, "a closed session served")
        except SessionClosed:
            pass
    needed_a = ("slimsell_pull", "slimsell_spmv_packed")
    if min(launches_a[k] for k in needed_a) == 0:
        raise AssertionError(f"a kernel never ran on phase 15a's path: "
                             f"{launches_a}")
    log(f"[15a] Router(background=True, max_inflight=2) over kronecker(10, "
        f"8) C8 L32 and erdos_renyi(150, 5) C8 L16 (weighted; the first "
        f"also under direction 'auto', one layout, not copied): "
        f"{len(plan)} queries from 4 producer threads, kinds {kinds_run}, "
        f"every result == the card's front door for it (integers bit-equal, "
        f"PageRank within PR_*); {stats['total']['batches_dispatched']} "
        f"slots; counters reconcile per graph and in total "
        f"({stats['total']['submitted']} submitted, "
        f"{stats['total']['completed']} completed)")
    log(f"[15a] lifecycle: on_full='shed' at max_pending=4 served 4 and "
        f"shed 6 (QueryShed), 'raise' refused the fifth (QueueFull) and took "
        f"it after a flush; close() with 6 queries in flight completed them "
        f"all and ended the flush thread; a second close() a no-op; "
        f"SessionClosed after close, UnknownGraph for an unknown name; "
        f"the router stream's launches "
        f"{dict((k, v) for k, v in launches_a.items() if v)}; 15a took "
        f"{time.perf_counter() - t0:.1f} s")

    # (b) scale 20: phase 14b's stream through one session
    stream, first = served["stream"], served["first"]
    plan = [stream_submit(q) for q in stream]
    ops.reset_launches()

    def same_as_14b(res, q, what, *, sweeps):
        want = first[q["qid"]]
        check(res.status == want.status == "ok"
              and equal(res.values, want.values)
              and (equal(res.parents, want.parents) if want.parents
                   is not None else res.parents is None)
              and (res.buckets, res.delta, res.n_components, res.residual)
              == (want.buckets, want.delta, want.n_components, want.residual)
              and (not sweeps or res.sweeps == want.sweeps),
              f"{what}: qid {q['qid']} ({q['algorithm']} {q['semiring']}) "
              "!= phase 14b's first pass")

    def bfs_sweeps(results):
        return sorted({r.sweeps for r, q in zip(results, stream)
                       if q["algorithm"] == "bfs"})

    passes = []
    sess = GraphSession(tiled, max_batch=64, max_inflight=2, background=True,
                        device=dev)
    check(sess.tiled is tiled
          and sess.tiled.cols.data_ptr() == tiled.cols.data_ptr(),
          "the session copied the scale-20 layout")
    for p in (1, 2):
        s0 = sess.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = produced(sess.submit, plan, f"15b pass {p}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s1 = sess.stats()
        for res, q in zip(results, stream):
            # batched BFS and k-hop sweeps follow the slot cuts, which the
            # flush thread's timing decides: printed, not compared
            same_as_14b(res, q, f"15b threaded pass {p}",
                        sweeps=q["algorithm"] not in ("bfs", "khop"))
        slots = s1["batches_dispatched"] - s0["batches_dispatched"]
        fill = (s1["columns_real"] - s0["columns_real"]) / max(
            1, s1["columns_total"] - s0["columns_total"])
        passes.append((f"threaded {p}", wall, slots, fill,
                       s1["compile_cache_hits"] - s0["compile_cache_hits"],
                       s1["compile_cache_misses"] - s0["compile_cache_misses"],
                       bfs_sweeps(results)))
    flusher = sess._flush_thread
    sess.close()
    check(not flusher.is_alive(), "the flush thread outlived close()")
    del results
    sess = GraphSession(tiled, max_batch=64, max_inflight=2, device=dev)
    for p in (1, 2):
        s0 = sess.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = [sess.submit(*a, **kw) for a, kw in plan]
        sess.drain()
        results = [h.result() for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s1 = sess.stats()
        for res, q in zip(results, stream):
            same_as_14b(res, q, f"15b drained pass {p}", sweeps=True)
        slots = s1["batches_dispatched"] - s0["batches_dispatched"]
        hits = s1["compile_cache_hits"] - s0["compile_cache_hits"]
        misses = s1["compile_cache_misses"] - s0["compile_cache_misses"]
        fill = (s1["columns_real"] - s0["columns_real"]) / (
            s1["columns_total"] - s0["columns_total"])
        check(slots == served["slots"] and fill == 1.0,
              f"drained pass {p}: {slots} slots at fill {fill}, 14b "
              f"{served['slots']} at 1.0")
        check(p == 1 or (hits == slots and misses == 0),
              f"drained pass 2: {hits} hits, {misses} misses")
        passes.append((f"drained {p}", wall, slots, fill, hits, misses,
                       bfs_sweeps(results)))
    sess.close()
    del results, handles
    launches_b = ops.launch_counts()
    needed_b = ("slimsell_spmv", "slimsell_spmm", "slimsell_spmm_wts",
                "slimsell_spmm_packed")
    if min(launches_b[k] for k in needed_b) == 0:
        raise AssertionError(f"a kernel never ran on phase 15b's path: "
                             f"{launches_b}")
    log(f"[15b] scale {SCALE}: GraphSession(tiled, max_batch=64, "
        f"max_inflight=2) on the resident layout (same cols storage, no "
        f"copy): phase 14b's {len(stream)} queries, every value, parents, "
        f"buckets, delta and count bit-equal to 14b's first pass (sweeps "
        f"too, but batched BFS and k-hop under the flush thread)")
    for name, wall, slots, fill, hits, misses, sw in passes:
        log(f"[15b] {name}: {wall * 1e3:.1f} ms, {slots} slots, fill "
            f"{fill:.4f}, handle hits {hits} misses {misses}, batched BFS "
            f"sweeps {sw}")
    log(f"[15b] phase 14b's passes (Batcher + Dispatcher, no session): "
        f"{', '.join(f'{t:.1f}' for t in served['serving']['pass_ms'])} ms, "
        f"{served['slots']} slots, on {card}")
    log(f"[15b] launches over the four passes, counted from zero: "
        f"{ {k: v for k, v in launches_b.items() if v} }")
    for r in table:
        if launches_a.get(r["name"]):
            r["phase15a_launches"] = launches_a[r["name"]]
        if launches_b.get(r["name"]):
            r["phase15b_launches"] = launches_b[r["name"]]
    return {"15a": launches_a, "15b": launches_b, "passes": passes}


# ---------------------------------------------------------------- phase 16

DIST_TIMEOUT_S = 600.0


def after_file(path: str, stop: threading.Event, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` once ``path`` exists, with its start and end
    on ``time.perf_counter``; raises if ``stop`` is set before it does."""
    while not os.path.exists(path):
        if stop.wait(0.2):
            raise RuntimeError(f"{path} never appeared")
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, t0, time.perf_counter()


def nccl_case(case) -> bool:
    """The 1 x 1 NCCL world runs each factory once: BFS tropical under
    auto, multi-BFS tropical under pull and packed, SSSP at the default
    delta, k-hop packed, the sliced BFS in int16, the rest as in 16c."""
    kw, f = case["kwargs"], case["factory"]
    if f == "bfs":
        return (kw["sr_name"], kw["direction"]) == ("tropical", "auto")
    if f == "multi_bfs" and not kw.get("packed"):
        return (kw["sr_name"], kw["direction"]) == ("tropical", "pull")
    if f == "sssp":
        return case["args"][1] != float("inf")
    if f == "khop":
        return kw.get("packed", False)
    if f == "bfs_sliced":
        return kw["frontier_dtype"] == "int16"
    return True
# the kernels each sub-phase's path must launch (summed over the ranks)
DIST_16B_KERNELS = ("slimsell_spmv", "slimsell_spmv_wts", "slimsell_spmm",
                    "slimsell_spmm_wts", "slimsell_pull",
                    "slimsell_spmm_packed")
DIST_16C_KERNELS = DIST_16B_KERNELS + ("slimsell_pull_mm",)


def dist_rows(ranks, cases) -> list:
    """Per case: rank 0's outputs, checked equal on every rank (digests),
    with each rank's time, collective time and calls, and launches."""
    out = []
    for idx, case in enumerate(cases):
        digests = {r[idx]["digest"] for r in ranks}
        if len(digests) != 1:
            raise AssertionError(f"the ranks' outputs differ: {case}")
        out.append({"case": case, "result": ranks[0][idx]["result"],
                    "seconds": [r[idx]["seconds"] for r in ranks],
                    "comm_s": [r[idx]["comm"]["seconds"] for r in ranks],
                    "copy_s": [r[idx]["comm"]["copy_seconds"] for r in ranks],
                    "comm_calls": ranks[0][idx]["comm"]["calls"],
                    "comm_bytes": ranks[0][idx]["comm"]["bytes"],
                    "launches": [r[idx]["launches"] for r in ranks]})
    return out


def launch_sum(rows) -> dict:
    """Kernel launches of some cases, summed over cases and ranks."""
    total = {}
    for row_ in rows:
        for per_rank in row_["launches"]:
            for k, v in per_rank.items():
                total[k] = total.get(k, 0) + v
    return total


def dist_line(row_) -> str:
    per_rank = [sum(v.values()) for v in row_["launches"]]
    return (f"{max(row_['seconds']) * 1e3:.1f} ms (slowest rank), "
            f"collectives {max(row_['comm_s']) * 1e3:.1f} ms (host copies "
            f"{max(row_['copy_s']) * 1e3:.1f}) in {row_['comm_calls']} calls "
            f"of {row_['comm_bytes'] / 1e6:.1f} MB a rank, launches per rank "
            f"{per_rank}")


def small_dist_cases(path, slot_path, roots, delta, comms=("allreduce",
                                                          "reduce_gather")):
    """Phase 16c's cases on one partition: every factory, both comm modes,
    every direction it takes, and the sliced BFS in three frontier types."""
    cases = []
    for comm in comms:
        for sr in SEMIRINGS:
            for d in ("push", "pull", "auto"):
                cases.append(dict(factory="bfs", partition=path,
                                  args=[roots[0]],
                                  kwargs=dict(sr_name=sr, direction=d,
                                              comm=comm)))
                cases.append(dict(factory="multi_bfs", partition=path,
                                  args=[roots],
                                  kwargs=dict(sr_name=sr, direction=d,
                                              comm=comm, slimwork=True)))
        cases.append(dict(factory="multi_bfs", partition=path, args=[roots],
                          kwargs=dict(sr_name="boolean", packed=True,
                                      batch_width=len(roots), comm=comm)))
        for dl in (delta, float("inf")):
            cases.append(dict(factory="sssp", partition=path,
                              args=[roots[0], dl],
                              kwargs=dict(comm=comm, slimwork=True)))
        cases.append(dict(factory="multi_sssp", partition=path,
                          args=[roots, delta], kwargs=dict(comm=comm)))
        cases.append(dict(factory="cc", partition=path, args=[],
                          kwargs=dict(comm=comm, slimwork=True)))
        cases.append(dict(factory="pagerank", partition=path,
                          args=[0.85, 1e-6], kwargs=dict(comm=comm)))
        cases.append(dict(factory="brandes", partition=path, args=[roots],
                          kwargs=dict(comm=comm)))
        for d in ("push", "pull", "auto"):
            cases.append(dict(factory="khop", partition=path, args=[roots],
                              kwargs=dict(k=2, direction=d, comm=comm)))
        cases.append(dict(factory="khop", partition=path, args=[roots],
                          kwargs=dict(k=2, packed=True,
                                      batch_width=len(roots), comm=comm)))
    for dtype in ("float32", "bfloat16", "int16"):
        cases.append(dict(factory="bfs_sliced", partition=slot_path,
                          args=["root_slot"],
                          kwargs=dict(frontier_dtype=dtype)))
    return cases


def check_small_dist(rows, refs, what: str) -> int:
    """Phase 16c: each case against the single-device port on the card;
    returns the number of cases held."""
    from repro_torch.core.betweenness import brandes_accumulate
    for row_ in rows:
        case, got = row_["case"], row_["result"]
        kw, f = case["kwargs"], case["factory"]
        name = f"{what} {f} {kw}"
        if f == "bfs":
            want = refs["bfs"][kw["sr_name"], kw["direction"]]
            ok = np.array_equal(got[0], want.distances) \
                and int(got[1]) == want.iterations
        elif f == "multi_bfs" and kw.get("packed"):
            want = refs["multi_bfs"]["boolean", "push"]
            ok = np.array_equal(got[0], want.distances) \
                and int(got[1]) == int(want.iterations[0])
        elif f == "multi_bfs":
            want = refs["multi_bfs"][kw["sr_name"], kw["direction"]]
            ok = np.array_equal(got[0], want.distances) \
                and int(got[1]) == int(want.iterations[0])
        elif f == "sssp":
            want = refs["sssp"][case["args"][1]]
            ok = np.array_equal(got[0], want.distances) \
                and (int(got[1]), int(got[2])) == (want.sweeps, want.buckets)
        elif f == "multi_sssp":
            want = refs["multi_sssp"]
            ok = np.array_equal(got[0], want.distances) \
                and np.array_equal(got[2], want.sweeps) \
                and np.array_equal(got[3], want.buckets)
        elif f == "cc":
            want = refs["cc"]
            ok = np.array_equal(got[0], want.labels) \
                and int(got[1]) == want.iterations
        elif f == "pagerank":
            pagerank_close(types.SimpleNamespace(ranks=got[0],
                                                 iterations=int(got[1])),
                           refs["pagerank"], 1e-6, name)
            ok = True
        elif f == "brandes":
            want, depths = refs["brandes"]
            scores = brandes_accumulate(got[0], np.asarray(case["args"][0]))
            scores /= 2.0
            top = float(want.scores.max())
            ok = np.allclose(scores, want.scores, rtol=BC_RTOL,
                             atol=BC_ATOL_REL * top) \
                and np.array_equal(got[1].T, depths.distances) \
                and int(got[2]) == int(depths.iterations[0])
        elif f == "khop":
            want = refs["khop"][kw.get("direction", "push"),
                                kw.get("packed", False)]
            ok = np.array_equal(got[0], want.distances)
        else:   # bfs_sliced: slot space back to vertex ids
            perm = refs["perm"]
            d = np.full(perm.size, -1, np.int32)
            d[perm] = np.asarray(got[0]).reshape(-1)[:perm.size]
            want = refs["bfs"]["tropical", "push"]
            ok = np.array_equal(d, want.distances) \
                and int(got[1]) == want.iterations
        if not ok:
            raise AssertionError(f"{name}: differs from the single-device "
                                 "port on the card")
    return len(rows)


def dist_phase(*, dev, card, csr, tiled, root, roots, lane_boolean, push,
               sssp_root, msssp, workloads, errs, table):
    """Phase 16: the 2D-distributed strategy (``core.dist_bfs`` over
    ``distributed.Grid``), ranks as processes sharing the one card over
    gloo. (a) the kernels on the path over two blocks of the scale-20 2 x 2
    partition against their plain versions; (b) a 2 x 2 world of four
    processes runs the factories at scale 20, each held to the
    single-device results of the earlier phases; (c) in the same world,
    every factory on kronecker(10, 8) under both comm modes and every
    direction it takes, then a 1 x 1 world on NCCL. Returns the launches of
    (b) and (c), summed over the ranks, and the two blocks of (a) with the
    work lists their kernels read."""
    import tempfile
    from repro_torch.core import direction as dm
    from repro_torch.core import engine, packing, semiring
    from repro_torch.core.betweenness import betweenness
    from repro_torch.core.bfs import bfs
    from repro_torch.core.cc import cc
    from repro_torch.core.dist_bfs import (partition_slimsell, run_cases,
                                           save_partition, shard)
    from repro_torch.core.formats import build_slimsell, sellcs_order
    from repro_torch.core.khop import khop_many
    from repro_torch.core.multi_bfs import multi_source_bfs
    from repro_torch.core.multi_sssp import multi_source_sssp
    from repro_torch.core.options import EngineConfig
    from repro_torch.core.pagerank import pagerank
    from repro_torch.core.spmv import (pull_mm_plain, pull_plain,
                                       spmm_packed_plain, spmm_plain,
                                       spmv_plain)
    from repro_torch.core.sssp import default_delta, sssp
    from repro_torch.distributed import launch
    from repro_torch.graphs.generators import kronecker, with_random_weights
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    part = partition_slimsell(csr, 2, 2, C=tiled.C, L=tiled.L,
                              sigma=tiled.sigma, device=dev)
    part_s = time.perf_counter() - t0
    log(f"[16] scale {SCALE} 2 x 2 partition in {part_s:.1f} s (on the card, "
        f"back to the host): "
        f"t_max={part.t_max} tiles a block, real tiles "
        f"{(-(-part.chunk_len // part.L)).sum(axis=-1).tolist()}, push pairs "
        f"K={part.inc_src.shape[-1]}")

    # (a) each kernel on the path at one state, on blocks (0, 0) and (1, 1):
    # the BFS state before iteration 3 (level 2 the frontier) of the phase
    # 4b root and of the first 16 roots of the phase-5 batch
    level, width = 2, 16
    d1 = torch.from_numpy(lane_boolean.distances).to(dev)
    dB = torch.from_numpy(np.ascontiguousarray(
        push.distances[:width].T)).to(dev)
    sd1 = torch.from_numpy(sssp_root.distances).to(dev)
    sdB = torch.from_numpy(np.ascontiguousarray(
        msssp.distances[:width].T)).to(dev)
    inf = float("inf")

    def operands(d):
        front = d == level
        ids = torch.arange(1, d.shape[0] + 1, dtype=torch.float32,
                           device=dev)
        ids = ids[:, None] if d.ndim > 1 else ids
        return front, ~((d >= 0) & (d <= level)), {
            "tropical": torch.where((d >= 0) & (d <= level), d.float(), inf),
            "real": front.float(), "boolean": front.int(),
            "selmax": torch.where(front, ids, 0.0)}

    front1, nf1, x1 = operands(d1)
    frontB, nfB, xB = operands(dB)
    xB = xB["tropical"]
    w1 = torch.where(front1, sd1, inf)
    wB = torch.where(frontB, sdB, inf)
    words = packing.pack_bits(frontB, axis=1)
    n_cases = 0
    shards = {}   # kept, with their work lists, for phase 17's contracts
    for i, j in ((0, 0), (1, 1)):
        local = shards[i, j] = shard(part, i, j).to_torch(dev)
        lo = j * local.n_x

        def cut(x, fill):
            return engine._column_range(x, lo, local.n_x, fill)

        m1 = dm.push_tile_mask(local, cut(front1, False))
        mB = dm.push_tile_mask(local, cut(frontB, False))
        what = f"scale {SCALE} block ({i}, {j})"
        for name in SEMIRINGS:
            sr = semiring.get(name)
            x = cut(x1[name], sr.zero)
            check_equal("slimsell_spmv", ops.spmv(sr, local, x, tile_mask=m1),
                        spmv_plain(sr, local, x, m1), errs, f"{what} {name}")
            n_cases += 1
        sr = semiring.TROPICAL
        X = cut(xB, inf)
        check_equal("slimsell_spmm", ops.spmm(sr, local, X, tile_mask=mB),
                    spmm_plain(sr, local, X, mB), errs, f"{what} B={width}")
        pm1 = engine._pull_tile_mask(local, nf1)
        x = cut(x1["tropical"], inf)
        check_equal("slimsell_pull", ops.pull(sr, local, x, nf1,
                                              tile_mask=pm1),
                    pull_plain(sr, local, x, nf1, pm1), errs, what)
        pmB = engine._pull_tile_mask(local, nfB.any(dim=1))
        check_equal("slimsell_pull_mm", ops.pull_mm(sr, local, X, nfB,
                                                    tile_mask=pmB),
                    pull_mm_plain(sr, local, X, nfB, pmB), errs,
                    f"{what} B={width}")
        mp = semiring.MINPLUS
        x = cut(w1, inf)
        check_equal("slimsell_spmv_wts",
                    ops.spmv(mp, local, x, tile_mask=m1, weights=local.wts),
                    spmv_plain(mp, local, x, m1, local.wts), errs, what)
        X = cut(wB, inf)
        check_equal("slimsell_spmm_wts",
                    ops.spmm(mp, local, X, tile_mask=mB, weights=local.wts),
                    spmm_plain(mp, local, X, mB, local.wts), errs,
                    f"{what} B={width}")
        W = cut(words, 0)
        check_equal("slimsell_spmm_packed",
                    ops.spmm_packed(local, W, tile_mask=mB),
                    spmm_packed_plain(local, W, mB), errs, f"{what} B={width}")
        n_cases += 6
        del local, X, W
    del d1, dB, sd1, sdB, x1, xB, w1, wB, words, front1, frontB, nf1, nfB
    torch.cuda.synchronize()
    log(f"[16a] kernels == plain on shard views, blocks (0, 0) and (1, 1) of "
        f"the scale-{SCALE} 2 x 2 partition ({n_cases} cases: kernel 1 in 4 "
        f"semirings, 1w, 2, 2w, 3, 4, 6 at the state before iteration "
        f"{level + 1}, the batch kernels at B={width}; localized operands of n_col={part.n_col} rows, results "
        f"of n={part.n} rows, the other shards' rows the semiring zero)")

    # (c)'s graph and its single-device references on the card
    small_csr = with_random_weights(kronecker(10, 8, seed=1), low=2 ** -8,
                                    high=1.0, seed=2)
    small = build_slimsell(small_csr, C=8, L=32).to_torch(dev)
    small_roots = [int(r) for r in np.random.default_rng(16).choice(
        np.nonzero(small_csr.deg)[0], 12, replace=False)]
    delta = default_delta(small)
    refs = {"bfs": {}, "multi_bfs": {}, "sssp": {}, "khop": {},
            "perm": sellcs_order(small_csr.deg, small_csr.n)}
    for name in SEMIRINGS:
        for d in ("push", "pull", "auto"):
            cfg = EngineConfig(direction=d)
            refs["bfs"][name, d] = bfs(small, small_roots[0], name,
                                       config=cfg, device=dev)
            refs["multi_bfs"][name, d] = multi_source_bfs(
                small, small_roots, name, config=cfg, device=dev)
            if name == "boolean":
                refs["khop"][d, False] = khop_many(small, small_roots, 2,
                                                   config=cfg, device=dev)
    refs["khop"]["push", True] = khop_many(small, small_roots, 2,
                                           packed=True, device=dev)
    for dl in (delta, inf):
        refs["sssp"][dl] = sssp(small, small_roots[0], delta=dl, device=dev)
    refs["multi_sssp"] = multi_source_sssp(small, small_roots, delta=delta,
                                           device=dev)
    refs["cc"] = cc(small, device=dev)
    refs["pagerank"] = pagerank(small, device=dev)
    refs["brandes"] = (betweenness(small, small_roots, device=dev),
                       refs["multi_bfs"]["tropical", "push"])
    slot_root = int(np.nonzero(refs["perm"] == small_roots[0])[0][0])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        t0 = time.perf_counter()
        big = os.path.join(tmp, "scale20")
        save_partition(part, big)
        del part
        paths = {}
        for name, (R, slot) in {"k10": (2, False), "k10s": (2, True),
                                "k10_1": (1, False),
                                "k10s_1": (1, True)}.items():
            paths[name] = os.path.join(tmp, name)
            save_partition(partition_slimsell(small_csr, R, R, C=8, L=32,
                                              slot_space=slot, device=dev),
                           paths[name])
        save_s = time.perf_counter() - t0
        # (b) the factories at scale 20 (the first BFS also builds each
        # shard's work lists)
        big_cases = [
            dict(factory="bfs", partition=big, args=[root],
                 kwargs=dict(direction="push")),
            dict(factory="bfs", partition=big, args=[root],
                 kwargs=dict(direction="auto")),
            dict(factory="multi_bfs", partition=big, args=[roots],
                 kwargs=dict(direction="push")),
            dict(factory="multi_bfs", partition=big, args=[roots],
                 kwargs=dict(sr_name="boolean", packed=True,
                             batch_width=len(roots))),
            dict(factory="sssp", partition=big,
                 args=[root, sssp_root.delta], kwargs=dict(slimwork=True)),
            dict(factory="multi_sssp", partition=big,
                 args=[roots, msssp.delta], kwargs={}),
            dict(factory="cc", partition=big, args=[],
                 kwargs=dict(slimwork=True)),
            dict(factory="pagerank", partition=big, args=[0.85, 1e-6],
                 kwargs={}),
        ]
        small_cases = small_dist_cases(paths["k10"], paths["k10s"],
                                       small_roots, delta)
        for c in small_cases:
            if c["args"] == ["root_slot"]:
                c["args"] = [slot_root]
        # (c) besides, a 1 x 1 world on NCCL (the route of a run with a
        # card a rank): each factory once, started once the 2 x 2 world
        # has ended 16b's cases, so that 16b is timed on a quiet card
        big_done = os.path.join(tmp, "16b_done")
        big_cases[-1]["signal"] = big_done
        nccl_cases = [c for c in small_dist_cases(
            paths["k10_1"], paths["k10s_1"], small_roots, delta,
            comms=("allreduce",)) if nccl_case(c)]
        for c in nccl_cases:
            if c["args"] == ["root_slot"]:
                c["args"] = [slot_root]
        stop = threading.Event()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            t0 = time.perf_counter()
            nccl_world = pool.submit(after_file, big_done, stop, launch,
                                     run_cases, (1, 1), ("data", "model"),
                                     (nccl_cases,), backend="nccl",
                                     device=dev, timeout=DIST_TIMEOUT_S)
            try:
                ranks = launch(run_cases, (2, 2), ("data", "model"),
                               (big_cases + small_cases,), backend="gloo",
                               device=dev, timeout=DIST_TIMEOUT_S)
            finally:
                stop.set()
            world_s = time.perf_counter() - t0
            nccl_ranks, nccl_t0, nccl_t1 = nccl_world.result()
            nccl_rows = dist_rows(nccl_ranks, nccl_cases)
            nccl_from, nccl_to = nccl_t0 - t0, nccl_t1 - t0
        rows = dist_rows(ranks, big_cases + small_cases)
        del ranks
        big_rows, small_rows = rows[:len(big_cases)], rows[len(big_cases):]

    # (b) against the single-device results of phases 4b, 5, 8b, 9b and 12b
    names = ("bfs push", "bfs auto", "multi_bfs lane push",
             "multi_bfs packed", "sssp", "multi_sssp", "cc", "pagerank")
    got = {n: r["result"] for n, r in zip(names, big_rows)}
    for n in ("bfs push", "bfs auto"):
        if not np.array_equal(got[n][0], lane_boolean.distances) \
                or int(got[n][1]) != lane_boolean.iterations:
            raise AssertionError(f"[16b] {n}: distances or iterations differ "
                                 "from phase 4b's")
    for n in ("multi_bfs lane push", "multi_bfs packed"):
        if not np.array_equal(got[n][0], push.distances) \
                or int(got[n][1]) != int(push.iterations[0]):
            raise AssertionError(f"[16b] {n}: distances or iterations differ "
                                 "from phase 5's push batch")
    dist, sweeps, buckets = got["sssp"]
    if not np.array_equal(dist, sssp_root.distances) \
            or (int(sweeps), int(buckets)) != (sssp_root.sweeps,
                                               sssp_root.buckets):
        raise AssertionError("[16b] sssp differs from phase 8b's")
    dist, _, sweeps, buckets = got["multi_sssp"]
    if not (np.array_equal(dist, msssp.distances)
            and np.array_equal(sweeps, msssp.sweeps)
            and np.array_equal(buckets, msssp.buckets)):
        raise AssertionError("[16b] multi_sssp differs from phase 9b's")
    if not np.array_equal(got["cc"][0], workloads["cc"].labels) \
            or int(got["cc"][1]) != workloads["cc"].iterations:
        raise AssertionError("[16b] cc differs from phase 12b's")
    pr = types.SimpleNamespace(ranks=got["pagerank"][0],
                               iterations=int(got["pagerank"][1]))
    pr_l1, pr_said = pagerank_close(pr, workloads["pagerank"], 1e-6,
                                    "[16b] dist pagerank")
    log(f"[16b] scale {SCALE}, a 2 x 2 world of four processes sharing the "
        f"card over gloo (collectives through the host), started and run in "
        f"{world_s:.1f} s with 16c; shards written in {save_s:.1f} s")
    for n, r in zip(names, big_rows):
        log(f"[16b] {n}: {dist_line(r)}")
    log(f"[16b] held: bfs push and auto == phase 4b (distances, iterations), "
        f"both multi_bfs == phase 5's push batch, sssp == phase 8b "
        f"(distances, sweeps, buckets), multi_sssp == phase 9b (distances, "
        f"sweeps, buckets), cc == phase 12b (labels, sweeps), pagerank within "
        f"PR_* of phase 12b's fused run (L1 {pr_l1:.3e}"
        f"{'; ' + pr_said if pr_said else ', sweeps equal'})")
    launches_b = launch_sum(big_rows)
    missing = [k for k in DIST_16B_KERNELS if not launches_b.get(k)]
    if missing:
        raise AssertionError(f"[16b] kernels never ran on the path: {missing}"
                             f" ({launches_b})")
    log(f"[16b] launches over the eight calls, four ranks, counted from "
        f"zero: {launches_b}")

    # (c)
    n_small = check_small_dist(small_rows, refs, "[16c] 2 x 2 gloo")
    n_nccl = check_small_dist(nccl_rows, refs, "[16c] 1 x 1 nccl")
    launches_c = launch_sum(small_rows)
    missing = [k for k in DIST_16C_KERNELS if not launches_c.get(k)]
    if missing:
        raise AssertionError(f"[16c] kernels never ran on the path: {missing}"
                             f" ({launches_c})")
    small_s = sum(max(r["seconds"]) for r in small_rows)
    comm_s = sum(max(r["comm_s"]) for r in small_rows)
    log(f"[16c] kronecker(10, 8) C=8 L=32, 2 x 2 gloo: {n_small} cases "
        f"(bfs and multi_bfs 4 semirings x push / pull / auto, packed, "
        f"sssp at the default delta and inf, multi_sssp, cc, pagerank, "
        f"brandes, khop lane x 3 directions and packed, x allreduce and "
        f"reduce_gather; the sliced BFS in float32, bfloat16, int16) == the "
        f"single-device port on the card; {small_s:.2f} s, collectives "
        f"{comm_s:.2f} s; launches {launches_c}")
    log(f"[16c] 1 x 1 world on NCCL, started once the 2 x 2 world had "
        f"ended 16b's cases (beside its 16c cases): {n_nccl} cases (each "
        f"factory once) == the same; ran from {nccl_from:.1f} s to "
        f"{nccl_to:.1f} s after the 2 x 2 world started; launches "
        f"{launch_sum(nccl_rows)}")
    for r in table:
        if launches_b.get(r["name"]):
            r["phase16b_launches"] = launches_b[r["name"]]
        if launches_c.get(r["name"]):
            r["phase16c_launches"] = launches_c[r["name"]]
    return {"16b": launches_b, "16c": launches_c, "shards": shards}


# ---------------------------------------------------------------- phase 17

# the kernels phase 17c's sanitized runs at scale 20 must launch (the 2g and
# bag kernels run sanitized at scale 14 beside them)
ANALYSIS_17C_KERNELS = ("slimsell_spmv", "slimsell_spmv_wts", "slimsell_spmm",
                        "slimsell_spmm_wts", "slimsell_pull",
                        "slimsell_pull_mm", "slimsell_spmv_packed",
                        "slimsell_spmm_packed")
ANALYSIS_17D_KERNELS = ("slimsell_spmv", "slimsell_spmv_wts",
                        "slimsell_spmm")


def corrupt_copy(tiled, kind: str):
    """A copy of a device layout with one corrupt field (the layout itself
    untouched) and the message the sanitizer must raise for it."""
    live = int(torch.nonzero(tiled.cols.reshape(-1) >= 0)[0])
    if kind == "column n + 7":
        cols = tiled.cols.clone()
        cols.view(-1)[live] = tiled.n + 7
        return dataclasses.replace(tiled, cols=cols), "out-of-bounds vertex ids"
    if kind == "NaN weight":
        wts = tiled.wts.clone()
        wts.view(-1)[live] = float("nan")
        return dataclasses.replace(tiled, wts=wts), "NaN/inf/negative"
    tp = tiled.tile_ptr.clone()           # "tile_ptr past T"
    tp[tiled.n_chunks // 2] = tiled.n_tiles + 5
    return dataclasses.replace(tiled, tile_ptr=tp), "tile_ptr is not"


def analysis_phase(*, dev, card, tiled, root, roots, lane_boolean, push,
                   sssp_root, msssp, workloads, shards, small, errs, table):
    """Phase 17: the analysis layer and the sanitizer on the card. (a) the
    semiring probe against the port's table and the laws on the probe's
    tables, an unknown code refused; (b) the contracts on the work lists the
    kernels read (the scale-20 layout's, its 2 x 2 blocks'); (c) sanitized
    runs at scale 20 against unsanitized ones, bit-equal and timed beside
    each other, the GCN and bag kernels sanitized at scale 14, and corrupt
    copies of the scale-14 layout refused before any launch; (d) a 2 x 2
    gloo world sanitized against unsanitized, and a corrupt shard failing
    its launch. Returns the launches of (c)'s sanitized scale-20 runs."""
    import tempfile
    from repro_torch.analysis import contracts, laws
    from repro_torch.core import debug, semiring
    from repro_torch.core.bfs import bfs
    from repro_torch.core.cc import cc
    from repro_torch.core.dist_bfs import (partition_slimsell, run_cases,
                                           save_partition)
    from repro_torch.core.multi_bfs import multi_source_bfs
    from repro_torch.core.multi_sssp import multi_source_sssp
    from repro_torch.core.options import EngineConfig
    from repro_torch.core.pagerank import pagerank
    from repro_torch.core.sssp import sssp
    from repro_torch.distributed import launch
    from repro_torch.graphs.generators import kronecker, with_random_weights
    from repro_torch.kernels import ops
    from repro_torch.profile_spmm import time_ms

    # (a) the CUDA table on the card against the port's, and its laws
    t0 = time.perf_counter()
    ops.reset_launches()
    failures = laws.cross_check_kernel_tables() + laws.cross_check_probe(dev)
    torch.cuda.synchronize()
    probe_launches = ops.launch_counts()["semiring_probe"]
    if failures:
        raise AssertionError(f"[17a] the kernel table: {failures}")
    if not probe_launches:
        raise AssertionError("[17a] semiring_probe never ran")
    try:
        laws.probe(11, torch.zeros(2, device=dev))
        raise AssertionError("[17a] the probe took unknown code 11")
    except RuntimeError as e:
        refused = str(e)
    x = laws.value_domain(semiring.TROPICAL).to(dev)
    got = laws.probe(semiring.TROPICAL.code, x)
    want = laws.table_on(semiring.TROPICAL, x)
    errs["semiring_probe"] = max(float(torch.where(
        laws.same(got[k], want[k]), 0.0,
        (got[k].double() - want[k].double()).abs()).max()) for k in want)
    ms = time_ms(lambda: laws.probe(semiring.TROPICAL.code, x), 50)
    plain_ms = time_ms(lambda: laws.table_on(semiring.TROPICAL, x), 50)
    n = x.numel()
    moved = 4 * (n + 1 + n + n * n)           # values in; zero, edge, add out
    ops_needed = n * n + n
    bound_ms = 1e3 * max(moved / HBM_BYTES_PER_S, ops_needed / F32_OPS_PER_S)
    source, replaces = KERNEL_INFO["semiring_probe"]
    table.append({
        "name": "semiring_probe", "route": "cuda", "source": source,
        "replaces": replaces, "launches": probe_launches,
        "max_abs_err": errs["semiring_probe"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes" if moved / HBM_BYTES_PER_S
        >= ops_needed / F32_OPS_PER_S else "operations", "library_ms": None,
        "semiring": "tropical", "bytes": moved,
        "note": "the analysis layer's probe of the CUDA semiring table, not "
                "a ported TPU kernel: it replaces the JAX package's "
                "behavioural check of semiring_ops"})
    log(f"[17a] semiring_probe: the CUDA table (semiring.cuh) == the port's "
        f"table exactly for codes 0, 1, 2, 3, 5 on their domains; the laws "
        f"hold on the probe's tables (associativity and distributivity "
        f"through second launches over the first one's results); the "
        f"source's enum, structs and dispatch cases == the port's; unknown "
        f"code refused ({refused.split(':', 1)[1].strip()}); "
        f"{probe_launches} launches; one launch {ms:.4f} ms, the port's "
        f"table {plain_ms:.4f} ms on {card}; "
        f"{time.perf_counter() - t0:.1f} s")

    # (b) the contracts on the work lists the kernels read
    t0 = time.perf_counter()
    failures = contracts.check_layout_work(f"scale {SCALE}", tiled)
    sizes = {"layout": (int(tiled.spmm_work[2][0].shape[0]),
                        int(tiled.spmv_work[2][0].shape[0]))}
    for (i, j), local in shards.items():
        failures += contracts.check_layout_work(f"block ({i}, {j})", local)
        sizes[f"block ({i}, {j})"] = (int(local.spmm_work[2][0].shape[0]),
                                      int(local.spmv_work[2][0].shape[0]))
    contract_s = time.perf_counter() - t0
    if failures:
        raise AssertionError(f"[17b] contract violations: {failures[:10]}")
    log(f"[17b] contracts hold on the work lists the kernels read (bounds, "
        f"coverage below cl, one writer a row and a partial slot, folds in "
        f"piece order): the scale-{SCALE} layout's spmm_work and spmv_work "
        f"({tiled.n_chunks} chunks) and blocks (0, 0) and (1, 1) of its "
        f"2 x 2 partition (padding tiles past cl); (pieces, items) "
        f"{sizes}; {contract_s:.2f} s on the host")

    # (c) sanitized against unsanitized at scale 20
    E = EngineConfig
    runs = {
        "bfs push": (lambda c: bfs(tiled, root, config=c, device=dev),
                     ("distances", "iterations"), E()),
        "bfs auto": (lambda c: bfs(tiled, root, config=c, device=dev),
                     ("distances", "iterations"), E(direction="auto")),
        "bfs hostloop auto": (
            lambda c: bfs(tiled, root, config=c, device=dev),
            ("distances", "iterations", "work_log"),
            E(direction="auto", mode="hostloop")),
        "packed bfs": (
            lambda c: bfs(tiled, root, "boolean", packed=True, config=c,
                          device=dev), ("distances", "iterations"), E()),
        "multi_bfs lane": (
            lambda c: multi_source_bfs(tiled, roots, config=c, device=dev),
            ("distances", "iterations"), E()),
        "multi_bfs pull": (
            lambda c: multi_source_bfs(tiled, roots, config=c, device=dev),
            ("distances", "iterations"), E(direction="pull")),
        "multi_bfs packed": (
            lambda c: multi_source_bfs(tiled, roots, "boolean", packed=True,
                                       config=c, device=dev),
            ("distances", "iterations"), E()),
        "sssp": (lambda c: sssp(tiled, root, delta=sssp_root.delta, config=c,
                                device=dev),
                 ("distances", "sweeps", "buckets"), E()),
        "multi_sssp": (lambda c: multi_source_sssp(
            tiled, roots, delta=msssp.delta, config=c, device=dev),
            ("distances", "sweeps", "buckets"), E()),
        "cc": (lambda c: cc(tiled, config=c, device=dev),
               ("labels", "iterations"), E()),
        "pagerank": (lambda c: pagerank(tiled, config=c, device=dev), None,
                     E()),
    }
    t0 = time.perf_counter()
    secs = {name: {False: [], True: []} for name in runs}

    def timed(name, fn, cfg, sanitize):
        with (debug.checked() if sanitize else debug.suspended()):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(cfg)
            torch.cuda.synchronize()
        secs[name][sanitize].append(time.perf_counter() - t1)
        return out

    # the main path of the phase: every run sanitized, counted from zero
    ops.reset_launches()
    sanitized = {name: timed(name, fn, cfg, True)
                 for name, (fn, _, cfg) in runs.items()}
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    missing = [k for k in ANALYSIS_17C_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"[17c] kernels never ran sanitized: {missing}")
    plain = {name: timed(name, fn, cfg, False)
             for name, (fn, _, cfg) in runs.items()}
    for name, (_, fields, _) in runs.items():
        if fields is None:
            pagerank_close(sanitized[name], plain[name], 1e-6,
                           f"[17c] sanitized pagerank at scale {SCALE}")
        else:
            same_fields(sanitized[name], plain[name], fields,
                        f"[17c] {name} sanitized vs unsanitized")
    # and the earlier phases' results where the run is theirs
    for name in ("bfs push", "bfs auto", "bfs hostloop auto", "packed bfs"):
        same_fields(plain[name], lane_boolean, ("distances", "iterations"),
                    f"[17c] {name} vs phase 4b")
    for name in ("multi_bfs lane", "multi_bfs packed", "multi_bfs pull"):
        same_fields(plain[name], push, ("distances",),
                    f"[17c] {name} vs phase 5")
    same_fields(plain["sssp"], sssp_root, ("distances", "sweeps", "buckets"),
                "[17c] sssp vs phase 8b")
    same_fields(plain["multi_sssp"], msssp, ("distances", "sweeps",
                                             "buckets"),
                "[17c] multi_sssp vs phase 9b")
    same_fields(plain["cc"], workloads["cc"], ("labels",),
                "[17c] cc vs phase 12b")
    # more rounds, each pair in the other order than the one before: one
    # for a call of 0.1 s or more, four for a shorter one (the host clock's
    # noise weighs more there)
    for name, (fn, _, cfg) in runs.items():
        for r in range(1 if secs[name][False][0] >= 0.1 else 4):
            for s in ((False, True) if r % 2 == 0 else (True, False)):
                timed(name, fn, cfg, s)
        plain_s = float(np.median(secs[name][False]))
        san_s = float(np.median(secs[name][True]))
        log(f"[17c] {name}: unsanitized {plain_s * 1e3:.1f} ms, sanitized "
            f"{san_s * 1e3:.1f} ms ({san_s / plain_s:.3f}x; medians of "
            f"{len(secs[name][True])} each, in turns) on {card}")
    with debug.checked():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        debug.check_layout(tiled)
        torch.cuda.synchronize()
        layout_ms = (time.perf_counter() - t1) * 1e3
    log(f"[17c] scale {SCALE}: every sanitized run == its unsanitized twin "
        f"(bit for bit; pagerank within PR_*), and == phases 5, 8b, 9b, 12b "
        f"where the run is theirs; one check_layout over {tiled.n_tiles} "
        f"tiles and wts {layout_ms:.1f} ms; sanitized launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")

    # the GCN and bag kernels sanitized at scale 14: the layout checked, the
    # operands' gathers bounded, the results' finiteness read
    real = semiring.REAL
    g17 = torch.Generator(device=dev).manual_seed(17)
    X = torch.randn(small.n, 16, generator=g17, device=dev)
    deg = small.deg.float()
    with debug.checked():
        debug.check_layout(small)
        y = ops.spmm(real, small, X, deg=deg)
        debug.check_sweep(real, y)
        tab = torch.randn(1000, 64, generator=g17, device=dev)
        bags = torch.randint(-1, 1000, (512, 4), generator=g17, device=dev,
                             dtype=torch.int32)
        debug.check_gather(bags[bags >= 0], tab.shape[0])
        out = ops.embedding_bag(tab, bags)
        debug.check_sweep(real, out)
        bad = bags.clone()
        bad[0, 0] = tab.shape[0] + 5
        try:
            debug.check_gather(bad[bad >= 0], tab.shape[0])
            raise AssertionError("[17c] a bag id past the table passed")
        except debug.SanitizerError:
            pass
    torch.cuda.synchronize()
    log(f"[17c] scale {SMALL_SCALE}: slimsell_spmm_gcn and "
        f"embedding_bag_grouped sanitized (layout, bag ids, finite results); "
        f"a bag id past the table refused")

    # corrupt copies at scale 14, refused on the card before any launch
    refusals = []
    for kind in ("column n + 7", "NaN weight", "tile_ptr past T"):
        bad_layout, match = corrupt_copy(small, kind)
        for mode in ("fused", "hostloop"):
            cfg = E(mode=mode, sanitize=True)
            torch.cuda.synchronize()
            before = ops.launch_counts()
            try:
                if kind == "NaN weight":
                    sssp(bad_layout, 0, delta=0.05, config=cfg, device=dev)
                else:
                    bfs(bad_layout, 0, config=cfg, device=dev)
                raise AssertionError(f"[17c] {kind} {mode}: not refused")
            except debug.SanitizerError as e:
                if match not in str(e):
                    raise AssertionError(f"[17c] {kind} {mode}: {e}")
                said = str(e)
            torch.cuda.synchronize()
            if ops.launch_counts() != before:
                raise AssertionError(f"[17c] {kind} {mode}: a kernel "
                                     "launched on the corrupt copy")
            refusals.append(f"{kind} {mode}: {said}")
        del bad_layout
    for r in refusals:
        log(f"[17c] refused before any launch, counts unchanged: {r}")

    # (d) a 2 x 2 gloo world, each case unsanitized then sanitized, and a
    # corrupt shard under the sanitizer
    t0 = time.perf_counter()
    k10 = with_random_weights(kronecker(10, 8, seed=1), low=2 ** -8, high=1.0,
                              seed=2)
    k10_root = int(np.argmax(k10.deg))
    k10_roots = [int(r) for r in np.random.default_rng(17).choice(
        np.nonzero(k10.deg)[0], 12, replace=False)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_analysis_") as tmp:
        good, bad_path = os.path.join(tmp, "good"), os.path.join(tmp, "bad")
        part = partition_slimsell(k10, 2, 2, C=8, L=32, device=dev)
        save_partition(part, good)
        block = part.cols[0, 1].reshape(-1)
        block[np.flatnonzero(block >= 0)[0]] = part.n_col + 3
        save_partition(part, bad_path)
        cases = [dict(factory=f, partition=good, args=args, kwargs=kw,
                      sanitize=s)
                 for f, args, kw in (
                     ("bfs", [k10_root], {}),
                     ("bfs", [k10_root], {"direction": "auto"}),
                     ("multi_bfs", [k10_roots], {}),
                     ("sssp", [k10_root, 0.25], {"slimwork": True}),
                     ("cc", [], {"slimwork": True}))
                 for s in (False, True)]
        ranks = launch(run_cases, (2, 2), ("data", "model"), (cases,),
                       backend="gloo", device=dev, timeout=DIST_TIMEOUT_S)
        world_s = time.perf_counter() - t0
        for i in range(0, len(cases), 2):
            digests = {r[i]["digest"] for r in ranks} \
                | {r[i + 1]["digest"] for r in ranks}
            if len(digests) != 1:
                raise AssertionError(f"[17d] {cases[i]['factory']} "
                                     f"{cases[i]['kwargs']}: sanitized != "
                                     "unsanitized or the ranks differ")
        d_launches = {}
        for r in ranks:
            for c in r[1::2]:
                for k, v in c["launches"].items():
                    d_launches[k] = d_launches.get(k, 0) + v
        missing = [k for k in ANALYSIS_17D_KERNELS if not d_launches.get(k)]
        if missing:
            raise AssertionError(f"[17d] kernels never ran: {missing}")
        t1 = time.perf_counter()
        try:
            with debug.checked():
                launch(run_cases, (2, 2), ("data", "model"),
                       ([dict(factory="bfs", partition=bad_path,
                              args=[k10_root], kwargs={})],),
                       backend="gloo", device=dev, timeout=DIST_TIMEOUT_S)
            raise AssertionError("[17d] the corrupt shard did not fail the "
                                 "launch")
        except RuntimeError as e:
            if "SanitizerError: SlimSell cols contains out-of-bounds" \
                    not in str(e):
                raise AssertionError(f"[17d] the launch failed otherwise: "
                                     f"{str(e)[-400:]}")
            failed = str(e).splitlines()[0] + " " + str(e).strip() \
                .splitlines()[-1]
        bad_s = time.perf_counter() - t1
    log(f"[17d] kronecker(10, 8) C=8 L=32, a 2 x 2 gloo world on the card: "
        f"bfs push and auto, multi_bfs over 12 roots, sssp, cc, each "
        f"sanitized == unsanitized on every rank ({world_s:.1f} s with the "
        f"start; sanitized launches over the ranks {d_launches}); block "
        f"(0, 1) with a column >= n_x under debug.checked(): {failed} "
        f"({bad_s:.1f} s)")
    for r in table:
        if launches.get(r["name"]):
            r["phase17c_launches"] = launches[r["name"]]
        if d_launches.get(r["name"]):
            r["phase17d_launches"] = d_launches[r["name"]]
    return launches


# ---------------------------------------------------------------- phase 18

# training's bounds, fixed before the first card run. 18a: kernel 7's
# table gradients under autograd against autograd of its plain version on
# the card (both scatter with index_add_, whose atomics add in no fixed
# order), relative to the sum of the magnitudes a row receives, to which a
# float32 sum's rounding scales (rows here take up to 12,288 bag gradients
# and their sum may cancel); 2g's X gradients within phase 10's 1e-5; a
# Muon step of a stacked leaf: its orthogonalised update (the weights' step
# over lr * scale) within the CPU test's bound on _newton_schulz (the
# bfloat16 products' float32 sums the card adds in another order, and one
# bfloat16 rounding that lands the other way moves the update by ~1e-2
# after five iterations), the momentum bit-equal. 18b: step 1 of the SlimSell GCN against
# the same step on the segment aggregation. 18c / 18d: a DLRM step with
# kernel 7 against the same step with the plain lookups (the forward adds
# in the same order, so the loss differs only by the atomics of neither;
# the gradient's norm by index_add_'s order), and a resumed DLRM run
# against an uninterrupted one
TRAIN_BAG_TOL = 1e-5
TRAIN_GCN_TOL = 1e-4
TRAIN_MUON_TOL = dict(rtol=2e-2, atol=2e-2)
TRAIN_DLRM_LOSS_RTOL = 1e-6
TRAIN_DLRM_NORM_RTOL = 1e-4
TRAIN_STEPS = 5
TRAIN_SPLIT_STEPS = 3


def step_times(step, params, state, batches, n: int):
    """``n`` steps of ``step``, each timed by the host clock around a
    synchronised call: the weights, the state, each step's metrics (loss
    and grad norm as floats) and seconds."""
    metrics, secs = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[i % len(batches)])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return params, state, metrics, secs


def check_trees_close(got, want, what: str, tol: float) -> float:
    """Every leaf within rtol = atol = ``tol``; returns the max abs err."""
    from repro_torch import pytree
    err = 0.0
    for a, b in zip(pytree.leaves(got), pytree.leaves(want)):
        a, b = a.detach(), b.detach()
        err = max(err, max_abs_err(a, b))
        if not torch.allclose(a.double(), b.double(), rtol=tol, atol=tol):
            raise AssertionError(f"{what}: not within {tol} (max abs err "
                                 f"{max_abs_err(a, b)})")
    return err


def bag_grads_close(got, want, magnitude, what: str) -> float:
    """Table gradients: ``|got - want| <= TRAIN_BAG_TOL * magnitude``, the
    magnitude the sum of ``|bag gradient|`` each element received (the
    plain version's gradient for the absolute output gradients). Returns
    the largest error over that magnitude."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"bag_lookup gradient not finite: {what}")
    rel = float(((got - want).abs() / magnitude.clamp_min(1e-30)).max())
    if rel > TRAIN_BAG_TOL:
        raise AssertionError(f"bag_lookup gradient: {what}: error {rel:.3e} "
                             f"of the magnitude, bound {TRAIN_BAG_TOL}")
    return rel


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def train_gcn_phase(*, dev, card, csr, tiled, gcn_layouts, errs, table):
    """Phase 18a and 18b: the two kernels' autograd routes and a Muon step
    on the card, then gcn-cora trained at scale 20 on phase 10b's
    features."""
    from repro_torch import optim, pytree
    from repro_torch.configs.gcn_cora import gcn_model_flops, make_config
    from repro_torch.core.formats import is_symmetric
    from repro_torch.core.semiring import REAL
    from repro_torch.core.spmv import spmm_plain
    from repro_torch.kernels import autograd, ops
    from repro_torch.kernels.ref import embedding_bag_grouped_ref
    from repro_torch.models.gnn import gcn_init, gcn_loss
    from repro_torch.train import make_train_step

    # (a) 2g's X gradient: the same sweep over the output's gradient
    gen = torch.Generator(device=dev).manual_seed(18)
    n_2g = 0
    for lname, t in gcn_layouts.items():
        deg = t.deg.float()
        if not is_symmetric(t):
            raise AssertionError(f"{lname}: the layout is not symmetric")
        for width in (1, 16, 33):
            X = torch.randn((t.n, width), generator=gen, device=dev)
            R = torch.randn((t.n, width), generator=gen, device=dev)
            before = ops.SPMM_GCN.launches
            Xa = X.clone().requires_grad_(True)
            got, = torch.autograd.grad(
                (autograd.gcn_aggregate(t, Xa, deg) * R).sum(), [Xa])
            if ops.SPMM_GCN.launches != before + 2:
                raise AssertionError("gcn_aggregate: not one launch forward "
                                     "and one backward")
            Xb = X.clone().requires_grad_(True)
            want, = torch.autograd.grad(
                (spmm_plain(REAL, t, Xb, deg=deg) * R).sum(), [Xb])
            check_close("slimsell_spmm_gcn", got, want, errs,
                        f"X gradient, {lname} B={width}", 1e-5)
            n_2g += 1
    t = next(iter(gcn_layouts.values()))
    try:
        autograd.gcn_aggregate(t, torch.ones((t.n, 1), device=dev,
                                             requires_grad=True),
                               t.deg.float().requires_grad_(True))
        raise AssertionError("gcn_aggregate took a deg that requires grad")
    except ValueError as e:
        deg_refused = str(e)
    # kernel 7's table gradients: index_add_ of the bags' gradients
    g18 = np.random.default_rng(18)
    bag_err, n_bag = 0.0, 0
    for V, d, B, K in BAG_CASES:
        tab = torch.from_numpy(g18.standard_normal((V, d)).astype(
            np.float32)).to(dev)
        for mode in ("sum", "mean"):
            ids = bag_ids(V, (B, 1, K), 0.3, g18)
            ids[0, 0, :] = -1
            bags = torch.from_numpy(ids).to(dev)
            R = torch.randn((B, 1, d), generator=gen, device=dev)
            ta = [tab.clone().requires_grad_(True)]
            before = ops.EMBEDDING_BAG_GROUPED.launches
            out = autograd.bag_lookup(ta, bags, mode)
            got, = torch.autograd.grad(out, ta, grad_outputs=R)
            if ops.EMBEDDING_BAG_GROUPED.launches != before + 1:
                raise AssertionError("bag_lookup: not one launch")
            tb = [tab.clone().requires_grad_(True)]
            ref = embedding_bag_grouped_ref(tb, bags, mode)
            want, mag = (torch.autograd.grad(ref, tb, grad_outputs=r,
                                             retain_graph=True)[0]
                         for r in (R, R.abs()))
            check_equal("embedding_bag_grouped", out.detach(), ref.detach(),
                        errs, f"bag_lookup forward V={V} {mode}")
            bag_err = max(bag_err, bag_grads_close(
                got, want, mag, f"V={V} d={d} B={B} K={K} {mode}"))
            n_bag += 1
    vocabs = (100, 3, 1000, 17, 50)
    tabs = [torch.from_numpy(g18.standard_normal((v, 128)).astype(
        np.float32)).to(dev) for v in vocabs]
    ids = np.stack([bag_ids(v, (4096, 3), 0.2, g18) for v in vocabs], 1)
    ids[7, 4, 1] = vocabs[4]                      # an id past its table
    bags = torch.from_numpy(ids).to(dev)
    for mode in ("sum", "mean"):
        R = torch.randn((4096, len(vocabs), 128), generator=gen, device=dev)
        ta = [x.clone().requires_grad_(True) for x in tabs]
        got = torch.autograd.grad(autograd.bag_lookup(ta, bags, mode), ta,
                                  grad_outputs=R)
        tb = [x.clone().requires_grad_(True) for x in tabs]
        ref = embedding_bag_grouped_ref(tb, bags, mode)
        want = torch.autograd.grad(ref, tb, grad_outputs=R, retain_graph=True)
        mag = torch.autograd.grad(ref, tb, grad_outputs=R.abs())
        for i, (a, b, m) in enumerate(zip(got, want, mag)):
            bag_err = max(bag_err, bag_grads_close(
                a, b, m, f"5 tables, table {i}, {mode}"))
        n_bag += 1
    # one Muon step of a stacked leaf, the card against the CPU: the
    # orthogonalised update, o = (p - p') / (lr * scale)
    p0 = g18.standard_normal((3, 64, 32)).astype(np.float32) * 0.1
    gr = g18.standard_normal((3, 64, 32)).astype(np.float32)
    muon_out = {}
    step_scale = 0.02 * (64 / 32) ** 0.5         # muon()'s lr, the shape's
    for d in ("cpu", dev):
        p = {"w": torch.tensor(p0, device=d)}
        opt = optim.muon()
        st = opt.init(p)
        opt.update({"w": torch.tensor(gr, device=d)}, st, p,
                   torch.zeros((), dtype=torch.int32, device=d))
        muon_out[str(d)] = ((torch.tensor(p0) - p["w"].cpu()) / step_scale,
                            st["w"]["mom"].cpu(), p["w"].cpu())
    muon_err = max_abs_err(muon_out[str(dev)][0], muon_out["cpu"][0])
    muon_w_err = max_abs_err(muon_out[str(dev)][2], muon_out["cpu"][2])
    if not torch.allclose(muon_out[str(dev)][0], muon_out["cpu"][0],
                          **TRAIN_MUON_TOL) or not bits_equal(
            muon_out[str(dev)][1], muon_out["cpu"][1]):
        raise AssertionError(f"muon step: card != CPU (update max abs err "
                             f"{muon_err})")
    torch.cuda.synchronize()
    log(f"[18a] gcn_aggregate (2g under autograd): X gradient == autograd "
        f"of the plain version within 1e-5 on {n_2g} cases ({', '.join(gcn_layouts)}; "
        f"B=1/16/33), one launch forward and one backward; deg requiring "
        f"grad refused ({deg_refused!r}); bag_lookup (7 under autograd): "
        f"forward == plain bit for bit, table gradients within "
        f"{TRAIN_BAG_TOL} of the summed magnitudes of autograd of the plain "
        f"version on {n_bag} cases (BAG_CASES sum and mean with pads; 5 "
        f"tables, an id past its table), largest {bag_err:.3e}; muon step of a [3, 64, 32] leaf card == "
        f"CPU, its orthogonalised update within rtol = atol = 2e-2 (max "
        f"abs err {muon_err:.3e}; the weights' {muon_w_err:.3e}), "
        f"bfloat16 momentum bit-equal")

    # (b) gcn-cora trained at scale 20 on phase 10b's features
    cfg = make_config()
    slim = dataclasses.replace(cfg, aggregation="slimsell")
    seg = dataclasses.replace(cfg, aggregation="segment")
    n = tiled.n
    t0 = time.perf_counter()
    symmetric = is_symmetric(tiled)
    sym_s = time.perf_counter() - t0
    if not symmetric:
        raise AssertionError(f"the scale-{SCALE} layout is not symmetric")
    feat = torch.randn((n, cfg.d_in), generator=torch.Generator(
        device=dev).manual_seed(10), device=dev)
    batch = gcn_batch(csr, feat, tiled, dev)
    gl = torch.Generator(device=dev).manual_seed(18)
    batch["labels"] = torch.randint(0, cfg.n_classes, (n,), generator=gl,
                                    device=dev, dtype=torch.int32)
    n_train = round(0.05 * n)
    mask = torch.zeros(n, device=dev)
    mask[torch.randperm(n, generator=gl, device=dev)[:n_train]] = 1.0
    batch["train_mask"] = mask
    params = gcn_init(cfg, generator=torch.Generator().manual_seed(11),
                      device=dev)
    seg_params = {"w": [w.clone() for w in params["w"]]}
    steps = {}
    for name, c in (("slimsell", slim), ("segment", seg)):
        steps[name] = make_train_step(
            lambda p, b, c=c: gcn_loss(p, b, c, device=dev), optim.adamw(),
            grad_clip=1.0)
    seg_step, seg_init = steps["segment"]
    seg_params, _, seg_m, _ = step_times(seg_step, seg_params,
                                         seg_init(seg_params), [batch], 1)
    slim_step, slim_init = steps["slimsell"]
    state = slim_init(params)
    ops.reset_launches()
    params, state, metrics, secs = step_times(slim_step, params, state, [batch],
                                              1)
    step1 = {"w": [w.detach().clone() for w in params["w"]]}
    params, state, more, more_s = step_times(slim_step, params, state, [batch],
                                             TRAIN_STEPS - 1)
    metrics += more
    secs += more_s
    counts = ops.launch_counts()
    if counts["slimsell_spmm_gcn"] != 4 * TRAIN_STEPS or any(
            v for k, v in counts.items() if k != "slimsell_spmm_gcn"):
        raise AssertionError(f"GCN training: launches {counts} over "
                             f"{TRAIN_STEPS} steps, want slimsell_spmm_gcn "
                             f"four a step and nothing else")
    if not all(np.isfinite(m).all() for m in metrics):
        raise AssertionError(f"GCN training: metrics not finite: {metrics}")
    loss_err = abs(metrics[0][0] - seg_m[0][0])
    norm_err = abs(metrics[0][1] - seg_m[0][1])
    for what, a, b in (("loss", metrics[0][0], seg_m[0][0]),
                       ("grad norm", metrics[0][1], seg_m[0][1])):
        if abs(a - b) > TRAIN_GCN_TOL * (1 + abs(b)):
            raise AssertionError(f"GCN step 1 {what}: slimsell {a!r}, "
                                 f"segment {b!r}")
    w_err = check_trees_close(step1, seg_params, "GCN step 1 weights, "
                              "slimsell vs segment", TRAIN_GCN_TOL)
    med = float(np.median(secs[1:]))
    flops = gcn_model_flops(cfg, n, int(csr.indices.size), cfg.d_in)
    gcn_row = {"steps": TRAIN_STEPS, "step_ms": 1e3 * med,
               "step_ms_each": [1e3 * s for s in secs],
               "nodes_per_s": n / med, "tflops": flops / med / 1e12,
               "model_flops": flops, "losses": [m[0] for m in metrics],
               "grad_norms": [m[1] for m in metrics],
               "step1_vs_segment_max_abs_err": {"loss": loss_err,
                                                "grad_norm": norm_err,
                                                "weights": w_err},
               "symmetric_check_s": sym_s}
    log(f"[18b] gcn-cora trained at scale {SCALE} (n={n}, nnz="
        f"{int(csr.indices.size)}, d_in {cfg.d_in} -> {cfg.d_hidden} -> "
        f"{cfg.n_classes}; labels uniform on [0, {cfg.n_classes}), "
        f"train_mask {n_train} vertices; AdamW, clip 1.0): {TRAIN_STEPS} "
        f"slimsell steps, losses {[round(m[0], 6) for m in metrics]}, grad "
        f"norms {[round(m[1], 6) for m in metrics]}; launches "
        f"slimsell_spmm_gcn={counts['slimsell_spmm_gcn']} (4 a step); "
        f"step 1 == segment within {TRAIN_GCN_TOL} (loss {loss_err:.3e}, "
        f"grad norm {norm_err:.3e}, weights {w_err:.3e}); layout symmetric "
        f"(checked in {sym_s:.3f} s)")
    log(f"[18b] warm step, median of {len(secs) - 1}: {med * 1e3:.4f} ms "
        f"({[round(s * 1e3, 4) for s in secs]}), {n / med:.6e} nodes/s, "
        f"{flops / med / 1e12:.4f} TFLOP/s ({flops:.6e} FLOPs a step, "
        f"gcn_model_flops) on {card}")
    for r in table:
        if r["name"] == "slimsell_spmm_gcn":
            r["phase18b_launches"] = counts["slimsell_spmm_gcn"]
            r["training"] = gcn_row
    return gcn_row


def train_dlrm_phase(*, dev, card, errs, table):
    """Phase 18c: DLRM at ``train_batch`` on ``capped_config(2**22)``."""
    from repro_torch import convert, optim, pytree
    from repro_torch.configs.dlrm_mlperf import (RECSYS_SHAPES, capped_config,
                                                 train_flops)
    from repro_torch.data.pipeline import CriteoPipeline
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import embedding_bag_grouped_ref
    from repro_torch.models import dlrm
    from repro_torch.train import make_train_step

    cfg = capped_config(2 ** 22)
    B = RECSYS_SHAPES["train_batch"]["batch"]
    held = torch.cuda.memory_allocated()   # what the earlier phases keep
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dlrm.dlrm_init(cfg, generator=torch.Generator(
        device=dev).manual_seed(18), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    table_bytes = sum(t.numel() * t.element_size() for t in params["tables"])
    t0 = time.perf_counter()
    pipe = CriteoPipeline(cfg.vocabs, B, cfg.multi_hot, seed=18)
    batches = [convert.dlrm_batch_from_arrays(pipe.get_batch(i), device=dev)
               for i in range(TRAIN_STEPS + TRAIN_SPLIT_STEPS)]
    batch_s = time.perf_counter() - t0
    leaves, treedef = pytree.flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    # step 1's loss and gradient norm with the plain lookups, before the
    # optimiser's state exists (its moments would not fit beside a second
    # gradient)
    with plain_lookups(dlrm, embedding_bag_grouped_ref):
        before = ops.launch_counts()
        loss_ref = dlrm.dlrm_loss(params, batches[0], cfg, device=dev)
        grads = torch.autograd.grad(loss_ref, leaves)
        norm_ref = float(optim.global_norm(list(grads)))
        loss_ref = float(loss_ref.detach())
        if ops.launch_counts() != before:
            raise AssertionError("the plain reference step launched a kernel")
    del grads
    torch.cuda.empty_cache()
    opt = optim.adamw()
    step, init = make_train_step(
        lambda p, b: dlrm.dlrm_loss(p, b, cfg, device=dev), opt, grad_clip=1.0)
    state = init(params)
    ops.reset_launches()
    params, state, metrics, secs = step_times(step, params, state, batches,
                                              TRAIN_STEPS)
    counts = ops.launch_counts()
    if counts["embedding_bag_grouped"] != TRAIN_STEPS or any(
            v for k, v in counts.items() if k != "embedding_bag_grouped"):
        raise AssertionError(f"DLRM training: launches {counts} over "
                             f"{TRAIN_STEPS} steps, want embedding_bag_grouped "
                             f"once a step and nothing else")
    if not all(np.isfinite(m).all() for m in metrics):
        raise AssertionError(f"DLRM training: metrics not finite: {metrics}")
    loss_rel = abs(metrics[0][0] - loss_ref) / abs(loss_ref)
    norm_rel = abs(metrics[0][1] - norm_ref) / abs(norm_ref)
    if loss_rel > TRAIN_DLRM_LOSS_RTOL or norm_rel > TRAIN_DLRM_NORM_RTOL:
        raise AssertionError(f"DLRM step 1 against the plain lookups: loss "
                             f"{metrics[0][0]!r} vs {loss_ref!r}, grad norm "
                             f"{metrics[0][1]!r} vs {norm_ref!r}")
    peak = torch.cuda.max_memory_allocated()

    def split_step(batch):
        """One step by parts, CUDA events between them: forward, backward,
        clip, optimiser."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        loss = dlrm.dlrm_loss(params, batch, cfg, device=dev)
        ev[1].record()
        grads = pytree.unflatten(treedef, list(torch.autograd.grad(loss, leaves)))
        ev[2].record()
        optim.clip_by_global_norm(grads, 1.0)
        ev[3].record()
        opt.update(grads, state["opt"], params, state["step"])
        state["step"] = state["step"] + 1
        ev[4].record()
        ev[4].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    before = ops.EMBEDDING_BAG_GROUPED.launches
    parts = np.median([split_step(batches[TRAIN_STEPS + i])
                       for i in range(TRAIN_SPLIT_STEPS)], axis=0)
    if ops.EMBEDDING_BAG_GROUPED.launches != before + TRAIN_SPLIT_STEPS:
        raise AssertionError("the split steps did not launch kernel 7 once each")
    med = float(np.median(secs[1:]))
    flops = train_flops(cfg, B)
    row = {"batch": B, "rows": sum(cfg.vocabs), "table_bytes": table_bytes,
           "steps": TRAIN_STEPS, "step_ms": 1e3 * med,
           "step_ms_each": [1e3 * s for s in secs],
           "samples_per_s": B / med, "tflops": flops / med / 1e12,
           "model_flops": flops, "peak_bytes": peak, "held_before_bytes": held,
           "losses": [m[0] for m in metrics],
           "grad_norms": [m[1] for m in metrics],
           "step1_vs_plain_rel": {"loss": loss_rel, "grad_norm": norm_rel},
           "forward_ms": parts[0], "backward_ms": parts[1],
           "clip_ms": parts[2], "optimiser_ms": parts[3],
           "init_s": init_s, "batches_s": batch_s}
    log(f"[18c] {cfg.name} capped at 2^22 rows a table: {sum(cfg.vocabs)} "
        f"rows, tables {table_bytes} bytes, initialised on the card in "
        f"{init_s:.2f} s; {len(batches)} CriteoPipeline batches of {B} made "
        f"in {batch_s:.2f} s; {TRAIN_STEPS} steps (AdamW, clip 1.0): losses "
        f"{[round(m[0], 6) for m in metrics]}, grad norms "
        f"{[round(m[1], 6) for m in metrics]}; launches "
        f"embedding_bag_grouped={counts['embedding_bag_grouped']} (one a "
        f"step); step 1 against the plain lookups: loss rel err "
        f"{loss_rel:.3e} (bound {TRAIN_DLRM_LOSS_RTOL}), grad norm rel err "
        f"{norm_rel:.3e} (bound {TRAIN_DLRM_NORM_RTOL})")
    log(f"[18c] warm step, median of {len(secs) - 1}: {med * 1e3:.4f} ms "
        f"({[round(s * 1e3, 4) for s in secs]}), {B / med:.6e} samples/s, "
        f"{flops / med / 1e12:.4f} TFLOP/s ({flops:.6e} FLOPs a step, "
        f"3 B flops_mlp); CUDA events (median of {TRAIN_SPLIT_STEPS}): "
        f"forward {parts[0]:.4f} ms, backward {parts[1]:.4f} ms, clip "
        f"{parts[2]:.4f} ms, optimiser {parts[3]:.4f} ms (sum "
        f"{parts.sum():.4f}); peak device memory {peak / 2**30:.2f} GiB "
        f"({peak} bytes; {held} of them held by the earlier phases) on "
        f"{card}")
    for r in table:
        if r["name"] == "embedding_bag_grouped":
            r["phase18c_launches"] = counts["embedding_bag_grouped"]
            r["training"] = row
    del params, state, batches, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return row


def train_checkpoint_phase(*, dev, card):
    """Phase 18d: save after 2 steps, restore on the card, 2 more steps,
    against 4 uninterrupted steps: a gcn-cora GCN on a graph of Cora's
    shape (bit-equal) and a DLRM at the MLPerf widths with 1,000-row tables
    (within 18c's bounds)."""
    import shutil
    import tempfile

    from repro_torch import convert, optim, pytree
    from repro_torch.checkpoint import store
    from repro_torch.configs.dlrm_mlperf import capped_config
    from repro_torch.configs.gcn_cora import make_config
    from repro_torch.core.formats import build_slimsell
    from repro_torch.data.pipeline import CriteoPipeline
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels import ops
    from repro_torch.models import dlrm
    from repro_torch.models.gnn import gcn_init, gcn_loss
    from repro_torch.train import make_train_step

    gcfg = dataclasses.replace(make_config(), aggregation="slimsell")
    csr = erdos_renyi(2708, 3.9, seed=18)
    g = torch.Generator(device=dev).manual_seed(19)
    feat = torch.randn((csr.n, gcfg.d_in), generator=g, device=dev)
    gbatch = gcn_batch(csr, feat, build_slimsell(csr, C=8, L=16).to_torch(dev),
                       dev)
    gbatch["labels"] = torch.randint(0, gcfg.n_classes, (csr.n,), generator=g,
                                     device=dev, dtype=torch.int32)
    gbatch["train_mask"] = (torch.rand(csr.n, generator=g, device=dev)
                            < 0.05).float()
    dcfg = capped_config(1000)
    pipe = CriteoPipeline(dcfg.vocabs, 4096, dcfg.multi_hot, seed=19)
    dbatches = [convert.dlrm_batch_from_arrays(pipe.get_batch(i), device=dev)
                for i in range(4)]
    models = {
        "gcn": (lambda: gcn_init(gcfg, generator=torch.Generator().manual_seed(
                    19), device=dev),
                lambda p, b: gcn_loss(p, b, gcfg, device=dev), [gbatch]),
        "dlrm": (lambda: dlrm.dlrm_init(dcfg, generator=torch.Generator(
                     device=dev).manual_seed(19), device=dev),
                 lambda p, b: dlrm.dlrm_loss(p, b, dcfg, device=dev),
                 dbatches)}
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    said = []
    ops.reset_launches()
    try:
        for name, (init_params, loss, batches) in models.items():
            step, init = make_train_step(loss, optim.adamw(), grad_clip=1.0)
            p = init_params()
            p, s, whole, _ = step_times(step, p, init(p), batches, 4)
            q = init_params()
            q, t, first, _ = step_times(step, q, init(q), batches, 2)
            ckpt = os.path.join(ckpt_root, name)
            t0 = time.perf_counter()
            store.save(ckpt, 2, (q, t), metadata={"model": name})
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            (q2, t2), meta = store.restore(ckpt, store.latest_step(ckpt),
                                           (q, t), device=dev)
            restore_s = time.perf_counter() - t0
            saved, restored = pytree.leaves((q, t)), pytree.leaves((q2, t2))
            if meta != {"model": name} or len(saved) != len(restored) or not all(
                    bits_equal(a.detach(), b) for a, b in zip(saved, restored)):
                raise AssertionError(f"{name}: a restored tensor differs from "
                                     "the one saved")
            rest = batches[2:] if len(batches) > 1 else batches
            q2, t2, resumed, _ = step_times(step, q2, t2, rest, 2)
            if name == "gcn":
                if resumed != whole[2:] or not all(
                        bits_equal(a.detach(), b.detach()) for a, b in zip(
                            pytree.leaves((q2, t2)), pytree.leaves((p, s)))):
                    raise AssertionError(f"gcn: the resumed run differs from "
                                         f"4 uninterrupted steps: {resumed} "
                                         f"vs {whole[2:]}")
                held = "bit-equal (losses, grad norms, weights, state)"
            else:
                for (l1, n1), (l2, n2) in zip(resumed, whole[2:]):
                    if abs(l1 - l2) > TRAIN_DLRM_LOSS_RTOL * abs(l2) or \
                            abs(n1 - n2) > TRAIN_DLRM_NORM_RTOL * abs(n2):
                        raise AssertionError(f"dlrm: the resumed run's steps "
                                             f"{resumed} vs {whole[2:]}")
                held = (f"losses within rtol {TRAIN_DLRM_LOSS_RTOL}, grad "
                        f"norms within {TRAIN_DLRM_NORM_RTOL}")
            n_bytes = sum(a.numel() * a.element_size() for a in saved)
            said.append(f"{name}: {len(saved)} tensors ({n_bytes} bytes) "
                        f"saved in {save_s:.3f} s, restored in {restore_s:.3f} "
                        f"s bit-equal; steps 3-4 after the restore {held} "
                        f"({[round(x, 6) for x, _ in resumed]} vs "
                        f"{[round(x, 6) for x, _ in whole[2:]]})")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    log(f"[18d] checkpoints (save after 2 steps, restore with device='cuda', "
        f"2 more steps, against 4 uninterrupted): " + "; ".join(said)
        + f"; launches {counts}")
    return counts


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 1
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from repro_torch.configs.sssp_graph500 import WEIGHT_HIGH, WEIGHT_LOW
    from repro_torch.core import direction as dm
    from repro_torch.core import engine, packing, semiring
    from repro_torch.core.bfs import bfs, bfs_spec, packed_bfs_spec
    from repro_torch.core.formats import (build_csr, build_slimsell,
                                          storage_summary)
    from repro_torch.core.multi_bfs import (multi_bfs_spec, multi_source_bfs,
                                            packed_multi_bfs_spec)
    from repro_torch.core.multi_sssp import multi_source_sssp, multi_sssp_spec
    from repro_torch.core.options import EngineConfig
    from repro_torch.core.spmv import (pull_first_hits, pull_mm_plain,
                                       pull_plain, spmm_packed_plain,
                                       spmm_plain, spmv_packed_plain,
                                       spmv_plain)
    from repro_torch.core.sssp import (default_delta, sssp, sssp_spec,
                                       weight_views)
    from repro_torch.graph500 import (batch_teps, run_graph500,
                                      run_graph500_sssp, sample_roots,
                                      validate_bfs_tree, validate_sssp_tree)
    from repro_torch.serving import GraphSession
    from repro_torch.configs.gcn_cora import make_config
    from repro_torch.graphs.generators import (erdos_renyi, kronecker,
                                               with_random_weights)
    from repro_torch.models.gnn import _gcn_aggregate, gcn_forward, gcn_init
    from repro_torch import convert
    from repro_torch.configs.dlrm_mlperf import (RECSYS_SHAPES, capped_config,
                                                 reduced_config)
    from repro_torch.data.pipeline import CriteoPipeline
    from repro_torch.kernels.ref import (embedding_bag_grouped_ref,
                                         embedding_bag_ref)
    from repro_torch.models import dlrm
    from repro_torch.profile_spmm import (chunk_split, pull_split, pull_work,
                                          sssp_sweeps, sweep_times,
                                          tile_slots, time_ms)

    def weighted_kronecker(scale):
        return with_random_weights(kronecker(scale, EDGE_FACTOR, seed=1),
                                   low=WEIGHT_LOW, high=WEIGHT_HIGH, seed=2)
    from repro_torch.kernels import build, ops

    dev = torch.device("cuda")
    card = card_line()
    log(f"[1] card: {card} | torch: {torch.cuda.get_device_name(0)} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = build.build(ptxas_info=True)
    log(f"[2] built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    # ---- 3: each kernel against its plain version, on the card
    rng = np.random.default_rng(0)
    small_csr = weighted_kronecker(SMALL_SCALE)
    small_host = build_slimsell(small_csr, C=8, L=128)
    small = small_host.to_torch(dev)
    errs = {k: 0.0 for k in KERNEL_INFO}
    n_cases = 0
    for name in SEMIRINGS:
        sr = semiring.get(name)
        for mask_name, mask in masks(small, rng, dev).items():
            for B in (None, 1, 5, 64):
                shape = (small.n,) if B is None else (small.n, B)
                x = frontier(sr, shape, rng, dev)
                what = f"{name} B={B} mask={mask_name}"
                if B is None:
                    check_equal("slimsell_spmv", ops.spmv(sr, small, x, tile_mask=mask),
                                spmv_plain(sr, small, x, mask), errs, what)
                else:
                    check_equal("slimsell_spmm", ops.spmm(sr, small, x, tile_mask=mask),
                                spmm_plain(sr, small, x, mask), errs, what)
                n_cases += 1
                for kind in NF_KINDS:
                    nf = not_final(kind, shape, rng, dev)
                    if B is None:
                        check_equal("slimsell_pull",
                                    ops.pull(sr, small, x, nf, tile_mask=mask),
                                    pull_plain(sr, small, x, nf, mask), errs,
                                    f"{what} nf={kind}")
                    else:
                        check_equal("slimsell_pull_mm",
                                    ops.pull_mm(sr, small, x, nf, tile_mask=mask),
                                    pull_mm_plain(sr, small, x, nf, mask), errs,
                                    f"{what} nf={kind}")
                    n_cases += 1
    torch.cuda.synchronize()
    log(f"[3] kernels == plain on {n_cases} cases (scale {SMALL_SCALE}, "
        f"n={small.n}, tiles={small.n_tiles})")
    # the three SpMM entries where one chunk is cut into many pieces: an
    # Erdos-Renyi graph with a vertex joined to all the others
    g3 = np.random.default_rng(3)
    hub_n = 2 ** 14
    er = erdos_renyi(hub_n, 8.0, seed=7)
    er_src = np.repeat(np.arange(hub_n), np.diff(er.indptr))
    hub_edges = np.concatenate([
        np.stack([er_src, er.indices], 1),
        np.stack([np.zeros(hub_n - 1, np.int64), np.arange(1, hub_n)], 1)])
    hub_csr = with_random_weights(build_csr(hub_edges, hub_n), low=WEIGHT_LOW,
                                  high=WEIGHT_HIGH, seed=7)
    hub = build_slimsell(hub_csr, C=8, L=128).to_torch(dev)
    hub_pieces = int(ops.spmm_work(hub.tile_ptr, hub.cl, hub.L,
                                   ops.piece_tiles(hub.L))[1][0, 2])
    hub_masks = masks(hub, g3, dev)
    hub_masks["whole_chunks"] = torch.from_numpy(
        g3.random(hub.n_chunks) < 0.6).to(dev)[hub.row_block.long()]
    hub_deg = hub.deg.float()
    n_cases = 0
    for mask_name, mask in hub_masks.items():
        for width in (1, 5, 16, 33, 64, 97, 160):
            what = f"hub graph B={width} mask={mask_name}"
            for name in SEMIRINGS:
                sr = semiring.get(name)
                Xh = frontier(sr, (hub.n, width), g3, dev)
                check_equal("slimsell_spmm", ops.spmm(sr, hub, Xh, tile_mask=mask),
                            spmm_plain(sr, hub, Xh, mask), errs,
                            f"{what} {name}")
            Xh = sssp_frontier((hub.n, width), 0.5, g3, dev)
            check_equal("slimsell_spmm_wts",
                        ops.spmm(semiring.MINPLUS, hub, Xh, tile_mask=mask,
                                 weights=hub.wts),
                        spmm_plain(semiring.MINPLUS, hub, Xh, mask, hub.wts),
                        errs, what)
            Xh = torch.from_numpy(g3.standard_normal((hub.n, width)).astype(
                np.float32)).to(dev)
            check_close("slimsell_spmm_gcn",
                        ops.spmm(semiring.REAL, hub, Xh, tile_mask=mask,
                                 deg=hub_deg),
                        spmm_plain(semiring.REAL, hub, Xh, mask, deg=hub_deg),
                        errs, what, 1e-5)
            n_cases += len(SEMIRINGS) + 2
    torch.cuda.synchronize()
    log(f"[3] SpMM entries == plain on {n_cases} cases of a hub graph "
        f"(n={hub.n}, the hub's chunk "
        f"{int(hub.tile_ptr[1] - hub.tile_ptr[0])} tiles in {hub_pieces} "
        f"pieces; B=1/5/16/33/64/97/160 x 5 masks): the implicit SpMM in 4 "
        f"semirings and the stored-weight SpMM exactly, the GCN SpMM within "
        f"1e-5")
    # the two SpMV entries on the same graph, whose hub chunk they cut into
    # pieces of their own, at C=8, L=128 and at C=3, L=1 (padding rows in
    # the last chunk), with a mask that keeps one tile of the hub besides;
    # the packed SpMV (5) over the same pieces at both layouts, and the
    # single-source pull (3) at C=8, L=128 (its plain version loops over
    # each tile rank of the longest chunk, 16,383 at L=1: seconds a call)
    n_cases, spmv_pieces = 0, {}
    n_single = {"slimsell_pull": 0, "slimsell_spmv_packed": 0}
    for hname, (C, L) in (("C8 L128", (8, 128)), ("C3 L1", (3, 1))):
        ht = hub if (C, L) == (8, 128) else build_slimsell(
            hub_csr, C=C, L=L).to_torch(dev)
        hm = masks(ht, g3, dev)
        hm["whole_chunks"] = torch.from_numpy(
            g3.random(ht.n_chunks) < 0.6).to(dev)[ht.row_block.long()]
        hm["one_hub_tile"] = torch.zeros(ht.n_tiles, dtype=torch.bool,
                                         device=dev)
        hm["one_hub_tile"][int(ht.tile_ptr[0] + ht.tile_ptr[1]) // 2] = True
        folds = ops.spmv_work(ht.tile_ptr, ht.cl, ht.L,
                              ops.spmv_piece_tiles(ht.L))[2]
        spmv_pieces[hname] = int(folds[0, 2]) if len(folds) else 1
        poisoned = torch.where(ht.cols < 0, -1000.0, ht.wts)
        for mask_name, mask in hm.items():
            what = f"hub graph {hname} SpMV mask={mask_name}"
            for name in SEMIRINGS:
                sr = semiring.get(name)
                xh = frontier(sr, (ht.n,), g3, dev)
                check_equal("slimsell_spmv", ops.spmv(sr, ht, xh, tile_mask=mask),
                            spmv_plain(sr, ht, xh, mask), errs, f"{what} {name}")
            xh = sssp_frontier((ht.n,), 0.5, g3, dev)
            want = spmv_plain(semiring.MINPLUS, ht, xh, mask, ht.wts)
            for w in (ht.wts, poisoned):
                check_equal("slimsell_spmv_wts",
                            ops.spmv(semiring.MINPLUS, ht, xh, tile_mask=mask,
                                     weights=w), want, errs, what)
            n_cases += len(SEMIRINGS) + 2
            for density in (0.02, 0.5):
                xw = packing.pack_bits(torch.from_numpy(
                    g3.random(ht.n) < density).to(dev))
                check_equal("slimsell_spmv_packed",
                            ops.spmv_packed(ht, xw, tile_mask=mask),
                            spmv_packed_plain(ht, xw, mask), errs,
                            f"{what} density={density}")
                n_single["slimsell_spmv_packed"] += 1
            if L > 1:
                for name in SEMIRINGS:
                    sr = semiring.get(name)
                    for kind in ("random", "all"):
                        xh = frontier(sr, (ht.n,), g3, dev)
                        nf = not_final(kind, (ht.n,), g3, dev)
                        check_equal("slimsell_pull",
                                    ops.pull(sr, ht, xh, nf, tile_mask=mask),
                                    pull_plain(sr, ht, xh, nf, mask), errs,
                                    f"{what} {name} nf={kind}")
                        n_single["slimsell_pull"] += 1
        del ht, hm, poisoned
    torch.cuda.synchronize()
    log(f"[3] SpMV entries == plain on {n_cases} cases of the hub graph (the "
        f"hub's chunk in {spmv_pieces} pieces of the SpMV; 6 masks, one "
        f"keeping a single tile of the hub): the implicit SpMV in 4 semirings "
        f"and the stored-weight SpMV (the layout's weights and padding "
        f"weights poisoned to -1000) exactly; on the same pieces "
        f"slimsell_spmv_packed == plain on {n_single['slimsell_spmv_packed']}"
        f" cases (both layouts, 2 densities) and slimsell_pull == plain on "
        f"{n_single['slimsell_pull']} (C8 L128, 4 semirings x nf random and "
        f"all)")
    # the batched pull and the packed SpMM on the same graph, over the
    # SpMV's pieces: the pull's first hit across pieces (its plain version
    # once at B=160, each narrower batch its first columns: the pull is
    # column by column), with the hub's first hit only in its first, a
    # middle or its last piece, or in a middle one and the last with other
    # values; the packed SpMM at C=8, L=128 and C=3, L=1
    n_cases = 0
    hub_items = ops.spmv_work(hub.tile_ptr, hub.cl, hub.L,
                              ops.spmv_piece_tiles(hub.L))[0].tolist()
    hub_rv = hub.row_vertex.cpu().numpy()
    hub_chunk, hub_row = map(int, np.argwhere(hub_rv == 0)[0])
    hub_pieces_pull = sorted(tuple(it) for it in hub_items if it[0] == hub_chunk)
    hub_cols = hub.cols.cpu().numpy()

    def hub_leaves(piece):
        _, t0, n_slots, _ = hub_pieces_pull[piece]
        c = hub_cols[t0:t0 - (-n_slots // hub.L), hub_row].reshape(-1)
        return torch.from_numpy(c[c >= 0])
    last = len(hub_pieces_pull) - 1
    hit_pieces = {"first": [0], "middle": [last // 2], "last": [last],
                  "middle_and_last": [last // 2, last]}
    for name in SEMIRINGS:
        sr = semiring.get(name)
        cases = [(f"mask={m} nf={kind}", mask,
                  frontier(sr, (hub.n, 160), g3, dev),
                  not_final(kind, (hub.n, 160), g3, dev))
                 for m, mask in hub_masks.items() for kind in ("random", "all")]
        for where, pieces in hit_pieces.items():
            Xh = torch.full((hub.n, 160), sr.zero, dtype=sr.dtype)
            for k, piece in enumerate(pieces):
                u = hub_leaves(piece)
                Xh[u] = torch.from_numpy(g3.integers(
                    1, 4, size=(u.numel(), 160)) * 10 ** k).to(sr.dtype)
            cases.append((f"hub's hit in the {where} piece(s)", None,
                          Xh.to(dev), not_final("all", (hub.n, 160), g3, dev)))
        for what, mask, Xh, nf in cases:
            want = pull_mm_plain(sr, hub, Xh, nf, mask)
            for width in (1, 5, 33, 64, 97, 160):
                check_equal("slimsell_pull_mm",
                            ops.pull_mm(sr, hub, Xh[:, :width].contiguous(),
                                        nf[:, :width].contiguous(),
                                        tile_mask=mask),
                            want[:, :width], errs,
                            f"hub graph {name} B={width} {what}")
                n_cases += 1
            if what.startswith("hub's hit"):
                # the single-source pull on the first column: the plain
                # pull is column by column
                check_equal("slimsell_pull",
                            ops.pull(sr, hub, Xh[:, 0].contiguous(),
                                     nf[:, 0].contiguous()),
                            want[:, 0], errs, f"hub graph {name} {what}")
                n_single["slimsell_pull"] += 1
    torch.cuda.synchronize()
    log(f"[3] slimsell_pull_mm == plain on {n_cases} cases of the hub graph "
        f"(the hub's chunk in {len(hub_pieces_pull)} pieces of the SpMV's "
        f"list; 4 semirings x B=1/5/33/64/97/160 x the 5 masks x nf random "
        f"and all, and the hub's first hit only in the first, a middle or "
        f"the last piece, or in a middle and the last with other values); "
        f"slimsell_pull == plain on those hits too, "
        f"{n_single['slimsell_pull']} single-source hub cases in all")
    n_cases = 0
    for hname, (C, L) in (("C8 L128", (8, 128)), ("C3 L1", (3, 1))):
        ht = hub if (C, L) == (8, 128) else build_slimsell(
            hub_csr, C=C, L=L).to_torch(dev)
        hm = masks(ht, g3, dev)
        hm["whole_chunks"] = torch.from_numpy(
            g3.random(ht.n_chunks) < 0.6).to(dev)[ht.row_block.long()]
        for mask_name, mask in hm.items():
            for width in (1, 5, 33, 64, 97, 160):
                for density in (0.02, 0.5):
                    xw = packing.pack_bits(torch.from_numpy(
                        g3.random((ht.n, width)) < density).to(dev), axis=1)
                    check_equal("slimsell_spmm_packed",
                                ops.spmm_packed(ht, xw, tile_mask=mask),
                                spmm_packed_plain(ht, xw, mask), errs,
                                f"hub graph {hname} B={width} "
                                f"density={density} mask={mask_name}")
                    n_cases += 1
        del ht, hm
    torch.cuda.synchronize()
    log(f"[3] slimsell_spmm_packed == plain on {n_cases} cases of the hub "
        f"graph (C=8 L=128 and C=3 L=1, the hub's chunk in {spmv_pieces} "
        f"pieces; B=1/5/33/64/97/160 x 5 masks x 2 densities)")
    del hub, hub_masks, hub_deg, Xh

    # ---- 4a: the kernel path against the plain path at scale 14
    small_roots = sample_roots(small_csr, 64)
    root0 = int(small_roots[0])
    paths = [("bfs", "push", "fused"), ("bfs", "pull", "fused"),
             ("bfs", "auto", "fused"), ("bfs", "auto", "hostloop"),
             ("multi", "push", "fused"), ("multi", "pull", "fused"),
             ("multi", "auto", "fused")]
    plain = (spmv_plain, spmm_plain, pull_plain, pull_mm_plain)
    for name in SEMIRINGS:
        for kind, direction, mode in paths:
            cfg = EngineConfig(direction=direction, mode=mode)
            if kind == "bfs":
                def run():
                    return bfs(small, root0, name, need_parents=True,
                               log_work=True, config=cfg, device=dev)
                fields = ("distances", "parents", "iterations", "work_log",
                          "directions")
            else:
                def run():
                    return multi_source_bfs(small, small_roots, name,
                                            need_parents=True, log_work=True,
                                            config=cfg, device=dev)
                fields = ("distances", "parents", "iterations", "work_log",
                          "pull_cols_log")
            with plain_sweeps(engine, *plain):
                before = ops.launch_counts()
                ref = run()
                if ops.launch_counts() != before:
                    raise AssertionError("the plain reference run launched a kernel")
            got = run()
            for f in fields:
                if not np.array_equal(getattr(ref, f), getattr(got, f)):
                    raise AssertionError(f"kernel path != plain path: {f} of "
                                         f"{kind} {name} {direction} {mode}")
    log(f"[4a] kernel path == plain path at scale {SMALL_SCALE} in 4 "
        f"semirings: {', '.join(' '.join(p) for p in paths)}")

    # ---- the main path at scale 20: phases 4b and 5, counted
    t0 = time.perf_counter()
    csr = weighted_kronecker(SCALE)
    t1 = time.perf_counter()
    host = build_slimsell(csr, C=8, L=128, sigma=csr.n)
    t2 = time.perf_counter()
    tiled = host.to_torch(dev)
    torch.cuda.synchronize()
    log(f"[4] scale {SCALE}: n={csr.n} nnz={csr.nnz} tiles={tiled.n_tiles} "
        f"chunks={tiled.n_chunks} K={tiled.inc_src.numel()} | generate "
        f"{t1 - t0:.1f} s, build_slimsell {t2 - t1:.1f} s, to device "
        f"{time.perf_counter() - t2:.1f} s")
    root = int(sample_roots(csr, 1)[0])
    # the SpMV's work list is built once for a layout, at its first sweep;
    # built here, so that the first timed BFS below does not carry it
    t0 = time.perf_counter()
    spmv_items = ops._spmv_work_on_device(tiled)[0]
    torch.cuda.synchronize()
    log(f"[4] the SpMV's work list: {spmv_items.shape[0]} items, built once "
        f"for the layout in {(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    auto_dirs = lane_boolean = None
    for direction, mode in (("push", "fused"), ("auto", "fused"),
                            ("auto", "hostloop")):
        cfg = EngineConfig(direction=direction, mode=mode)
        for name in SEMIRINGS if mode == "fused" else ("tropical",):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = bfs(tiled, root, name, need_parents=True, log_work=True,
                      config=cfg, device=dev)
            dt = time.perf_counter() - t0
            validate_bfs_tree(csr, root, res.distances, res.parents)
            if (direction, mode, name) == ("auto", "fused", "tropical"):
                auto_dirs = res.directions
            if (direction, mode, name) == ("push", "fused", "boolean"):
                lane_boolean = res
            log(f"[4b] bfs {name} {direction} {mode}: root={root} "
                f"iterations={res.iterations} directions="
                f"{res.directions.tolist()} work_log={res.work_log.tolist()} "
                f"tiles={int(res.work_log.sum())} {dt * 1e3:.1f} ms valid tree")

    spmm_before = ops.launch_counts()["slimsell_spmm"]
    with recorded(GraphSession, "bfs_many") as harness_out:
        rep = run_graph500(scale=SCALE, edge_factor=EDGE_FACTOR, n_roots=64,
                           batch_size=64, semiring="tropical", csr=csr,
                           tiled=tiled, device=dev)
    harness_spmm = ops.launch_counts()["slimsell_spmm"] - spmm_before
    if rep.validated != 64:
        raise AssertionError(f"graph500 validated {rep.validated} of 64 roots")
    log(f"[5] {rep.summary()} batch_s={rep.batch_seconds.tolist()}")
    log(f"[5] push hmean TEPS {rep.harmonic_mean_teps:.6e} on {card}")
    roots = rep.roots
    # the harness's batch went through GraphSession.bfs_many; a direct
    # multi_source_bfs of the same roots, timed beside it, must give the
    # same trees with the same kernel-2 launches
    spmm_before = ops.launch_counts()["slimsell_spmm"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = multi_source_bfs(tiled, roots, "tropical", need_parents=True,
                              device=dev)
    direct_s = time.perf_counter() - t0
    direct_spmm = ops.launch_counts()["slimsell_spmm"] - spmm_before
    (served_batch,) = harness_out
    for i, r in enumerate(served_batch):
        if not (np.array_equal(r.distances, direct.distances[i])
                and np.array_equal(r.parents, direct.parents[i])):
            raise AssertionError(f"root {roots[i]}: the harness's session "
                                 "batch != a direct multi_source_bfs")
    if harness_spmm != direct_spmm:
        raise AssertionError(f"kernel 2 launched {harness_spmm} times for "
                             f"the harness batch, {direct_spmm} for the "
                             "direct call")
    log(f"[5] the harness batch (GraphSession.bfs_many) == a direct "
        f"multi_source_bfs of the 64 roots, parents on (distances and "
        f"parents bit-equal), kernel 2 launches {harness_spmm} == "
        f"{direct_spmm}; harness batch {rep.batch_seconds[0] * 1e3:.1f} ms, "
        f"direct call {direct_s * 1e3:.1f} ms on {card}")
    del harness_out, served_batch, direct
    # the push batch's distances: what run_graph500 just validated against
    # the oracle, and what the other directions must equal
    push = multi_source_bfs(tiled, roots, "tropical", log_work=True, device=dev)
    log(f"[5] push work_log={push.work_log[0][:push.iterations[0]].tolist()}")
    batched = {}
    for direction in ("auto", "pull"):
        cfg = EngineConfig(direction=direction)
        before = ops.launch_counts()
        rep_d = run_graph500(scale=SCALE, edge_factor=EDGE_FACTOR, n_roots=64,
                             batch_size=64, semiring="tropical", csr=csr,
                             tiled=tiled, config=cfg, validate=False,
                             device=dev)
        harness_launches = {k: v - before[k] for k, v in
                            ops.launch_counts().items() if v > before[k]}
        if direction == "pull" and not harness_launches.get(
                "slimsell_pull_mm"):
            raise AssertionError(f"the pull harness batch never launched "
                                 f"kernel 4: {harness_launches}")
        if not np.array_equal(rep_d.roots, roots):
            raise AssertionError("the batches sampled other roots")
        res = multi_source_bfs(tiled, roots, "tropical", need_parents=True,
                               log_work=True, config=cfg, device=dev)
        if not np.array_equal(res.distances, push.distances):
            raise AssertionError(f"{direction} batch distances != push batch")
        n_valid = 0
        for i, r in enumerate(roots):
            validate_bfs_tree(csr, int(r), res.distances[i], res.parents[i],
                              d_ref=push.distances[i])
            n_valid += 1
        it = int(res.iterations[0])
        batched[direction] = res
        # the timed batch ran with validate=False (its summary says
        # validated=0); this second call's trees are the ones validated
        log(f"[5] {rep_d.summary()} batch_s={rep_d.batch_seconds.tolist()}")
        log(f"[5] {direction} hmean TEPS {rep_d.harmonic_mean_teps:.6e} on "
            f"{card}; the harness batch's launches {harness_launches}; "
            f"distances == push batch, {n_valid} of 64 trees "
            f"validated in a second call; "
            f"pull_cols_log={res.pull_cols_log[0][:it].tolist()} "
            f"work_log={res.work_log[0][:it].tolist()}")
    launches = {k: v for k, v in ops.launch_counts().items()
                if k in LANE_KERNELS}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran on the main path: {launches}")
    log(f"[5] main-path launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- 6: at the phase-5 shapes, each kernel against its plain version
    # (4 semirings x 4 masks), then timed with every tile kept
    g = np.random.default_rng(1)
    B = 64
    n_cases = 0
    for name in SEMIRINGS:
        sr = semiring.get(name)
        for mask_name, mask in masks(tiled, g, dev).items():
            for kern, fn, plain_fn, shape in (
                    ("slimsell_spmv", ops.spmv, spmv_plain, (tiled.n,)),
                    ("slimsell_spmm", ops.spmm, spmm_plain, (tiled.n, B))):
                xt = frontier(sr, shape, g, dev)
                check_equal(kern, fn(sr, tiled, xt, tile_mask=mask),
                            plain_fn(sr, tiled, xt, mask), errs,
                            f"scale {SCALE}: {name} mask={mask_name}")
                n_cases += 1
    # the pull kernels at real pull states: the single-source BFS state just
    # before the first iteration auto runs as pull, and the batch's state
    # just before the first iteration most of auto's columns pull
    k_pull = 1 + int(np.argmax(auto_dirs == dm.PULL))
    plog = batched["auto"].pull_cols_log[0]
    k_batch = 1 + int(np.argmax(plog > B // 2)) if (plog > B // 2).any() \
        else k_pull
    states = {}
    for name in SEMIRINGS:
        sr = semiring.get(name)
        for kern, spec, arg, k in (
                ("slimsell_pull", bfs_spec(name), root, k_pull),
                ("slimsell_pull_mm", multi_bfs_spec(name),
                 torch.from_numpy(roots), k_batch)):
            st = engine.run_fused(spec, tiled, arg, max_iters=k - 1,
                                  direction="pull").state
            xt, nf = spec.frontier(st, k), spec.not_final(st)
            mask = engine._pull_tile_mask(tiled, nf.any(dim=-1) if nf.ndim > 1 else nf)
            fn = ops.pull if kern == "slimsell_pull" else ops.pull_mm
            plain_fn = pull_plain if kern == "slimsell_pull" else pull_mm_plain
            check_equal(kern, fn(sr, tiled, xt, nf, tile_mask=mask),
                        plain_fn(sr, tiled, xt, nf, mask), errs,
                        f"real state {name} iteration {k}")
            n_cases += 1
            if name == "tropical":
                fbits = spec.source_bits(st, k).float()
                states[kern] = (xt, nf, mask, fbits, k)
    torch.cuda.synchronize()
    log(f"[6] kernels == plain on {n_cases} cases at scale {SCALE} "
        f"(SpMV, SpMM B={B}; pull at iteration {k_pull}, pull_mm B={B} at "
        f"iteration {k_batch})")
    tropical, real = semiring.get("tropical"), semiring.get("real")
    full = torch.ones(tiled.n_tiles, dtype=torch.bool, device=dev)
    x = frontier(tropical, (tiled.n,), g, dev)
    X = frontier(tropical, (tiled.n, B), g, dev)
    xr = frontier(real, (tiled.n,), g, dev)
    Xr = frontier(real, (tiled.n, B), g, dev)
    adj = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr), torch.from_numpy(csr.indices.astype(np.int64)),
        torch.ones(csr.nnz), size=(csr.n, csr.n)).to(dev)
    for got, want in ((ops.spmv(real, tiled, xr), adj @ xr),
                      (ops.spmm(real, tiled, Xr), torch.sparse.mm(adj, Xr))):
        log(f"[6] real-semiring kernel vs library max_abs_err "
            f"{max_abs_err(got, want)}")
    # the bytes the function needs: each chunk's cols up to its length cl
    # (the slots past it are padding), tile_ptr, row_vertex, cl, the bool mask
    edges = int((tiled.cols >= 0).sum())
    index_bytes = 4 * (tiled.tile_ptr.numel() + tiled.row_vertex.numel()
                       + tiled.cl.numel()) + full.numel()
    layout_bytes = 4 * tiled.C * int(tiled.cl.sum(dtype=torch.int64)) \
        + index_bytes
    table = []

    def row(kern, ms, plain_ms, library_ms, moved, ops_needed,
            semiring_name="tropical", **extra):
        bound_ms = 1e3 * max(moved / HBM_BYTES_PER_S, ops_needed / F32_OPS_PER_S)
        source, replaces = KERNEL_INFO[kern]
        table.append({
            "name": kern, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kern],
            "max_abs_err": errs[kern], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if moved / HBM_BYTES_PER_S
            >= ops_needed / F32_OPS_PER_S else "operations",
            "library_ms": library_ms, "semiring": semiring_name,
            "bytes": moved,
            **extra})
        return bound_ms

    for kern, width, xt, xl, fn, plain_fn, lib in (
            ("slimsell_spmv", 1, x, xr, ops.spmv, spmv_plain,
             lambda: adj @ xr),
            ("slimsell_spmm", B, X, Xr, ops.spmm, spmm_plain,
             lambda: torch.sparse.mm(adj, Xr))):
        ms = time_ms(lambda: fn(tropical, tiled, xt, tile_mask=full), 20)
        ms_real = time_ms(lambda: fn(real, tiled, xl, tile_mask=full), 20)
        plain_ms = time_ms(lambda: plain_fn(tropical, tiled, xt, full), 3)
        library_ms = time_ms(lib, 20)
        moved = layout_bytes + 2 * 4 * tiled.n * width   # layout, x in, y out
        bound_ms = row(kern, ms, plain_ms, library_ms, moved,
                       2 * edges * width,                # edge value + min
                       ms_real=ms_real, batch=width,
                       library_call="torch.sparse.mm (real)" if width > 1
                       else "sparse CSR @ x (real)")
        log(f"[6] {kern} B={width}: kernel {ms:.4f} ms (real {ms_real:.4f}) "
            f"plain {plain_ms:.3f} ms library {library_ms:.4f} ms bound "
            f"{bound_ms:.4f} ms ({moved / 1e9:.3f} GB) on {card}")
    split = chunk_split(lambda m: ops.spmm(tropical, tiled, X, tile_mask=m),
                        tiled, parts=SPLIT_PARTS)
    table[-1]["chunk_split"] = split
    log(f"[6] slimsell_spmm B={B} over parts of the layout: {split_line(split)}"
        f" on {card}")
    split = chunk_split(lambda m: ops.spmv(tropical, tiled, x, tile_mask=m),
                        tiled)
    table[-2]["chunk_split"] = split
    log(f"[6] slimsell_spmv over parts of the layout: {split_line(split)}; "
        f"adj @ x (real) in this call {table[-2]['library_ms']:.4f} ms on "
        f"{card}")
    for kern, fn, plain_fn in (("slimsell_pull", ops.pull, pull_plain),
                               ("slimsell_pull_mm", ops.pull_mm, pull_mm_plain)):
        xt, nf, mask, fbits, k = states[kern]
        width = 1 if xt.ndim == 1 else xt.shape[1]
        ms = time_ms(lambda: fn(tropical, tiled, xt, nf, tile_mask=mask), 20)
        plain_ms = time_ms(lambda: plain_fn(tropical, tiled, xt, nf, mask), 3)
        lib = (lambda: adj @ fbits) if width == 1 \
            else (lambda: torch.sparse.mm(adj, fbits))
        library_ms = time_ms(lib, 20)
        nf2 = nf.reshape(tiled.n, width)
        _, ranks = pull_first_hits(tropical, tiled, xt.reshape(tiled.n, width),
                                   nf2, mask)
        work = pull_work(tiled, ranks, nf2, mask, ops.spmv_piece_tiles(tiled.L))
        # cols read through the hits, x in, nf in, y out, layout indices
        moved = 4 * work["slots_read"] + 4 * xt.numel() + nf.numel() \
            + 4 * xt.numel() + index_bytes
        pending = int(nf2.any(dim=1).sum())
        # the push sweep of the same iteration, for comparison
        push_fn = ops.spmv if width == 1 else ops.spmm
        push_mask = dm.push_tile_mask(tiled, fbits > 0)
        push_ms = time_ms(lambda: push_fn(tropical, tiled, xt,
                                          tile_mask=push_mask), 20)
        # the single-source pull beside the batched pull at B=1 on its state
        extra = {} if width > 1 else {"pull_mm_b1_ms": time_ms(
            lambda: ops.pull_mm(tropical, tiled, xt[:, None].contiguous(),
                                nf[:, None].contiguous(), tile_mask=mask), 20)}
        bound_ms = row(kern, ms, plain_ms, library_ms, moved,
                       work.pop("operations"), batch=width, iteration=k,
                       pending_rows=pending, tiles_kept=int(mask.sum()),
                       push_ms=push_ms, push_tiles=int(push_mask.sum()),
                       library_call=("torch.sparse.mm" if width > 1 else
                                     "sparse CSR @ x")
                       + " (real; full reduction, not the same function)",
                       **extra, **work)
        log(f"[6] {kern} B={width} at iteration {k}: kernel {ms:.4f} ms plain "
            f"{plain_ms:.3f} ms library (full reduction, not the same "
            f"function) {library_ms:.4f} ms bound {bound_ms:.4f} ms "
            f"({moved / 1e9:.4f} GB) | push sweep of this iteration "
            f"{push_ms:.4f} ms over {int(push_mask.sum())} tiles"
            + (f" | slimsell_pull_mm B=1 on this state "
               f"{extra['pull_mm_b1_ms']:.4f} ms" if extra else "")
            + f" | pending rows {pending}, tiles kept {int(mask.sum())}, "
            f"{work} on {card}")
        # the parts of the layout, each within the state's mask, and the
        # floor: no pending row (or (row, column)), reading nf and writing y
        split = pull_split(tiled, xt, nf, mask, parts=SPLIT_PARTS)
        table[-1]["chunk_split"] = split
        log(f"[6] {kern} B={width} over parts of the layout (each within "
            f"the state's mask): {split_line(split)}; slots read past "
            f"the first hits (pieces of {ops.spmv_piece_tiles(tiled.L)} "
            f"tiles side by side) at most {work['slots_past_hits']} of "
            f"{work['slots_read']} on {card}")
    torch.cuda.synchronize()

    # ---- 7: SlimSell-B, the bit-packed boolean path
    boolean = semiring.get("boolean")
    # (a) scale 14: each packed kernel against its plain version, then the
    # packed path on the card against the packed path on the CPU
    g7 = np.random.default_rng(7)
    packed_masks = masks(small, g7, dev)
    keep_chunk = torch.from_numpy(g7.random(small.n_chunks) < 0.6).to(dev)
    packed_masks["whole_chunks"] = keep_chunk[small.row_block.long()]
    n_cases = 0
    for mask_name, mask in packed_masks.items():
        for width in (None, 1, 5, 33, 64, 97, 160):
            for density in (0.02, 0.5):
                shape = (small.n,) if width is None else (small.n, width)
                bits = torch.from_numpy(g7.random(shape) < density).to(dev)
                what = f"B={width} density={density} mask={mask_name}"
                if width is None:
                    xw = packing.pack_bits(bits)
                    check_equal("slimsell_spmv_packed",
                                ops.spmv_packed(small, xw, tile_mask=mask),
                                spmv_packed_plain(small, xw, mask), errs, what)
                else:
                    xw = packing.pack_bits(bits, axis=1)
                    check_equal("slimsell_spmm_packed",
                                ops.spmm_packed(small, xw, tile_mask=mask),
                                spmm_packed_plain(small, xw, mask), errs, what)
                n_cases += 1
    torch.cuda.synchronize()
    small_cpu = small_host.to_torch("cpu")
    for kind, mode in (("bfs", "fused"), ("bfs", "hostloop"),
                       ("multi", "fused"), ("multi", "hostloop")):
        cfg = EngineConfig(mode=mode)
        if kind == "bfs":
            def run(t, d):
                return bfs(t, root0, "boolean", packed=True, need_parents=True,
                           log_work=True, config=cfg, device=d)
            fields = ("distances", "parents", "iterations", "work_log",
                      "directions")
        else:
            def run(t, d):
                return multi_source_bfs(t, small_roots, "boolean", packed=True,
                                        need_parents=True, log_work=True,
                                        config=cfg, device=d)
            fields = ("distances", "parents", "iterations", "work_log")
        ref, got = run(small_cpu, "cpu"), run(small, dev)
        for f in fields:
            if not np.array_equal(getattr(ref, f), getattr(got, f)):
                raise AssertionError(f"packed {kind} {mode}: {f} on the card "
                                     "!= on the CPU")
    log(f"[7a] packed kernels == plain on {n_cases} cases; packed bfs and "
        f"multi_source_bfs ({small_roots.size} roots), fused and hostloop: "
        f"card == CPU at scale {SMALL_SCALE}")

    # (b) scale 20: the packed main path, its launches counted from zero
    ops.reset_launches()
    packed_bfs = {}
    for mode in ("fused", "hostloop"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bfs(tiled, root, "boolean", packed=True, need_parents=True,
                  log_work=True, config=EngineConfig(mode=mode), device=dev)
        dt = time.perf_counter() - t0
        if res.iterations != lane_boolean.iterations or any(
                not np.array_equal(getattr(res, f), getattr(lane_boolean, f))
                for f in ("distances", "work_log")):
            raise AssertionError(f"packed bfs {mode} != lane-boolean push")
        validate_bfs_tree(csr, root, res.distances, res.parents,
                          d_ref=lane_boolean.distances)
        packed_bfs[mode] = res
        log(f"[7b] bfs boolean packed push {mode}: root={root} iterations="
            f"{res.iterations} work_log={res.work_log.tolist()} "
            f"{dt * 1e3:.1f} ms; == lane-boolean push (distances, "
            "iterations, work_log), valid DP-parent tree")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pk = multi_source_bfs(tiled, roots, "boolean", packed=True,
                          need_parents=True, device=dev)
    first_s = time.perf_counter() - t0
    if not np.array_equal(pk.distances, push.distances):
        raise AssertionError("packed batch distances != push batch")
    n_valid = 0
    for i, r in enumerate(roots):
        validate_bfs_tree(csr, int(r), pk.distances[i], pk.parents[i],
                          d_ref=push.distances[i])
        n_valid += 1
    pk_log = multi_source_bfs(tiled, roots, "boolean", packed=True,
                              log_work=True, device=dev)
    it = int(pk_log.iterations[0])
    if it != int(push.iterations[0]) or not np.array_equal(pk_log.work_log,
                                                           push.work_log):
        raise AssertionError("packed batch work log != push batch's")
    packed_launches = {k: v for k, v in ops.launch_counts().items()
                       if k in PACKED_KERNELS}
    if min(packed_launches.values()) == 0:
        raise AssertionError("a packed kernel never ran on the packed main "
                             f"path: {packed_launches}")
    launches.update(packed_launches)
    log(f"[7b] packed batch of the phase-5 roots: distances == push batch, "
        f"{n_valid} of 64 trees valid, work_log == push batch's "
        f"{pk_log.work_log[0][:it].tolist()}; first call {first_s:.4f} s; "
        f"packed main-path launches {packed_launches}")
    # push and packed batches in turns, with and without parents
    seconds = {(kind, p): [] for kind in ("push", "packed")
               for p in (True, False)}
    for order in (("push", "packed"), ("packed", "push")):
        for kind in order:
            for parents in (True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = multi_source_bfs(
                    tiled, roots, "tropical" if kind == "push" else "boolean",
                    packed=kind == "packed", need_parents=parents, device=dev)
                seconds[(kind, parents)].append(time.perf_counter() - t0)
                if not np.array_equal(res.distances, push.distances):
                    raise AssertionError(f"{kind} batch distances changed")
    for (kind, parents), ss in seconds.items():
        teps = [hmean(batch_teps(csr, push.distances, t)) for t in ss]
        log(f"[7b] {kind} batch {'with' if parents else 'without'} parents: "
            f"s={ss} hmean TEPS={teps} on {card}")
    # single-source lane-boolean and packed push in turns, fused and hostloop
    ms_bfs = {(kind, mode): [] for kind in ("lane", "packed")
              for mode in ("fused", "hostloop")}
    for order in (("lane", "packed"), ("packed", "lane")):
        for kind in order:
            for mode in ("fused", "hostloop"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = bfs(tiled, root, "boolean", packed=kind == "packed",
                          need_parents=True, log_work=True,
                          config=EngineConfig(mode=mode), device=dev)
                ms_bfs[(kind, mode)].append(1e3 * (time.perf_counter() - t0))
                if not np.array_equal(res.work_log, lane_boolean.work_log):
                    raise AssertionError(f"{kind} bfs {mode} work log changed")
    log(f"[7b] single-source boolean push, with parents, ms in turns: "
        + ", ".join(f"{kind} {mode} {v}" for (kind, mode), v in ms_bfs.items())
        + f" on {card}")

    # (c) each packed kernel at the real state of its iteration with the
    # most tiles: with that iteration's push mask, and with every tile kept
    slots = tile_slots(tiled) * tiled.C
    for kern, spec, arg, wl, width in (
            ("slimsell_spmv_packed", packed_bfs_spec(tiled.n), root,
             packed_bfs["fused"].work_log, None),
            ("slimsell_spmm_packed", packed_multi_bfs_spec(B),
             torch.from_numpy(roots), pk_log.work_log[0][:it], B)):
        k = 1 + int(np.argmax(wl))
        st = engine.run_fused(spec, tiled, arg, max_iters=k - 1).state
        xw, bits = spec.frontier(st, k), spec.source_bits(st, k)
        mask = dm.push_tile_mask(tiled, bits)
        fn = ops.spmv_packed if width is None else ops.spmm_packed
        plain_fn = spmv_packed_plain if width is None else spmm_packed_plain
        for m in (mask, full):
            check_equal(kern, fn(tiled, xw, tile_mask=m),
                        plain_fn(tiled, xw, m), errs,
                        f"scale {SCALE} real state, iteration {k}")
        n_kept = int(mask.sum())
        ms = time_ms(lambda: fn(tiled, xw, tile_mask=full), 20)
        masked_ms = time_ms(lambda: fn(tiled, xw, tile_mask=mask), 20)
        plain_ms = time_ms(lambda: plain_fn(tiled, xw, full), 3)
        # the lane kernel over the same frontier as int32 0/1 lanes
        xl = bits.to(torch.int32).contiguous()
        lane_fn = ops.spmv if width is None else ops.spmm
        lane_ms = time_ms(lambda: lane_fn(boolean, tiled, xl, tile_mask=full),
                          20)
        xr = bits.float()
        lib = (lambda: adj @ xr) if width is None \
            else (lambda: torch.sparse.mm(adj, xr))
        library_ms = time_ms(lib, 20)
        # cols up to cl + indices + x words in + y words out; a shift and
        # an OR per slot (SpMV) or one OR per slot and word (SpMM), integer
        # work counted against the float32 rate of the CUDA cores
        words = xw.numel()
        per_slot = 2 if width is None else xw.shape[1]
        moved = layout_bytes + 2 * 4 * words
        masked_moved = 4 * int(slots[mask].sum()) + index_bytes + 2 * 4 * words
        masked_bound_ms = 1e3 * max(masked_moved / HBM_BYTES_PER_S,
                                    per_slot * edges / F32_OPS_PER_S)
        bound_ms = row(kern, ms, plain_ms, library_ms, moved,
                       per_slot * edges, semiring_name="boolean_packed",
                       batch=width or 1, iteration=k, tiles_kept=n_kept,
                       masked_ms=masked_ms, masked_bound_ms=masked_bound_ms,
                       lane_ms=lane_ms,
                       library_call=("torch.sparse.mm" if width else
                                     "sparse CSR @ x") + " (real, unpacked "
                       "frontier; not the same function)")
        log(f"[7c] {kern} B={width or 1} at iteration {k}: every tile kept "
            f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms lane boolean kernel "
            f"{lane_ms:.4f} ms library (not the same function) "
            f"{library_ms:.4f} ms bound {bound_ms:.4f} ms ({moved / 1e9:.4f} "
            f"GB) | iteration mask ({n_kept} tiles) kernel {masked_ms:.4f} ms "
            f"bound {masked_bound_ms:.4f} ms ({masked_moved / 1e9:.4f} GB) on "
            f"{card}")
        split = chunk_split(lambda m: fn(tiled, xw, tile_mask=m), tiled)
        table[-1]["chunk_split"] = split
        spmv_ms = next(r["ms"] for r in table if r["name"] == "slimsell_spmv")
        log(f"[7c] {kern} B={width or 1} over parts of the layout: "
            f"{split_line(split)}; slimsell_spmv (1) with every tile kept "
            f"in this run (phase 6) {spmv_ms:.4f} ms on {card}")
    torch.cuda.synchronize()

    # (d) the paper's storage accounting at scale 20
    store = storage_summary(csr, C=8, L=128)
    log(f"[7d] storage in 32-bit cells (paper Table III) at scale {SCALE}: "
        f"{dataclasses.asdict(store)}; SlimSell / Sell-C-sigma "
        f"{store.slimsell_vs_sellcs:.4f}, SlimSell / AL "
        f"{store.slimsell_vs_al:.4f}; a packed frontier is "
        f"{packing.packed_words(csr.n)} words, a lane one {csr.n}")

    # ---- 8: weighted SSSP, the stored-weight (min-plus) kernel
    minplus = semiring.MINPLUS
    sssp_fields = ("distances", "parents", "sweeps", "buckets", "work_log",
                   "delta")
    # (a) scale 14: the kernel against its plain version, then sssp on the
    # card against sssp on the CPU
    g8 = np.random.default_rng(8)
    n_cases = 0
    light, heavy = weight_views(small.wts, default_delta(small))
    for view, w in (("full", small.wts), ("light", light), ("heavy", heavy)):
        for mask_name, mask in packed_masks.items():
            for kind, finite in (("all_inf", 0.0), ("sparse", 0.02),
                                 ("dense", 0.7)):
                x = sssp_frontier(small.n, finite, g8, dev)
                check_equal("slimsell_spmv_wts",
                            ops.spmv(minplus, small, x, tile_mask=mask,
                                     weights=w),
                            spmv_plain(minplus, small, x, mask, w), errs,
                            f"scale {SMALL_SCALE} {view} mask={mask_name} "
                            f"x={kind}")
                n_cases += 1
    torch.cuda.synchronize()
    runs = []
    for mode in ("fused", "hostloop"):
        for delta in (None, float("inf"), 0.05):
            kw = dict(delta=delta, need_parents=True, log_work=True,
                      config=EngineConfig(mode=mode))
            ref = sssp(small_cpu, root0, device="cpu", **kw)
            got = sssp(small, root0, device=dev, **kw)
            for f in sssp_fields:
                if not np.array_equal(getattr(ref, f), getattr(got, f)):
                    raise AssertionError(f"sssp {mode} delta={delta}: {f} on "
                                         "the card != on the CPU")
            runs.append(f"{mode} delta={got.delta:.6g} sweeps={got.sweeps} "
                        f"buckets={got.buckets}")
    log(f"[8a] stored-weight kernel == plain on {n_cases} cases; sssp card "
        f"== CPU at scale {SMALL_SCALE}, root {root0} (distances, parents, "
        f"sweeps, buckets, work_log): {'; '.join(runs)}")

    # (b) scale 20: the SSSP main path, its launches counted from zero
    ops.reset_launches()
    single = {}
    for mode in ("fused", "hostloop"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sssp(tiled, root, need_parents=True, log_work=True,
                   config=EngineConfig(mode=mode), device=dev)
        single[mode] = (res, time.perf_counter() - t0)
    fused, hostloop = single["fused"][0], single["hostloop"][0]
    for f in sssp_fields:
        if not np.array_equal(getattr(fused, f), getattr(hostloop, f)):
            raise AssertionError(f"sssp at scale {SCALE}: {f} fused != "
                                 "hostloop")
    adj_w = csr_matrix((csr.weights, csr.indices, csr.indptr),
                       shape=(csr.n, csr.n))
    t0 = time.perf_counter()
    d_ref = dijkstra(adj_w, directed=True, indices=[root])[0]
    scipy_one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    validate_sssp_tree(csr, root, fused.distances, fused.parents, d_ref=d_ref)
    validate_one_s = time.perf_counter() - t0
    for mode, (res, dt) in single.items():
        log(f"[8b] sssp {mode}: root={root} delta={res.delta:.6g} "
            f"sweeps={res.sweeps} buckets={res.buckets} "
            f"tiles={int(res.work_log.sum())} {dt * 1e3:.1f} ms")
    log(f"[8b] fused == hostloop (distances, parents, sweeps, buckets, "
        f"work_log); distances == scipy dijkstra ({scipy_one_s:.1f} s), tree "
        f"valid ({validate_one_s:.2f} s); "
        f"work_log={fused.work_log.tolist()}")
    before = ops.launch_counts()
    with recorded(GraphSession, "sssp") as per_root:
        rep = run_graph500_sssp(scale=SCALE, edge_factor=EDGE_FACTOR,
                                n_roots=64, csr=csr, tiled=tiled,
                                validate=False, device=dev)
    harness_launches = {k: v - before[k] for k, v in
                        ops.launch_counts().items() if v > before[k]}
    if not harness_launches.get("slimsell_spmm_wts"):
        raise AssertionError(f"the per-root harness never launched kernel "
                             f"2w: {harness_launches}")
    for r in table:
        if r["name"] == "slimsell_spmm_wts":
            r["phase8b_harness_launches"] = harness_launches[
                "slimsell_spmm_wts"]
    if not np.array_equal(rep.roots, roots):
        raise AssertionError("the SSSP harness sampled other roots")
    log(f"[8b] {rep.summary()}")
    log(f"[8b] sssp hmean TEPS {rep.harmonic_mean_teps:.6e} (per root "
        f"{rep.teps.min():.4e}..{rep.teps.max():.4e}) on {card}, each root "
        f"a width-1 slot of GraphSession (kernel 2w at B=1; PR 22's "
        f"harness on kernel 1w: 3.925e8); launches {harness_launches}; per "
        f"root sweeps={rep.sweeps.tolist()} buckets={rep.buckets.tolist()}")
    # the timed run did not validate (its summary says validated=0): a
    # second pass gives the trees, with the same schedule
    trees = []
    for i, r in enumerate(rep.roots):
        res = sssp(tiled, int(r), need_parents=True, device=dev)
        if (res.sweeps, res.buckets) != (rep.sweeps[i], rep.buckets[i]):
            raise AssertionError(f"sssp root {r}: another schedule on a "
                                 "second call")
        h = per_root[i]
        if not (np.array_equal(h.distances, res.distances)
                and np.array_equal(h.parents, res.parents)
                and (h.sweeps, h.buckets, h.delta)
                == (res.sweeps, res.buckets, res.delta)):
            raise AssertionError(f"sssp root {r}: the harness's session "
                                 "result != the direct sssp")
        trees.append(res)
    del per_root
    log("[8b] the harness's 64 session results == the direct sssp of each "
        "root (distances, parents, sweeps, buckets, delta bit-equal)")
    wts_launches = ops.launch_counts()["slimsell_spmv_wts"]
    if wts_launches == 0:
        raise AssertionError("the stored-weight kernel never ran on the SSSP "
                             "main path")
    launches["slimsell_spmv_wts"] = wts_launches
    projected = time.perf_counter() - t_start \
        + 64 * (scipy_one_s + validate_one_s)
    n_check = 64 if projected < VALIDATE_ALL_BY_S else 16
    t0 = time.perf_counter()
    d_refs = dijkstra(adj_w, directed=True, indices=rep.roots[:n_check])
    for i in range(n_check):
        validate_sssp_tree(csr, int(rep.roots[i]), trees[i].distances,
                           trees[i].parents, d_ref=d_refs[i])
    log(f"[8b] {n_check} of 64 SSSP trees validated (distances == one scipy "
        f"dijkstra call over {n_check} roots, parents tight) in "
        f"{time.perf_counter() - t0:.1f} s (projected end with all 64: "
        f"{projected:.0f} s of the run); main-path launches "
        f"slimsell_spmv_wts={wts_launches}")

    # (c) the kernel at the real state of the sweep with the most tiles
    k = 1 + int(np.argmax(fused.work_log))
    spec = sssp_spec(tiled, fused.delta)
    st = engine.run_fused(spec, tiled, root, max_iters=k - 1).state
    x, w = spec.frontier(st, k), spec.weights(st)
    mask = dm.push_tile_mask(tiled, spec.source_bits(st, k))
    n_kept = int(mask.sum())
    if n_kept != int(fused.work_log[k - 1]):
        raise AssertionError("the rebuilt state is not the run's")
    for m in (mask, full):
        check_equal("slimsell_spmv_wts",
                    ops.spmv(minplus, tiled, x, tile_mask=m, weights=w),
                    spmv_plain(minplus, tiled, x, m, w), errs,
                    f"scale {SCALE} real state, sweep {k}")
    ms = time_ms(lambda: ops.spmv(minplus, tiled, x, tile_mask=full,
                                  weights=w), 20)
    masked_ms = time_ms(lambda: ops.spmv(minplus, tiled, x, tile_mask=mask,
                                         weights=w), 20)
    plain_ms = time_ms(lambda: spmv_plain(minplus, tiled, x, full, w), 3)
    implicit_ms = time_ms(lambda: ops.spmv(tropical, tiled, x, tile_mask=full),
                          20)
    adj_wt = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr),
        torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(csr.weights), size=(csr.n, csr.n)).to(dev)
    x_fin = torch.where(torch.isfinite(x), x, 0.0)[:, None]
    library_ms = time_ms(lambda: torch.sparse.mm(adj_wt, x_fin), 20)
    # cols and wts up to cl, the indices, x in, y out; an add and a min per
    # edge against the float32 rate
    wts_bytes = layout_bytes - index_bytes
    moved = layout_bytes + wts_bytes + 2 * 4 * tiled.n
    masked_moved = 8 * int(slots[mask].sum()) + index_bytes + 2 * 4 * tiled.n
    masked_bound_ms = 1e3 * max(masked_moved / HBM_BYTES_PER_S,
                                2 * edges / F32_OPS_PER_S)
    bound_ms = row("slimsell_spmv_wts", ms, plain_ms, library_ms, moved,
                   2 * edges, semiring_name="minplus", batch=1, sweep=k,
                   phase=("light", "heavy")[st["phase"]], tiles_kept=n_kept,
                   masked_ms=masked_ms, masked_bound_ms=masked_bound_ms,
                   implicit_ms=implicit_ms,
                   library_call="torch.sparse.mm (real, the same weights; "
                   "not the same function)")
    log(f"[8c] slimsell_spmv_wts at sweep {k} ({('light', 'heavy')[st['phase']]}"
        f" phase): every tile kept kernel {ms:.4f} ms plain {plain_ms:.3f} ms "
        f"implicit-value SpMV {implicit_ms:.4f} ms library (not the same "
        f"function) {library_ms:.4f} ms bound {bound_ms:.4f} ms "
        f"({moved / 1e9:.4f} GB) | sweep mask ({n_kept} tiles) kernel "
        f"{masked_ms:.4f} ms bound {masked_bound_ms:.4f} ms "
        f"({masked_moved / 1e9:.4f} GB) on {card}")
    # the kernel over parts of the layout, and at every sweep of the phase-8b
    # root (each state rebuilt): the sum is what a root's sweeps cost
    split = chunk_split(lambda m: ops.spmv(minplus, tiled, x, tile_mask=m,
                                           weights=w), tiled)
    sweeps = sssp_sweeps(tiled, root)
    for j, xs, ws, ms_ in sweeps:
        check_equal("slimsell_spmv_wts",
                    ops.spmv(minplus, tiled, xs, tile_mask=ms_, weights=ws),
                    spmv_plain(minplus, tiled, xs, ms_, ws), errs,
                    f"scale {SCALE} sweep {j} of root {root}")
    sweep_ms = sweep_times(tiled, sweeps, 10)
    table[-1].update(chunk_split=split, sweep_ms=sweep_ms,
                     sweep_sum_ms=sum(sweep_ms))
    log(f"[8c] slimsell_spmv_wts over parts of the layout: "
        f"{split_line(split)} on {card}")
    log(f"[8c] slimsell_spmv_wts at each of the {len(sweeps)} sweeps of root "
        f"{root} (== plain at each): sum {sum(sweep_ms):.4f} ms, against "
        f"{single['fused'][1] * 1e3:.1f} ms for the whole fused sssp of phase "
        f"8b; tiles:ms "
        + ", ".join(f"{int(ms_.sum())}:{t:.4f}"
                    for (*_, ms_), t in zip(sweeps, sweep_ms)) + f" on {card}")
    del sweeps
    torch.cuda.synchronize()

    # ---- 9: batched multi-source SSSP, the stored-weight (min-plus) SpMM
    t9 = time.perf_counter()
    # (a) scale 14: the kernel against its plain version, then
    # multi_source_sssp on the card against the same on the CPU
    g9 = np.random.default_rng(9)
    n_cases = 0
    poisoned = torch.where(small.cols < 0, -1000.0, small.wts)
    for mask_name, mask in packed_masks.items():
        for width in (1, 5, 33, 64, 97, 160):
            for kind, finite in (("sparse", 0.02), ("dense", 0.7)):
                X = sssp_frontier((small.n, width), finite, g9, dev)
                want = spmm_plain(minplus, small, X, mask, small.wts)
                for wname, w in (("wts", small.wts), ("poisoned", poisoned)):
                    check_equal("slimsell_spmm_wts",
                                ops.spmm(minplus, small, X, tile_mask=mask,
                                         weights=w), want, errs,
                                f"scale {SMALL_SCALE} B={width} "
                                f"mask={mask_name} x={kind} {wname}")
                    n_cases += 1
    torch.cuda.synchronize()
    msssp_fields = ("distances", "parents", "sweeps", "buckets", "iterations",
                    "work_log", "delta")
    runs = []
    for mode in ("fused", "hostloop"):
        kw = dict(need_parents=True, log_work=True,
                  config=EngineConfig(mode=mode))
        ref = multi_source_sssp(small_cpu, small_roots[:16], device="cpu", **kw)
        got = multi_source_sssp(small, small_roots[:16], device=dev, **kw)
        for f in msssp_fields:
            if not np.array_equal(getattr(ref, f), getattr(got, f)):
                raise AssertionError(f"multi_source_sssp {mode}: {f} on the "
                                     "card != on the CPU")
        runs.append(f"{mode} iterations={got.iterations.tolist()} "
                    f"sweeps={got.sweeps.tolist()}")
    log(f"[9a] stored-weight SpMM kernel == plain on {n_cases} cases; "
        f"multi_source_sssp card == CPU at scale {SMALL_SCALE}, 16 roots "
        f"(distances, parents, sweeps, buckets, iterations, work_log): "
        f"{'; '.join(runs)}")

    # (b) scale 20: the batched SSSP main path, its launches counted from
    # zero over (b) and (c)
    ops.reset_launches()
    batch_runs = {}
    for mode in ("fused", "hostloop"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = multi_source_sssp(tiled, roots, need_parents=True, log_work=True,
                                config=EngineConfig(mode=mode), device=dev)
        batch_runs[mode] = (res, time.perf_counter() - t0)
    mf, mh = batch_runs["fused"][0], batch_runs["hostloop"][0]
    it = int(mf.iterations[0])
    for f in ("distances", "parents", "sweeps", "buckets", "iterations",
              "delta"):
        if not np.array_equal(getattr(mf, f), getattr(mh, f)):
            raise AssertionError(f"multi_source_sssp at scale {SCALE}: {f} "
                                 "fused != hostloop")
    if not np.array_equal(mf.work_log[0][:it], mh.work_log[0]):
        raise AssertionError("multi_source_sssp work log fused != hostloop")
    if mf.delta != fused.delta:
        raise AssertionError("the batch took another delta than phase 8b")
    for i, r in enumerate(roots):
        t = trees[i]
        if not (np.array_equal(mf.distances[i], t.distances)
                and np.array_equal(mf.parents[i], t.parents)
                and (mf.sweeps[i], mf.buckets[i]) == (t.sweeps, t.buckets)):
            raise AssertionError(f"multi_source_sssp row {i} (root {r}) != "
                                 "the per-root sssp")
    for mode, (res, dt) in batch_runs.items():
        log(f"[9b] multi_source_sssp {mode}: 64 roots, B=64, delta="
            f"{res.delta:.6g} iterations={int(res.iterations[0])} "
            f"{dt:.4f} s with parents")
    log(f"[9b] fused == hostloop (distances, parents, sweeps, buckets, "
        f"iterations, work_log); every row == phase 8b's per-root sssp "
        f"(distances, parents, sweeps, buckets); sweeps per root "
        f"{int(mf.sweeps.min())}..{int(mf.sweeps.max())}, batch iterations "
        f"{it}; work_log={mf.work_log[0][:it].tolist()}")

    # (c) the batched Graph500 SSSP harness, with and without parents
    for parents in (True, False):
        t0 = time.perf_counter()
        with recorded(GraphSession, "sssp") as batch_out:
            rep9 = run_graph500_sssp(scale=SCALE, edge_factor=EDGE_FACTOR,
                                     n_roots=64, batched=True, batch_size=64,
                                     csr=csr, tiled=tiled, validate=False,
                                     need_parents=parents, device=dev)
        call_s = time.perf_counter() - t0
        if not (np.array_equal(rep9.roots, roots)
                and np.array_equal(rep9.sweeps, rep.sweeps)
                and np.array_equal(rep9.buckets, rep.buckets)):
            raise AssertionError("the batched SSSP harness: other roots, "
                                 "sweeps or buckets than the per-root one")
        for i, h in enumerate(batch_out[0]):
            if not (np.array_equal(h.distances, mf.distances[i])
                    and (np.array_equal(h.parents, mf.parents[i])
                         if parents else h.parents is None)
                    and (h.sweeps, h.buckets, h.delta)
                    == (mf.sweeps[i], mf.buckets[i], mf.delta)):
                raise AssertionError(f"the batched SSSP harness's row {i} "
                                     "!= phase 9b's")
        del batch_out
        log(f"[9c] {rep9.summary()} ({'with' if parents else 'without'} "
            f"parents); rows (GraphSession.sssp(batch=True)) == phase 9b's "
            f"(distances, {'parents, ' if parents else ''}sweeps, buckets, "
            f"delta)")
        log(f"[9c] batched sssp hmean TEPS {rep9.harmonic_mean_teps:.6e} "
            f"{'with' if parents else 'without'} parents (harness call "
            f"{call_s:.4f} s; per-root harness, phase 8b: "
            f"{rep.harmonic_mean_teps:.6e}) on {card}")
    msssp_launches = ops.launch_counts()["slimsell_spmm_wts"]
    if msssp_launches == 0:
        raise AssertionError("the stored-weight SpMM never ran on the "
                             "batched SSSP main path")
    launches["slimsell_spmm_wts"] = msssp_launches
    t0 = time.perf_counter()
    validate_sssp_tree(csr, int(roots[0]), mf.distances[0], mf.parents[0],
                       d_ref=trees[0].distances)
    one_s = time.perf_counter() - t0
    n_check = 64 if time.perf_counter() - t_start + 64 * one_s \
        < VALIDATE_BATCH_BY_S else 16
    for i in range(n_check):
        validate_sssp_tree(csr, int(roots[i]), mf.distances[i], mf.parents[i],
                           d_ref=trees[i].distances)
    log(f"[9c] {n_check} of 64 batched SSSP trees validated against the "
        f"per-root distances in {time.perf_counter() - t0:.1f} s; main-path "
        f"launches slimsell_spmm_wts={msssp_launches} (9b and 9c)")

    # (d) the kernel at the real state of the batch's sweep with the most
    # tiles: with that sweep's mask and with every tile kept
    k = 1 + int(np.argmax(mf.work_log[0][:it]))
    spec = multi_sssp_spec(tiled, mf.delta)
    st = engine.run_fused(spec, tiled, torch.from_numpy(roots),
                          max_iters=k - 1).state
    X = spec.frontier(st, k)
    mask = dm.push_tile_mask(tiled, spec.source_bits(st, k))
    n_kept = int(mask.sum())
    if n_kept != int(mf.work_log[0][k - 1]):
        raise AssertionError("the rebuilt batch state is not the run's")
    for m in (mask, full):
        check_equal("slimsell_spmm_wts",
                    ops.spmm(minplus, tiled, X, tile_mask=m, weights=tiled.wts),
                    spmm_plain(minplus, tiled, X, m, tiled.wts), errs,
                    f"scale {SCALE} real batch state, sweep {k}")
    log(f"[9a] stored-weight SpMM kernel == plain at scale {SCALE}, B={B}, "
        f"the batch's sweep {k} ({n_kept} tiles): with its mask and with "
        f"every tile kept")
    ms = time_ms(lambda: ops.spmm(minplus, tiled, X, tile_mask=full,
                                  weights=tiled.wts), 20)
    masked_ms = time_ms(lambda: ops.spmm(minplus, tiled, X, tile_mask=mask,
                                         weights=tiled.wts), 20)
    plain_ms = time_ms(lambda: spmm_plain(minplus, tiled, X, full, tiled.wts),
                       3)
    implicit_ms = time_ms(lambda: ops.spmm(tropical, tiled, X, tile_mask=full),
                          20)
    X_fin = torch.where(torch.isfinite(X), X, 0.0)
    library_ms = time_ms(lambda: torch.sparse.mm(adj_wt, X_fin), 20)
    phases = st["phase"]
    # cols and wts up to cl, the indices, X in, Y out; an add and a min per
    # edge and column against the float32 rate
    moved = layout_bytes + wts_bytes + 2 * 4 * tiled.n * B
    masked_moved = 8 * int(slots[mask].sum()) + index_bytes \
        + 2 * 4 * tiled.n * B
    masked_bound_ms = 1e3 * max(masked_moved / HBM_BYTES_PER_S,
                                2 * edges * B / F32_OPS_PER_S)
    split = chunk_split(lambda m: ops.spmm(minplus, tiled, X, tile_mask=m,
                                           weights=tiled.wts), tiled,
                        parts=SPLIT_PARTS)
    bound_ms = row("slimsell_spmm_wts", ms, plain_ms, library_ms, moved,
                   2 * edges * B, semiring_name="minplus", batch=B, sweep=k,
                   chunk_split=split,
                   light_columns=int((phases == 0).sum()),
                   tiles_kept=n_kept, masked_ms=masked_ms,
                   masked_bound_ms=masked_bound_ms, implicit_ms=implicit_ms,
                   library_call="torch.sparse.mm (real, the same weights; "
                   "not the same function)")
    log(f"[9d] slimsell_spmm_wts B={B} at sweep {k} "
        f"({int((phases == 0).sum())} columns light): every tile kept kernel "
        f"{ms:.4f} ms plain {plain_ms:.3f} ms implicit-value SpMM "
        f"{implicit_ms:.4f} ms library (not the same function) "
        f"{library_ms:.4f} ms bound {bound_ms:.4f} ms ({moved / 1e9:.4f} GB) "
        f"| sweep mask ({n_kept} tiles) kernel {masked_ms:.4f} ms bound "
        f"{masked_bound_ms:.4f} ms ({masked_moved / 1e9:.4f} GB) on {card}")
    log(f"[9d] slimsell_spmm_wts B={B} over parts of the layout: "
        f"{split_line(split)} on {card}")
    torch.cuda.synchronize()
    log(f"[9] phase 9 took {time.perf_counter() - t9:.1f} s; the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- 10: GCN inference on the SlimSell-W aggregation (kernel 2g)
    t10 = time.perf_counter()
    # GCN is float32 end to end, as in the JAX package: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gcn_cfg = make_config()
    slim_cfg = dataclasses.replace(gcn_cfg, aggregation="slimsell")
    seg_cfg = dataclasses.replace(gcn_cfg, aggregation="segment")
    # (a) the kernel against its plain version, then the card against the CPU
    g10 = np.random.default_rng(10)
    cora_csr = erdos_renyi(2708, 3.9, seed=10)
    cora_host = build_slimsell(cora_csr, C=8, L=16)
    cora = cora_host.to_torch(dev)
    gcn_layouts = {
        "cora-shape ER C=8 L=16": cora,
        f"kronecker({SMALL_SCALE}) C=8 L=128": small,
        f"kronecker({SMALL_SCALE}) C=8 L=16":
            build_slimsell(small_csr, C=8, L=16).to_torch(dev)}
    n_cases = 0
    for lname, t in gcn_layouts.items():
        deg_t = t.deg.float()
        gmasks = masks(t, g10, dev)
        keep_chunk = torch.from_numpy(g10.random(t.n_chunks) < 0.6).to(dev)
        gmasks["whole_chunks"] = keep_chunk[t.row_block.long()]
        for mask_name, mask in gmasks.items():
            for width in (1, 5, 16, 33, 64, 160):
                X = torch.from_numpy(g10.standard_normal(
                    (t.n, width)).astype(np.float32)).to(dev)
                check_close("slimsell_spmm_gcn",
                            ops.spmm(real, t, X, tile_mask=mask, deg=deg_t),
                            spmm_plain(real, t, X, mask, deg=deg_t), errs,
                            f"{lname} B={width} mask={mask_name}", 1e-5)
                n_cases += 1
    torch.cuda.synchronize()
    cpu_params = gcn_init(gcn_cfg, generator=torch.Generator().manual_seed(10),
                          device="cpu")
    dev_params = {"w": [w.to(dev) for w in cpu_params["w"]]}
    card_cpu = []
    for gname, gcsr, ghost, gtiled in (
            ("cora-shape ER", cora_csr, cora_host, cora),
            (f"kronecker({SMALL_SCALE})", small_csr, small_host, small)):
        feat = torch.from_numpy(g10.standard_normal(
            (gcsr.n, gcn_cfg.d_in)).astype(np.float32))
        cpu_batch = gcn_batch(gcsr, feat, ghost.to_torch("cpu"), "cpu")
        dev_batch = gcn_batch(gcsr, feat, gtiled, dev)
        for cfg in (seg_cfg, slim_cfg):
            with torch.inference_mode():
                want = gcn_forward(cpu_params, cpu_batch, cfg, device="cpu")
                got = gcn_forward(dev_params, dev_batch, cfg, device=dev)
            check_close("gcn_forward", got.cpu(), want, None,
                        f"{gname} {cfg.aggregation} card vs CPU", 1e-4)
            card_cpu.append(f"{gname} {cfg.aggregation} "
                            f"{max_abs_err(got.cpu(), want):.3e}")
    log(f"[10a] slimsell_spmm_gcn within 1e-5 of plain, no NaN, on {n_cases} "
        f"cases ({', '.join(gcn_layouts)}; B=1/5/16/33/64/160 x 5 masks); "
        f"gcn_forward at d_in {gcn_cfg.d_in} card == CPU within 1e-4, max abs "
        f"err: {'; '.join(card_cpu)}")

    # (b) the GCN main path at scale 20: three requests, counted from zero
    ops.reset_launches()
    feat = torch.randn((tiled.n, gcn_cfg.d_in),
                       generator=torch.Generator(device=dev).manual_seed(10),
                       device=dev)
    params = gcn_init(gcn_cfg, generator=torch.Generator().manual_seed(11),
                      device=dev)
    batch = gcn_batch(csr, feat, tiled, dev)
    answers = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            y = gcn_forward(params, batch, slim_cfg)
        torch.cuda.synchronize()
        answers.append((y, time.perf_counter() - t0))
    y_slim = answers[0][0]
    if y_slim.shape != (tiled.n, gcn_cfg.n_classes) \
            or not torch.isfinite(y_slim).all():
        raise AssertionError(f"GCN logits: shape {tuple(y_slim.shape)}, or "
                             "not finite")
    if not all(torch.equal(y, y_slim) for y, _ in answers):
        raise AssertionError("the three GCN requests gave different logits")
    with torch.inference_mode():
        y_seg = gcn_forward(params, batch, seg_cfg)
    check_close("gcn_forward", y_slim, y_seg, None,
                f"slimsell vs segment at scale {SCALE}", 1e-3)
    seg_err = max_abs_err(y_slim, y_seg)
    fwd = {"slimsell": [], "segment": []}
    for _ in range(5):
        for name, cfg in (("slimsell", slim_cfg), ("segment", seg_cfg)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                gcn_forward(params, batch, cfg)
            torch.cuda.synchronize()
            fwd[name].append(time.perf_counter() - t0)
    gcn_launches = ops.launch_counts()["slimsell_spmm_gcn"]
    if gcn_launches != 2 * (len(answers) + len(fwd["slimsell"])):
        raise AssertionError(f"slimsell_spmm_gcn launched {gcn_launches} times "
                             f"over {len(answers) + 5} SlimSell forwards")
    launches["slimsell_spmm_gcn"] = gcn_launches
    log(f"[10b] gcn-cora at scale {SCALE} (n={tiled.n}, d_in "
        f"{gcn_cfg.d_in}, features {feat.numel() * 4 / 1e9:.2f} GB): 3 "
        f"requests {[round(dt, 6) for _, dt in answers]} s, bit-equal to "
        f"each other; slimsell == segment within 1e-3 (max abs err "
        f"{seg_err:.3e}, logits max abs {float(y_seg.abs().max()):.3e}); "
        f"main-path launches slimsell_spmm_gcn={gcn_launches}")
    # where a warm forward's time goes: x @ w (two layers) and the two
    # aggregations (each layer's input is [n, 16])
    w0, w1 = params["w"]
    with torch.inference_mode():
        xw = feat @ w0
        h = torch.relu(gcn_forward({"w": [w0]}, batch, slim_cfg))
        mm_ms = time_ms(lambda: feat @ w0, 5) + time_ms(lambda: h @ w1, 5)
        agg_ms = {name: 2 * time_ms(
            lambda: _gcn_aggregate(xw, batch, tiled.n, name), 5)
            for name in ("slimsell", "segment")}
    for name in ("slimsell", "segment"):
        med = float(np.median(fwd[name]))
        log(f"[10b] {name} forward, warm, median of 5: {med:.6f} s "
            f"({fwd[name]}), {tiled.n / med:.6e} nodes/s; x @ w "
            f"{mm_ms:.4f} ms ({mm_ms / 1e3 / med:.4f}), aggregation "
            f"{agg_ms[name]:.4f} ms ({agg_ms[name] / 1e3 / med:.4f}) on {card}")
    del feat, batch, xw, h, answers, y, y_slim, y_seg
    torch.cuda.empty_cache()

    # (c) the kernel alone at d = 16, every tile kept
    degf = tiled.deg.float()
    X16 = torch.from_numpy(g10.standard_normal((tiled.n, 16)).astype(
        np.float32)).to(dev)
    got = ops.spmm(real, tiled, X16, tile_mask=full, deg=degf)
    want32 = spmm_plain(real, tiled, X16, full, deg=degf)
    check_close("slimsell_spmm_gcn", got, want32, errs,
                f"scale {SCALE} B=16 every tile kept", 1e-5)
    want64 = spmm_plain(real, tiled, X16.double(), full, deg=degf.double())
    check_close("slimsell_spmm_gcn", got, want64, None,
                f"scale {SCALE} B=16 against float64", 1e-4)
    err64 = max_abs_err(got, want64)
    plain_err64 = max_abs_err(want32, want64)
    del want64
    norm = torch.rsqrt(degf.clamp_min(1.0)).cpu().numpy()
    rows = np.repeat(np.arange(csr.n), np.diff(csr.indptr))
    adj_gcn = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr),
        torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(norm[rows] * norm[csr.indices]),
        size=(csr.n, csr.n)).to(dev)
    lib_err = max_abs_err(got, torch.sparse.mm(adj_gcn, X16))
    ms = time_ms(lambda: ops.spmm(real, tiled, X16, tile_mask=full,
                                  deg=degf), 20)
    plain_ms = time_ms(lambda: spmm_plain(real, tiled, X16, full, deg=degf), 3)
    implicit_ms = time_ms(lambda: ops.spmm(real, tiled, X16, tile_mask=full),
                          20)
    library_ms = time_ms(lambda: torch.sparse.mm(adj_gcn, X16), 20)
    # cols up to cl, the indices and mask, deg, X in, Y out; per edge one
    # weight product, and a multiply and an add per column; per vertex a
    # clamp, a root and a division
    moved = layout_bytes + 4 * tiled.n + 2 * 4 * tiled.n * 16
    split = chunk_split(lambda m: ops.spmm(real, tiled, X16, tile_mask=m,
                                           deg=degf), tiled,
                        parts=SPLIT_PARTS)
    bound_ms = row("slimsell_spmm_gcn", ms, plain_ms, library_ms, moved,
                   2 * edges * 16 + edges + 3 * tiled.n, semiring_name="real",
                   batch=16, implicit_ms=implicit_ms, chunk_split=split,
                   max_abs_err_vs_float64=err64,
                   library_call="torch.sparse.mm on the GCN-normalised CSR "
                   "(real; the same function)")
    log(f"[10c] slimsell_spmm_gcn B=16, every tile kept: kernel {ms:.4f} ms "
        f"plain {plain_ms:.3f} ms implicit real SpMM {implicit_ms:.4f} ms "
        f"library (the same function) {library_ms:.4f} ms bound "
        f"{bound_ms:.4f} ms ({moved / 1e9:.4f} GB) on {card}; max abs err "
        f"vs float64: kernel {err64:.3e}, float32 plain {plain_err64:.3e}, "
        f"vs library {lib_err:.3e}")
    log(f"[10c] slimsell_spmm_gcn B=16 over parts of the layout: "
        f"{split_line(split)} on {card}")
    torch.cuda.synchronize()
    log(f"[10] phase 10 took {time.perf_counter() - t10:.1f} s (reserve "
        f"{GCN_RESERVE_S:.0f} s); the run {time.perf_counter() - t_start:.1f} "
        f"s so far")

    # ---- 18a-b: the kernels' autograd routes, and gcn-cora trained at scale
    # 20 on phase 10b's features, while the layout stands
    t18 = time.perf_counter()
    train_gcn_phase(dev=dev, card=card, csr=csr, tiled=tiled,
                    gcn_layouts=gcn_layouts, errs=errs, table=table)
    gc.collect()
    torch.cuda.empty_cache()
    t18_ab = time.perf_counter() - t18
    log(f"[18] phase 18a-b took {t18_ab:.1f} s; the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- 12: CC, k-hop and PageRank on the ported sweeps, at scale 20
    # before phase 11 frees the layout
    t12 = time.perf_counter()
    _, workloads = graph_workloads(
        dev=dev, card=card, csr=csr, tiled=tiled, root=root,
        lane_boolean=lane_boolean, roots=roots, push=push,
        small_csr=small_csr, small_cpu=small_cpu, small=small, root0=root0,
        adj=adj, full=full, layout_bytes=layout_bytes, errs=errs, table=table)
    torch.cuda.synchronize()
    log(f"[12] phase 12 took {time.perf_counter() - t12:.1f} s (reserve "
        f"{GRAPH_RESERVE_S:.0f} s); the run {time.perf_counter() - t_start:.1f}"
        f" s so far")

    # ---- 13: Brandes betweenness through kernel 2's real mode, at scale 20
    # before phase 11 frees the layout
    t13 = time.perf_counter()
    betweenness_phase(dev=dev, card=card, csr=csr, tiled=tiled, roots=roots,
                      push=push, small_csr=small_csr, small_cpu=small_cpu,
                      small=small, table=table)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[13] phase 13 took {time.perf_counter() - t13:.1f} s (reserve "
        f"{BC_RESERVE_S:.0f} s); the run {time.perf_counter() - t_start:.1f}"
        f" s so far")

    # ---- 14: the serving dispatcher over the ported front doors and
    # handles, at scale 20 before phase 11 frees the layout
    t14 = time.perf_counter()
    served = serving_phase(dev=dev, card=card, tiled=tiled, roots=roots,
                           push=push, msssp=mf, workloads=workloads,
                           table=table)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[14] phase 14 took {time.perf_counter() - t14:.1f} s (reserve "
        f"{SERVE_RESERVE_S:.0f} s); the run {time.perf_counter() - t_start:.1f}"
        f" s so far")

    # ---- 15: the serving session and router, at scale 20 before phase 11
    # frees the layout
    t15 = time.perf_counter()
    session_phase(dev=dev, card=card, tiled=tiled, served=served, table=table)
    del served
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[15] phase 15 took {time.perf_counter() - t15:.1f} s (reserve "
        f"{SESSION_RESERVE_S:.0f} s); the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- 16: the 2D-distributed strategy, ranks as processes sharing the
    # card, at scale 20 before phase 11 frees the layout
    t16 = time.perf_counter()
    dist_out = dist_phase(dev=dev, card=card, csr=csr, tiled=tiled,
                          root=root, roots=[int(r) for r in roots],
                          lane_boolean=lane_boolean, push=push,
                          sssp_root=fused, msssp=mf, workloads=workloads,
                          errs=errs, table=table)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[16] phase 16 took {time.perf_counter() - t16:.1f} s (reserve "
        f"{DIST_RESERVE_S:.0f} s); the run {time.perf_counter() - t_start:.1f}"
        f" s so far")

    # ---- 17: the analysis layer and the sanitizer, at scale 20 before phase
    # 11 frees the layout
    t17 = time.perf_counter()
    analysis_phase(dev=dev, card=card, tiled=tiled, root=root,
                   roots=[int(r) for r in roots], lane_boolean=lane_boolean,
                   push=push, sssp_root=fused, msssp=mf, workloads=workloads,
                   shards=dist_out["shards"], small=small, errs=errs,
                   table=table)
    del workloads, dist_out
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[17] phase 17 took {time.perf_counter() - t17:.1f} s (reserve "
        f"{ANALYSIS_RESERVE_S:.0f} s); the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    # ---- 11: DLRM inference (dlrm-mlperf widths) with the embedding bag (7)
    t11 = time.perf_counter()
    # free what phases 4-10 hold on the card: the capped tables take 45 GB
    held = torch.cuda.memory_allocated()
    del (tiled, small, cora, gcn_layouts, adj, adj_gcn, adj_wt, x, X, xr, Xr,
         x_fin, X_fin, X16, got, want32, degf, full, states, st, mask,
         packed_masks, light, heavy, poisoned)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[11] device memory held {held / 2**30:.2f} GiB before phase 11, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after freeing")
    # DLRM is float32 end to end, as in the JAX package: matmul and bmm stay
    # in full float32 (allow_tf32 is False since phase 10, PyTorch's default)
    # (a) kernel 7 against its plain version, bit-equal (both add in slot
    # order); the bags a strided field of a [B, 3, K] id tensor, and the
    # same bags contiguous
    g11 = np.random.default_rng(11)
    n_cases = 0
    for V, d, B, K in BAG_CASES:
        tab = torch.from_numpy(g11.standard_normal((V, d)).astype(
            np.float32)).to(dev)
        for pads in ("none", "random", "empty"):
            ids = bag_ids(V, (B, 3, K), 0.0 if pads == "none" else 0.3, g11)
            if pads != "none":
                ids[0, 1, :] = -1
            if pads == "empty":
                ids[:] = -1
            field = torch.from_numpy(ids).to(dev)[:, 1]
            for bags in (field, field.contiguous()):
                for mode in ("sum", "mean"):
                    check_equal("embedding_bag_grouped",
                                ops.embedding_bag(tab, bags, mode),
                                embedding_bag_ref(tab, bags, mode), errs,
                                f"V={V} d={d} B={B} K={K} {pads} {mode} "
                                f"contiguous={bags.is_contiguous()}")
                    n_cases += 1
    # a table past 2^31 elements, its last rows read: 64-bit row offsets
    V_big = 2 ** 24 + 2 ** 20
    big = torch.randn((V_big, 128), generator=torch.Generator(
        device=dev).manual_seed(11), device=dev)
    ids = bag_ids(2 ** 20, (4096, 3), 0.2, g11)
    ids[ids >= 0] += 2 ** 24
    ids[:, 0] = np.arange(V_big - 4096, V_big)  # the very last rows
    bags = torch.from_numpy(ids).to(dev)
    for mode in ("sum", "mean"):
        check_equal("embedding_bag_grouped", ops.embedding_bag(big, bags, mode),
                    embedding_bag_ref(big, bags, mode), errs,
                    f"V={V_big} ({V_big * 128} elements) {mode}")
        n_cases += 1
    last = ops.embedding_bag(big, bags[:, :1])
    if not torch.equal(last, big[-4096:]):
        raise AssertionError("embedding_bag misread the last rows of a table "
                             "past 2^31 elements")
    # the grouped entry: five tables in one launch, the big one read to its
    # last rows, ids strided along K, an id past V in table 4 only
    vocabs = (100, 3, V_big, 1000, 17)
    gtables = [big if v == V_big else torch.from_numpy(
        g11.standard_normal((v, 128)).astype(np.float32)).to(dev)
        for v in vocabs]
    ids = np.stack([bag_ids(v, (4096, 3), 0.2, g11) for v in vocabs], 1)
    ids[:, 2, 0] = np.arange(V_big - 4096, V_big)
    ids[7, 4, 1] = vocabs[4]
    gbags = torch.from_numpy(np.repeat(ids, 2, axis=2)).to(dev)[:, :, ::2]
    n_grouped = 0
    for mode in ("sum", "mean"):
        for stacked in (False, True):
            Zg = torch.full((4096, 1 + len(vocabs), 128), 5.0, device=dev)
            got_g = ops.embedding_bag_grouped(gtables, gbags, mode,
                                              out=Zg[:, 1:] if stacked else None)
            what = f"grouped {mode} stacked={stacked}"
            check_equal_nan("embedding_bag_grouped", got_g,
                            embedding_bag_grouped_ref(gtables, gbags, mode),
                            errs, what)
            per_table = torch.stack([ops.embedding_bag(t, gbags[:, i], mode)
                                     for i, t in enumerate(gtables)], 1)
            check_equal_nan("embedding_bag_grouped", got_g, per_table, errs,
                            f"{what} against one launch a table")
            nan_bags = torch.isnan(got_g).any(dim=2).nonzero().tolist()
            if nan_bags != [[7, 4]]:
                raise AssertionError(f"grouped: NaN bags {nan_bags}, not [[7, 4]]")
            if stacked and not torch.equal(Zg[:, 0], torch.full(
                    (4096, 128), 5.0, device=dev)):
                raise AssertionError("grouped: wrote outside its out slice")
            n_grouped += 1
    del big, last, gtables, gbags, Zg, got_g, per_table
    # out of contract: ids at or past V are never read and make their bag NaN
    tab = torch.randn((100, 128), device=dev)
    bags = torch.from_numpy(bag_ids(100, (64, 3), 0.2, g11)).to(dev)
    bags[5, 1], bags[9, 0] = 100, 2 ** 31 - 1
    y = ops.embedding_bag(tab, bags)
    nan_rows = torch.isnan(y).any(dim=1).nonzero().flatten().tolist()
    if nan_rows != [5, 9] or not torch.isnan(y[[5, 9]]).all():
        raise AssertionError(f"ids past the table: NaN rows {nan_rows}")
    torch.cuda.synchronize()
    # dlrm_forward on the card against the CPU, within 1e-4
    card_cpu = []
    for cname, cfg_a in (("reduced", reduced_config()),
                         ("mlperf widths, 1000 rows", capped_config(1000)),
                         ("mlperf widths, 1000 rows, multi_hot 3",
                          dataclasses.replace(capped_config(1000), multi_hot=3))):
        cpu_p = dlrm.dlrm_init(cfg_a, generator=torch.Generator().manual_seed(12),
                               device="cpu")
        dev_p = {"tables": [t.to(dev) for t in cpu_p["tables"]],
                 **{k: [{n: v.to(dev) for n, v in layer.items()}
                        for layer in cpu_p[k]] for k in ("bot", "top")}}
        arrays = CriteoPipeline(cfg_a.vocabs, 256, cfg_a.multi_hot,
                                seed=12).get_batch(0)
        if cfg_a.multi_hot > 1:
            arrays["sparse"][g11.random(arrays["sparse"].shape) < 0.3] = -1
            arrays["sparse"][0, :, :] = -1  # every bag of one sample empty
        with torch.inference_mode():
            want = dlrm.dlrm_forward(cpu_p, convert.dlrm_batch_from_arrays(
                arrays, device="cpu"), cfg_a, device="cpu")
            got_f = dlrm.dlrm_forward(dev_p, convert.dlrm_batch_from_arrays(
                arrays, device=dev), cfg_a, device=dev)
        check_close("dlrm_forward", got_f.cpu(), want, None,
                    f"{cname} card vs CPU", 1e-4)
        card_cpu.append(f"{cname} {max_abs_err(got_f.cpu(), want):.3e} "
                        f"(logits max abs {float(want.abs().max()):.3e})")
    del tab, bags, y, dev_p
    log(f"[11a] embedding_bag == plain (bit-equal) on {n_cases} cases "
        f"(B x K x d sweep, sum and mean, pads none / random / empty, strided "
        f"and contiguous bags, a {V_big}-row table past 2^31 elements read to "
        f"its last row); ids past V give NaN bags {nan_rows}; "
        f"embedding_bag_grouped == plain and == one launch a table "
        f"(bit-equal) on {n_grouped} cases of 5 tables {vocabs}, the big one "
        f"read to its last rows, an id past V in one table only giving NaN "
        f"in that bag alone; dlrm_forward card == CPU within 1e-4, max abs "
        f"err: {'; '.join(card_cpu)}")

    # (b) the main path at full width on the capped tables
    cfg = capped_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen11 = torch.Generator(device=dev).manual_seed(11)
    params = dlrm.dlrm_init(cfg, generator=gen11, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    table_bytes = sum(t.numel() * t.element_size() for t in params["tables"])
    t0 = time.perf_counter()
    batches = {name: convert.dlrm_batch_from_arrays(CriteoPipeline(
        cfg.vocabs, RECSYS_SHAPES[name]["batch"], cfg.multi_hot,
        seed=11).get_batch(0), device=dev) for name in SERVE_SHAPES}
    torch.cuda.synchronize()
    log(f"[11b] {cfg.name} capped at 2^24 rows a table: {sum(cfg.vocabs)} "
        f"rows, tables {table_bytes} bytes, initialised on the card in "
        f"{init_s:.2f} s; batches {dict((k, RECSYS_SHAPES[k]['batch']) for k in SERVE_SHAPES)} "
        f"made in {time.perf_counter() - t0:.2f} s")

    def forward_s(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            y = dlrm.dlrm_forward(params, batch, cfg)
        torch.cuda.synchronize()
        return y, time.perf_counter() - t0

    ops.reset_launches()
    n_fwd = 0
    first, fwd = {}, {}
    for name in SERVE_SHAPES:
        B = RECSYS_SHAPES[name]["batch"]
        answers = [forward_s(batches[name]) for _ in range(3)]
        y0 = answers[0][0]
        if y0.shape != (B,) or not torch.isfinite(y0).all():
            raise AssertionError(f"{name}: logits of shape {tuple(y0.shape)}, "
                                 "or not finite")
        if not all(torch.equal(y, y0) for y, _ in answers):
            raise AssertionError(f"{name}: the three requests differ")
        first[name] = y0
        fwd[name] = [forward_s(batches[name])[1]
                     for _ in range(20 if name == "serve_p99" else 5)]
        n_fwd += len(answers) + len(fwd[name])
        log(f"[11b] {name} B={B}: 3 requests "
            f"{[round(dt, 6) for _, dt in answers]} s, bit-equal, finite")
    counts = ops.launch_counts()
    if counts["embedding_bag_grouped"] != n_fwd:
        raise AssertionError(
            f"embedding_bag_grouped launched {counts['embedding_bag_grouped']} "
            f"times over {n_fwd} forwards: one launch a forward, all "
            f"{len(cfg.vocabs)} tables in it")
    launches["embedding_bag_grouped"] = counts["embedding_bag_grouped"]
    peak = torch.cuda.max_memory_allocated()
    log(f"[11b] main-path launches embedding_bag_grouped="
        f"{counts['embedding_bag_grouped']} ({n_fwd} forwards x 1); peak "
        f"device memory {peak / 2**30:.2f} GiB ({peak} bytes)")
    # the kernel's logits against the plain lookups' on the card: bit-equal
    for name in SERVE_SHAPES:
        with plain_lookups(dlrm, embedding_bag_grouped_ref):
            before = ops.launch_counts()
            with torch.inference_mode():
                y_plain = dlrm.dlrm_forward(params, batches[name], cfg)
            if ops.launch_counts() != before:
                raise AssertionError("the plain reference run launched a kernel")
        if not torch.equal(y_plain, first[name]):
            raise AssertionError(f"{name}: logits with kernel 7 != logits with "
                                 "the plain lookups")
    log(f"[11b] logits with the grouped kernel 7 == logits with "
        f"embedding_bag_grouped_ref in _lookup_all, bit-equal, at "
        f"{', '.join(SERVE_SHAPES)}")

    def split_ms(batch):
        """CUDA events between the forward's parts: the bottom MLP, the 26
        lookups (one grouped launch into the stacked tensor), the
        interaction and the top MLP."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        with torch.inference_mode():
            ev[0].record()
            dense = dlrm.bottom(params, batch["dense"], cfg)
            ev[1].record()
            Z = dense.new_empty((dense.shape[0], 1 + cfg.n_sparse,
                                 dense.shape[1]))
            dlrm._lookup_all(params["tables"], batch["sparse"], Z[:, 1:])
            ev[2].record()
            Z[:, 0] = dense
            xi = dlrm._interact(Z)
            ev[3].record()
            dlrm.top(params, xi)
            ev[4].record()
        ev[4].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    serve = {}
    for name in SERVE_SHAPES:
        B = RECSYS_SHAPES[name]["batch"]
        split_ms(batches[name])
        parts = np.median([split_ms(batches[name]) for _ in range(5)], axis=0)
        med = float(np.median(fwd[name]))
        serve[name] = {"batch": B, "forward_ms": 1e3 * med,
                       "samples_per_s": B / med,
                       "bottom_ms": parts[0], "lookups_ms": parts[1],
                       "interaction_ms": parts[2], "top_ms": parts[3]}
        log(f"[11b] {name} B={B} forward, warm, median of {len(fwd[name])}: "
            f"{med * 1e3:.4f} ms, {B / med:.6e} samples/s on {card}; CUDA "
            f"events (median of 5): bottom MLP {parts[0]:.4f} ms, lookups "
            f"{parts[1]:.4f} ms, interaction {parts[2]:.4f} ms, top MLP "
            f"{parts[3]:.4f} ms (sum {parts.sum():.4f})")
    # the retrieval path: one user against 10^6 candidates
    n_cand = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    cands = torch.randn((n_cand, cfg.embed_dim), generator=gen11, device=dev)
    user = {"dense": batches["serve_p99"]["dense"][:1]}

    def retrieve():
        with torch.inference_mode():
            u = dlrm.dlrm_user_tower(params, user, cfg)[0]
            return u, dlrm.retrieval_scores(u, cands)

    u, scores = retrieve()
    check_close("retrieval_scores", scores, cands.double() @ u.double(), None,
                "against float64", 1e-4)
    retrieval_ms = time_ms(retrieve, 20)
    log(f"[11b] retrieval_cand: user tower + {n_cand} x {cfg.embed_dim} "
        f"scores {retrieval_ms:.4f} ms on {card}; scores within 1e-4 of float64")
    del batches, first, y_plain, cands, u, scores

    # (c) kernel 7 at both serving shapes on one 2^24-row table (a launch
    # with T = 1), K = 1 and K = 3 with pads, beside its plain version,
    # F.embedding_bag and its bound; enough bag sets in turn that the rows
    # read exceed the 50 MB L2
    tab = params["tables"][0]
    V, d = tab.shape
    shape_rows = []
    for name in SERVE_SHAPES:
        B = RECSYS_SHAPES[name]["batch"]
        for K, pad_share in ((1, 0.0), (3, 0.3)):
            n_sets = max(2, -(-(64 << 20) // (B * K * 4 * d)))
            sets = [bag_ids(V, (B, K), pad_share, g11) for _ in range(n_sets)]
            dev_sets = [torch.from_numpy(s_).to(dev) for s_ in sets]
            lib_sets = [library_bags(s_, dev) for s_ in sets]
            got_b = ops.embedding_bag(tab, dev_sets[0])
            check_equal("embedding_bag_grouped", got_b,
                        embedding_bag_ref(tab, dev_sets[0]), errs,
                        f"{name} K={K} on a 2^24-row table")
            lib_err = max_abs_err(torch.nn.functional.embedding_bag(
                lib_sets[0][0], tab, lib_sets[0][1], mode="sum"), got_b)
            it_k, it_p, it_l = (itertools.cycle(dev_sets),
                                itertools.cycle(dev_sets),
                                itertools.cycle(lib_sets))

            def library():
                flat, offsets = next(it_l)
                return torch.nn.functional.embedding_bag(flat, tab, offsets,
                                                         mode="sum")

            reps = max(20, 2 * n_sets)
            ms = time_ms(lambda: ops.embedding_bag(tab, next(it_k)), reps)
            plain_ms = time_ms(lambda: embedding_bag_ref(tab, next(it_p)), reps)
            library_ms = time_ms(library, reps)
            # the ids, each distinct row they name once (pads read nothing)
            # and the output; one add per id that is not a pad, per element
            moved = 4 * B * K + 4 * bag_rows(sets) * d + 4 * B * d
            adds = sum(int((s_ >= 0).sum()) for s_ in sets) / n_sets * d
            bound_ms = 1e3 * max(moved / HBM_BYTES_PER_S, adds / F32_OPS_PER_S)
            shape_rows.append({"shape": name, "batch": B, "tables": 1, "K": K,
                               "pad_share": pad_share, "ms": ms,
                               "plain_ms": plain_ms, "library_ms": library_ms,
                               "bound_ms": bound_ms, "bytes": moved,
                               "adds": adds, "bag_sets": n_sets,
                               "max_abs_err_vs_library": lib_err})
            log(f"[11c] embedding_bag (one table) {name} B={B} K={K} (pads "
                f"{pad_share}): "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms F.embedding_bag "
                f"{library_ms:.4f} ms bound {bound_ms:.4f} ms ({moved / 1e6:.2f} "
                f"MB, {n_sets} bag sets in turn) on {card}; vs library max abs "
                f"err {lib_err:.3e}")
    del dev_sets, lib_sets
    # the launch over all 26 tables, as a forward makes it, beside its plain
    # version, 26 launches of one table and 26 F.embedding_bag calls
    tables = params["tables"]
    T = len(tables)
    grouped_rows = []
    for name in SERVE_SHAPES:
        B = RECSYS_SHAPES[name]["batch"]
        for K, pad_share in ((1, 0.0), (3, 0.3)):
            n_sets = max(2, -(-(64 << 20) // (B * T * K * 4 * d)))
            sets = [np.stack([bag_ids(v, (B, K), pad_share, g11)
                              for v in cfg.vocabs], 1) for _ in range(n_sets)]
            dev_sets = [torch.from_numpy(s_).to(dev) for s_ in sets]
            lib_sets = [[library_bags(s_[:, t], dev) for t in range(T)]
                        for s_ in sets]
            got_g = ops.embedding_bag_grouped(tables, dev_sets[0])
            check_equal("embedding_bag_grouped", got_g,
                        embedding_bag_grouped_ref(tables, dev_sets[0]), errs,
                        f"{name} K={K}, 26 capped tables")
            check_equal("embedding_bag_grouped", got_g, torch.stack(
                [ops.embedding_bag(t, dev_sets[0][:, i])
                 for i, t in enumerate(tables)], 1), errs,
                f"{name} K={K}, 26 capped tables, against one launch a table")
            lib_err = max(max_abs_err(torch.nn.functional.embedding_bag(
                flat, t, offsets, mode="sum"), got_g[:, i])
                for i, (t, (flat, offsets)) in enumerate(zip(tables,
                                                             lib_sets[0])))
            del got_g
            it_g, it_p, it_t, it_l = (itertools.cycle(dev_sets),
                                      itertools.cycle(dev_sets),
                                      itertools.cycle(dev_sets),
                                      itertools.cycle(lib_sets))

            def per_table():
                bags = next(it_t)
                return [ops.embedding_bag(t, bags[:, i])
                        for i, t in enumerate(tables)]

            def library():
                return [torch.nn.functional.embedding_bag(
                    flat, t, offsets, mode="sum")
                    for t, (flat, offsets) in zip(tables, next(it_l))]

            reps = max(20, 2 * n_sets)
            ms = time_ms(lambda: ops.embedding_bag_grouped(tables, next(it_g)),
                         reps)
            per_table_ms = time_ms(per_table, reps)
            library_ms = time_ms(library, reps)
            plain_ms = time_ms(lambda: embedding_bag_grouped_ref(
                tables, next(it_p)), max(3, n_sets))
            moved = 4 * B * T * K + 4 * sum(
                bag_rows([s_[:, t] for s_ in sets]) for t in range(T)) * d \
                + 4 * B * T * d
            adds = sum(int((s_ >= 0).sum()) for s_ in sets) / n_sets * d
            bound_ms = 1e3 * max(moved / HBM_BYTES_PER_S, adds / F32_OPS_PER_S)
            grouped_rows.append({"shape": name, "batch": B, "tables": T,
                                 "K": K, "pad_share": pad_share, "ms": ms,
                                 "per_table_ms": per_table_ms,
                                 "plain_ms": plain_ms,
                                 "library_ms": library_ms,
                                 "bound_ms": bound_ms, "bytes": moved,
                                 "adds": adds, "bag_sets": n_sets,
                                 "max_abs_err_vs_library": lib_err})
            log(f"[11c] embedding_bag_grouped {name} B={B} x {T} tables K={K} "
                f"(pads {pad_share}): one launch {ms:.4f} ms, 26 one-table "
                f"launches {per_table_ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, 26 F.embedding_bag {library_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({moved / 1e6:.2f} MB, {n_sets} bag "
                f"sets in turn) on {card}; vs library max abs err "
                f"{lib_err:.3e}")
            del dev_sets, lib_sets, sets
    head = grouped_rows[0]  # serve_p99, K = 1: the cell the grouping is for
    row("embedding_bag_grouped", head["ms"], head["plain_ms"],
        head["library_ms"], head["bytes"], head["adds"], semiring_name=None,
        batch=head["batch"], K=1, tables=T,
        library_call="26 torch.nn.functional.embedding_bag calls (sum, 1-D "
        "ids and offsets; the same function)",
        shapes=grouped_rows + shape_rows,
        serving=serve, retrieval_ms=retrieval_ms, peak_bytes=peak)
    del params, tab, tables
    torch.cuda.empty_cache()
    log(f"[11] phase 11 took {time.perf_counter() - t11:.1f} s (reserve "
        f"{DLRM_RESERVE_S:.0f} s); the run {time.perf_counter() - t_start:.1f} "
        f"s so far")

    # ---- 18c-d: DLRM trained at train_batch on the 2^22-row tables, once
    # phase 11 has freed its own; checkpoints
    t18 = time.perf_counter()
    train_dlrm_phase(dev=dev, card=card, errs=errs, table=table)
    train_checkpoint_phase(dev=dev, card=card)
    log(f"[18] phase 18 took {t18_ab + time.perf_counter() - t18:.1f} s "
        f"(reserve {TRAIN_RESERVE_S:.0f} s); the run "
        f"{time.perf_counter() - t_start:.1f} s so far")

    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
