#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths (``neural_spectral_codec_torch``) the way a user
would, at the full width of the model the repository supports, with
weights and data made from seeds:

1. device: requires a CUDA card and prints its name and power limit;
2. build: compiles the hand-written kernels from ``csrc/`` (one nvcc per
   source, in parallel);
3. kernels: each kernel against its plain PyTorch version on the same
   CUDA tensors at its path's shapes. The serving kernels at 8
   full-density HDL-64E scans (133,632 points each) and on edge cases
   (drop mode, other fold counts, partial rows, no interpolation, points
   on bin edges and axes): the spectral kernel to <= 1e-5, the two
   projection kernels bit-equal (and equal to the plain path run on the
   CPU). The general projection kernel on scans in random order and in a
   sensor's sweep order (rings flattened ring-major, a NaN tail), each at
   B=1 and B=8. The probe kernels at the
   probe shapes (512 x 2176 keys, 512 x 768 and 512 x 2176 floors,
   512 x 2112 chain): the ring-fold probe bit-equal for n_folds 1-3 and,
   after the min over folds, equal to the ring kernel's image; every
   phase-ablation variant launches and gives finite rows; the ring-fold
   probe also bit-equal at B=1, on a single row, width 2175, rows off a
   16-byte boundary, all-invalid rows, rows that wrap at every point and
   the widest rows it takes, the next width refused; both roll kernels
   bit-equal (int32 views) there and in ROLL_CASES: windows shorter than
   the row, rows with NaN, ±0 and ±inf, widths 2175 and 2110, rows off a
   16-byte boundary, single rows; the three probes' device time also with
   a cold L2 (a 64 MB write before each launch, not counted), the
   ring-fold probe's also at B=1. The
   spectral kernel also at the serve shape (B=1),
   at E=16 (the training configuration) and E=20 (pooling windows that
   straddle CTAs), each with interpolation on and off and alpha 2.0 and
   1.3; the ring kernel also at B=1. One wrapper call of each serving
   kernel must enqueue its kernel and no other device operation
   (``torch.profiler``). Times (``utils/timing.py``), per
   kernel: its own device time (``torch.profiler`` kernel time by name
   over 50 wrapper calls, cross-checked by CUDA events around 200 bare
   C-entry launches queued behind a spin kernel), at B=8 and, for the
   three serving kernels, B=1 (the general projection kernel in both
   point orders); the wrapper's time per call (one event
   pair per call); the plain version's; and the bound (bytes at
   3.35 TB/s or fp32 operations at 67 TFLOP/s, from this run's shapes).
   The verifier's two searches, kernel N (nearest neighbour, 31 a
   registration) and kernel K (k-NN within a cloud, one a prepared
   cloud), bit-equal to their plain versions at 4,096 x 4,096 on two
   prepared frames of phase 8's stream and random clouds, and on a
   lattice (ties), duplicate targets, one or no valid target, fewer than
   k valid points, NaN rows, P != Q, P = 1, k = 16 and 32; their device
   time, wrapper and plain time, the two-call yardstick (torch.cdist +
   argmin or topk) and the bound (9 operations a pair that cannot fuse,
   at 33.5 T/s). The verifier's two eigen-solves, kernel C (k-NN PCA to
   normals or GICP covariances, one a prepared cloud) and kernel R (the
   point-to-point update after kernel N: weights, centroids, H and the
   Kabsch solve, one a point-to-point iteration), against their plain
   versions (float32 ``eigh``; the float32 step ending in ``svd`` and
   ``det``): C after kernel K on
   the two prepared frames, random, padded, few-valid, repeated,
   collinear and lattice clouds, covariances (k 20, eps 1e-3) within 1e-5
   and normals (k 16) within 1 - |cos| <= 1e-4 on the rows whose relative
   eigen-gap lets the float32 solve reach the bar, invariants on every
   row, every row finite; R's update on the prepared frames' steps
   (identity and offset, half masked, no pair in range, P = 1,000 and
   20,000) within 1e-7 of the float64 plain step (R, and t over
   max(1, |p_c|_1)) and of the float32 one plus its own error, the
   same bits twice, and its solve entry on random, reflected, rotation,
   rank-2, rank-1 and zero H and a real step's H, R within 1e-5 and t
   within 1e-5 max(1, |p_c|_1), H = 0 giving I; their device, wrapper and
   plain time (and R's solve entry's device time), the yardstick
   (``eigh`` of the covariances; ``svd`` of H) and the bound (bytes).
   Kernel Q (the stage-1 query's fused body) bit-equal to its plain
   version, indices and distances, at 100,032 x 800 in 72 cases: float32
   and uint16 W1 rows and L2, Q = 1, 3, 8, 32 and 40 (two query groups),
   k = 1, 10, 50, 128 (K_MAX) and 200 (the distance entry), the spatial
   filter off and on, size the database, below it and 0 (every slot +inf,
   rows 0 .. k - 1), copies of a row (ties by the lower row) and rows at
   the filter radius +-1 ulp (the first masked); its device, wrapper and
   plain time at Q = 1, 8 and 32 for each storage and metric, the
   earlier plain chain, the
   ``cdist`` yardstick and the bound (bytes at Q = 1, operations at 32);
4. serve: a 1,000-node keyframe graph, a full-width SpectralGNN
   (800 -> 256 -> 800, 3 GAT layers), a 100,000-row W1 database on the
   card, and 32 requests through ``serve_step`` (16 ring-structured, 16
   arbitrary-order scans, each arriving on the host), top-10 with a
   spatial filter, query and insert on. The serving executables of both
   forms are built first by scratch executions (``warm_serve_step``): the
   captured graphs must hold K3 (its node cooperative, read back from the
   graph) + K1 or K2 + K1. The requests run through the replayed graphs
   (the counted path) and again eagerly from the same database snapshot:
   descriptors bit-equal, embeddings within 1e-6, indices and inserted
   rows equal; latency p50 and max of both, the device ms of one replay
   (CUDA events) and the graph pool's bytes. Each request's scan also
   sits in the database as a row computed by the plain path on the CPU,
   outside the spatial filter; it must come back as top-1, the descriptor
   must agree with the CPU's to 1e-4 and the embeddings to 1e-3, and
   every serving kernel's launch count must rise (kernel Q's included). Then the same
   database, and its rows as uint16 codes, through the stage-1 query
   graphs (``retriever.QueryExecutable``): each request's descriptor as
   one query and the 32 as a batch, with the spatial filter, through the
   graphs and eagerly: indices and distances bit-equal, top-1 the planted
   row; p50 wall and device ms of both forms, graph nodes, pool MiB;
5. probes: the two stage-profile entry points
   (``experiments.ring_stage_probe``, ``experiments.profile_hotpath``)
   with few iterations, each on its own: ring_stage_probe must launch the
   ring probe, the roll floor and the ring kernel, profile_hotpath the
   ring probe, the roll+min chain and the three serving kernels;
6. structured: ``encode_structured`` on four full-density flat streams
   (sweep order, firing-interleaved with and without a ring field, one
   unstructured); the first three must take the ring path and the last
   the general path, and each descriptor must be <= 1e-6 from
   ``encode_points_batch`` on the same cloud;
7. training: (k) kernel M (the miner's "hard" chunk) bit-equal to its
   plain version (draws with the same u, hard negatives, counts, valid)
   on every 2,048-anchor chunk of a 20,000-frame ``synthetic_city``
   sequence and on partial chunks, then timed on one 2,048 x 100,000
   chunk; kernel M's other three entries (the "semi-hard" W₁ block, the
   "random" counts, the draw over either mask) and kernel S (the row
   select at count_neg // 2) bit-equal to their plain versions on the
   same chunks (S also against ``torch.sort(stable=True)`` and on rows of
   ties, ±0, ±inf, NaN, odd widths and strides, in both regimes and every
   cluster width, with runs of ties across slice edges; the counts entry
   and the draws after it also on pairs at each squared bound and one
   ulp either side), each timed at 2,048 x 100,000 (the counts entry's
   gate: kept pairs, both bounds; the draw over both masks after the
   counts entry and the positive draw after the hard entry, with the
   rounds an anchor, the frames read and the tiles its gate kept); kernel
   G (the gathers' backward)
   bit-equal to its plain version and to the CPU's ``index_add_`` on the
   GAT neighbour table of a 20,000-node graph (float32 and bf16) and on
   4,096 triplet gathers with repeats, timed against ``index_add_``; (d)
   the training graph families
   (mining, train step, embedding pass, revisit scan, recall) against
   their eager steps on a 20,000-node run: the same triplets, three train
   steps with equal losses, parameters, buffers and Adam state, equal
   embeddings, revisit queries and Recall@{1,5,10}; the step's profiler
   record holds G and no index_add kernel; two seeded epochs bit-equal;
   Recall@1 and @5 on tied embeddings equal to the CPU's; one
   100,000-node train step replayed and run eagerly, timed; the
   "semi-hard" and "random" mining graphs: the eager step's triplets at
   20,000 nodes, no capture in a second epoch, no op-by-op chunk, the
   CPU's anchors (semi-hard: and negatives) at 3,000 nodes with every
   draw inside its masks, a 100,000-node epoch timed;
   (a) one full-width train step (512 nodes, dropout 0, TF32
   off) on the card against the same step on the CPU from identical
   state, after hard-negative mining on both (the card's anchors and hard
   negatives must equal the CPU's): loss within 1e-4 relative, gradients
   within 1e-4 of each tensor's largest entry, parameters within 1e-4
   (except the gauge biases, whose true gradient is 0, and elements whose
   gradient is below 1e-3 of their tensor's largest, where Adam's update
   sign follows rounding); (b) the training entry point
   (``train_multi_dataset.main``, 120 synthetic frames, 2 epochs, a config
   dict with configs/training.yaml's values) once with the default encoder
   (``project`` and ``spectral`` must launch) and once with
   ``encoding.ring_major`` on 64-beam sweep-ordered sensor streams
   (``ring_fold`` and ``spectral`` must launch): finite losses, and the
   final checkpoint reloads to an equal state_dict; (c)
   ``experiments.scale_100k`` at 20,000 nodes through the training graphs
   and again eagerly: stage times, Recall@{1,5,10}, peak memory, and no
   capture in the graph run's second epoch of any family; M and G must
   launch;
8. online: the online loop (``run_online`` through
   ``experiments.online_latency.run``) with configs/inference.yaml over
   default.yaml (built in code), full width (800-D descriptors, the
   SpectralGNN with random weights, 131,072 points a scan, top-10,
   context window 10, GICP at 30 iterations, 4,096 points and 0.3 m
   voxels, one-dispatch serving, async loop closing, 8 verification
   workers, warmup on), except the spatial filter (0), the synthetic
   stream in place of a dataset and a capacity of the map plus the
   session. It resumes a 100,000-record store written through the port's
   ``save_database`` (random ^4 histograms over 20 km, no points) and
   streams 200 pre-generated frames of two laps. Checks: loop closures on
   the second lap, each within the gates, in the g2o file; every
   descriptor within 1e-4 of the CPU plain encoder; the same edge set in
   the synchronous ``fused_query: false`` mode; the native and torch (on
   the card) verifier backends agree on the candidates of 10 queries
   (first: which of the verifier's linear-algebra calls a CUDA graph
   captures, ``experiments.capture_probe``; solve_ex and inv_ex must),
   and on every pair the torch backend's registration graph (one replay
   a pair, 31 kernel N launches credited, and 30 of kernel R in
   point-to-point) gives the eager step's T, fitness and RMSE bit for
   bit, and on every cloud its prepare graph (kernels K and C) the eager
   prepare's tensors, for GICP and (2 queries) point-to-plane and
   point-to-point, whose T must also lie within 1e-4 of the plain step on
   the CPU; no graph captured after each verifier's ``warmup()``; a
   torch.profiler window over a prepare and a pair of each method holds
   no cuSOLVER or MAGMA kernel and no host copy beyond the three designed
   ones; with ms a pair of graph, eager and native, prepare's ms through
   its graph and eagerly, the graphs' nodes and capture seconds;
   100,000 + keyframes rows, restored by a save/load round trip; ``project``
   and ``spectral`` launched (counted inside the graph replays); 0 serving
   graphs captured mid-stream (``warmup()`` captures them) and one replay
   a keyframe. It prints per-keyframe latency p50/p95/max, keyframes over
   100 ms, stage means, GICP ms per pair of each backend, warmup seconds,
   peak device memory, each captured executable's bucket, nodes and
   capture seconds, the graph pool's bytes, and (torch.profiler over a
   short fresh session, warmed up before the profiler starts) the device
   time and operations per keyframe. Last, three sessions of 140 frames
   with the torch verifier: async after ``warmup()`` (the verifier's
   path, counted: kernels N, K and C must launch; verification ms a query,
   keyframe p50/p95/max; nothing captured mid-stream), then async and
   sync with the executable cache dropped every 20 frames while the
   verifier works through its backlog on the async worker: every serving
   capture counted, no registration graph captured mid-stream, and async
   with ``fused_query`` false, whose worker runs each stage-1 query
   through the query graph (replays counted, none captured mid-stream):
   the loop closures of all four equal. The synchronous split run
   captures no query graph mid-stream. Last, the split mode
   (``fused_encode`` false) on SPLIT_FRAMES frames: every eval step (one
   bucket graph replay a keyframe, ``gnn.EvalExecutable``) bit-equal to
   the same step run eagerly, the embeddings within SPLIT_EMB_TOL of the
   fused encode + refresh's on the same frames and weights, 0 eval or
   query graphs captured after ``warmup()``, keyframe p50/p95, one
   bucket's step wall and device ms through its graph and eagerly. Then
   the full-graph mode (``gnn.use_local_updates`` false) on the same
   frames: ``warmup()`` captures the eval graphs of the buckets 8 to
   1,024 (that of ``max_active_nodes``), each keyframe's whole window runs
   one replay of its bucket's graph; every forward (warm-up included)
   bit-equal to the same executable run eagerly on the same padded graph,
   every keyframe's within SPLIT_EMB_TOL of ``gnn_forward`` op by op on
   the unpadded window, 0 eval or query graphs captured mid-stream, one
   eval replay a keyframe, no op-by-op forward in the session, K3 and K1
   launched; keyframe p50/p95/max and stage means; at the configured
   window (a 1,000-node graph of seeded descriptors) bucket 1,024 through
   its graph bit-equal to its eager step and within SPLIT_EMB_TOL of the
   op-by-op forward, the wall and device ms of the three, and the eval
   graph pool's MiB;
9. datasets and evaluation: three sequences written in their datasets'
   on-disk formats from seeded SyntheticWorld streams through simulated
   sensors (``DATA_SEQS``: KITTI 150 frames of 131,072 points in sweep
   order, NCLT 64 frames of an HDL-32E, HeLiPR 64 frames of 16 beams with
   ring ids), then the user's entry points on them: ``run_benchmark``
   (configs/inference.yaml, phase 7b's trained full-width GNN, the
   rotation check, native read-ahead "always") with the default encoder
   (``project`` and ``spectral`` must launch, ``ring_fold`` not) and with
   ``encoding.ring_major`` (``ring_fold`` and ``spectral`` must launch);
   ``_process_sequence`` with read-ahead "always" and "off" in turns
   (scans/s, descriptors bit-equal); ``pipeline --mode online`` on the
   KITTI sequence (a g2o file whose loop closures all join a second-lap
   scan to its place on the first lap; per-keyframe latency) and
   ``pipeline --mode train`` for one epoch on the three sequences (a
   checkpoint, a finite loss). Every keyframe descriptor of both
   benchmark runs within 1e-4 of the CPU plain encoder; each evaluation
   on the card equal to the same function on the CPU over the same
   embeddings (``_eval_same``); the rotation check passed; the ranking
   graph (``evaluation.RankExecutable``) equal to the eager step and the
   CPU on 6,000 descriptors in chunks of 1,000 (the last padded) and on
   tied embeddings, then 100,000 embeddings through the graph and
   eagerly, timed, with the ranking pool's MiB;
10. multi-device and bf16 (``parallel/``, one controller, ``Mesh``):
   ``create_mesh()`` over every card (printed), four logical shards of
   the first (``Mesh([cuda:0] * 4)``) and, on a machine with more cards,
   up to four distinct ones. The batch-sharded encoders on 32 full-
   density scans, 8 a shard (general path at 131,072 points in random
   and sweep order, ring path 64 x 2088): equal to the unsharded batch
   encoder (<= 1e-7, 0 expected), within 1e-4 of the CPU plain path,
   4 K3 + 4 K1 or 4 K2 + 4 K1 a call. The row-sharded W1 database at
   100,000 x 800 in 4 slabs, float32 W1, uint16 W1 and float32 L2: 32
   planted queries top-1 with the spatial filter, indices equal to the
   unsharded retriever's (ties by the lower row), distances within
   1e-6 (uint16: one code), ``update_rows`` on four slabs,
   ``exclude_last``, ``as_of_size``; the sharded query through its
   graph bit-equal to the same step run eagerly, no capture after
   warm-up; query ms p50 of all three. Two-stage
   retrieval on the mesh loaded from phase 8's final store: every
   session keyframe's candidates equal the unsharded ones;
   ``can_fuse_serving()`` false. Training: the full-width SpectralGNN on
   a 20,000-node graph, 4096 triplets, DP and node-sharded against the
   single-device step (loss 1e-5 relative, gradients 3e-5 +
   1e-5·max|g| except the gauge biases), the sharded eval forward within
   1e-5 and the sharded recall equal, ms per step of each; kernel G
   bit-equal to its plain version and the CPU's ``index_add_`` at the
   plans the sharded steps build (each node slab's neighbours and a DP
   replica's into the 20,000-row transform, the triplet columns of a
   batch and of its DP slabs, the padded batch's masked triplets left
   out through ``valid``); the sharded
   programs as captured graphs: DP and node-sharded, two fresh runs of 5
   Adam steps through the graph and one eagerly (the last batch with 300
   padded triplets) leave the same losses, parameters, BatchNorm buffers
   and Adam state bit for bit, the first loss within 1e-5 relative of the
   single-device step's, G's nodes in each graph from ``graph_census``
   (24 and 15), one capture a run and none after, ms a step through the
   graph and eagerly with the device-busy share; the sharded eval forward
   and Recall@{1,5,10} through their graphs equal to their eager steps
   and to one device (on one card the sharded recall is the
   single-device one), timed; bf16: the
   step's loss and gradients float32 and finite, the forward within
   3e-2·max(|out|, 1) of float32 and 1e-2·max(|out|, 1) of the CPU's
   bf16 forward, ms per step against float32, and a bf16 ``serve_step``
   ranking its own planted embedding top-1 in an L2 database;
   ``dryrun_multichip(4, devices=[cuda:0] * 4)``, its train step and
   eval forward through the sharded executables;
11. the rest of the API: ``SpectralEncoder.encode_points`` on one
   full-density scan (133,632 points, cut to its 131,072) and ``forward``
   on 8 random-order scans, each equal to ``encode_points_batch`` on the
   same padded input and within 1e-4 of the CPU plain path, one
   projection and one spectral launch a call; ``encode_range_image``
   (method and function, one spectral launch) and ``project_points`` (one
   projection launch, equal to the CPU image); the port's ``entry()``
   (8 scans of 16,384 points, the full-width GNN with seeded weights):
   its ``fn`` replays a CUDA graph captured at the first call (K3's node
   cooperative), bit-equal to the same step op by op, against the same
   function on the CPU (descriptors 1e-4, embeddings 1e-3), the p50 wall
   and device ms of both forms; the experiments
   ``retrieval_latency`` at 100,000 rows (float32 and uint16 per-query
   ms; uint16 rankings within the one-code rule), ``density_defense``'s
   ray cast of a scene and of a loop pose on the card bit-equal to the
   CPU's, the script at its defaults, ``degraded_recall`` (200 frames, 3 epochs),
   ``cross_sensor_uplift`` and ``selection_divergence`` small, each with
   finite numbers (the first four must launch the projection and
   spectral kernels); ``native.voxel_overlap`` within 1e-6 of the numpy
   ``compute_overlap`` on the same stride-subsampled clouds.

Launch counts are set to 0 just before each path (4, each entry point of
5, 6, each entry-point run of 7 and 7d's counted mining run of each other
strategy, 8's one-dispatch run, its verifier
comparison, its warm torch-verifier session, its split and full-graph
sessions, each entry-point
run of 9, each sharded encoder call, each sharded train graph's run
and the dry run of 10, each call and
experiment of 11) and read just after. Any failure raises
and the script exits nonzero, printing no result. Otherwise the line
before the last is the kernels' JSON record (launches per path and in
total, device, wrapper and plain times, bound, ``ms`` the wrapper's time
per call as earlier records held it, and ``library_ms`` null
with the reason: no single PyTorch call computes any kernel's function;
kernels N, K, C, R, M's two W₁ entries and S also carry
``yardstick_ms``: two calls for N, K and S, one that computes part of the
function for the others)
and the last is ``{"ok": true, "device": {...}}``. Before them it
prints every graph family's captures, replays, eager steps and (serving,
eval) executables built over the whole run, and the declared op-by-op
paths on the card: eval forwards by ``gnn_forward``
(``gnn.STATS["eager_forwards"]``: the evaluation's one a sequence in
phase 9, the dry run's reference and this script's own references) and
the op-by-op sharded
programs (``sharded_op_by_op``: phase 10's comparison runs of
``make_sharded_train_step`` and ``make_sharded_eval_step``; and
``retriever.STATS["sharded"]``, queries over distinct cards).
It needs no JAX.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SEED = 0
BATCH = 8                      # kernel-phase batch (bench.py's headline B)
N_RINGS, PER_RING = 64, 2088   # HDL-64E full density: 133,632 points
N_POINTS = N_RINGS * PER_RING
N_NODES = 1000
DB_ROWS = 100_000
N_REQUESTS = 32
TOP_K = 10
MIN_DIST = 10.0                # spatial filter radius (m)
TIMED_CALLS = 25

SPECTRAL_TOL = 1e-5            # kernel vs plain on the card
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
# fp32 operations a second that are not FMAs: an FMA counts as 2 of the
# 67 T, a lone sum, product or comparison takes the same slot
FP32_OPS_NO_FMA = FP32_FLOPS / 2
VERIFY_POINTS = 4096           # configs/default.yaml verification_max_points
SEARCH_OPS = 9                 # kernels N, K: 3 differences, 3 squares,
                               # 2 sums and a comparison a pair
PCA_COV_TOL = 1e-5             # kernel C vs plain: covariances, and
PCA_NORMAL_TOL = 1e-4          # 1 - |cos| of normals, on the rows whose
PCA_GAP_ERR = 1e-6             # relative eigen-gap g lets the float32
                               # plain solve reach the bar: its covariance
                               # error is about PCA_GAP_ERR / g (checked on
                               # a prepared cloud by
                               # tests/test_torch_pca_kabsch.py), so g >=
                               # 0.1 for covariances and g >= 7.1e-5 for
                               # normals; below, invariants only
PCA_INV_TOL = 1e-5             # eigenvalues {eps, 1, 1} and n in the span
KABSCH_TOL = 1e-5              # kernel R's solve vs plain: R, and
                               # t / max(1, |p_c|)
KABSCH_UPDATE_TOL = 1e-7       # kernel R's update vs the float64 plain step,
                               # the same way: its float64 sums and solve
                               # leave T's float32 rounding (<= 3e-8 in R);
                               # float32 sums would not pass (the float32
                               # plain step is ~4e-7 from float64). vs the
                               # float32 plain step: this plus that step's
                               # own distance from the float64 one
T_TOL = 1e-4                   # p2p registration on the card vs the CPU
PROFILED_CALLS = 50
QUEUED_CALLS = 200
COLD_FLUSH_BYTES = 64 << 20    # written between launches: > the 50 MB L2
# roll-kernel cases beyond the probe shapes, (rows, width, stages, arrays,
# misaligned), arrays 0 = the P3 chain: windows shorter than the row (P2
# at 4, 8 and 6 stages, P3 at 5 and 16), saturated ones, rows with NaN, ±0
# and ±inf (``_special_rows``), widths that are not a multiple of 4, rows
# 4 bytes off a 16-byte boundary (the scalar loads), single rows
ROLL_CASES = (
    (512, 2176, 4, 2, False), (512, 2176, 8, 2, False),
    (512, 768, 6, 2, False), (512, 2176, 8, 1, False),
    (512, 2176, 12, 2, False), (512, 2176, 12, 1, False),
    (512, 2176, 40, 2, False), (64, 2175, 12, 2, False),
    (64, 2175, 11, 1, False), (64, 2176, 8, 2, True), (1, 2176, 12, 2, False),
    (1, 768, 6, 1, False),
    (512, 2112, 5, 0, False), (512, 2112, 16, 0, False),
    (512, 2112, 64, 0, False), (64, 2110, 16, 0, False),
    (64, 2110, 64, 0, False), (64, 2112, 16, 0, True),
    (1, 2112, 64, 0, False), (1, 2112, 16, 0, False),
)
# no single PyTorch call computes any kernel's whole function
NO_LIBRARY = {
    "spectral": "torch.fft.rfft covers one of six stages (interpolation, "
                "row fill, pooling, |DFT|, binning, sum-to-1)",
    "ring_fold": "per-point angle math, gates and the fold rule's min",
    "project": "per-point angle math and gates before the scatter-min",
    "ring_probe": "the fold rule's min over precomputed keys",
    "roll_floor": "the first minimum of a circular window with its "
                  "payload (argmin at the smallest forward offset, then "
                  "a[j] + b[j]); no PyTorch call takes a windowed argmin",
    "roll_min_chain": "torch.amin gives the saturated chain's row min, but "
                      "neither its + 1 nor its broadcast, nor a window "
                      "shorter than the row",
    "nearest": "no one call; yardstick_ms times torch.cdist + argmin (two "
               "calls, masking left out), which the port never calls",
    "knn": "no one call; yardstick_ms times torch.cdist + topk (two calls, "
           "masking and the tie order left out), which the port never calls",
    "knn_pca": "no one call; yardstick_ms times torch.linalg.eigh on the "
               "(P, 3, 3) covariances, which computes part of the function "
               "(not the gather, the covariances or the output) and which "
               "the port never calls on a card",
    "kabsch": "no one call; yardstick_ms times torch.linalg.svd of the one "
              "3 x 3 H, which computes part of the function (not the "
              "weights, gather, sums, det, the product or t) and which the "
              "port never calls on a card",
    "mine": "no one call; yardstick_ms times torch.cdist(p=1) of the "
            "chunk's CDFs against every frame's, the W1 matrix alone (not "
            "the masks, counts, argmin or draw), which the port no longer "
            "calls",
    "gather_bwd": "torch.index_add_ of the same rows into zeros (library_ms; "
                  "atomics, so its sum order changes from run to run), which "
                  "the port's train step no longer calls",
    "mine_rows": "no one call; yardstick_ms times torch.cdist(p=1) of the "
                 "chunk's CDFs against every frame's (the W1 matrix, not the "
                 "masks, the +inf outside the negatives or the counts), "
                 "which the port no longer calls",
    "mine_counts": "no PyTorch call counts a distance and gap mask's "
                   "members without building the (chunk, n) masks",
    "mine_draw_mask": "the r-th member of a mask in index order; "
                      "torch.multinomial draws from the same support with "
                      "another rule",
    "select": "no one call: torch.kthvalue takes one place for every row; "
              "yardstick_ms times torch.sort(stable=True) + gather (two "
              "calls), which the port no longer calls",
    "query": "no one call; yardstick_ms times torch.cdist(p=1) + "
             "smallest_k (two calls, the masks left out), which the port "
             "never calls",
    "query_dist": "no one call computes the masked W1 distances; the port "
                  "ranks them with smallest_k (torch.topk of int64 keys)",
}
# kernel function names as torch.profiler reports them
KERNEL_NAMES = {
    "spectral": ("spectral_encode_kernel",),
    "ring_fold": ("ring_fold_kernel",),
    "project": ("project_points_kernel",),
    "ring_probe": ("ring_probe_kernel",),
    "roll_floor": ("roll_floor_kernel",),
    "roll_min_chain": ("roll_min_chain_kernel",),
    "nearest": ("nearest_kernel",),
    "knn": ("knn_kernel",),
    "knn_pca": ("knn_pca_kernel",),
    "kabsch": ("p2p_update_kernel",),
    "mine": ("mine_hard_kernel",),
    "mine_draw": ("mine_draw_kernel",),
    "gather_bwd": ("gather_bwd_kernel",),
    "mine_counts": ("mine_counts_kernel",),
    "mine_rows": ("mine_rows_kernel",),
    "mine_draw_mask": ("mine_draw_mask_kernel",),
    "select": ("select_cluster_kernel", "select_rows_kernel"),
    "query": ("query_kernel", "query_group_kernel", "query_merge_kernel"),
    "query_dist": ("query_kernel", "query_group_kernel"),
}
DESC_TOL = 1e-4                # card vs CPU plain path (1-ulp atan2f cause)
EMB_TOL = 1e-3
GRAPH_EMB_TOL = 1e-6           # serve: graph replay vs the eager step
REPLAYS = 50                   # serve: replays timed by CUDA events
TRAIN_TOL = 1e-4               # train step: card vs CPU
TRAIN_NODES = 512
SCALE_NODES = 20_000
MINE_NODES = 100_000           # kernel M timed on one chunk of this many
MINE_CHUNK = 2048              # anchors (training/miner.py ANCHOR_CHUNK)
MINE_PARAMS = (5.0, 30.0, 10.0, 100.0, 30.0)   # scale_100k's thresholds
DRAW_OPS = 12                  # a frame's mask in M's draw: 3 subtractions,
#                                3 products, 2 sums, the gap, 3 comparisons
BOX_OPS = 18                   # a tile's box test in M's draw (the least,
#                                the positives'): 6 subtractions, 6
#                                comparisons for the least |d|, 3 products,
#                                2 sums, 1 comparison
MINE_CPU_NODES = 3000          # phase 7d: other strategies, card vs CPU
MINE_EAGER_CHUNKS = 3          # phase 7d: eager chunks timed at BIG_NODES
RANK_CPU_NODES = 6000          # phase 9: ranking graph vs eager vs CPU
RANK_CPU_CHUNK = 1000          # phase 9: its query chunk (last one padded)
GRAPH_STEPS = 3                # train graph vs eager: steps compared
BIG_NODES = 100_000            # one train-step replay timed at this size
STORE_ROWS = 100_000           # phase 8: the resumed map's records
ONLINE_FRAMES = 200            # phase 8: synthetic stream, two laps
ONLINE_POINTS = 131_072        # configs/default.yaml encoding.max_points
ONLINE_WARM_SCANS = 10         # reported apart from the steady scans
VERIFY_QUERIES = 10            # phase 8: queries whose candidates both
                               # verifier backends check
TRACE_FRAMES = 30              # phase 8: keyframes under torch.profiler
CONCURRENT_FRAMES = 140        # phase 8: captures beside the verifier
SPLIT_FRAMES = 60              # phase 8: split-mode eval sessions
SPLIT_EMB_TOL = 1e-5           # split vs fused session's embeddings
# phase 9: sequences written in their datasets' formats, each drawn from
# one seeded SyntheticWorld along two laps of a 120 m circle through a
# simulated sensor: (beam elevations in degrees, points a scan, frames).
# KITTI: 64 beams at the centres of the 64 image rows over the configs'
# -24.8..2 deg, 131,072 points in sweep order; NCLT: an HDL-32E's 32 beams
# over -30.67..10.67 deg; HeLiPR: 16 beams with ring ids, every 4th of
# KITTI's, so that the ring-major encoder can take them (with
# elevation_mode "clip" a VLP-16's beams above +2 deg would share the top
# row and break the ring contract). NCLT and HeLiPR are firing-
# interleaved. 64 frames (laps of 32) put a revisit 32 frames back, beyond
# validation.skip_frames (30).
_ROW_DEG = 26.8 / 64
DATA_SEQS = {
    "kitti": (tuple(-24.8 + (i + 0.5) * _ROW_DEG for i in range(64)),
              131_072, 150),
    "nclt": (tuple(-30.67 + i * 41.34 / 31 for i in range(32)), 69_632, 64),
    "helipr": (tuple(-24.8 + (4 * i + 2.5) * _ROW_DEG for i in range(16)),
               28_800, 64),
}
NCLT_DATE = "2012-01-08"
HELIPR_SEQ = "Roundabout01"
TAU2_ULPS = 16                 # phase 9: tau², card vs CPU (see _eval_same)
PAR_SHARDS = 4                 # phase 10: logical shards of the one card
PAR_SCANS = 32                 # phase 10: 8 full-density scans a shard
PAR_POINTS = 131_072           # configs/default.yaml encoding.max_points
PAR_ROWS = 100_000             # phase 10: sharded database, 4 x 25,000
PAR_QUERIES = 32
PAR_NODES = 20_000             # phase 10: sharded training graph
PAR_TRIPLETS = 4096
PAR_STEPS = 5                  # timed steps per mode after one warm-up
PAR_RUNS = 5                   # sharded graphs: Adam steps of a fresh run
PAR_PADDED = 300               # padded triplets in a run's last batch
SHARD_TOL = 1e-7               # sharded vs unsharded encoder (0 expected)
QUERY_ROWS = 100_032           # phase 3: kernel Q's database (phase 4's)
QUERY_MIN_D = 50.0             # kernel Q: the filter radius of its cases
QUERY_TIES = (3, 11, 20)       # kernel Q: copies of row 7 (query 0's)
QUERY_K_EDGE = 128             # kernel Q: K_MAX, the fused route's largest
QUERY_K_BIG = 200              # phase 4: a batch through the distance entry
QUERY_POS_OPS = 10             # kernel Q: a (query, row)'s spatial test:
                               # 3 differences, 3 squares, 2 sums, the
                               # root and a comparison
ENTRY_CALLS = 20               # phase 11: timed calls of entry()'s fn
OVERLAP_TOL = 1e-6             # phase 11: native voxel IoU vs numpy

# configs/training.yaml (with its parent default.yaml), the sections the
# training pipeline reads, built in code: the card has no PyYAML
TRAINING_CONFIG = {
    "encoding": {"n_elevation": 16, "n_azimuth": 360,
                 "elevation_range": [-24.8, 2.0], "max_range": 80.0,
                 "min_range": 1.0, "elevation_mode": "clip",
                 "target_elevation_bins": 16, "n_bins": 50, "alpha": 2.0,
                 "epsilon": 1e-8, "interpolate_empty": True,
                 "ring_major": False, "max_points": 131072},
    "keyframe": {"distance_threshold": 0.5, "rotation_threshold": 15.0,
                 "overlap_threshold": 0.7, "temporal_threshold": 5.0,
                 "voxel_size": 0.2, "max_keyframes": 100000,
                 "temporal_neighbors": 5},
    "gnn": {"input_dim": 800, "hidden_dim": 256, "output_dim": 800,
            "n_layers": 3, "dropout": 0.1, "residual": True, "edge_dim": 2},
    "system": {"seed": 42, "checkpoint_dir": "checkpoints"},
    "training": {"learning_rate": 5e-4, "weight_decay": 1e-5,
                 "n_epochs": 50, "triplets_per_step": 4096,
                 "early_stopping": True, "patience": 10, "grad_clip": 1.0,
                 "mixed_precision": False},
    "triplet": {"margin": 0.1, "positive_distance_max": 5.0,
                "positive_temporal_min": 30, "negative_distance_min": 10.0,
                "negative_distance_max": 50.0, "mining_strategy": "hard",
                "n_negatives_per_anchor": 1},
    "validation": {"recall_k_values": [1, 5, 10]},
    "checkpoint": {"save_best": True, "save_last": True},
    "ablation": {"disable_gnn": False, "disable_temporal_edges": False},
}


def _general_scans(n: int, seed: int):
    """Arbitrary-order scans of N_POINTS points: directions a little wider
    than the elevation band (clip mode puts them in the edge rows), ranges
    on both sides of the 1-80 m gate, and a NaN padding tail per scan."""
    import numpy as np
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, (n, N_POINTS))
    el = rng.uniform(np.deg2rad(-26.0), np.deg2rad(3.0), (n, N_POINTS))
    r = rng.uniform(0.5, 90.0, (n, N_POINTS))
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el), rng.uniform(0, 1, r.shape)],
                   axis=-1).astype(np.float32)
    for i, tail in enumerate(rng.integers(0, N_POINTS // 8, n)):
        pts[i, N_POINTS - tail:] = np.nan
    return pts


def _sweep_scans(n: int, seed: int):
    """Scans as a sensor's file stores them: the rings of
    ``make_structured_ring_scans`` (N_RINGS x PER_RING, full density)
    flattened ring-major to (N_POINTS, 4), consecutive points sharing an
    azimuth column, with a NaN padding tail per scan."""
    import numpy as np
    from neural_spectral_codec_torch.ops.ring_path import (
        make_structured_ring_scans)
    from neural_spectral_codec_torch.ops.spectral import SpectralEncoderConfig
    pts = make_structured_ring_scans(n, N_RINGS, PER_RING,
                                     SpectralEncoderConfig().projection,
                                     seed=seed).reshape(n, N_POINTS, 4)
    rng = np.random.default_rng(seed + 1)
    for i, tail in enumerate(rng.integers(0, N_POINTS // 8, n)):
        pts[i, N_POINTS - tail:] = np.nan
    return np.ascontiguousarray(pts)


def _edge_points(n: int, seed: int, proj):
    """Points at the plain version's bin edges (angles k/A of a turn and
    the row boundaries, in float64), on the x and y axes, on z = 0 and at
    the origin: where the kernel's bin test defers to float64 angles."""
    import numpy as np
    rng = np.random.default_rng(seed)
    az = -np.pi + rng.integers(0, proj.n_azimuth + 1, n) * (
        2 * np.pi / proj.n_azimuth)
    el = proj.elevation_min + rng.integers(0, proj.n_elevation + 1, n) * (
        proj.elevation_span / proj.n_elevation)
    r = rng.uniform(1.5, 70.0, n)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el), np.zeros(n)], axis=-1).astype(np.float32)
    pts[: n // 8, 1] = 0.0
    pts[n // 8: n // 4, 0] = 0.0
    pts[n // 4: 3 * n // 8, 2] = 0.0
    pts[-3:] = [[0, 0, 0, 0], [0, 0, 5, 0], [-5, -0.0, 0, 0]]
    return pts


def _time_ms(fn) -> float:
    from neural_spectral_codec_torch.utils.timing import time_ms
    return time_ms(fn, calls=TIMED_CALLS)


def _bound(n_bytes: float, n_flops: float = 0.0,
           n_ops_no_fma: float = 0.0) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take,
    each input read once and each output written once at the memory rate,
    or the fp32 operations at the peak rate (FMAs counted as 2 at 67 T,
    operations that cannot fuse at 33.5 T), whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / FP32_FLOPS + n_ops_no_fma / FP32_OPS_NO_FMA
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _draw_bounds(walk: dict, scanned: int, count: int, splits: int
                 ) -> dict:
    """M's draw's bounds on one chunk's draws (``count`` anchors), from
    ``walk`` (its ``mine_kernel.draw_rounds``, the model of the gated
    walk) and ``scanned`` (``draw_frames``): ``bound_ms`` over the work the
    gated function needs, DRAW_OPS a frame of the kept tiles up to each
    member and BOX_OPS a box test, or the bytes of the distinct frames and
    boxes it reads, u, the counts, the splits' counts and the draw; beside
    it ``scan_bound_ms``, DRAW_OPS a frame from the split's first to each
    member, or every position's bytes and the same others (the bound
    before the gate)."""
    per_anchor = 4 * count * (3 + splits)
    ms, by = _bound(
        12 * walk["model_frames_touched"] + 24 * walk["model_tiles_touched"]
        + per_anchor,
        n_ops_no_fma=DRAW_OPS * walk["model_frames_needed"]
        + BOX_OPS * walk["model_tiles_tested"])
    return {"bound_ms": ms, "bound_by": by, "frames_scanned": scanned,
            "scan_bound_ms": _bound(12 * MINE_NODES + per_anchor,
                                    n_ops_no_fma=DRAW_OPS * scanned)[0]}


def _spectral_ops(imgs, cfg) -> int:
    """fp32 operations the spectral kernel's function needs on ``imgs``
    (B, E, A): the |rDFT| with columns a and A - a of a row folded (2 FMAs
    per pooled row, frequency and column pair, an add for the middle
    column of an even A, 3 for the magnitude, 1 to bin it), the fold (2
    per row and column pair), the pooling (an FMA per pixel of each
    window) and the interpolation (4 per empty pixel of a row that holds a
    valid one; rows the fill copies are not counted, so the bound stays a
    least time)."""
    import torch
    b, n_elev, n_azim = imgs.shape
    n_t, n_f = cfg.target_elevation_bins, cfg.n_freqs
    half = (n_azim - 1) // 2
    window = sum(-(-(t + 1) * n_elev // n_t) - t * n_elev // n_t
                 for t in range(n_t))
    per_scan = (n_t * n_f * (4 * half + (n_azim % 2 == 0) + 3 + 1)
                + 2 * n_t * half + 2 * window * n_azim)
    n_interp = 0
    if cfg.interpolate_empty:
        valid = imgs > 0
        n_interp = int((~valid & valid.any(-1, keepdim=True)).sum())
    return b * per_scan + 4 * n_interp


def _device_times(name: str, wrapper, profiled: int = PROFILED_CALLS,
                  queued_calls: int = QUEUED_CALLS) -> dict:
    """A kernel's own device time, apart from its wrapper: torch.profiler
    over ``profiled`` wrapper calls (kernel time by name), and CUDA
    events around ``queued_calls`` bare C-entry launches of the last
    call's arguments, queued behind a spin kernel."""
    from neural_spectral_codec_torch.utils.timing import (
        kernel_device_ms, time_queued_ms)
    kernel = _all_kernels()[name]
    keep = wrapper()            # its tensors stay alive for the bare loop
    queued = time_queued_ms(kernel.bare(), n=queued_calls)
    del keep
    prof, seen = kernel_device_ms(wrapper, KERNEL_NAMES[name],
                                  calls=profiled)
    return {"profiler_ms": prof, "profiled_launches": seen,
            "queued_ms": queued,
            "device_ms": prof if prof is not None else queued}


def _only_kernel(name: str, wrapper) -> None:
    """One wrapper call enqueues its kernel and no other device
    operation (the output allocation enqueues none): its launch counter
    counts one launch per profiled call, and the profiler's record holds
    that kernel alone."""
    from neural_spectral_codec_torch.utils.timing import device_ops
    wrapper()
    ops, launches = _counted(lambda: [op for op, _ in device_ops(wrapper)])
    print(f"{name}: one wrapper call enqueues {ops}", flush=True)
    _check(launches[name] >= 1 and launches[name] == sum(
        v for k, v in launches.items() if k != "query_group"),
           f"{name}: profiled wrapper calls launched {launches}")
    _check(len(ops) == 1 and KERNEL_NAMES[name][0] in ops[0],
           f"{name}: a wrapper call enqueues {ops}, not only its kernel")


def _replay_ms(exe) -> float:
    """Device ms of one replay of a serving executable's graph: CUDA
    events around REPLAYS replays (its last staged step again: the same
    query and the same row written, so nothing changes; not counted)."""
    import torch
    exe.graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(REPLAYS):
        exe.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPLAYS


def _host_split(exe, ret, stage, calls: int = 20) -> dict:
    """Median ms of a serving step's parts on the host clock: staging the
    inputs (``stage(insert_at, eff_size)``), ``execute`` (the upload, the
    replay and the fetch, waited for) and copying the answer out of the
    pinned buffer; scratch executions at the next free row, whose bytes
    are put back (not counted: the launches are measurements)."""
    times = {"stage_ms": [], "execute_ms": [], "copy_out_ms": []}

    def dispatch(insert_at: int, eff: int):
        row = slice(insert_at, insert_at + 1)
        kept = (ret._db_rows[row].clone(), ret._db_pos[row].clone())
        t0 = time.perf_counter()
        stage(insert_at, eff)
        t1 = time.perf_counter()
        out = exe.execute()
        t2 = time.perf_counter()
        {k: v.copy() for k, v in out.items()}
        t3 = time.perf_counter()
        ret.write_rows(insert_at, *kept)
        times["stage_ms"].append(1e3 * (t1 - t0))
        times["execute_ms"].append(1e3 * (t2 - t1))
        times["copy_out_ms"].append(1e3 * (t3 - t2))

    launches = [(k, k.launches) for k in _all_kernels().values()]
    for _ in range(calls):
        ret.fused_dispatch(dispatch, insert=False)
    for k, n in launches:
        k.launches = n
    return {k: statistics.median(v) for k, v in times.items()}


def _query_graphs(device, ret, queries, qps, planted) -> None:
    """Phase 4's database (100,000 float32 rows and the requests' rows,
    and the same rows as uint16 codes) through the stage-1 query graphs
    (``retriever.QueryExecutable``): every request's descriptor as a
    single query and the 32 as one batch, with the spatial filter, once
    through the graphs (Q = 1 captured by ``warm_query``, Q = 32 at its
    first call) and once eagerly (``use_graph`` off): indices and
    distances bit-equal, top-1 the planted row; the p50 wall ms (host
    clock around the call, which fetches) and the device ms
    (``device_ops``) of both forms, each graph's nodes (``graph_census``)
    and the query pool's MiB. Then the batch at k = QUERY_K_BIG (kernel
    Q's distance entry and ``smallest_k``) through its graph and eagerly:
    equal, its first k the k = TOP_K answer."""
    import numpy as np
    from neural_spectral_codec_torch import _build
    from neural_spectral_codec_torch.retrieval import retriever as R
    from neural_spectral_codec_torch.utils.timing import device_ops
    size = ret.database_size
    u16 = R.WassersteinRetriever(n_bins=ret.n_bins, capacity=ret.capacity,
                                 storage="uint16", device=device)
    u16.write_rows(0, R.quantize_cdf(ret._db_rows[:size]),
                   ret._db_pos[:size])
    u16.database_size = size
    pos = np.stack([p[:3] for p in qps])
    kw = {"spatial_min_distance": MIN_DIST}

    def single(r, j):
        return r.query(queries[j], TOP_K, query_position=pos[j], **kw)

    def batch(r):
        return r.query_batch(queries, TOP_K, query_positions=pos, **kw)

    def dev_ms(fn, calls):
        return sum(us for _, us in device_ops(fn, calls=calls)) / calls / 1e3

    for storage, r in (("float32", ret), ("uint16", u16)):
        r.warm_query(TOP_K)
        res, times = {}, {}
        for form in ("graph", "eager"):
            r.use_graph = form == "graph"
            res[form] = ([single(r, j) for j in range(len(queries))],
                         batch(r))
            times[form] = {
                "single_wall_ms": _p50_ms(lambda: single(r, 3)),
                "single_device_ms": dev_ms(lambda: single(r, 3), 5),
                "batch_wall_ms": _p50_ms(lambda: batch(r), calls=5),
                "batch_device_ms": dev_ms(lambda: batch(r), 2)}
        r.use_graph = True
        (gs, gb), (es, eb) = res["graph"], res["eager"]
        same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(gs + [gb], es + [eb]))
        top1 = all(int(gs[j][0][0]) == int(planted[j])
                   and int(gb[0][j, 0]) == int(planted[j])
                   for j in range(len(queries)))
        nodes = {e.n_queries: _build.graph_census(e.graph.raw_cuda_graph())
                 for e in R.cached_executables()
                 if e._retriever() is r and e.graph is not None}
        print(f"query: {size} {storage} rows, graph vs eager bit-equal "
              f"{same}, top-1 planted {top1}; ms {json.dumps(times)}; "
              f"graph nodes by Q "
              f"{ {q: (c['nodes'], c['kernels']) for q, c in nodes.items()} }"
              f" (nodes, kernels)", flush=True)
        _check(same, f"query: {storage} graphs differ from the eager step")
        _check(top1, f"query: {storage} top-1 is not the planted row")
        _check(sorted(nodes) == [1, len(queries)],
               f"query: {storage} graphs captured for Q {sorted(nodes)}")
        # k above K_MAX: kernel Q's distance entry and smallest_k, graphed
        big = {}
        for form in ("graph", "eager"):
            r.use_graph = form == "graph"
            big[form] = r.query_batch(queries, QUERY_K_BIG,
                                      query_positions=pos, **kw)
        r.use_graph = True
        _check(all(np.array_equal(a, b)
                   for a, b in zip(big["graph"], big["eager"]))
               and np.array_equal(big["graph"][0][:, 0], planted)
               and np.array_equal(big["graph"][0][:, :TOP_K], gb[0]),
               f"query: {storage} k={QUERY_K_BIG} graph != eager, or its "
               f"first {TOP_K} differ from the k={TOP_K} answer")
    print(f"query: graph pool {R.POOL.bytes(device) / 2**20:.1f} MiB, "
          f"counts {json.dumps(R.STATS)}", flush=True)


def _query_data(device, n: int, bins: int) -> dict:
    """Kernel Q's database at phase 4's size: n rows of ``bins``-bin
    random histograms (as phase 4's), stored as W1 CDF rows (float32 and
    their uint16 codes) and as raw vectors (L2), positions over +-1 km;
    32 queries, each a row's histogram plus noise, at that row's position
    plus 1 m. Query 0 is row 7's histogram itself, at the origin: rows
    QUERY_TIES hold copies of row 7 (equal distances: the lower row
    first), at (QUERY_MIN_D - 1 ulp, 0, 0), (QUERY_MIN_D, 0, 0) and
    (QUERY_MIN_D + 1 ulp, 0, 0) from it, so the spatial filter masks the
    first and keeps the other two (a norm of exactly the axis offset)."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.ops.wasserstein import histogram_cdf
    from neural_spectral_codec_torch.retrieval.retriever import quantize_cdf
    g = torch.Generator(device=device).manual_seed(SEED + 60)
    h = torch.rand((n, bins), generator=g, device=device) ** 4
    pos = (torch.rand((n, 3), generator=g, device=device) - 0.5) * 2000.0
    src = torch.randint(0, n, (32,), generator=g, device=device)
    src[0] = 7
    q = h[src] + 0.2 * torch.rand((32, bins), generator=g,
                                  device=device) / bins
    q[0] = h[7]
    qpos = pos[src] + 1.0
    qpos[0] = 0.0
    steps = np.array([np.nextafter(np.float32(QUERY_MIN_D), np.float32(0)),
                      QUERY_MIN_D, np.nextafter(np.float32(QUERY_MIN_D),
                                                np.float32(1e9))],
                     np.float32)
    for row, x in zip(QUERY_TIES, steps):
        h[row] = h[7]
        pos[row] = torch.tensor([float(x), 0.0, 0.0], device=device)
    cdf = histogram_cdf(h, 1e-8)
    return {"f32": cdf, "u16": quantize_cdf(cdf), "l2": h, "pos": pos,
            "hist": q, "qpos": qpos, "cdf": histogram_cdf(q, 1e-8)}


def _old_query_chain(rows, pos, size, q, filters, k: int, metric: str):
    """The plain stage-1 query the port ran before kernel Q (the earlier
    ``retriever._distances`` and ``query_math``): the broadcast (Q, rows,
    bins) difference in chunks of 2^28 elements, summed (or normed),
    masked, ``smallest_k``. A yardstick only: the port no longer runs
    it."""
    import torch
    from neural_spectral_codec_torch.retrieval.retriever import (
        dequantize_rows, smallest_k)
    x = dequantize_rows(rows)
    step = max(1, (1 << 28) // x.numel())
    out = []
    for c in q.split(step):
        diff = x[None, :, :] - c[:, None, :]
        out.append(diff.abs().sum(dim=2) if metric == "wasserstein"
                   else torch.linalg.vector_norm(diff, dim=2))
    d = torch.cat(out)
    invalid = (torch.arange(x.shape[0], device=x.device) >= size)[None, :]
    min_d = filters[:, 3:4]
    near = torch.linalg.vector_norm(
        pos[None, :, :] - filters[:, None, :3], dim=2) < min_d
    return smallest_k(torch.where(invalid | ((min_d > 0) & near),
                                  torch.inf, d), k)


def _query_kernel_cases(device) -> dict:
    """Kernel Q (``retrieval/query_kernel.py``, ``csrc/query.cu``) against
    its plain version on the card, indices and distances bit for bit, at
    phase 4's 100,032 x 800 (``_query_data``): W1 over float32 rows, W1
    over uint16 codes and L2; Q = 1 and 32 (and 40: two query groups, k =
    10 and 50; and 3 and 8, one query tile of the group kernel, k = 10 and
    50 with the filter off and on); k = 1, 10, 128 (K_MAX) and 200 (beyond
    K_MAX: the distance entry and smallest_k); without and with the
    spatial filter; size = the database, below it, and 0 (every slot
    +inf, rows 0 .. k - 1); size as a device int64 and as an int. The
    ties and the +-1 ulp rows of ``_query_data`` are in every database.
    Then the fused route's device time (both launches; torch.profiler,
    queued bare launches; the merge launch's apart) at Q = 1, 8 and 32 over
    float32 and uint16 rows and for L2 (k = 10), and at k = K_MAX over
    float32 rows, its wrapper's and plain version's, the distance
    entry's, the earlier plain chain (``_old_query_chain``) and the
    two-call yardstick torch.cdist(p=1) + smallest_k, those two as device
    time summed over every operation a call enqueues; bounds from this
    run's shapes."""
    import torch
    from neural_spectral_codec_torch.retrieval import query_kernel as qk
    from neural_spectral_codec_torch.retrieval.retriever import (
        dequantize_rows, smallest_k)
    from neural_spectral_codec_torch.utils.timing import device_ops
    n, bins = QUERY_ROWS, 800
    data = _query_data(device, n, bins)
    zero = torch.zeros((32, 4), device=device)
    filt = torch.cat([data["qpos"], torch.full((32, 1), QUERY_MIN_D,
                                               device=device)], dim=1)
    mid = torch.tensor(n - 1000, dtype=torch.int64, device=device)
    modes = {"f32": ("wasserstein", data["f32"], data["cdf"]),
             "u16": ("wasserstein", data["u16"], data["cdf"]),
             "l2": ("l2", data["l2"], data["hist"])}
    cases = 0
    for mode, (metric, rows, queries) in modes.items():
        for n_q in (1, 32):
            q = queries[:n_q].contiguous()
            for k, f, size in ((1, zero, n), (10, filt, mid), (10, zero, mid),
                               (200, filt, n), (QUERY_K_EDGE, filt, mid),
                               (10, filt, 0), (200, zero, 0)):
                f = f[:n_q].contiguous()
                got = qk.query_cuda(rows, data["pos"], size, q, f, k, metric)
                want = qk.query_plain(rows, data["pos"], size, q, f, k,
                                      metric)
                what = (f"{mode} Q={n_q} k={k} filter {bool(f.any())} "
                        f"size {int(size)}")
                _check(torch.equal(got[0], want[0]) and torch.equal(
                    got[1].view(torch.int32), want[1].view(torch.int32)),
                       f"query kernel != plain version ({what}: "
                       f"{int((got[0] != want[0]).sum())} indices differ)")
                if int(size) == 0:
                    _check(bool(torch.isinf(got[1]).all()) and torch.equal(
                        got[0][0], torch.arange(k, device=device)),
                           f"query kernel, size 0 ({what}): {got[0][0, :8]}")
                if k == 10 and int(size) > 0:
                    # query 0: row 7 and its copies, the first copy masked
                    ties = sorted([7, *QUERY_TIES[bool(f.any()):]])
                    top = got[0][0, :len(ties)].tolist()
                    _check(top == ties,
                           f"query kernel ({what}): ties and the +-1 ulp rows "
                           f"came out as {top}, not {ties}")
                cases += 1
    for mode, (metric, rows, queries) in modes.items():
        # more queries than a CTA holds: two query groups
        q = torch.cat([queries, queries[:8]]).contiguous()
        f = torch.cat([filt, filt[:8]]).contiguous()
        for k in (10, 50):
            got = qk.query_cuda(rows, data["pos"], mid, q, f, k, metric)
            want = qk.query_plain(rows, data["pos"], mid, q, f, k, metric)
            _check(torch.equal(got[0], want[0]) and torch.equal(
                got[1].view(torch.int32), want[1].view(torch.int32)),
                   f"query kernel != plain version ({mode} Q=40 k={k})")
            cases += 1
        # groups of one query tile (the group kernel's small groups)
        for n_q in (3, 8):
            q = queries[:n_q].contiguous()
            for k in (10, 50):
                for f in (filt, zero):
                    f = f[:n_q].contiguous()
                    got = qk.query_cuda(rows, data["pos"], mid, q, f, k,
                                        metric)
                    want = qk.query_plain(rows, data["pos"], mid, q, f, k,
                                          metric)
                    _check(torch.equal(got[0], want[0]) and torch.equal(
                        got[1].view(torch.int32), want[1].view(torch.int32)),
                           f"query kernel != plain version ({mode} Q={n_q} "
                           f"k={k} filter {bool(f.any())})")
                    cases += 1
    torch.cuda.synchronize()
    print(f"query: kernel Q bit-equal to its plain version in {cases} cases "
          f"at {n} x {bins} (float32, uint16, L2; Q 1, 3, 8, 32 and 40; "
          f"k 1, 10, 50, {QUERY_K_EDGE}, 200; filter off and on; size {n}, "
          f"{n - 1000}, 0; ties to the lower row; the +-1 ulp rows masked as "
          f"JAX masks them)", flush=True)

    def dev_ms(fn, calls: int = 3) -> float:
        fn()
        return sum(us for _, us in device_ops(fn, calls=calls)) / calls / 1e3

    out = {}
    for name, mode, n_q, k in (("query", "f32", 1, TOP_K),
                               ("query_dist", "f32", 1, 200)):
        metric, rows, queries = modes[mode]
        q, f = queries[:n_q].contiguous(), filt[:n_q].contiguous()

        def call(rows=rows, q=q, f=f, k=k, metric=metric):
            return qk.query_cuda(rows, data["pos"], mid, q, f, k, metric)

        wrapper_ms = _time_ms(call)
        t = {"max_abs_err": 0.0, "ms": wrapper_ms, "wrapper_ms": wrapper_ms,
             "plain_ms": _time_ms(lambda: qk.query_plain(
                 rows, data["pos"], mid, q, f, k, metric)),
             **_device_times(name, call)}
        out[name] = t
    t = out["query"]
    for mode, n_q in (("f32", 1), ("f32", 8), ("f32", 32), ("u16", 1),
                      ("u16", 8), ("u16", 32), ("l2", 1), ("l2", 8),
                      ("l2", 32)):
        metric, rows, queries = modes[mode]
        q, f = queries[:n_q].contiguous(), filt[:n_q].contiguous()
        key = f"{mode}_q{n_q}"

        def call(rows=rows, q=q, f=f, metric=metric):
            return qk.query_cuda(rows, data["pos"], mid, q, f, TOP_K, metric)

        dev = _device_times("query", call, profiled=10, queued_calls=20)
        t[f"device_ms_{key}"] = dev["device_ms"]
        t[f"merge_ms_{key}"] = sum(
            us for op, us in device_ops(call, calls=5)
            if "query_merge_kernel" in op) / 5 / 1e3
        t[f"wrapper_ms_{key}"] = _few_ms(call, 5)
        t[f"old_chain_ms_{key}"] = dev_ms(lambda: _old_query_chain(
            rows, data["pos"], mid, q, f, TOP_K, metric), calls=1)
        t[f"plain_ms_{key}"] = _few_ms(lambda: qk.query_plain(
            rows, data["pos"], mid, q, f, TOP_K, metric), 2)
        if mode != "l2":
            x = dequantize_rows(rows)
            t[f"yardstick_ms_{key}"] = dev_ms(lambda: smallest_k(
                torch.cdist(q, x, p=1), TOP_K), calls=1)
        item = rows.element_size()
        t[f"bound_ms_{key}"], t[f"bound_by_{key}"] = _bound(
            n * bins * item + n * 12 + n_q * (bins * 4 + 16 + TOP_K * 12),
            n_ops_no_fma=(2 + (mode == "l2")) * n_q * n * bins
            + (n * bins if mode == "u16" else 0) + QUERY_POS_OPS * n_q * n)
        print(f"kernel query {key}: device {t[f'device_ms_{key}']:.5f} ms "
              f"(the merge {t[f'merge_ms_{key}']:.5f}), "
              f"wrapper {t[f'wrapper_ms_{key}']:.5f}, plain "
              f"{t[f'plain_ms_{key}']:.4f}, earlier plain chain "
              f"{t[f'old_chain_ms_{key}']:.4f} (device), yardstick "
              f"{t.get(f'yardstick_ms_{key}')} (cdist + smallest_k, "
              f"device), bound {t[f'bound_ms_{key}']:.5f} ms "
              f"({t[f'bound_by_{key}']})", flush=True)
    for n_q in (1, 32):
        q, f = data["cdf"][:n_q].contiguous(), filt[:n_q].contiguous()
        t[f"device_ms_f32_q{n_q}_k{QUERY_K_EDGE}"] = _device_times(
            "query", lambda q=q, f=f: qk.query_cuda(
                data["f32"], data["pos"], mid, q, f, QUERY_K_EDGE,
                "wasserstein"), profiled=10, queued_calls=20)["device_ms"]
    print(f"kernel query: k = {QUERY_K_EDGE} (lists in shared memory) "
          f"float32 device {t[f'device_ms_f32_q1_k{QUERY_K_EDGE}']:.5f} ms "
          f"at Q = 1, {t[f'device_ms_f32_q32_k{QUERY_K_EDGE}']:.5f} at 32",
          flush=True)
    t["bound_ms"], t["bound_by"] = t["bound_ms_f32_q1"], t["bound_by_f32_q1"]
    t["yardstick_ms"] = t["yardstick_ms_f32_q1"]
    t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
    d = out["query_dist"]
    d["bound_ms"], d["bound_by"] = t["bound_ms"], t["bound_by"]
    d["share_of_bound"] = d["bound_ms"] / d["device_ms"]
    for name, t in out.items():
        print(f"kernel {name}: f32 Q=1 k={TOP_K if name == 'query' else 200} "
              f"device {t['device_ms']:.5f} ms (profiler {t['profiler_ms']}, "
              f"queued bare {t['queued_ms']:.5f}), wrapper "
              f"{t['wrapper_ms']:.5f} ms, plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}, "
              f"{100 * t['share_of_bound']:.1f}% of it)", flush=True)
    return out


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def _check_cpu_image(name: str, got, on_cpu) -> None:
    """The card's image equals the CPU plain path's: both round angles
    and square roots from float64 (ops/range_image.py)."""
    n_diff = int((on_cpu != got.cpu()).sum())
    print(f"{name}: kernel == plain on the card; vs the CPU plain path "
          f"{n_diff} of {got.numel()} pixels differ", flush=True)
    _check(n_diff == 0, f"{name}: the card's image differs from the CPU's")


def _sweep_rings(rows, per_ring: int, n_turns: float, seed: int, proj):
    """One scan of rings at their rows' elevation centers, each sweeping
    ``n_turns`` turns of azimuth (n_turns > 1: extra wrap events)."""
    import numpy as np
    from neural_spectral_codec_torch.ops.ring_path import (
        ring_elevation_centers)
    rng = np.random.default_rng(seed)
    el = ring_elevation_centers(proj, proj.n_elevation)[list(rows)]
    az = rng.uniform(0, 2 * np.pi, (1, len(rows), 1)) \
        + np.linspace(0, n_turns * 2 * np.pi, per_ring)[None, None]
    r = rng.uniform(0.5, 90.0, (1, len(rows), per_ring))
    ce, se = np.cos(el)[None, :, None], np.sin(el)[None, :, None]
    return np.stack([r * ce * np.cos(az), r * ce * np.sin(az),
                     r * se * np.ones_like(az), np.zeros_like(az)],
                    axis=-1).astype(np.float32)


def _edge_cases(device) -> None:
    """Options and inputs the serving run does not reach, each kernel
    against its plain version on the card: drop mode, 3-channel points,
    points on bin edges and axes (the general kernel's float64 path), an
    empty batch of points, n_folds = 1 and 3 with extra wraps and leading
    holes, rings on a subset of rows, no interpolation, another alpha."""
    import torch
    from neural_spectral_codec_torch.ops import (
        projection_kernel, ring_kernel, spectral_kernel)
    from neural_spectral_codec_torch.ops.range_image import (
        project_points_batch_plain)
    from neural_spectral_codec_torch.ops.ring_path import (
        project_rings_batch_plain)
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig, encode_images_plain)

    drop = SpectralEncoderConfig(elevation_mode="drop",
                                 elevation_range_deg=(-20.0, 0.0))
    pts = torch.from_numpy(_general_scans(2, SEED + 11)).to(device)
    edge = torch.from_numpy(_edge_points(40_000, SEED + 13,
                                         drop.projection)).to(device)
    for name, p, proj in (("drop", pts, drop.projection),
                          ("xyz", pts[..., :3].contiguous(),
                           SpectralEncoderConfig().projection),
                          ("edges, drop", edge[None], drop.projection),
                          ("edges, clip", torch.stack([edge, edge.flip(0)]),
                           SpectralEncoderConfig().projection),
                          ("N=0", pts[:, :0], drop.projection)):
        got = projection_kernel.project_points_cuda(p, proj)
        _check(torch.equal(got, project_points_batch_plain(p, proj)),
               f"projection kernel != plain version ({name})")
    rows = (3, 5, 9, 40, 41, 63)
    scan = _sweep_rings(rows, 1500, 2.6, SEED + 12, drop.projection)
    scan[0, 1, :200] = float("nan")                     # leading holes
    scan[0, 2, 700:900] = float("nan")                  # interior holes
    rings = torch.from_numpy(scan).to(device)
    for n_folds in (1, 2, 3):
        for proj in (SpectralEncoderConfig().projection, drop.projection):
            got = ring_kernel.project_rings_cuda(rings, proj, rows, n_folds)
            want = project_rings_batch_plain(rings, proj, rows, n_folds)
            _check(torch.equal(got, want), f"ring kernel != plain version "
                   f"(n_folds={n_folds}, {proj.elevation_mode})")
    imgs = project_points_batch_plain(pts, drop.projection)
    for cfg, alpha in ((drop._replace(interpolate_empty=False), 2.0),
                       (drop, 1.3)):
        err = float((spectral_kernel.encode_images_cuda(imgs, alpha, cfg)
                     - encode_images_plain(imgs, alpha, cfg)).abs().max())
        _check(err <= SPECTRAL_TOL, f"spectral kernel vs plain {err:.3e} "
               f"(interpolate={cfg.interpolate_empty}, alpha={alpha})")
    print("edge cases: drop mode, xyz input, points on bin edges and axes, "
          "N=0, n_folds 1-3 with extra wraps and holes, partial rows, no "
          "interpolation, alpha 1.3: kernels match their plain versions",
          flush=True)


def _spectral_shapes(gen) -> None:
    """The spectral kernel against its plain version at B=1 (the serve
    shape) and B=8, at E=64, the training configuration's E=16 (T=16, no
    pooling) and an E that T does not divide (E=20), each with
    interpolation on and off and alpha 2.0 and 1.3; at B=8 with empty rows
    and an all-empty scan."""
    import itertools

    import torch
    from neural_spectral_codec_torch.ops import spectral_kernel
    from neural_spectral_codec_torch.ops.range_image import (
        project_points_batch_plain)
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig, encode_images_plain)
    worst = 0.0
    for n_elev, batch in itertools.product((64, 16, 20), (1, BATCH)):
        base = SpectralEncoderConfig(n_elevation=n_elev)
        imgs = project_points_batch_plain(gen[:batch], base.projection)
        if batch > 1:
            imgs[1, : n_elev // 4] = 0.0                # empty rows
            imgs[2] = 0.0                               # empty scan
        imgs = imgs.contiguous()
        for interp in (True, False):
            for alpha in (2.0, 1.3):
                cfg = base._replace(interpolate_empty=interp)
                got = spectral_kernel.encode_images_cuda(imgs, alpha, cfg)
                err = float((got - encode_images_plain(imgs, alpha, cfg))
                            .abs().max())
                worst = max(worst, err)
                _check(err <= SPECTRAL_TOL and
                       bool(torch.isfinite(got).all()),
                       f"spectral kernel vs plain {err:.3e} (E={n_elev}, "
                       f"B={batch}, interpolate={interp}, alpha={alpha})")
    print(f"spectral kernel: B=1 and B={BATCH}, E=64, 16 and 20, "
          f"interpolation on and off, alpha 2.0 and 1.3: max abs err vs "
          f"plain {worst:.3e}",
          flush=True)


def _probe_kernels(device) -> dict:
    """The three probe kernels against their plain versions at the probe
    shapes, the roll kernels also in ROLL_CASES; returns {name: record
    fields} (max abs err, times, bound; for the roll kernels also the
    device time with a cold L2)."""
    import itertools

    import numpy as np
    import torch
    from neural_spectral_codec_torch.ops import probe_kernels as pk
    from neural_spectral_codec_torch.ops.ring_kernel import project_rings_cuda
    from neural_spectral_codec_torch.ops.ring_path import (
        make_structured_ring_scans)
    from neural_spectral_codec_torch.ops.spectral import SpectralEncoderConfig
    from neural_spectral_codec_torch.utils.timing import time_loop_ms

    proj = SpectralEncoderConfig().projection
    rows = tuple(range(N_RINGS))
    scans = make_structured_ring_scans(BATCH, N_RINGS, PER_RING, proj,
                                       seed=SEED + 20)
    extra = _sweep_rings(rows, PER_RING, 2.6, SEED + 21, proj)[0]
    extra[::5, ::9] = np.nan                            # scattered holes
    extra[3, :300] = np.nan                             # leading holes
    extra[7, 900:1400] = np.nan                         # interior holes
    scans[-1] = extra                                   # extra wrap events
    scans = torch.from_numpy(scans).to(device)
    key, vals = pk.ring_keys_padded(scans, proj)        # (512, 2176)
    for n_folds in (1, 2, 3):
        got = pk.ring_fold_probe(key, vals, proj.n_azimuth, n_folds)
        want = pk.ring_fold_rows_plain(key, vals, proj.n_azimuth, n_folds)
        _check(torch.equal(got, want), f"ring probe != plain version "
               f"(n_folds={n_folds}, {int((got != want).sum())} slots)")
        image = project_rings_cuda(scans, proj, rows, n_folds)
        _check(torch.equal(pk.fold_min_rows(got, BATCH, N_RINGS,
                                            proj.n_azimuth, n_folds), image),
               f"ring probe's rows != ring kernel's image (n_folds="
               f"{n_folds})")
    n_variants = 0
    for k in range(1, len(pk.PHASES) + 1):
        for skip in itertools.combinations(pk.PHASES, k):
            out = pk.ring_fold_probe(key, vals, proj.n_azimuth, 2, skip)
            _check(bool(torch.isfinite(out).all()),
                   f"ring probe without {skip}: non-finite rows")
            n_variants += 1
    print(f"ring probe: bit-equal to its plain version for n_folds 1-3 and "
          f"to the ring kernel after the fold min; {n_variants} ablation "
          f"variants launch with finite rows", flush=True)
    _ring_probe_cases(device, key, vals)

    rng = np.random.default_rng(SEED + 22)
    wpad = pk.folded_width(proj.n_azimuth, 2)
    floors = {}
    for width in (key.shape[1], wpad):
        u = torch.from_numpy(rng.uniform(0, 1, (key.shape[0], width))
                             .astype(np.float32)).to(device)
        floors[width] = (torch.round(u * 64) / 8, u)    # ties in x
    for width, n_stages, n_arrays in ((key.shape[1], 12, 1),
                                      (key.shape[1], 12, 2),
                                      (key.shape[1], 40, 2), (wpad, 10, 2)):
        x, y = floors[width]
        got = pk.roll_floor(x, y, n_stages, n_arrays)
        _check(torch.equal(got, pk.roll_floor_plain(x, y, n_stages,
                                                    n_arrays)),
               f"roll floor != plain version ({width} wide, {n_stages} "
               f"stages, {n_arrays} arrays)")
    xroll = torch.from_numpy(rng.uniform(0, 1, (BATCH * N_RINGS, 2112))
                             .astype(np.float32)).to(device)
    chain = pk.roll_min_chain(xroll, 64)
    _check(torch.equal(chain, pk.roll_min_chain_plain(xroll, 64)),
           "roll+min chain != plain version")
    print("roll floor (1 and 2 arrays, 10-40 stages, 2176 and 768 wide) "
          "and roll+min chain (64 stages, 512 x 2112): bit-equal to their "
          "plain versions", flush=True)
    _roll_cases(device)

    x, y = floors[key.shape[1]]
    wpad = pk.folded_width(proj.n_azimuth, 2)
    pairs = {
        "ring_probe": (lambda: pk.ring_fold_probe(key, vals, proj.n_azimuth,
                                                  2),
                       lambda: pk.ring_fold_rows_plain(
                           key, vals, proj.n_azimuth, 2),
                       4 * (key.numel() + vals.numel()
                            + key.shape[0] * wpad)),
        "roll_floor": (lambda: pk.roll_floor(x, y, 12, 2),
                       lambda: pk.roll_floor_plain(x, y, 12, 2),
                       4 * 3 * x.numel()),
        "roll_min_chain": (lambda: pk.roll_min_chain(xroll, 64),
                           lambda: pk.roll_min_chain_plain(xroll, 64),
                           4 * 2 * xroll.numel()),
    }
    flush = torch.empty(COLD_FLUSH_BYTES // 4, device=device)
    key1, vals1 = key[:N_RINGS].contiguous(), vals[:N_RINGS].contiguous()
    out = {}
    for name, (kernel, plain, n_bytes) in pairs.items():
        err = float((kernel() - plain()).abs().max())
        # plain, kernel, kernel, plain, in one call on one card
        p0 = time_loop_ms(plain, n=20)
        k0, k1 = time_loop_ms(kernel, n=200), time_loop_ms(kernel, n=200)
        p1 = time_loop_ms(plain, n=20)
        bound_ms, bound_by = _bound(n_bytes)
        out[name] = {"max_abs_err": err, "ms": (k0 + k1) / 2,
                     "plain_ms": (p0 + p1) / 2, "wrapper_ms": _time_ms(kernel),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     **_device_times(name, kernel)}
        # a cold L2: a 64 MB write before each call, not counted
        out[name]["device_ms_cold"] = _profiled_ms(
            name, lambda kernel=kernel: (flush.zero_(), kernel()))
        t = out[name]
        b1 = ""
        if name == "ring_probe":
            # B=1: the 64 rings of one scan
            def call1():
                return pk.ring_fold_probe(key1, vals1, proj.n_azimuth, 2)
            t.update({"bound_ms_b1": _bound(4 * (key1.numel() + vals1.numel()
                                                 + N_RINGS * wpad))[0],
                      "device_ms_b1": _profiled_ms(name, call1),
                      "device_ms_cold_b1": _profiled_ms(
                          name, lambda: (flush.zero_(), call1()))})
            b1 = (f"; B=1 device {_fmt_ms(t['device_ms_b1'])} ms, cold L2 "
                  f"{_fmt_ms(t['device_ms_cold_b1'])} ms, bound "
                  f"{t['bound_ms_b1']:.5f} ms")
        print(f"kernel {name}: device {t['device_ms']:.5f} ms "
              f"(profiler {t['profiler_ms']}, queued bare "
              f"{t['queued_ms']:.5f}), cold L2 "
              f"{_fmt_ms(t['device_ms_cold'])} ms{b1}, wrapper "
              f"{t['wrapper_ms']:.5f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}); loops kernel {k0:.5f}/{k1:.5f}, plain "
              f"{p0:.5f}/{p1:.5f} (B={BATCH})", flush=True)
    return out


def _special_rows(n_rows: int, width: int, seed: int, first: int = 0):
    """(x, y) float32 rows for the roll kernels' edge cases: x in steps of
    1/8 over [-1, 2] (ties); with r = row + ``first``, rows r = 1 mod 4
    have runs of +0 and -0 as their min, r = 2 mod 4 scattered +inf and
    -inf, r = 3 mod 4 one NaN, r = 7 mod 8 a NaN every 97 columns; y
    uniform with -0 every 13th column (it tells the chosen index apart)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 25, (n_rows, width)) / 8 - 1).astype(np.float32)
    y = rng.uniform(-1, 1, (n_rows, width)).astype(np.float32)
    y[:, ::13] = -0.0
    r = np.arange(n_rows) + first
    zeros = np.flatnonzero(r % 4 == 1)
    x[zeros] = np.abs(x[zeros]) + np.float32(0.125)
    x[np.ix_(zeros, np.arange(0, width, 11))] = -0.0
    x[np.ix_(zeros, np.arange(5, width, 17))] = 0.0
    inf = np.flatnonzero(r % 4 == 2)
    x[np.ix_(inf, rng.integers(0, width, width // 50 + 1))] = np.inf
    x[np.ix_(inf, rng.integers(0, width, width // 80 + 1))] = -np.inf
    nan = np.flatnonzero(r % 4 == 3)
    x[nan, rng.integers(0, width, len(nan))] = np.nan
    x[np.ix_(np.flatnonzero(r % 8 == 7), np.arange(0, width, 97))] = np.nan
    return x, y


def _on_card(a, device, misaligned: bool):
    """A contiguous CUDA copy of ``a``; with ``misaligned`` its data starts
    4 bytes past a 16-byte boundary."""
    import torch
    t = torch.from_numpy(a)
    if not misaligned:
        return t.to(device)
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _roll_cases(device) -> None:
    """Both roll kernels bit-equal (int32 views) to their plain versions
    on the card in every case of ROLL_CASES."""
    import torch
    from neural_spectral_codec_torch.ops import probe_kernels as pk
    for i, (rows, width, n_stages, n_arrays, misaligned) in enumerate(
            ROLL_CASES):
        x, y = _special_rows(rows, width, SEED + 40 + i, first=i % 4)
        x, y = _on_card(x, device, misaligned), _on_card(y, device, misaligned)
        if n_arrays:
            got = pk.roll_floor(x, y, n_stages, n_arrays)
            want = pk.roll_floor_plain(x, y, n_stages, n_arrays)
        else:
            got = pk.roll_min_chain(x, n_stages)
            want = pk.roll_min_chain_plain(x, n_stages)
        diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        _check(diff == 0, f"roll kernel != plain version ({rows} x {width}, "
               f"{n_stages} stages, arrays {n_arrays}, misaligned "
               f"{misaligned}: {diff} elements)")
    print(f"roll kernels: {len(ROLL_CASES)} more cases bit-equal to their "
          "plain versions (windows shorter than the row, NaN, +-0 and "
          "+-inf rows, widths 2175 and 2110, misaligned rows, single rows)",
          flush=True)


def _probe_key_rows(n_rows: int, width: int, seed: int):
    """(keys, ranges) float32 rows for the ring probe's edge cases: sweeps
    of 2.6 turns (extra wrap events) from random starts with scattered
    holes, a leading, an interior and a trailing invalid run on rows 1-3
    mod 8, rows 4 mod 8 with no valid point, rows 5 mod 8 falling one bin
    a point (every valid point after the first a wrap), keys outside
    [0, 360) as holes; ranges in [0.5, 80) with ties, +inf at holes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    az = rng.uniform(0, 360, (n_rows, 1)) + np.linspace(0, 2.6 * 360, width)
    key = (np.floor(az) % 360).astype(np.float32)
    key[rng.uniform(size=key.shape) < 0.1] = -1.0
    kind = np.arange(n_rows) % 8
    key[kind == 1, : (2 * width) // 5] = -1.0
    key[kind == 2, width // 3: (2 * width) // 3] = 400.0
    key[kind == 3, width - width // 4:] = -1.0
    key[kind == 4] = -1.0
    key[kind == 5] = (359 - np.arange(width)) % 360
    vals = (rng.integers(1, 160, key.shape) / 2).astype(np.float32)
    vals[~((key >= 0) & (key < 360))] = np.inf
    return key, vals


def _ring_probe_cases(device, key, vals) -> None:
    """The ring probe bit-equal to its plain version for n_folds 1-3 on:
    B=1 (64 rows, 512 threads a CTA), a single row, a width that is not
    a multiple of 4 (the scalar loads), rows 4 bytes off a 16-byte
    boundary, all-invalid rows and rows whose points all wrap
    (``_probe_key_rows``), and the widest rows the kernel takes (12
    points a thread at 512 threads) and one point less (the scalar
    loads); the next width must be refused with the wrapper's error, and
    a call after it must still be right."""
    import torch
    from neural_spectral_codec_torch.ops import probe_kernels as pk
    n_azim = 360
    widest = 12 * 512      # kPer points a thread at kManyThreads threads
    rows = {name: _probe_key_rows(n, w, SEED + 50 + i)
            for i, (name, n, w) in enumerate((
                ("2175 wide", 512, 2175), ("misaligned", 512, 2176),
                ("edge rows, B=1", N_RINGS, 2176), ("edge rows", 512, 2176),
                (f"widest {widest}", 3, widest),
                (f"widest - 1 {widest - 1}", 3, widest - 1)))}
    cases = {"B=1": (key[:N_RINGS].contiguous(), vals[:N_RINGS].contiguous()),
             "single row": (key[:1].contiguous(), vals[:1].contiguous())}
    for name, (k, v) in rows.items():
        misaligned = name == "misaligned"
        cases[name] = (_on_card(k, device, misaligned),
                       _on_card(v, device, misaligned))
    for name, (k, v) in cases.items():
        for n_folds in (1, 2, 3):
            got = pk.ring_fold_probe(k, v, n_azim, n_folds)
            want = pk.ring_fold_rows_plain(k, v, n_azim, n_folds)
            diff = int((got.view(torch.int32)
                        != want.view(torch.int32)).sum())
            _check(diff == 0, f"ring probe != plain version ({name}, "
                   f"{tuple(k.shape)}, n_folds={n_folds}: {diff} slots)")
    wide = _probe_key_rows(2, widest + 1, SEED + 60)
    try:
        pk.ring_fold_probe(torch.from_numpy(wide[0]).to(device),
                           torch.from_numpy(wide[1]).to(device), n_azim, 2)
        refused = False
    except RuntimeError as e:
        refused = "nsc_ring_probe" in str(e)
    _check(refused, f"ring probe: rows of {widest + 1} not refused")
    k, v = cases["edge rows"]
    _check(torch.equal(pk.ring_fold_probe(k, v, n_azim, 2),
                       pk.ring_fold_rows_plain(k, v, n_azim, 2)),
           "ring probe: wrong after a refused layout")
    print(f"ring probe: {len(cases)} more cases bit-equal for n_folds 1-3 "
          f"({', '.join(cases)}); rows of {widest + 1} refused", flush=True)


def _profiled_ms(name: str, call):
    """torch.profiler device ms per call of kernel ``name`` over
    PROFILED_CALLS calls of ``call``; a window that records no device
    time for it (it happens now and then) is taken again, up to three
    times, then None."""
    from neural_spectral_codec_torch.utils.timing import kernel_device_ms
    for _ in range(3):
        ms, _ = kernel_device_ms(call, KERNEL_NAMES[name],
                                 calls=PROFILED_CALLS)
        if ms is not None:
            return ms
    return None


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f}"


def _same_or_nan(a, b) -> bool:
    """Equal bit for bit, a NaN matching any NaN (the card's arithmetic
    gives its canonical NaN, a CPU keeps the payload)."""
    import torch
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bool(
        torch.equal(a[~nan], b[~nan]))


def _scene_clouds(device) -> tuple:
    """Two consecutive frames of phase 8's synthetic stream (131,072
    points) as the verifier prepares them: 0.3 m voxel means padded to
    VERIFY_POINTS, on the card, with their masks
    (``experiments.kernel_ab.prepared_frames``)."""
    from neural_spectral_codec_torch.experiments.kernel_ab import (
        prepared_frames)
    return prepared_frames(device, seed=SEED + 41, n_points=131_072,
                           max_points=VERIFY_POINTS)


def _search_kernels(device) -> dict:
    """Kernels N (``nearest_kernel``) and K (``knn_kernel``) against their
    plain versions on the card, bit for bit (indices, and N's squared
    distances with NaN matching NaN), at the verifier's shape (4,096 x
    4,096) on two prepared frames of phase 8's stream and on random
    clouds, and on edge cases: a lattice (ties everywhere), duplicate
    targets, one valid target, none, fewer than k valid points, NaN rows,
    P != Q, P = 1, k = 16 and 32; and where the kernels split their work
    (N: 2 ranks of Q/2 targets, tiles of 2,048, 32 parts a tile, groups
    of 8, 64 rows a CTA; K: 32 rows a CTA, the own batch first, tiles of
    4,096): a valid NaN target after the rows' finite minimum and before
    it, NaN only under the mask, duplicates across group, part and rank
    boundaries, P and Q off every multiple (Q below the cluster split and
    the parts, several tiles a rank), rows with exactly k valid points,
    k = 1, 16, 20 and 32 on the prepared frame, own batches that are the
    last, partial one, several tiles of K, NaN candidates inside a row's
    k. Then, on the prepared frames, each
    kernel's device time (torch.profiler, queued bare launches), its
    wrapper's, its plain version's, the two-call yardstick (torch.cdist +
    argmin or topk) and the bound (9 operations that cannot fuse a pair at
    33.5 T/s); one wrapper call must enqueue the kernel alone."""
    import torch
    from neural_spectral_codec_torch.retrieval import knn_kernel as kk
    from neural_spectral_codec_torch.retrieval import nearest_kernel as nk
    n = VERIFY_POINTS
    g = torch.Generator(device=device).manual_seed(SEED + 50)

    def cloud(rows):
        return (torch.rand(rows, 3, generator=g, device=device) - 0.5) * 40.0

    src, dst = cloud(n), cloud(n)
    mask = torch.rand(n, generator=g, device=device) < 0.8
    ones = torch.ones(n, dtype=torch.bool, device=device)
    lattice = torch.stack(torch.meshgrid(
        *[torch.arange(16.0, device=device)] * 3, indexing="ij"),
        -1).reshape(-1, 3) * 0.5
    between = (lattice + torch.tensor([0.25, 0.0, 0.25], device=device))[
        torch.randperm(n, generator=g, device=device)].contiguous()
    dup = torch.cat([dst[:n // 2], dst[:n // 2]])
    one = torch.zeros(n, dtype=torch.bool, device=device)
    one[777] = True
    few = torch.arange(n, device=device) % 400 == 0          # 11 valid
    nan_src = src.clone()
    nan_src[[5, 100]] = float("nan")
    nan_src[7, 1] = float("nan")
    scene_a, mask_a, scene_b, mask_b = _scene_clouds(device)
    nan = float("nan")
    nan_late = dst.clone()          # the finite minima lie mostly before it
    nan_late[3000] = nan
    nan_early = dst.clone()         # the first NaN early, another later
    nan_early[10, 2] = nan
    nan_early[2600, 0] = nan
    nan_masked = dst.clone()        # NaN only where the mask is off
    nan_masked[~mask] = nan
    tie = dst.clone()               # equal targets across the boundaries of
    seams = [7, 255, 511, 1023, 2047, 3583]   # a group, parts and the ranks
    for j in seams:
        tie[j + 1] = tie[j]
    tie_src = torch.cat([tie[seams], tie[seams].repeat(60, 1) + (torch.rand(
        60 * len(seams), 3, generator=g, device=device) - 0.5) * 0.2,
        src[:600]]).contiguous()
    wide, wide_mask = cloud(9000), torch.rand(
        9000, generator=g, device=device) < 0.9   # 3 tiles a rank (N), K
    perm = torch.randperm(n, generator=g, device=device)
    exactly, exactly32 = (torch.zeros(n, dtype=torch.bool, device=device)
                          for _ in range(2))
    exactly[perm[:20]] = True       # rows with exactly k valid points
    exactly32[perm[:32]] = True
    nan_pts = cloud(40)             # NaN candidates within a row's k
    nan_pts[[3, 5, 11, 17, 23, 33, 34, 36, 38, 39]] = nan
    nan_pts[21, 1] = nan
    nearest_cases = [
        ("scene", scene_a, scene_b, mask_b), ("random", src, dst, mask),
        ("lattice_ties", between, lattice, ones),
        ("duplicate_targets", src, dup, ones), ("one_valid", src, dst, one),
        ("none_valid", src, dst, torch.zeros_like(one)),
        ("nan_rows", nan_src, dst, mask),
        ("p_ne_q", src[:1000].contiguous(), dst[:3001].contiguous(),
         mask[:3001].contiguous()),
        ("p_1", src[:1].contiguous(), dst, mask),
        ("nan_after_minimum", src, nan_late, ones),
        ("nan_before_minimum", src, nan_early, ones),
        ("nan_masked", src, nan_masked, mask),
        ("ties_across_seams", tie_src, tie, ones),
        ("p257_q4097", src[:257].contiguous(), cloud(4097),
         torch.ones(4097, dtype=torch.bool, device=device)),
        ("q_below_split", src[:300].contiguous(), dst[:5].contiguous(),
         mask[:5].contiguous()),
        ("q_1", src, dst[:1].contiguous(), ones[:1]),
        ("p33_q7", src[:33].contiguous(), dst[:7].contiguous(),
         ones[:7]),
        ("q_9000", src, wide, wide_mask),
        ("scene_p_ne_q", scene_a[:4093].contiguous(), scene_b[:3001]
         .contiguous(), mask_b[:3001].contiguous())]
    knn_cases = [
        ("scene", scene_a, mask_a, 20), ("scene_k16", scene_a, mask_a, 16),
        ("random", src, mask, 20), ("lattice_ties", lattice, ones, 20),
        ("duplicates", dup, ones, 20), ("few_valid", src, few, 20),
        ("one_valid", src, one, 20), ("nan_rows", nan_src, mask, 20),
        ("k32", src, mask, 32), ("p_1", src[:1].contiguous(), ones[:1], 1),
        ("scene_k1", scene_a, mask_a, 1), ("scene_k32", scene_a, mask_a, 32),
        ("exactly_k", src, exactly, 20),
        ("exactly_k32", src, exactly32, 32),
        ("last_batch_partial", scene_a[:4093].contiguous(),
         mask_a[:4093].contiguous(), 20),
        ("n_1013", src[:1013].contiguous(), mask[:1013].contiguous(), 20),
        ("three_tiles", wide, wide_mask, 20),
        ("two_tiles_k32", wide[:5000].contiguous(),
         wide_mask[:5000].contiguous(), 32),
        ("nan_in_k", nan_pts, ones[:40], 32),
        ("nan_in_k_n24", nan_pts[:24].contiguous(), ones[:24], 20)]
    for name, a, b, m in nearest_cases:
        j, d2 = nk.nearest_cuda(a, b, m)
        jp, d2p = nk.nearest_plain(a, b, m)
        _check(torch.equal(j, jp) and _same_or_nan(d2, d2p),
               f"nearest kernel != plain version ({name}: "
               f"{int((j != jp).sum())} indices differ)")
    for name, a, m, k in knn_cases:
        idx, want = kk.knn_cuda(a, m, k), kk.knn_plain(a, m, k)
        _check(torch.equal(idx, want), f"knn kernel != plain version "
               f"({name}, k={k}: {int((idx != want).sum())} indices differ)")
    torch.cuda.synchronize()
    print(f"nearest: bit-equal to the plain version on "
          f"{[c[0] for c in nearest_cases]}; knn on "
          f"{[c[0] for c in knn_cases]}", flush=True)

    calls = {
        "nearest": (lambda: nk.nearest_cuda(scene_a, scene_b, mask_b),
                    lambda: nk.nearest_plain(scene_a, scene_b, mask_b),
                    lambda: torch.cdist(scene_a, scene_b).argmin(1),
                    _bound(n * 12 * 2 + n + n * 12, n_ops_no_fma=SEARCH_OPS
                           * n * n)),
        "knn": (lambda: kk.knn_cuda(scene_a, mask_a, 20),
                lambda: kk.knn_plain(scene_a, mask_a, 20),
                lambda: torch.cdist(scene_a, scene_a).topk(
                    20, largest=False),
                _bound(n * 12 + n + n * 20 * 8, n_ops_no_fma=SEARCH_OPS
                       * n * n)),
    }
    out = {}
    for name, (kernel, plain, yard, (bound_ms, bound_by)) in calls.items():
        _only_kernel(name, kernel)
        wrapper_ms = _time_ms(kernel)
        t = {"max_abs_err": 0.0, "ms": wrapper_ms, "wrapper_ms": wrapper_ms,
             "plain_ms": _time_ms(plain), "yardstick_ms": _time_ms(yard),
             "bound_ms": bound_ms, "bound_by": bound_by,
             **_device_times(name, kernel)}
        t["share_of_bound"] = bound_ms / t["device_ms"]
        out[name] = t
        print(f"kernel {name}: {n} x {n} (prepared frames) device "
              f"{t['device_ms']:.5f} ms (profiler {t['profiler_ms']}, queued "
              f"bare {t['queued_ms']:.5f}), wrapper {wrapper_ms:.5f} ms, "
              f"plain {t['plain_ms']:.4f} ms, yardstick "
              f"{t['yardstick_ms']:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}, {100 * t['share_of_bound']:.1f}% of it)",
              flush=True)
    return out


def _pca_rows(pts, idx, k: int):
    """(relative eigen-gap (lambda1 - lambda0) / lambda2, 0 where lambda2
    is 0; the eigenvalues; the float64 covariances) of each point's k-NN
    covariance, formed in float64 on the card (a reference only)."""
    import torch
    nbr = pts.double()[idx]
    c = nbr - nbr.mean(dim=1, keepdim=True)
    cov64 = torch.einsum("pki,pkj->pij", c, c) / k
    lam = torch.linalg.eigvalsh(cov64)
    gap = torch.where(lam[:, 2] > 0, (lam[:, 1] - lam[:, 0])
                      / lam[:, 2].clamp(min=1e-300), torch.zeros_like(
                          lam[:, 2]))
    return gap, lam, cov64


def _pca_case(name: str, pts, mask, mode: str, k: int) -> tuple:
    """Kernel C against its plain version on one cloud (after kernel K):
    every row finite; the rows whose relative eigen-gap lets the float32
    plain solve reach the bar held to it (covariances within PCA_COV_TOL,
    normals within 1 - |cos| <= PCA_NORMAL_TOL); every row to the
    invariants (a covariance symmetric with eigenvalues {eps, 1, 1}, a
    normal a unit vector in the span of the two smallest eigenvectors).
    Returns (the largest difference on the checked rows, rows checked)."""
    import torch
    from neural_spectral_codec_torch.retrieval import knn_kernel as kk
    from neural_spectral_codec_torch.retrieval import pca_kernel as pk
    eps = 1e-3
    idx = kk.knn_cuda(pts, mask, k)
    got = pk.knn_pca_cuda(pts, idx, mode, eps)
    want = pk.knn_pca_plain(pts, idx, mode, eps)
    gap, lam, cov64 = _pca_rows(pts, idx, k)
    what = f"knn_pca ({name}, {mode}, k={k})"
    _check(bool(torch.isfinite(got).all()), f"{what}: a row not finite")
    if mode == "covariances":
        rows = gap >= PCA_GAP_ERR / PCA_COV_TOL
        err = float((got - want)[rows].abs().max()) if rows.any() else 0.0
        _check(err <= PCA_COV_TOL, f"{what}: {err:.3e} from the plain "
               f"version on rows of relative gap >= 0.1")
        ev = torch.linalg.eigvalsh(got.double())
        inv = float((ev - torch.tensor([eps, 1.0, 1.0], dtype=ev.dtype,
                                       device=ev.device)).abs().max())
        _check(torch.equal(got, got.transpose(1, 2))
               and inv <= PCA_INV_TOL, f"{what}: not symmetric, or "
               f"eigenvalues {inv:.3e} from (eps, 1, 1)")
    else:
        rows = gap >= PCA_GAP_ERR / math.sqrt(2 * PCA_NORMAL_TOL)
        cos = (got.double() * want.double()).sum(1).abs()
        err = float(1 - cos[rows].min()) if rows.any() else 0.0
        _check(err <= PCA_NORMAL_TOL, f"{what}: 1 - |cos| {err:.3e} from "
               f"the plain version on rows of relative gap >= 7.1e-5")
        n = got.double()
        ray = torch.einsum("pi,pij,pj->p", n, cov64, n)
        _check(float(((n * n).sum(1) - 1).abs().max()) <= 1e-6 and bool(
            (ray <= lam[:, 1] + PCA_INV_TOL * lam[:, 2] + 1e-30).all()),
            f"{what}: a normal not unit or not in the span of the two "
            f"smallest eigenvectors")
    return err, int(rows.sum())


def _kabsch_cases(device, scene) -> list:
    """(name, H (B, 3, 3), p_c, q_c (B, 3)) on the card: random H,
    reflections (det(V U^T) = -1), H of a small rotation of 200 points,
    rank 2 (planar), rank 1 (collinear), H = 0 (no match), and the first
    point-to-point step's H between the two prepared frames."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.retrieval import nearest_kernel as nk
    rng = np.random.default_rng(SEED + 60)
    b = 64
    p_c = rng.uniform(-30, 30, (b, 3))
    q_c = p_c + rng.normal(0, 1, (b, 3))
    rand = rng.normal(size=(b, 3, 3))
    refl = rng.normal(size=(b, 3, 3))
    refl[np.linalg.det(refl) > 0, :, 2] *= -1
    rot = []
    for _ in range(b):
        src = rng.normal(0, 3, (200, 3))
        a = rng.uniform(-0.3, 0.3)
        c, s_ = math.cos(a), math.sin(a)
        R = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]])
        rot.append(src.T @ (src @ R.T))
    cases = [("random", rand), ("reflection", refl), ("rotation",
                                                      np.stack(rot)),
             ("rank2", rng.normal(size=(b, 3, 2))
              @ rng.normal(size=(b, 2, 3))),
             ("rank1", rng.normal(size=(b, 3, 1))
              @ rng.normal(size=(b, 1, 3))),
             ("zero", np.zeros((b, 3, 3)))]

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device)

    out = [(name, dev(h), dev(p_c), dev(q_c)) for name, h in cases]
    src, src_mask, dst, dst_mask = scene
    j, d2 = nk.nearest_cuda(src, dst, dst_mask)
    w = (src_mask & (torch.sqrt(d2) <= 1.0)).float()
    q = dst[j]
    sw = w.sum().clamp(min=1e-6)
    pc = (src * w[:, None]).sum(0) / sw
    qc = (q * w[:, None]).sum(0) / sw
    H = torch.einsum("ni,nj->ij", (src - pc) * w[:, None], q - qc)
    out.append(("scene_step", H[None].contiguous(), pc[None].contiguous(),
                qc[None].contiguous()))
    return out


def _kabsch_case(name: str, h, p_c, q_c) -> float:
    """Kernel R's solve entry (``kabsch_cuda``, the update's horn_solve
    alone) against its plain version (svd and det on the card) on each H
    of a case: a proper rotation, R within KABSCH_TOL and t within
    KABSCH_TOL * max(1, |p_c|_1) where the optimal rotation is unique; for
    rank 1 the same trace(R H); H = 0 gives R = I exactly. Returns the
    largest |R difference| (0 for rank 1)."""
    import torch
    from neural_spectral_codec_torch.retrieval import pca_kernel as pk
    err = 0.0
    eye = torch.eye(3, device=h.device)
    for i in range(h.shape[0]):
        got = pk.kabsch_cuda(h[i], p_c[i], q_c[i])
        want = pk.kabsch_plain(h[i], p_c[i], q_c[i])
        R, Rw = got[:3, :3].double(), want[:3, :3].double()
        what = f"kabsch ({name}, H {i})"
        _check(bool(torch.isfinite(got).all()) and float(
            (R @ R.T - eye.double()).abs().max()) <= 4e-6 and abs(float(
                torch.linalg.det(R)) - 1) <= 4e-6, f"{what}: not a proper "
               f"rotation")
        scale = max(1.0, float(p_c[i].abs().sum()))
        if name == "rank1":
            obj = float((R * h[i].double().T).sum())
            objw = float((Rw * h[i].double().T).sum())
            _check(abs(obj - objw) <= 1e-5 * max(1.0, abs(objw)),
                   f"{what}: trace(R H) {obj} != {objw}")
            continue
        e = float((R - Rw).abs().max())
        et = float((got[:3, 3] - want[:3, 3]).abs().max())
        _check(e <= KABSCH_TOL and et <= KABSCH_TOL * scale and torch.equal(
            got[3], want[3]), f"{what}: R {e:.3e}, t {et:.3e} from the "
            f"plain version")
        if name == "zero":
            _check(torch.equal(got[:3, :3], eye), f"{what}: R != I")
        err = max(err, e)
    return err


def _p2p_cases(device, scene) -> dict:
    """Kernel R's update (``pca_kernel.p2p_update_cuda``) against its
    plain version on the card, on kernel N's correspondences of the two
    prepared frames: from the identity and from a 2 degree, 0.55 m offset,
    with every other source point masked, with no pair in range (T = I
    exactly), at P = 1,000 (a cluster of 2) and P = 20,000 (8 CTAs, points
    past the registers gathered again). R within KABSCH_UPDATE_TOL and t
    within KABSCH_UPDATE_TOL * max(1, |p_c|_1) of the plain step in
    float64; of the float32 plain step within the same bars plus that
    step's own distance from the float64 one (the error of its float32
    sums and solve, which the kernel does not have); a proper rotation; a
    second call the same bits. Returns {case: (R error vs float32 plain,
    vs float64 plain, t error vs float64 plain / max(1, |p_c|_1))}."""
    import torch
    from neural_spectral_codec_torch.retrieval import nearest_kernel as nk
    from neural_spectral_codec_torch.retrieval import pca_kernel as pk
    src, src_mask, dst, dst_mask = scene
    eye = torch.eye(4, device=device)
    off = eye.clone()
    ang = math.radians(2.0)
    off[0, 0], off[0, 1], off[1, 0], off[1, 1] = (
        math.cos(ang), -math.sin(ang), math.sin(ang), math.cos(ang))
    off[:3, 3] = torch.tensor([0.5, -0.2, 0.1], device=device)
    half = src_mask & (torch.arange(len(src), device=device) % 2 == 0)
    big = src.repeat(5, 1)[:20_000].contiguous()
    big_mask = src_mask.repeat(5)[:20_000].contiguous()
    cases = [("identity", src, src_mask, eye, 1.0),
             ("offset", src, src_mask, off, 1.0),
             ("half_masked", src, half, eye, 1.0),
             ("none_in_range", src, src_mask, off, 1e-6),
             ("p1000", src[:1000].contiguous(), src_mask[:1000].contiguous(),
              eye, 1.0),
             ("p20000", big, big_mask, off, 1.0)]
    out = {}
    for name, s, m, T, max_corr in cases:
        moved = (s @ T[:3, :3].T + T[:3, 3]).contiguous()
        j, d2 = nk.nearest_cuda(moved, dst, dst_mask)
        want = pk.p2p_update_plain(s, m, dst, j, d2, max_corr)
        want64 = pk.p2p_update_plain(s.double(), m, dst.double(), j, d2,
                                     max_corr)
        w = m & (torch.sqrt(d2) <= max_corr)
        p_c = (s.double() * w[:, None]).sum(0) / max(float(w.sum()), 1e-6)
        scale = max(1.0, float(p_c.abs().sum()))
        own_r = float((want[:3, :3].double() - want64[:3, :3]).abs().max())
        own_t = float((want[:3, 3].double() - want64[:3, 3]).abs().max())
        got = pk.p2p_update_cuda(s, m, dst, j, d2, max_corr)
        again = pk.p2p_update_cuda(s, m, dst, j, d2, max_corr)
        R = got[:3, :3].double()
        e32 = float((R - want[:3, :3].double()).abs().max())
        e64 = float((R - want64[:3, :3]).abs().max())
        t32 = float((got[:3, 3].double() - want[:3, 3].double()).abs().max())
        t64 = float((got[:3, 3].double() - want64[:3, 3]).abs().max())
        what = f"kabsch update ({name})"
        _check(torch.equal(got, again) and bool(torch.isfinite(got).all())
               and float((R @ R.T - torch.eye(3, dtype=R.dtype,
                                              device=device)).abs().max())
               <= 4e-6 and abs(float(torch.linalg.det(R)) - 1) <= 4e-6
               and torch.equal(got[3], eye[3]), f"{what}: not the same "
               f"bits twice, or not a proper rotation")
        _check(e64 <= KABSCH_UPDATE_TOL and t64 <= KABSCH_UPDATE_TOL * scale,
               f"{what}: R {e64:.3e}, t {t64:.3e} from the float64 plain")
        _check(e32 <= KABSCH_UPDATE_TOL + own_r and
               t32 <= KABSCH_UPDATE_TOL * scale + own_t, f"{what}: R "
               f"{e32:.3e}, t {t32:.3e} from the float32 plain (its own "
               f"error R {own_r:.3e}, t {own_t:.3e})")
        if name == "none_in_range":
            _check(torch.equal(got, eye), f"{what}: T != I")
        out[name] = (e32, e64, t64 / scale)
    return out


def _pca_kernels(device) -> dict:
    """Kernels C (``pca_kernel.knn_pca``) and R (``pca_kernel.p2p_update``)
    against their plain versions on the card. C after kernel K, on the two
    prepared frames of phase 8's stream, random clouds, a padded cloud
    (3,000 valid points and zeros), fewer than k valid points, 24 copies
    of each point, points on three lines and a lattice, as covariances
    (k 20, eps 1e-3) and normals (k 16), under the bars and gap rule of
    ``_pca_case``. R's update on the cases of ``_p2p_cases``, and its
    solve entry on 64 H of each kind of ``_kabsch_cases``. Then, on the
    prepared frame at k 20, C's device time (torch.profiler, queued bare
    launches), its wrapper's, its plain version's, the yardstick
    (``torch.linalg.eigh`` on the (P, 3, 3) batch) and the bound (its
    bytes at 3.35 TB/s: the points, the indices and the covariances); and
    the same for R's update on the prepared frames' first step (yardstick
    ``torch.linalg.svd`` of H; bound its bytes: the source points, mask,
    j, d2, the gathered targets and T), and the solve entry's device
    time; one wrapper call of each must enqueue the kernel alone."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.retrieval import knn_kernel as kk
    from neural_spectral_codec_torch.retrieval import nearest_kernel as nk
    from neural_spectral_codec_torch.retrieval import pca_kernel as pk
    n = VERIFY_POINTS
    g = torch.Generator(device=device).manual_seed(SEED + 61)
    scene = _scene_clouds(device)
    scene_a, mask_a, scene_b, mask_b = scene
    rand = (torch.rand(n, 3, generator=g, device=device) - 0.5) * 40.0
    rand_mask = torch.rand(n, generator=g, device=device) < 0.8
    padded = torch.zeros(n, 3, device=device)
    padded[:3000] = scene_a[:3000]
    pad_mask = torch.arange(n, device=device) < 3000
    few = torch.zeros(n, 3, device=device)
    few[:11] = rand[:11]
    few_mask = torch.arange(n, device=device) < 11
    copies = rand[:171].repeat_interleave(24, 0)[:n].contiguous()
    rng = np.random.default_rng(SEED + 62)
    t = rng.uniform(-10, 10, (3, n // 3 + 1))
    dirs = np.array([[1, 0, 0], [0.6, 0.8, 0], [0, 0.6, 0.8]])
    lines = (t[:, :, None] * dirs[:, None, :] + np.array(
        [[0, 0, 0], [40, 0, 0], [0, 40, 0]])[:, None, :]).reshape(-1, 3)
    lines = torch.from_numpy(lines[:n].astype(np.float32)).to(device)
    lattice = (torch.stack(torch.meshgrid(
        *[torch.arange(16.0, device=device)] * 3, indexing="ij"),
        -1).reshape(-1, 3) * 0.5)[:n].contiguous()
    ones = torch.ones(n, dtype=torch.bool, device=device)
    clouds = [("scene_a", scene_a, mask_a), ("scene_b", scene_b, mask_b),
              ("random", rand, rand_mask), ("padded", padded, pad_mask),
              ("few_valid", few, few_mask), ("copies", copies, ones),
              ("collinear", lines, ones), ("lattice", lattice, ones)]
    errs = {}
    for name, pts, mask in clouds:
        for mode, k in (("covariances", 20), ("normals", 16)):
            errs[(name, mode)] = _pca_case(name, pts, mask, mode, k)
    torch.cuda.synchronize()
    print("knn_pca: within the bars of the plain version on the rows above "
          "the gap, invariants on every row, every row finite: " +
          ", ".join(f"{c} {m} {e:.3e} on {r} rows"
                    for (c, m), (e, r) in errs.items()), flush=True)
    upd = _p2p_cases(device, scene)
    torch.cuda.synchronize()
    print(f"kabsch update: within the bars of the plain version (float32 "
          f"and float64), proper rotations, no pair in range -> I, the "
          f"same bits twice; R error vs float32 / float64 plain, t error "
          f"vs float64 plain / max(1, |p_c|_1): "
          f"{json.dumps(upd)}", flush=True)
    kcases = _kabsch_cases(device, scene)
    kab = {name: _kabsch_case(name, h, pc, qc) for name, h, pc, qc in kcases}
    torch.cuda.synchronize()
    print(f"kabsch solve entry: within the bars of the plain version, "
          f"proper rotations, H = 0 -> I, rank 1 the same trace(R H): "
          f"{json.dumps(kab)}", flush=True)

    idx20 = kk.knn_cuda(scene_a, mask_a, 20)
    cov32 = pk.cov_matrices(scene_a, idx20)
    _, h, pc, qc = kcases[-1]
    h, pc, qc = h[0], pc[0], qc[0]
    j, d2 = nk.nearest_cuda(scene_a, scene_b, mask_b)
    k = 20
    calls = {
        "knn_pca": (lambda: pk.knn_pca_cuda(scene_a, idx20, "covariances",
                                            1e-3),
                    lambda: pk.knn_pca_plain(scene_a, idx20, "covariances",
                                             1e-3),
                    lambda: torch.linalg.eigh(cov32),
                    _bound(n * 12 + n * k * 8 + n * 36,
                           n_flops=n * 12 * k,
                           n_ops_no_fma=n * (6 * k + 9)),
                    max(e for (c, m), (e, _) in errs.items()
                        if m == "covariances")),
        "kabsch": (lambda: pk.p2p_update_cuda(scene_a, mask_a, scene_b, j,
                                              d2, 1.0),
                   lambda: pk.p2p_update_plain(scene_a, mask_a, scene_b, j,
                                               d2, 1.0),
                   lambda: torch.linalg.svd(h),
                   _bound(n * (12 + 1 + 8 + 4 + 12) + 64,
                          n_ops_no_fma=40 * n),
                   max(e[0] for e in upd.values())),
    }
    out = {}
    for name, (kernel, plain, yard, (bound_ms, bound_by), err) in \
            calls.items():
        _only_kernel(name, kernel)
        wrapper_ms = _time_ms(kernel)
        t = {"max_abs_err": err, "ms": wrapper_ms, "wrapper_ms": wrapper_ms,
             "plain_ms": _time_ms(plain), "yardstick_ms": _time_ms(yard),
             "bound_ms": bound_ms, "bound_by": bound_by,
             **_device_times(name, kernel)}
        t["share_of_bound"] = bound_ms / t["device_ms"]
        out[name] = t
        print(f"kernel {name}: " + ("(4096, 3) points, k 20 (prepared "
              "frame)" if name == "knn_pca" else "the update of 4,096 "
              "points (prepared frames' first step)") +
              f" device {t['device_ms']:.5f} ms "
              f"(profiler {t['profiler_ms']}, queued bare "
              f"{t['queued_ms']:.5f}), wrapper {wrapper_ms:.5f} ms, plain "
              f"{t['plain_ms']:.4f} ms, yardstick {t['yardstick_ms']:.4f} "
              f"ms, bound {bound_ms:.7f} ms ({bound_by}, "
              f"{100 * t['share_of_bound']:.2f}% of it)", flush=True)
    out["kabsch"]["solve_device_ms"] = _solve_entry_ms(h, pc, qc)
    return out


def _solve_entry_ms(h, pc, qc) -> dict:
    """Device ms (torch.profiler, queued bare launches) of kernel R's
    solve entry alone on the prepared frames' H."""
    from neural_spectral_codec_torch.retrieval import pca_kernel as pk
    from neural_spectral_codec_torch.utils.timing import (
        kernel_device_ms, time_queued_ms)
    pk.kabsch_cuda(h, pc, qc)
    solve = {"queued_ms": time_queued_ms(pk.KABSCH_SOLVE.bare(),
                                         n=QUEUED_CALLS),
             "profiler_ms": kernel_device_ms(
                 lambda: pk.kabsch_cuda(h, pc, qc), ("kabsch_solve_kernel",),
                 calls=PROFILED_CALLS)[0]}
    print(f"kernel kabsch: the solve entry alone, device ms "
          f"{_fmt_ms(solve['profiler_ms'])} (profiler), "
          f"{solve['queued_ms']:.5f} (queued bare)", flush=True)
    return solve


def _probe_paths() -> dict:
    """Phase 5: both stage-profile entry points, each with all six launch
    counts set to 0 just before it and read just after; each must launch
    the kernels its lines time. Returns {entry point: launches}."""
    from neural_spectral_codec_torch.experiments import (
        profile_hotpath, ring_stage_probe)
    runs = (
        ("ring_stage_probe", lambda: ring_stage_probe.main(
            ["--iters", "20", "--rounds", "3"]),
         ("ring_probe", "roll_floor", "ring_fold")),
        ("profile_hotpath", lambda: profile_hotpath.main(["--iters", "5"]),
         ("ring_probe", "roll_min_chain", "spectral", "ring_fold",
          "project")),
    )
    by_path = {}
    for name, run, needed in runs:
        _, launches = _counted(run)
        print(f"probes: {name} launches {launches}", flush=True)
        _check(all(launches[n] > 0 for n in needed),
               f"{name} never launched one of {needed}: {launches}")
        by_path[name] = launches
    return by_path


def _structured(device) -> dict:
    """Phase 6: ``encode_structured`` on four full-density flat streams,
    each descriptor against ``encode_points_batch`` on the same cloud;
    returns the launches."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.ops.ring_path import (
        encode_structured, infer_ring_ids_by_elevation,
        infer_ring_ids_from_sweep, make_structured_ring_scans,
        prepare_structured)
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig, encode_points_batch)

    cfg = SpectralEncoderConfig()
    scans = make_structured_ring_scans(4, N_RINGS, PER_RING, cfg.projection,
                                       seed=SEED + 30)
    sweep = scans[0].reshape(-1, 4)
    nclt = scans[1].transpose(1, 0, 2).reshape(-1, 4)
    helipr = scans[2].transpose(1, 0, 2).reshape(-1, 4)
    # a scan in no sensor order (a NaN tail here would become one ring of
    # every padding point, and the ring bucketing would allocate R x P)
    cloud = scans[3].reshape(-1, 4)[
        np.random.default_rng(SEED + 31).permutation(N_POINTS)]
    streams = {
        "sweep order (KITTI)": (sweep, infer_ring_ids_from_sweep(sweep), True),
        "interleaved (NCLT)": (nclt, infer_ring_ids_by_elevation(nclt), True),
        "ring field (HeLiPR)": (helipr, np.tile(np.arange(N_RINGS), PER_RING),
                                True),
        "unstructured": (cloud, infer_ring_ids_from_sweep(cloud), False),
    }
    want = {}
    for name, (flat, rid, ring) in streams.items():
        _check((prepare_structured(flat, rid, cfg) is not None) == ring,
               f"structured: {name} took the wrong branch")
        want[name] = encode_points_batch(
            torch.from_numpy(flat[None]).to(device), cfg.alpha, cfg)[0]
    got, launches = _counted(lambda: {
        name: encode_structured(flat, rid, cfg.alpha, cfg, device=device)
        for name, (flat, rid, _) in streams.items()})
    for name, (flat, _, ring) in streams.items():
        err = float((got[name] - want[name]).abs().max())
        _check(got[name].device.type == "cuda" and err <= 1e-6 and
               bool(torch.isfinite(got[name]).all()),
               f"structured: {name} descriptor {err:.3e} from the general "
               "path")
        print(f"structured: {name}, {len(flat)} points, "
              f"{'ring' if ring else 'general'} path, {err:.3e} from "
              f"encode_points_batch", flush=True)
    print(f"structured: launches {launches}", flush=True)
    _check({k: launches[k] for k in ("spectral", "ring_fold", "project")}
           == {"spectral": 4, "ring_fold": 3, "project": 1},
           f"structured: unexpected launches {launches}")
    return launches


def _all_kernels() -> dict:
    from neural_spectral_codec_torch.models import gather_kernel
    from neural_spectral_codec_torch.ops import (
        probe_kernels, projection_kernel, ring_kernel, spectral_kernel)
    from neural_spectral_codec_torch.retrieval import (
        knn_kernel, nearest_kernel, pca_kernel, query_kernel)
    from neural_spectral_codec_torch.training import (
        mine_kernel, select_kernel)
    return {"spectral": spectral_kernel.KERNEL,
            "ring_fold": ring_kernel.KERNEL,
            "project": projection_kernel.KERNEL,
            "ring_probe": probe_kernels.RING_PROBE,
            "roll_floor": probe_kernels.ROLL_FLOOR,
            "roll_min_chain": probe_kernels.ROLL_MIN_CHAIN,
            "nearest": nearest_kernel.KERNEL,
            "knn": knn_kernel.KERNEL,
            "knn_pca": pca_kernel.KNN_PCA,
            "kabsch": pca_kernel.KABSCH,
            "mine": mine_kernel.HARD,
            "mine_draw": mine_kernel.DRAW,
            "gather_bwd": gather_kernel.KERNEL,
            "mine_counts": mine_kernel.COUNTS,
            "mine_rows": mine_kernel.ROWS,
            "mine_draw_mask": mine_kernel.DRAW_MASK,
            "select": select_kernel.KERNEL,
            "query": query_kernel.KERNEL,
            "query_dist": query_kernel.DIST_KERNEL,
            # not a kernel: the group regime's share of query's and
            # query_dist's launches (Q > 1)
            "query_group": query_kernel.GROUP}


def _counted(run) -> tuple:
    """(run's result, {kernel: launches}) with every count set to 0 just
    before ``run`` and read just after."""
    kernels = _all_kernels()
    for k in kernels.values():
        k.launches = 0
    out = run()
    return out, {n: k.launches for n, k in kernels.items()}


def _once_ms(fn) -> float:
    """Device ms of one call of ``fn`` (CUDA events; the caller has called
    it once already)."""
    import torch
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _few_ms(fn, calls: int) -> float:
    from neural_spectral_codec_torch.utils.timing import time_ms
    return time_ms(fn, calls=calls, warmup=1)


def _mine_inputs(n: int, device) -> tuple:
    """(positions, CDFs) of an n-frame ``synthetic_city`` sequence on the
    card, the CDFs as the miner forms them."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.experiments.scale_100k import (
        synthetic_city)
    desc, poses, _ = synthetic_city(n)
    cdfs = np.cumsum(desc / np.maximum(desc.sum(1, keepdims=True), 1e-12),
                     axis=1).astype(np.float32)
    return (torch.from_numpy(poses[:, :3, 3].astype(np.float32)).to(device),
            torch.from_numpy(cdfs).to(device))


def _same_mined(got, want) -> list:
    import torch
    return [f for f, a, b in zip(got._fields, got, want)
            if not torch.equal(a, b)]


def _training_kernels(device) -> dict:
    """Phase 7k: kernel M (``training/mine_kernel.py``) against
    ``mine_plain`` on the card, bit for bit (positive draws with the same
    u, hard negatives, both counts, valid), on every MINE_CHUNK-anchor
    chunk of a SCALE_NODES-frame ``synthetic_city`` sequence (the last
    one moved back to end at the sequence's end, as the miner runs it)
    and on partial chunks (1 anchor, the last 37, 100 in the middle);
    then timed on one MINE_CHUNK x MINE_NODES chunk (device, wrapper and
    plain time, the yardstick cdist, the bound: 2 operations a bin and
    pair that cannot fuse). Kernel G (``models/gather_kernel.py``)
    against its plain version and the CPU's ``index_add_``, bit for bit,
    on the GAT neighbour table of a SCALE_NODES-node graph (its valid
    slots' plan; float32 and bf16 gradients, zero at masked slots) and on
    4,096 triplet gathers with repeats into (SCALE_NODES, 800); timed
    against ``index_add_`` on the same rows."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.experiments.scale_100k import (
        synthetic_city)
    from neural_spectral_codec_torch.keyframe.graph import (
        build_graph, graph_to_tensors)
    from neural_spectral_codec_torch.models import gather_kernel as gk
    from neural_spectral_codec_torch.training import mine_kernel as mk

    params = tuple(float(v) for v in np.array(MINE_PARAMS, np.float32))
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    n = SCALE_NODES
    pos, cdf = _mine_inputs(n, device)
    boxes = mk.tile_boxes(pos)
    cases = [(min(s, n - MINE_CHUNK), MINE_CHUNK)
             for s in range(0, n, MINE_CHUNK)]
    n_chunks = len(cases)
    cases += [(0, 1), (n - 37, 37), (n // 2, 100)]
    valid, mined = 0, []
    for k, (start, count) in enumerate(cases):
        u = torch.rand(count, generator=gen, device=device)
        st = torch.tensor([start], dtype=torch.int32, device=device)
        want = mk.mine_plain(pos, cdf, start, count, params, u)
        got = mk.mine_cuda(pos, cdf, st, count, params, u, boxes)
        bad = _same_mined(got, want)
        _check(not bad, f"mine kernel != plain version (start {start}, "
               f"count {count}): {bad} differ")
        valid += int(want.valid.sum())
        if k < n_chunks:     # the miner keeps a moved-back chunk's new ones
            mined.append([t[k * MINE_CHUNK - start:] for t in got])
    print(f"mine: bit-equal to the plain version (draws, hard negatives, "
          f"counts, valid) on the {n_chunks} chunks of a {n}-frame "
          f"sequence and 3 partial chunks ({valid} valid anchors)",
          flush=True)
    # one 4,096-triplet batch of M's own output, as the trainer's first
    # epoch takes it (its seeded shuffle): the plans of kernel G below
    pos_i, neg_i, _, _, ok = (torch.cat(f) for f in zip(*mined))
    anchors = torch.nonzero(ok)[:, 0]
    trip = torch.stack([anchors, pos_i[anchors].long(),
                        neg_i[anchors].long()], dim=1)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(
        len(trip))[:4096]).to(device)
    mined_batch = trip[perm]
    del pos, cdf
    pos, cdf = _mine_inputs(MINE_NODES, device)
    bins, start = cdf.shape[1], MINE_NODES // 2
    u = torch.rand(MINE_CHUNK, generator=gen, device=device)
    st = torch.tensor([start], dtype=torch.int32, device=device)
    scratch = mk.mine_scratch(MINE_NODES, MINE_CHUNK, device)
    boxes = mk.tile_boxes(pos)      # alive for the bare launches

    def call():
        return mk.mine_cuda(pos, cdf, st, MINE_CHUNK, params, u, boxes,
                            scratch)

    def plain():
        return mk.mine_plain(pos, cdf, start, MINE_CHUNK, params, u)

    bad = _same_mined(call(), plain())
    _check(not bad, f"mine kernel != plain version at {MINE_CHUNK} x "
           f"{MINE_NODES}: {bad} differ")
    bound_ms, bound_by = _bound(
        4 * MINE_NODES * (3 + bins) + 4 * MINE_CHUNK + 17 * MINE_CHUNK,
        n_ops_no_fma=2 * bins * MINE_CHUNK * MINE_NODES)
    wrapper_ms = _few_ms(call, 10)
    t = {"max_abs_err": 0.0, "ms": wrapper_ms, "wrapper_ms": wrapper_ms,
         "plain_ms": _once_ms(plain),
         "yardstick_ms": _few_ms(lambda: torch.cdist(
             cdf[start:start + MINE_CHUNK][None], cdf[None], p=1.0), 3),
         "bound_ms": bound_ms, "bound_by": bound_by,
         **_device_times("mine", call, profiled=10, queued_calls=3)}
    # the draw's device time after the first entry (each profiled call
    # launches both; the positions are cold after its 320 MB of CDFs), and
    # queued bare draws (warm)
    draw = _device_times("mine_draw", call, profiled=10, queued_calls=20)
    t["draw_device_ms"], t["draw_queued_ms"] = (draw["device_ms"],
                                                draw["queued_ms"])
    t["share_of_bound"] = bound_ms / t["device_ms"]
    # the draw's own bounds (_draw_bounds): over the gated work, and over
    # the frames from the split's first to the drawn positive
    got = call()
    splits = scratch[0].shape[0]
    walk = mk.draw_rounds(pos, start, got.pos_idx, got.count_pos, params,
                          "pos", splits)
    t.update({f"draw_{k}": v for k, v in _draw_bounds(
        walk, mk.draw_frames(got.pos_idx, got.count_pos, MINE_NODES,
                             splits), MINE_CHUNK, splits).items()})
    t.update({f"draw_{k}": v for k, v in walk.items()})
    t["draw_share_of_bound"] = t["draw_bound_ms"] / t["draw_device_ms"]
    out = {"mine": t}
    print(f"kernel mine: {MINE_CHUNK} x {MINE_NODES} x {bins} bins, device "
          f"{t['device_ms']:.4f} ms (profiler {t['profiler_ms']}, queued "
          f"bare {t['queued_ms']:.4f}), wrapper {wrapper_ms:.4f} ms, plain "
          f"{t['plain_ms']:.1f} ms, yardstick cdist {t['yardstick_ms']:.3f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"{100 * t['share_of_bound']:.1f}% of it); draw entry "
          f"{t['draw_device_ms']:.5f} ms after the first entry (queued "
          f"bare {t['draw_queued_ms']:.5f}) over {splits} splits, bound "
          f"{t['draw_bound_ms']:.5f} ms ({t['draw_bound_by']}, "
          f"{100 * t['draw_share_of_bound']:.1f}% of it; "
          f"{t['draw_model_frames_needed']} frames of kept tiles, "
          f"{t['draw_model_tiles_tested']} box tests), scan bound "
          f"{t['draw_scan_bound_ms']:.5f} ms "
          f"({t['draw_frames_scanned']} frames from the splits' starts); "
          f"model: rounds an anchor mean {t['draw_model_rounds_mean']:.3f}, "
          f"max {t['draw_model_rounds_max']}, "
          f"{t['draw_model_frames_read']} frames read, tiles kept before "
          f"the positive's {t['draw_model_tiles_kept_mean']:.2f} on average",
          flush=True)
    del pos, cdf, scratch

    desc, poses, _ = synthetic_city(n)
    g = graph_to_tensors(build_graph(desc, poses, temporal_neighbors=5),
                         device)
    keep = g.mask.reshape(-1)
    idx_all = g.neighbors.reshape(-1)
    plan = gk.make_plan(idx_all, n, keep)
    width = 256                                # hidden_dim of the GAT
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        grad = (torch.randn(idx_all.numel(), width, generator=gen,
                            device=device) * keep[:, None]).to(dtype)
        got = gk.gather_bwd_cuda(grad, plan, n)
        want_cpu = torch.zeros(n, width, dtype=dtype).index_add_(
            0, idx_all.cpu(), grad.cpu())
        _check(torch.equal(got, gk.gather_bwd_plain(grad, plan, n)) and
               torch.equal(got.cpu(), want_cpu),
               f"gather_bwd kernel != plain version / CPU index_add_ on the "
               f"neighbour table ({dtype})")
        grads[dtype] = grad
    tri = torch.randint(0, n, (4096,), generator=gen, device=device)
    tri[:1024] = tri[1024:2048]                # repeats
    tri_free = tri.clone()
    tri[:16] = 7                               # a long segment
    tgrad = torch.randn(4096, 800, generator=gen, device=device)
    tplan = gk.make_plan(tri, n)
    plans = {"random": (tri, tplan),
             "random_no16": (tri_free, gk.make_plan(tri_free, n))}
    plans.update({f"mined_{name}": (mined_batch[:, c].contiguous(),
                                    gk.make_plan(mined_batch[:, c], n))
                  for c, name in enumerate(("anchor", "positive",
                                            "negative"))})
    for name, (idx, pl) in plans.items():
        g = tgrad[:len(idx)]
        got = gk.gather_bwd_cuda(g, pl, n)
        _check(torch.equal(got, gk.gather_bwd_plain(g, pl, n)) and
               torch.equal(got.cpu(), torch.zeros(n, 800).index_add_(
                   0, idx.cpu(), g.cpu())),
               f"gather_bwd kernel != plain version / CPU index_add_ on the "
               f"{name} triplet plan")
        gb = g.to(torch.bfloat16)
        _check(torch.equal(gk.gather_bwd_cuda(gb, pl, n).cpu(), torch.zeros(
                   n, 800, dtype=torch.bfloat16).index_add_(
                   0, idx.cpu(), gb.cpu())),
               f"gather_bwd kernel != CPU index_add_ on the {name} triplet "
               f"plan (bf16)")
    print(f"gather_bwd: bit-equal to the plain version and the CPU's "
          f"index_add_ on the {n}-node neighbour table ({int(keep.sum())} "
          f"valid of {keep.numel()} slots; float32 and bf16) and on "
          f"{len(plans)} triplet plans (4,096 random gathers with repeats, "
          f"with and without a 16-position segment; the anchor, positive "
          f"and negative columns of {len(mined_batch)} mined triplets; "
          f"float32 and bf16)", flush=True)

    valid_idx, g32 = idx_all[keep], grads[torch.float32]
    g32_valid = g32[keep]
    p_valid = int(keep.sum())
    call = (lambda: gk.gather_bwd_cuda(g32, plan, n))
    bound_ms, bound_by = _bound(4 * p_valid * width + 4 * n * width
                                + 4 * p_valid + 4 * (n + 1))
    wrapper_ms = _time_ms(call)
    t = {"max_abs_err": 0.0, "ms": wrapper_ms, "wrapper_ms": wrapper_ms,
         "plain_ms": _time_ms(lambda: gk.gather_bwd_plain(g32, plan, n)),
         "library_ms": _time_ms(lambda: torch.zeros(
             n, width, device=device).index_add_(0, valid_idx, g32_valid)),
         "bound_ms": bound_ms, "bound_by": bound_by,
         **_device_times("gather_bwd", call)}
    t["share_of_bound"] = bound_ms / t["device_ms"]
    b16 = grads[torch.bfloat16]
    t["device_ms_bf16"] = _device_times(
        "gather_bwd", lambda: gk.gather_bwd_cuda(b16, plan, n))["device_ms"]
    tcall = (lambda: gk.gather_bwd_cuda(tgrad, tplan, n))
    t["device_ms_triplets"] = _device_times("gather_bwd", tcall)["device_ms"]
    t["library_ms_triplets"] = _time_ms(lambda: torch.zeros(
        n, 800, device=device).index_add_(0, tri, tgrad))
    t["bound_ms_triplets"] = _bound(4 * 4096 * 800 + 4 * n * 800
                                    + 4 * 4096 + 4 * (n + 1))[0]
    # the neighbour table's segment table, which each GAT layer of a train
    # step builds
    t["plan_ms"] = _time_ms(lambda: gk.make_plan(idx_all, n, keep))
    for name, (idx, pl) in plans.items():
        if name == "random":
            continue        # device_ms_triplets above
        seg = pl.offsets[1:] - pl.offsets[:-1]
        g = tgrad[:len(idx)]
        t[f"device_ms_{name}"] = _device_times(
            "gather_bwd", lambda: gk.gather_bwd_cuda(g, pl, n))["device_ms"]
        t[f"longest_segment_{name}"] = int(seg.max())
        t[f"rows_{name}"] = int((seg > 0).sum())
        print(f"gather_bwd, {name} triplet plan: {len(idx)} x 800 float32 "
              f"into {n} rows, longest segment {t[f'longest_segment_{name}']}"
              f", {t[f'rows_{name}']} non-empty rows: device "
              f"{t[f'device_ms_{name}']:.5f} ms", flush=True)
    seg = tplan.offsets[1:] - tplan.offsets[:-1]
    t["longest_segment_random"] = int(seg.max())
    t["rows_random"] = int((seg > 0).sum())
    out["gather_bwd"] = t
    print(f"kernel gather_bwd: {p_valid} rows of {width} float32 into {n} "
          f"(the GAT's neighbour gather at {n} nodes) device "
          f"{t['device_ms']:.5f} ms (profiler {t['profiler_ms']}, queued "
          f"bare {t['queued_ms']:.5f}), bf16 {t['device_ms_bf16']:.5f} ms, "
          f"wrapper {wrapper_ms:.5f} ms, plain {t['plain_ms']:.4f} ms, "
          f"index_add_ {t['library_ms']:.5f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}, {100 * t['share_of_bound']:.1f}% of it); 4,096 x "
          f"800 triplet rows (longest segment {t['longest_segment_random']}, "
          f"{t['rows_random']} non-empty rows) device "
          f"{t['device_ms_triplets']:.5f} ms, "
          f"index_add_ {t['library_ms_triplets']:.5f} ms, bound "
          f"{t['bound_ms_triplets']:.5f} ms; the neighbour table's segment "
          f"table {t['plan_ms']:.5f} ms", flush=True)
    return out


def _select_rows(device) -> list:
    """Phase 7k's rows for kernel S beyond the W₁ blocks: (name, block,
    places) with many ties, ±0, ±inf and NaN, widths that are not a
    multiple of 4, rows off a 16-byte boundary and a row stride wider than
    the row, places at both ends; widths of every cluster layout (1, 2, 4
    and 8 CTAs a row at 2 CTAs an SM, 8 at 1 an SM) and of the streaming
    regime (450,001 columns); and runs of one value across every slice
    edge of 2, 4 and 8-CTA rows, the rows at every 16-byte phase, with
    places on both sides of each edge."""
    import torch
    from neural_spectral_codec_torch.training.select_kernel import (
        select_layout)
    g = torch.Generator(device=device).manual_seed(SEED + 52)

    def places(x):
        k = torch.randint(0, x.shape[1], (x.shape[0],), generator=g,
                          device=device, dtype=torch.int32)
        k[0], k[-1] = 0, x.shape[1] - 1
        return k

    out = []
    for rows, n in ((64, 4096), (33, 1001), (8, 100_003), (1, 1), (5, 3),
                    (5, 30_000), (3, 200_000), (4, 300_000), (2, 450_001)):
        levels = torch.tensor([-float("inf"), -1.5, -0.0, 0.0, 0.25, 0.25,
                               7.0, float("inf"), float("nan")],
                              device=device)
        tied = levels[torch.randint(0, len(levels), (rows, n), generator=g,
                                    device=device)]
        out.append((f"ties {rows}x{n}", tied, places(tied)))
        rnd = torch.randn(rows, n, generator=g, device=device)
        rnd[:, ::7] = float("inf")
        out.append((f"random {rows}x{n}", rnd, places(rnd)))
    wide = torch.randn(16, 2051, generator=g, device=device)
    out.append(("off 16 bytes", wide[:, 1:], places(wide[:, 1:])))
    out.append(("row stride 2051", wide[:, :2048], places(wide[:, :2048])))
    same = torch.full((4, 5000), float("inf"), device=device)
    out.append(("all +inf", same, places(same)))
    for n in (30_001, 100_000, 300_000):
        ctas = select_layout(n)
        width = -(-n // ctas)
        row = torch.rand(n + 1, generator=g, device=device) + 1.0
        for e in range(width, n, width):
            row[e - 100:e + 101] = 0.5          # a run across the edge
        first = int((row[1:] < 0.5).sum())
        run = int((row[1:] == 0.5).sum())
        offs = [0, 99, 100, 101, 199, 200, 201, run // 2, run - 1, run]
        # row stride n + 1: the rows start at every 16-byte phase
        block = row[None].repeat(len(offs), 1)
        for name, x in (("from column 0", block[:, :n]),
                        ("from column 1", block[:, 1:])):
            k = torch.tensor([first + o for o in offs], dtype=torch.int32,
                             device=device)
            out.append((f"a run across each of the {ctas - 1} slice edges "
                        f"of {n} columns, {name}", x, k))
    return out


def _bound_positions(params) -> "np.ndarray":
    """Frame positions whose pairs sit exactly at the counts entry's
    squared bounds (``mine_kernel.mask_bounds``) and one ulp either side,
    and at distances within ±3 ulps of each distance threshold along x and
    along the xy diagonal: frames 0-127 at the origin and then one
    128-frame tile a probe, so each tile's box touches the anchors' at that
    sum of squares; a last tile holds a NaN coordinate."""
    import numpy as np
    from neural_spectral_codec_torch.training import mine_kernel as mk
    f32 = np.float32

    def exact(bound):                  # (dx, dz): dx² + dz² == bound
        d = np.sqrt(bound)
        for _ in range(4000):
            d = np.nextafter(d, f32(0))
            rest = f32(bound - d * d)
            e0 = np.sqrt(rest) if rest > 0 else f32(0)
            for e in (e0, np.nextafter(e0, f32(0)), np.nextafter(e0, f32(9)),
                      np.nextafter(np.nextafter(e0, f32(0)), f32(0)),
                      np.nextafter(np.nextafter(e0, f32(9)), f32(9))):
                if rest > 0 and d * d + e * e == bound:
                    return [d, f32(0), e]
        raise RuntimeError(f"no pair sums to {bound}")

    probes = []
    for t in (params[0], params[2], params[3]):
        d = f32(t)
        for _ in range(3):
            d = np.nextafter(d, f32(0))
        for _ in range(7):
            e = f32(d / np.sqrt(f32(2)))
            probes += [[d, f32(0), f32(0)], [e, e, f32(0)]]
            d = np.nextafter(d, f32(np.inf))
    for bound in mk.mask_bounds(tuple(params))[:3]:
        for v in (np.nextafter(f32(bound), f32(0)), f32(bound),
                  np.nextafter(f32(bound), f32(np.inf))):
            probes.append(exact(v))
    tiles = [np.zeros((128, 3), np.float32)]
    tiles += [np.tile(np.array(p, np.float32), (128, 1)) for p in probes]
    nan = np.tile(np.array([params[3], 0, 0], np.float32), (128, 1))
    nan[5, 1] = np.nan
    return np.concatenate(tiles + [nan])


def _counts_at_bounds(device) -> int:
    """Phase 7k: M's counts entry, and both mask draws after it, against
    their plain versions, bit for bit, on ``_bound_positions`` at
    ``scale_100k``'s thresholds and the miner's defaults (anchors: the
    first tile, then the first 2,048 frames); the chunks tested."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.training import mine_kernel as mk
    cases = 0
    for prm in (MINE_PARAMS, (5.0, 30.0, 10.0, 50.0, 30.0)):
        params = tuple(float(v) for v in np.array(prm, np.float32))
        pos = torch.from_numpy(_bound_positions(params)).to(device)
        n, boxes = pos.shape[0], mk.tile_boxes(pos)
        for start, count in ((0, 128), (0, min(2048, n)), (n - 300, 300)):
            st = torch.tensor([start], dtype=torch.int32, device=device)
            scratch = mk.mine_scratch(n, count, device)
            got = mk.counts_cuda(pos, st, count, params, scratch)
            want = mk.counts_plain(pos, start, count, params)
            where = f"at the bounds (thresholds {prm}, start {start}, " \
                    f"count {count})"
            _check(all(torch.equal(a, b) for a, b in zip(got, want)) and
                   int(want.count_neg.sum()) > 0,
                   f"mine_counts kernel: counts != plain version {where}")
            u = torch.linspace(0, float(np.nextafter(np.float32(1),
                                                     np.float32(0))),
                               count, device=device)
            for which in ("pos", "neg"):
                cnt = getattr(want, f"count_{which}")
                _check(torch.equal(
                    mk.draw_cuda(pos, st, count, params, u, cnt, which,
                                 scratch, boxes),
                    mk.draw_plain(pos, start, count, params, u, cnt, which)),
                    f"mine_draw_mask ({which}) after mine_counts != plain "
                    f"version {where}")
            cases += 1
    return cases


def _mining_entries(device) -> dict:
    """Phase 7k: kernel M's other three entries (``mine_kernel``
    ``counts_cuda``, ``rows_cuda``, ``draw_cuda``) and kernel S
    (``select_kernel.select_cuda``) against their plain versions on the
    card, bit for bit, on every MINE_CHUNK-anchor chunk of a
    SCALE_NODES-frame ``synthetic_city`` sequence (the last moved back) and
    on partial chunks (1 anchor, the last 37, 100 in the middle): the
    counts, the W₁ block, the draws over either mask after each entry
    (u of 0 and just under 1 included), S at count_neg // 2 of the block
    (also against ``torch.sort(stable=True)``); the counts entry and both
    draws after it on ``_counts_at_bounds``; S also on ``_select_rows``
    (both regimes, every cluster width, slice edges in runs of ties).
    Then each timed at MINE_CHUNK x MINE_NODES x 800 (the mask draw over
    the negatives and, under ``pos_``, the positives after the counts
    entry, with ``mine_kernel.draw_rounds``' rounds, frames read and
    tiles kept): device, wrapper and plain time, the bound (the counts
    entry's over the pairs its gate
    keeps, ``mine_kernel.gate_pairs``, with the all-pairs bound, the kept
    share and the splits' imbalance beside it), the yardsticks
    (``torch.cdist(p=1)`` for the rows entry, ``torch.sort(stable=True)``
    + ``gather`` for S)."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.training import mine_kernel as mk
    from neural_spectral_codec_torch.training import select_kernel as sk

    params = tuple(float(v) for v in np.array(MINE_PARAMS, np.float32))
    gen = torch.Generator(device=device).manual_seed(SEED + 51)
    n = SCALE_NODES
    pos, cdf = _mine_inputs(n, device)
    boxes = mk.tile_boxes(pos)
    cases = [(min(s, n - MINE_CHUNK), MINE_CHUNK)
             for s in range(0, n, MINE_CHUNK)]
    cases += [(0, 1), (n - 37, 37), (n // 2, 100)]
    below_one = float(np.nextafter(np.float32(1), np.float32(0)))
    drawn = {"pos": 0, "neg": 0}
    for start, count in cases:
        st = torch.tensor([start], dtype=torch.int32, device=device)
        u = torch.rand(count, generator=gen, device=device)
        u[:count // 4] = 0.0
        u[count // 4:count // 2] = below_one
        scratch = mk.mine_scratch(n, count, device)
        want = mk.counts_plain(pos, start, count, params)
        where = f"(start {start}, count {count})"
        for entry in ("counts", "rows"):
            if entry == "counts":
                got = mk.counts_cuda(pos, st, count, params, scratch)
            else:
                w1 = torch.empty((count, n), device=device)
                got = mk.rows_cuda(pos, cdf, st, count, params, w1, scratch)
                want_w1, want_r = mk.rows_plain(pos, cdf, start, count,
                                                params)
                _check(torch.equal(w1.view(torch.int32),
                                   want_w1.view(torch.int32)) and
                       all(torch.equal(a, b) for a, b in zip(want_r, want)),
                       f"mine_rows kernel != plain version {where}")
            _check(all(torch.equal(a, b) for a, b in zip(got, want)),
                   f"mine_{entry} kernel: counts != plain version {where}")
            for which in ("pos", "neg"):
                cnt = getattr(want, f"count_{which}")
                g = mk.draw_cuda(pos, st, count, params, u, cnt, which,
                                 scratch, boxes)
                w = mk.draw_plain(pos, start, count, params, u, cnt, which)
                _check(torch.equal(g, w), f"mine_draw_mask ({which}, after "
                       f"mine_{entry}) != plain version {where}")
                drawn[which] += int((cnt > 0).sum())
        k = want.count_neg // 2
        got = sk.select_cuda(w1, k)
        _check(torch.equal(got, sk.select_plain(w1, k)) and
               torch.equal(got.long(), torch.sort(
                   w1, dim=1, stable=True).indices.gather(
                   1, k.long()[:, None])[:, 0]),
               f"select kernel != plain version / stable sort on the W1 "
               f"block {where}")
    print(f"mine_counts, mine_rows, mine_draw_mask, select: bit-equal to "
          f"their plain versions on the {len(cases) - 3} chunks of a "
          f"{n}-frame sequence and 3 partial chunks ({drawn['pos']} "
          f"positive and {drawn['neg']} negative draws a draw entry; S at "
          f"count_neg // 2 also equal to torch.sort(stable=True))",
          flush=True)
    at_bounds = _counts_at_bounds(device)
    print(f"mine_counts, mine_draw_mask: bit-equal to their plain versions "
          f"on {at_bounds} chunks whose pairs sit at, and one ulp either "
          f"side of, each squared bound, and a NaN position", flush=True)
    regimes = set()
    for name, x, k in _select_rows(device):
        got = sk.select_cuda(x, k)
        _check(torch.equal(got, sk.select_plain(x, k)) and
               torch.equal(got.long(), torch.sort(
                   x, dim=1, stable=True).indices.gather(
                   1, k.long().clamp(0, x.shape[1] - 1)[:, None])[:, 0]),
               f"select kernel != plain version / stable sort on {name}")
        regimes.add(sk.select_layout(x.shape[1]))
    _check(regimes >= {0, 1, 2, 4, 8},
           f"select: the rows reached the layouts {sorted(regimes)}")
    print(f"select: bit-equal to the plain version and torch.sort(stable="
          f"True) on rows of ties, ±0, ±inf and NaN, odd widths, rows off "
          f"16 bytes, a wider row stride, all +inf and runs of ties across "
          f"every slice edge, in the cluster layouts "
          f"{sorted(regimes - {0})} and the streaming regime (0)",
          flush=True)
    del pos, cdf, w1, want_w1

    pos, cdf = _mine_inputs(MINE_NODES, device)
    bins, start, c = cdf.shape[1], MINE_NODES // 2, MINE_CHUNK
    st = torch.tensor([start], dtype=torch.int32, device=device)
    u = torch.rand(c, generator=gen, device=device)
    scratch = mk.mine_scratch(MINE_NODES, c, device)
    splits = scratch[0].shape[0]
    w1 = torch.empty((c, MINE_NODES), device=device)
    out = {}

    def rows():
        return mk.rows_cuda(pos, cdf, st, c, params, w1, scratch)

    want_w1, want = mk.rows_plain(pos, cdf, start, c, params)
    got = rows()
    _check(torch.equal(w1.view(torch.int32), want_w1.view(torch.int32)) and
           all(torch.equal(a, b) for a, b in zip(got, want)),
           f"mine_rows kernel != plain version at {c} x {MINE_NODES}")
    del want_w1
    t = {"max_abs_err": 0.0, "plain_ms": _once_ms(
             lambda: mk.rows_plain(pos, cdf, start, c, params)),
         "yardstick_ms": _few_ms(lambda: torch.cdist(
             cdf[start:start + c][None], cdf[None], p=1.0), 3),
         **_device_times("mine_rows", rows, profiled=10, queued_calls=3)}
    t["bound_ms"], t["bound_by"] = _bound(
        4 * MINE_NODES * (3 + bins) + 4 * c * MINE_NODES + 13 * c,
        n_ops_no_fma=2 * bins * c * MINE_NODES)
    out["mine_rows"] = t

    def counts():
        return mk.counts_cuda(pos, st, c, params, scratch)

    t = {"max_abs_err": 0.0,
         "plain_ms": _once_ms(lambda: mk.counts_plain(pos, start, c,
                                                      params)),
         **_device_times("mine_counts", counts, profiled=20,
                         queued_calls=20)}
    gate = mk.gate_pairs(pos, start, c, params, splits)
    # the bound of the pairs the gate leaves (what this data needs), and
    # the all-pairs bound beside it
    t["bound_ms"], t["bound_by"] = _bound(
        12 * MINE_NODES + 9 * c, n_ops_no_fma=DRAW_OPS * gate["kept"])
    t["all_pairs_bound_ms"] = _bound(
        12 * MINE_NODES + 9 * c, n_ops_no_fma=DRAW_OPS * c * MINE_NODES)[0]
    t["kept_pair_share"] = gate["kept"] / gate["pairs"]
    t["split_imbalance"] = max(gate["per_split"]) / (
        sum(gate["per_split"]) / len(gate["per_split"]))
    out["mine_counts"] = t
    cnt = counts()
    _check(all(torch.equal(a, b) for a, b in zip(
        cnt, mk.counts_plain(pos, start, c, params))),
        f"mine_counts kernel != plain version at {c} x {MINE_NODES}")

    boxes = mk.tile_boxes(pos)      # alive for the bare launches

    def drawer(which):
        return lambda: mk.draw_cuda(pos, st, c, params, u,
                                    getattr(cnt, f"count_{which}"), which,
                                    scratch, boxes)

    # both mask draws after the counts entry: the negatives' numbers are
    # the entry's, the positives' beside them under pos_
    draw_neg = drawer("neg")
    t = {"max_abs_err": 0.0}
    for which in ("neg", "pos"):
        counts_w = getattr(cnt, f"count_{which}")
        got = drawer(which)()
        _check(torch.equal(got, mk.draw_plain(pos, start, c, params, u,
                                              counts_w, which)),
               f"mine_draw_mask ({which}) kernel != plain version at {c} x "
               f"{MINE_NODES}")
        walk = mk.draw_rounds(pos, start, got, counts_w, params, which,
                              splits)
        d = {"plain_ms": _once_ms(lambda: mk.draw_plain(
                 pos, start, c, params, u, counts_w, which)),
             **walk, **_draw_bounds(walk, mk.draw_frames(
                 got, counts_w, MINE_NODES, splits), c, splits),
             **_device_times("mine_draw_mask", drawer(which), profiled=20,
                             queued_calls=20)}
        d["share_of_bound"] = d["bound_ms"] / d["device_ms"]
        t.update(d if which == "neg" else
                 {f"pos_{k}": v for k, v in d.items()})
    out["mine_draw_mask"] = t

    rows()
    k = want.count_neg // 2

    def select():
        return sk.select_cuda(w1, k)

    _check(torch.equal(select(), sk.select_plain(w1, k)),
           f"select kernel != plain version at {c} x {MINE_NODES}")
    t = {"max_abs_err": 0.0, "plain_ms": _once_ms(
             lambda: sk.select_plain(w1, k)),
         "yardstick_ms": _few_ms(lambda: torch.sort(
             w1, dim=1, stable=True).indices.gather(
             1, k.long()[:, None]), 3),
         **_device_times("select", select, profiled=20, queued_calls=20)}
    t["bound_ms"], t["bound_by"] = _bound(4 * c * MINE_NODES + 8 * c)
    out["select"] = t
    calls = {"mine_rows": rows, "mine_counts": counts,
             "mine_draw_mask": draw_neg, "select": select}
    for name, t in out.items():
        t["wrapper_ms"] = t["ms"] = _few_ms(calls[name], 5)
        t["share_of_bound"] = t["bound_ms"] / t["device_ms"]
        extra = (f", yardstick {t['yardstick_ms']:.3f} ms"
                 if "yardstick_ms" in t else "")
        print(f"kernel {name}: {c} x {MINE_NODES} x {bins} bins, device "
              f"{t['device_ms']:.5f} ms (profiler {t['profiler_ms']}, "
              f"queued bare {t['queued_ms']:.5f}), wrapper "
              f"{t['wrapper_ms']:.5f} ms, plain {t['plain_ms']:.3f} ms"
              f"{extra}, bound {t['bound_ms']:.5f} ms ({t['bound_by']}, "
              f"{100 * t['share_of_bound']:.1f}% of it)", flush=True)
    t = out["mine_draw_mask"]
    for which, pre in (("negatives", ""), ("positives", "pos_")):
        print(f"kernel mine_draw_mask: {which} after mine_counts, device "
              f"{t[pre + 'device_ms']:.5f} ms (queued bare "
              f"{t[pre + 'queued_ms']:.5f}), bound {t[pre + 'bound_ms']:.5f} "
              f"ms ({t[pre + 'bound_by']}, "
              f"{100 * t[pre + 'share_of_bound']:.1f}% of it; "
              f"{t[pre + 'model_frames_needed']} frames of kept tiles, "
              f"{t[pre + 'model_tiles_tested']} box tests), scan bound "
              f"{t[pre + 'scan_bound_ms']:.5f} ms "
              f"({100 * t[pre + 'scan_bound_ms'] / t[pre + 'device_ms']:.1f}"
              f"% of it; {t[pre + 'frames_scanned']} frames from the "
              f"{splits} splits' starts); model: "
              f"{t[pre + 'model_frames_read']} frames read, rounds an "
              f"anchor mean {t[pre + 'model_rounds_mean']:.3f}, max "
              f"{t[pre + 'model_rounds_max']}, tiles kept before the "
              f"member's {t[pre + 'model_tiles_kept_mean']:.2f} on average",
              flush=True)
    t = out["mine_counts"]
    print(f"kernel mine_counts: the gate keeps {gate['kept']} of "
          f"{gate['pairs']} pairs ({100 * t['kept_pair_share']:.2f}%); "
          f"bound over the kept pairs {t['bound_ms']:.5f} ms "
          f"({100 * t['share_of_bound']:.1f}% of it), all-pairs bound "
          f"{t['all_pairs_bound_ms']:.5f} ms "
          f"({100 * t['all_pairs_bound_ms'] / t['device_ms']:.1f}% of it); "
          f"kept pairs a split, the most over the mean "
          f"{t['split_imbalance']:.2f} over {splits} splits", flush=True)
    return out


def _tied_recall_input(n: int = 120, seed: int = 9) -> tuple:
    """A two-lap loop whose embeddings take 3 values, so that each query's
    k-th place is a tie among near and far candidates
    (``tests/test_torch_train_graph.tied_recall_input``)."""
    import numpy as np
    from neural_spectral_codec_torch.data.synthetic import loop_trajectory
    rng = np.random.default_rng(seed)
    poses = loop_trajectory(n, radius=40.0, loops=2.0)
    poses[:, :2, 3] += rng.normal(0, 0.5, (n, 2))
    table = rng.normal(size=(3, 8)).astype(np.float32)
    return table[rng.integers(0, 3, n)], poses


def _state_equal(a, b) -> bool:
    """Two trainers' model state and Adam state, bit for bit."""
    import torch
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if not all(torch.equal(v, sb[k]) for k, v in sa.items()):
        return False
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()[
        "state"]
    return all(torch.equal(v, ob[i][k]) for i, st in oa.items()
               for k, v in st.items())


def _flax_tree(named: dict, n_layers: int) -> dict:
    """The JAX package's parameter tree (numpy leaves) of tensors keyed
    like a ``SpectralGNN``'s ``named_parameters()``: the inverse of
    ``models.convert.from_flax`` on a parameter-shaped tree."""
    def a(name: str, transpose: bool = False):
        x = named[name].detach().cpu().numpy()
        return x.T if transpose else x
    tree = {"Dense_0": {"kernel": a("input_proj.weight", True),
                        "bias": a("input_proj.bias")},
            "BatchNorm_0": {"scale": a("input_bn.weight"),
                            "bias": a("input_bn.bias")},
            "Dense_1": {"kernel": a("output_proj.weight", True),
                        "bias": a("output_proj.bias")}}
    for i in range(n_layers):
        g = f"gat_layers.{i}"
        tree[f"EdgeGATLayer_{i}"] = {
            "lin": a(f"{g}.lin.weight", True),
            "att_src": a(f"{g}.att_src")[None],
            "att_dst": a(f"{g}.att_dst")[None], "bias": a(f"{g}.bias"),
            "lin_edge": a(f"{g}.lin_edge.weight", True),
            "att_edge": a(f"{g}.att_edge")[None]}
        tree[f"BatchNorm_{i + 1}"] = {"scale": a(f"gat_bns.{i}.weight"),
                                      "bias": a(f"gat_bns.{i}.bias")}
    return tree


def _converted_checkpoint(tr, path: Path) -> None:
    """``tr``'s model and Adam state as ``convert_orbax_checkpoint.py``
    writes a JAX trainer's: the Adam moments as optax trees through
    ``convert.from_optax_adam`` onto a plain float-lr Adam on the CPU."""
    import torch
    from neural_spectral_codec_torch.models import SpectralGNN
    from neural_spectral_codec_torch.models.convert import (
        from_flax, from_optax_adam)
    named = dict(tr.model.named_parameters())
    st = tr.optimizer.state
    mu = _flax_tree({n: st[p]["exp_avg"] for n, p in named.items()},
                    tr.model.n_layers)
    nu = _flax_tree({n: st[p]["exp_avg_sq"] for n, p in named.items()},
                    tr.model.n_layers)
    back = from_flax(mu)
    _check(all(torch.equal(back[n], st[p]["exp_avg"].cpu())
               for n, p in named.items()),
           "train graphs: the optax tree does not map back to the moments")
    model = SpectralGNN()
    model.load_state_dict({k: v.cpu() for k, v in
                           tr.model.state_dict().items()})
    opt = torch.optim.Adam(model.parameters(), lr=tr.current_lr,
                           weight_decay=1e-5)
    count = int(next(iter(st.values()))["step"])
    torch.save({"model": model.state_dict(),
                "optimizer": from_optax_adam(count, mu, nu, model, opt),
                "meta": {"epoch": 0, "global_step": count,
                         "best_val_metric": 0.0,
                         "epochs_without_improvement": 0,
                         "train_losses": []}}, path)


def _training_graphs(device) -> None:
    """Phase 7d: every training graph family against its eager step on a
    SCALE_NODES-node ``synthetic_city`` run (full-width SpectralGNN,
    dropout 0.1 drawn from the trainer's generator, which the train graph
    registers): the mined triplets equal; GRAPH_STEPS train steps replayed
    against the same steps run eagerly from one state (losses,
    parameters, BatchNorm buffers, Adam state bit-equal; the graph's
    census holds 3 + n_layers gather-backward kernels); the step's
    torch.profiler record holds G and no index_add kernel; the embedding
    pass, the revisit scan and Recall@{1,5,10} equal; two seeded
    one-epoch runs bit-equal; the tied-embedding recall equal to the
    CPU's. Then one BIG_NODES-node train step: device ms of a replay and
    host ms of a replayed and an eager step."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.experiments.scale_100k import (
        synthetic_city)
    from neural_spectral_codec_torch.keyframe.graph import build_graph
    from neural_spectral_codec_torch.models import SpectralGNN
    from neural_spectral_codec_torch.training import trainer as trmod
    from neural_spectral_codec_torch.training import validation
    from neural_spectral_codec_torch.training.miner import TripletMiner
    from neural_spectral_codec_torch.training.trainer import GNNTrainer
    from neural_spectral_codec_torch.utils.timing import device_ops

    t_phase = time.perf_counter()
    desc, poses, _ = synthetic_city(SCALE_NODES)
    graph = build_graph(desc, poses, temporal_neighbors=5)
    trip = {}
    for use_graph in (True, False):
        miner = TripletMiner(*MINE_PARAMS[:2], *MINE_PARAMS[2:4],
                             int(MINE_PARAMS[4]), seed=SEED, device=device,
                             use_graph=use_graph)
        trip[use_graph] = miner.mine_triplets(desc, poses)
    _check(len(trip[True]) > GRAPH_STEPS * 1000 and
           np.array_equal(trip[True], trip[False]),
           "train graphs: the mining graph's triplets differ from the eager "
           "step's")
    B = 4096
    batch = np.zeros((GRAPH_STEPS * B, 3), np.int64)
    rows = trip[True][:GRAPH_STEPS * B]
    batch[:len(rows)] = rows
    tmask = np.arange(GRAPH_STEPS * B) < len(rows)
    trainers, losses = {}, {}
    keep = tempfile.TemporaryDirectory(prefix="nsc_graphs_")
    try:
        for use_graph in (True, False):
            tr = GNNTrainer(model=SpectralGNN(), checkpoint_dir=keep.name,
                            seed=SEED, device=device, use_graph=use_graph)
            exe = tr.train_step_executable(graph, B)
            losses[use_graph] = [float(exe.run(
                {"triplets": batch[s * B:(s + 1) * B],
                 "tmask": tmask[s * B:(s + 1) * B]})[0]["loss"])
                for s in range(GRAPH_STEPS)]
            trainers[use_graph] = (tr, exe)
        (tg, eg), (te, ee) = trainers[True], trainers[False]
        _check(eg.graph is not None and ee.graph is None,
               "train graphs: the graph trainer did not capture")
        census = eg.census
        print(f"train graph: {SCALE_NODES} nodes, captured in "
              f"{eg.capture_s:.3f} s: {census['nodes']} nodes "
              f"({census['kernels']} kernels, {census['memcpy']} copies, "
              f"{census['memset']} memsets), gather-backward nodes "
              f"{census['gather_bwd']}; losses {losses[True]} (eager "
              f"{losses[False]})", flush=True)
        same = losses[True] == losses[False] and _state_equal(tg, te)
        _check(same, "train graph: the replayed steps differ from the "
               "eager steps (losses, parameters, buffers or Adam state)")
        # a JAX trainer's state as the Orbax converter writes it, loaded
        # into a card trainer (capturable Adam, steps on the device)
        _converted_checkpoint(tg, Path(keep.name) / "converted.pt")
        conv = {}
        for use_graph in (True, False):
            tr = GNNTrainer(model=SpectralGNN(), checkpoint_dir=keep.name,
                            seed=SEED + 2, device=device,
                            use_graph=use_graph)
            tr.load_checkpoint("converted")
            group = tr.optimizer.param_groups[0]
            steps_on_card = all(v["step"].device.type == "cuda"
                                for v in tr.optimizer.state.values())
            _check(group["capturable"] and steps_on_card and
                   group["lr"] is tr._lr,
                   "train graphs: the converted state did not load in the "
                   "capturable form")
            exe = tr.train_step_executable(graph, B)
            conv[use_graph] = (float(exe.run(
                {"triplets": batch[:B], "tmask": tmask[:B]})[0]["loss"]),
                tr)
        _check(conv[True][0] == conv[False][0] and
               _state_equal(conv[True][1], conv[False][1]),
               "train graphs: a step from the converted state differs "
               "between graph and eager")
        print(f"train graphs: a from_optax_adam checkpoint loads into the "
              f"card trainers (capturable Adam, steps on the card) and "
              f"steps equal through the graph and eagerly (loss "
              f"{conv[True][0]})", flush=True)
        del conv, tr, exe
        ops = {}
        for name, exe_ in (("eager", ee), ("graph", eg)):
            ops[name] = [op for op, _ in device_ops(lambda: exe_.run(
                {"triplets": batch[:B], "tmask": tmask[:B]}))]
        names = {k: sorted({o.split("(")[0][:60] for o in v})
                 for k, v in ops.items()}
        atomic = [o for v in ops.values() for o in v
                  if "index_add" in o or "indexFunc" in o]
        print(f"train graph: a step's profiler record: eager "
              f"{len(ops['eager'])} device operations, replay "
              f"{len(ops['graph'])}; gather-backward kernels "
              f"{sum('gather_bwd_kernel' in o for o in ops['eager'])} "
              f"(eager); index_add kernels {atomic}", flush=True)
        _check(not atomic and any("gather_bwd_kernel" in o
                                  for o in ops["eager"]),
               f"train graph: the step's record holds {atomic} or no G "
               f"({names['eager'][:40]})")
        _check(_state_equal(tg, te), "train graph: the profiled step "
               "differs between graph and eager")
        embs = {k: trainers[k][0].embed(graph) for k in (True, False)}
        _check(np.array_equal(embs[True], embs[False]),
               "embed graph: the replayed embeddings differ from eager")
        pos3 = poses[:, :3, 3].astype(np.float32)
        rev = {k: validation.find_revisit_queries(pos3, device=device,
                                                  use_graph=k)
               for k in (True, False)}
        _check(len(rev[True]) > 100 and np.array_equal(rev[True],
                                                       rev[False]),
               "revisit graph: the replayed scan differs from eager")
        rec = {k: validation.recall_at_ks(embs[True], poses, (1, 5, 10),
                                          device=device, use_graph=k)
               for k in (True, False)}
        _check(rec[True] == rec[False], f"recall graph: {rec}")
        print(f"train graphs: embeddings, {len(rev[True])} revisit queries "
              f"and Recall@1/5/10 {rec[True][0]} equal through the graphs "
              f"and eagerly", flush=True)

        runs = []
        for k in range(2):
            tr = GNNTrainer(model=SpectralGNN(), checkpoint_dir=keep.name,
                            seed=SEED, device=device)
            miner = TripletMiner(*MINE_PARAMS[:2], *MINE_PARAMS[2:4],
                                 int(MINE_PARAMS[4]), seed=SEED + 1,
                                 device=device)
            loss = tr.train_epoch(graph, miner, poses, desc)
            runs.append((loss, tr))
        _check(runs[0][0] == runs[1][0] and _state_equal(runs[0][1],
                                                         runs[1][1]),
               "train graphs: two seeded epochs differ")
        print(f"train graphs: two seeded epochs on the card bit-equal (loss "
              f"{runs[0][0]})", flush=True)
        del runs, trainers, tg, te, eg, ee

        emb, tposes = _tied_recall_input()
        for k in (1, 5):
            card = validation.recall_loop_closure(emb, tposes, k,
                                                  device=device)
            cpu = validation.recall_loop_closure(emb, tposes, k,
                                                 device="cpu")
            _check(card == cpu, f"tied recall@{k}: card {card}, CPU {cpu}")
        print("recall: tied embeddings give the CPU's Recall@1 and @5 on the "
              "card", flush=True)

        desc, poses, _ = synthetic_city(BIG_NODES)
        big = build_graph(desc, poses, temporal_neighbors=5)
        rng = np.random.default_rng(SEED)
        steps = rng.integers(0, BIG_NODES, (4, B, 3))
        ones = np.ones(B, bool)
        host = {}
        for use_graph in (True, False):
            tr = GNNTrainer(model=SpectralGNN(), checkpoint_dir=keep.name,
                            seed=SEED, device=device, use_graph=use_graph)
            exe = tr.train_step_executable(big, B)
            exe.run({"triplets": steps[0], "tmask": ones})
            times = []
            for s in range(1, 4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                exe.run({"triplets": steps[s], "tmask": ones})
                times.append(1e3 * (time.perf_counter() - t0))
            host[use_graph] = statistics.median(times)
            if use_graph:
                replay_ms = _replay_ms(exe)
        print(f"train graph: {BIG_NODES} nodes x {B} triplets: device ms of "
              f"one replay {replay_ms:.3f} (CUDA events over {REPLAYS}), "
              f"host ms a step (median of 3, fetch included) replayed "
              f"{host[True]:.3f}, eager {host[False]:.3f}", flush=True)
        del tr, exe
    finally:
        keep.cleanup()
    from neural_spectral_codec_torch.training import miner as miner_mod
    miner_mod.clear_cache()
    validation.clear_cache()
    torch.cuda.empty_cache()
    print(f"train graphs: phase 7d wall {time.perf_counter() - t_phase:.2f} "
          f"s; train family {trmod.STATS}", flush=True)


def _strategy_miner(strategy: str, device, use_graph: bool = True,
                    seed: int = SEED):
    from neural_spectral_codec_torch.training.miner import TripletMiner
    return TripletMiner(*MINE_PARAMS[:2], *MINE_PARAMS[2:4],
                        int(MINE_PARAMS[4]), mining_strategy=strategy,
                        seed=seed, device=device, use_graph=use_graph)


def _mining_graphs(device) -> dict:
    """Phase 7d, the "semi-hard" and "random" mining graphs: at
    SCALE_NODES nodes the triplets through the graphs equal the same
    steps run eagerly (same seed), the graph's census holds its kernels,
    a second epoch captures nothing and ``STATS["eager_chunks"]`` stays
    0; at MINE_CPU_NODES nodes the card's anchors (and semi-hard
    negatives) equal the CPU's and every draw lies inside the CPU's
    masks; at BIG_NODES nodes an epoch through the graph (wall, host
    clock), a chunk's replay on the device and, on MINE_EAGER_CHUNKS
    chunks, the eager step's wall. Returns the launches of the counted
    graph runs, one a strategy."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.experiments.scale_100k import (
        synthetic_city)
    from neural_spectral_codec_torch.training import mine_kernel as mk
    from neural_spectral_codec_torch.training import miner as miner_mod
    from neural_spectral_codec_torch.training.select_kernel import (
        select_layout)

    need = {"semi-hard": ("mine_rows", "select", "mine_draw_mask"),
            "random": ("mine_counts", "mine_draw_mask")}
    params = tuple(float(v) for v in np.array(MINE_PARAMS, np.float32))
    by_path = {}
    desc, poses, _ = synthetic_city(SCALE_NODES)
    for strategy in ("semi-hard", "random"):
        miner_mod.clear_cache()
        eager = _strategy_miner(strategy, device, False).mine_triplets(
            desc, poses)
        graphed = _strategy_miner(strategy, device)
        trip, launches = _counted(lambda: graphed.mine_triplets(desc, poses))
        by_path[f"mine_{strategy.replace('-', '_')}"] = launches
        _check(len(trip) > 1000 and np.array_equal(trip, eager),
               f"mining graph ({strategy}): the triplets differ from the "
               "eager step's")
        exe = [e for e in miner_mod.cached_executables()
               if e.graph is not None]
        _check(len(exe) == 1, f"mining graph ({strategy}): {len(exe)} "
               "captured executables, not 1")
        caps, reps = miner_mod.STATS["captures"], miner_mod.STATS["replays"]
        again = graphed.mine_triplets(desc, poses)
        _check(miner_mod.STATS["captures"] == caps and
               miner_mod.STATS["replays"] > reps and len(again) > 1000,
               f"mining graph ({strategy}): the second epoch captured")
        c = exe[0].census
        print(f"mining graph ({strategy}): {SCALE_NODES} nodes, captured in "
              f"{exe[0].capture_s:.3f} s, {c['nodes']} nodes ({c['kernels']}"
              f" kernels; {', '.join(f'{k} {c[k]}' for k in need[strategy])}"
              + (f"; S's cluster width {c['select_cluster_dim']}"
                 if strategy == "semi-hard" else "")
              + f"), {len(trip)} triplets equal to the eager step's, second "
              f"epoch captured nothing; launches {launches}", flush=True)
        _check(all(launches[k] > 0 for k in need[strategy]) and
               launches["mine"] == 0 and launches["mine_draw"] == 0,
               f"mining graph ({strategy}): launches {launches}")
    _check(miner_mod.STATS["eager_chunks"] == 0,
           f"mining: op-by-op chunks on the card {miner_mod.STATS}")

    desc, poses, _ = synthetic_city(MINE_CPU_NODES)
    positions = torch.from_numpy(poses[:, :3, 3].astype(np.float32))
    for strategy in ("semi-hard", "random"):
        card = _strategy_miner(strategy, device).mine_triplets(desc, poses)
        cpu = _strategy_miner(strategy, "cpu").mine_triplets(desc, poses)
        a = torch.from_numpy(card[:, 0])
        pos, neg = mk.chunk_masks(positions, a, 0, len(positions), params)
        rows = torch.arange(len(card))
        inside = bool(pos[rows, torch.from_numpy(card[:, 1])].all() and
                      neg[rows, torch.from_numpy(card[:, 2])].all())
        same = np.array_equal(card[:, 0], cpu[:, 0]) and (
            strategy == "random" or np.array_equal(card[:, 2], cpu[:, 2]))
        _check(len(card) > 100 and same and inside,
               f"mining ({strategy}): the card's triplets are not the "
               f"CPU's (anchors{', negatives' * (strategy != 'random')}) "
               "or fall outside its masks")
        print(f"mining ({strategy}): {MINE_CPU_NODES} nodes, the card's "
              f"{len(card)} anchors{' and negatives' * (strategy != 'random')}"
              f" equal the CPU's, every draw inside the CPU's masks",
              flush=True)

    desc, poses, _ = synthetic_city(BIG_NODES)
    pos_d, cdf_d = _mine_inputs(BIG_NODES, device)
    for strategy in ("semi-hard", "random"):
        miner_mod.clear_cache()
        graphed = _strategy_miner(strategy, device)
        t0 = time.perf_counter()
        first = graphed.mine_triplets(desc, poses)
        first_s = time.perf_counter() - t0
        caps = miner_mod.STATS["captures"]
        t0 = time.perf_counter()
        trip = graphed.mine_triplets(desc, poses)
        epoch_s = time.perf_counter() - t0
        exe = miner_mod.cached_executables()[0]
        c = exe.census
        eager = _strategy_miner(strategy, device, False).mine_triplets(
            desc, poses)
        _check(miner_mod.STATS["captures"] == caps and
               np.array_equal(first, eager) and len(trip) > 10_000,
               f"mining graph ({strategy}), {BIG_NODES} nodes: the second "
               f"epoch captured, or the graph's triplets differ from the "
               f"eager step's")
        _check(strategy != "semi-hard" or c["select_cluster_dim"] ==
               select_layout(BIG_NODES) > 1,
               f"mining graph (semi-hard), {BIG_NODES} nodes: S's node is "
               f"not a cluster of {select_layout(BIG_NODES)} ({c})")
        census = ", ".join(f"{k} {c[k]}" for k in need[strategy])
        print(f"mining graph ({strategy}): {BIG_NODES} nodes, {len(first)} "
              f"triplets equal to the eager step's, second epoch captured "
              f"nothing; census {census}"
              + (f", S a cluster node of width {c['select_cluster_dim']}"
                 if strategy == "semi-hard" else ""), flush=True)
        replay_ms = _replay_ms(exe)
        host = {}
        for use_graph in (True, False):
            e = miner_mod.mining_executable(
                BIG_NODES, MINE_CHUNK, cdf_d.shape[1], params, pos_d.device,
                use_graph, strategy)
            e.load_sequence(pos_d, cdf_d)
            times = []
            for k in range(MINE_EAGER_CHUNKS + 1):
                u = torch.rand((miner_mod.DRAWS[strategy], MINE_CHUNK),
                               device=device)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.run({"start": np.array([k * MINE_CHUNK], np.int32),
                       "u": u})
                times.append(1e3 * (time.perf_counter() - t0))
            host[use_graph] = statistics.median(times[1:])
        print(f"mining graph ({strategy}): {BIG_NODES} nodes, an epoch "
              f"through the graph {epoch_s:.3f} s ({len(trip)} triplets; "
              f"first epoch with its capture {first_s:.3f} s); a chunk "
              f"{replay_ms:.3f} ms on the device (replays, CUDA events), "
              f"host ms a chunk (median of {MINE_EAGER_CHUNKS}) replayed "
              f"{host[True]:.3f}, eager {host[False]:.3f}; mining pool "
              f"{miner_mod.POOL.bytes(device) / 2**20:.1f} MiB", flush=True)
    miner_mod.clear_cache()
    del pos_d, cdf_d
    torch.cuda.empty_cache()
    return by_path


def _train_step_vs_cpu(device) -> None:
    """Phase 7a: hard-negative mining and one full-width train step on the
    card against the same on the CPU, from identical state."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.experiments.scale_100k import (
        synthetic_city)
    from neural_spectral_codec_torch.keyframe.graph import (
        build_graph, graph_to_tensors)
    from neural_spectral_codec_torch.models import SpectralGNN
    from neural_spectral_codec_torch.models.gnn import gauge_parameters
    from neural_spectral_codec_torch.training.miner import TripletMiner
    from neural_spectral_codec_torch.training.trainer import (
        make_optimizer, train_step)

    desc, poses, _ = synthetic_city(TRAIN_NODES, revisit_period=128)
    mined = {d: TripletMiner(seed=SEED, device=d).mine_triplets(desc, poses)
             for d in ("cpu", device)}
    trip_cpu, trip_dev = mined["cpu"], mined[device]
    _check(len(trip_cpu) > 100 and
           np.array_equal(trip_cpu[:, [0, 2]], trip_dev[:, [0, 2]]),
           f"train: the card's anchors / hard negatives differ from the "
           f"CPU's ({len(trip_dev)} vs {len(trip_cpu)} triplets)")
    batch = np.zeros((4096, 3), np.int64)
    batch[:len(trip_cpu)] = trip_cpu
    tmask = np.arange(4096) < len(trip_cpu)
    graph_np = build_graph(desc, poses, temporal_neighbors=5)
    model_cpu = SpectralGNN(dropout=0.0,
                            generator=torch.Generator().manual_seed(SEED))
    model_dev = copy.deepcopy(model_cpu).to(device)
    gauge = gauge_parameters(model_cpu)
    out = {}
    for name, model, dev in (("cpu", model_cpu, "cpu"),
                             ("card", model_dev, device)):
        before = {k: v.detach().clone().cpu()
                  for k, v in model.named_parameters()}
        b = torch.from_numpy(batch).to(dev)
        t0 = time.perf_counter()
        loss = train_step(model, make_optimizer(model, 5e-4, 1e-5),
                          graph_to_tensors(graph_np, dev), b[:, 0], b[:, 1],
                          b[:, 2], torch.from_numpy(tmask).to(dev), 0.1,
                          grad_clip=1.0)
        loss = float(loss)
        out[name] = (loss, before, {k: v.grad.cpu() for k, v in
                                    model.named_parameters()},
                     {k: v.detach().cpu() for k, v in
                      model.state_dict().items()},
                     time.perf_counter() - t0)
    (l_cpu, p0, g_cpu, s_cpu, t_cpu), (l_dev, _, g_dev, s_dev, t_dev) = \
        out["cpu"], out["card"]
    err = {"loss": abs(l_dev - l_cpu) / max(1.0, abs(l_cpu))}
    for k, g in g_cpu.items():
        if k not in gauge:
            err[f"grad {k}"] = float((g_dev[k] - g).abs().max()) / max(
                1e-12, float(g.abs().max()))
    n_free = 0
    for k, v in s_cpu.items():
        if k in gauge or k.endswith("num_batches_tracked"):
            continue
        d = (s_dev[k] - v).abs()
        if k in g_cpu:      # a parameter: skip elements of sign-free grads
            free = g_cpu[k].abs() < 1e-3 * g_cpu[k].abs().max()
            n_free += int(free.sum())
            d = d[~free]
        err[k] = float(d.max()) if d.numel() else 0.0
    worst = max(err, key=err.get)
    moved = max(float((s_cpu[k] - p0[k]).abs().max()) for k in p0)
    print(f"train: {TRAIN_NODES} nodes, {len(trip_cpu)} triplets, anchors "
          f"and hard negatives equal on card and CPU; one step: loss "
          f"{l_dev:.6f} (CPU {l_cpu:.6f}), worst {worst} {err[worst]:.3e}; "
          f"largest parameter move {moved:.3e}; {n_free} elements with "
          f"sign-free gradients and {len(gauge)} gauge biases not held; "
          f"host s card {t_dev:.3f}, CPU {t_cpu:.3f}", flush=True)
    _check(math.isfinite(l_dev) and all(v <= TRAIN_TOL for v in err.values()),
           f"train: card vs CPU {worst} {err[worst]:.3e} > {TRAIN_TOL}")


def _train_entry(device, keep_pt: Path) -> dict:
    """Phase 7b: the training entry point, default and ring-major
    encoders; returns {path: launches}. The default run's final
    checkpoint is copied to ``keep_pt`` for phase 9."""
    import shutil

    import torch
    from neural_spectral_codec_torch import train_multi_dataset
    from neural_spectral_codec_torch.models import SpectralGNN, gnn

    try:
        import yaml
        print(f"train: PyYAML {yaml.__version__} is installed", flush=True)
    except ImportError:
        print("train: PyYAML is not installed; the config is a dict",
              flush=True)
    ring_cfg = copy.deepcopy(TRAINING_CONFIG)
    ring_cfg["encoding"].update({"ring_major": True, "n_elevation": 64})
    runs = (("train", TRAINING_CONFIG, [], ("project", "spectral", "mine",
                                            "gather_bwd"), ("ring_fold",)),
            ("train_ring", ring_cfg, ["--synthetic-beams", "64",
                                      "--synthetic-sweep-order"],
             ("ring_fold", "spectral", "mine", "gather_bwd"), ()))
    by_path = {}
    eager_forwards = gnn.STATS["eager_forwards"]
    for name, cfg, extra, needed, unused in runs:
        with tempfile.TemporaryDirectory(prefix="nsc_train_") as ckpt:
            args = ["--synthetic", "120", "--epochs", "2", "--device",
                    str(device), "--checkpoint-dir", ckpt] + extra
            t0 = time.perf_counter()
            trainer, launches = _counted(
                lambda: train_multi_dataset.main(args, config=cfg))
            wall = time.perf_counter() - t0
            model = SpectralGNN()
            model.load_state_dict(torch.load(
                Path(ckpt) / "final_model.pt", weights_only=True)["model"])
            same = all(torch.equal(v, trainer.model.state_dict()[k].cpu())
                       for k, v in model.state_dict().items())
            if name == "train":
                shutil.copyfile(Path(ckpt) / "final_model.pt", keep_pt)
        pipe = trainer.pipeline
        stages = {k: round(v, 3) for k, v in pipe.stage_seconds.items()}
        print(f"{name}: {wall:.2f} s, scans by path "
              f"{pipe.encoder.path_counts}, losses {trainer.train_losses}, "
              f"best R@1 {trainer.best_val_metric:.4f}, stage s {stages}, "
              f"launches {launches}", flush=True)
        _check(all(launches[k] > 0 for k in needed) and
               all(launches[k] == 0 for k in unused),
               f"{name}: unexpected launches {launches}")
        _check(len(trainer.train_losses) == 2 and
               all(math.isfinite(v) and v > 0 for v in trainer.train_losses),
               f"{name}: losses {trainer.train_losses}")
        _check(same, f"{name}: the checkpoint does not reload to the "
               "trained state_dict")
        by_path[name] = launches
    _check(gnn.STATS["eager_forwards"] == eager_forwards,
           "train: the training entry point ran an eager full-graph "
           "forward")
    from neural_spectral_codec_torch.training import miner, validation
    _check(not miner.cached_executables() and
           not validation.cached_executables(),
           "train: the mining or validation graphs outlived training")
    return by_path


def _scale(device) -> dict:
    """Phase 7c: the 100k-scale entry point at SCALE_NODES nodes, through
    the training graphs and again eagerly; its second epoch through the
    graphs must capture nothing. Returns its launches."""
    from neural_spectral_codec_torch.experiments import scale_100k
    from neural_spectral_codec_torch.models import gnn
    eager_forwards = gnn.STATS["eager_forwards"]
    out, launches = _counted(lambda: scale_100k.main(
        ["--nodes", str(SCALE_NODES), "--device", str(device)]))
    _check(gnn.STATS["eager_forwards"] == eager_forwards,
           "scale: training ran an eager full-graph forward")
    eager = out["eager"]
    print(f"scale: {SCALE_NODES} nodes, graphs vs eager: mining "
          f"{out['mining_s']:.3f} / {eager['mining_s']:.3f} s, ms a step "
          f"{out['ms_per_step']:.3f} / {eager['ms_per_step']:.3f}, embed "
          f"{out['embed_s']:.3f} / {eager['embed_s']:.3f} s, validation "
          f"{out['validation_s']:.3f} / {eager['validation_s']:.3f} s; "
          f"captures {out['captures']}, second epoch "
          f"{out['captures_second_epoch']}; launches {launches}; allocated "
          f"{out['allocated_mib']:.1f} MiB after the run, "
          f"{out['allocated_after_release_mib']:.1f} after release_graphs",
          flush=True)
    _check(math.isfinite(out["avg_loss"]) and
           all(0.0 <= out[f"recall@{k}"] <= 1.0 for k in (1, 5, 10)) and
           out["n_queries"] > 0, f"scale: {out}")
    _check(not any(out["captures_second_epoch"].values()) and
           all(v > 0 for v in out["replays_second_epoch"].values()) and
           not any(eager["captures"].values()),
           f"scale: captures after the first epoch {out}")
    _check(launches["mine"] > 0 and launches["gather_bwd"] > 0,
           f"scale: M or G never launched {launches}")
    return launches


def _write_store(path: Path, n_bins: int, seed: int) -> int:
    """Phase 8's map: STORE_ROWS records through the port's
    ``save_database``: random ^4 histograms, poses spread over 20 km
    (random yaw), no points."""
    import numpy as np
    from neural_spectral_codec_torch.keyframe.selector import Keyframe
    from neural_spectral_codec_torch.retrieval.two_stage import (
        TwoStageRetrieval)
    rng = np.random.default_rng(seed)
    hist = rng.random((STORE_ROWS, n_bins), dtype=np.float32) ** 4
    hist /= hist.sum(axis=1, keepdims=True)
    yaw = rng.uniform(-np.pi, np.pi, STORE_ROWS)
    poses = np.tile(np.eye(4), (STORE_ROWS, 1, 1))
    poses[:, 0, 0] = poses[:, 1, 1] = np.cos(yaw)
    poses[:, 0, 1], poses[:, 1, 0] = -np.sin(yaw), np.sin(yaw)
    poses[:, :2, 3] = rng.uniform(-10_000.0, 10_000.0, (STORE_ROWS, 2))
    store = TwoStageRetrieval(n_bins=n_bins, capacity=1, device="cpu")
    store.keyframes = [Keyframe(i, i, None, poses[i], float(i),
                                descriptor=hist[i])
                       for i in range(STORE_ROWS)]
    return store.save_database(str(path))


def _cpu_descriptors(keyframes, cfg, max_points: int) -> "torch.Tensor":
    """Each keyframe's descriptor by the plain encoder on the CPU, from
    its points padded as the online loop pads them."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.ops.range_image import pad_points
    from neural_spectral_codec_torch.ops.spectral import encode_points_batch
    out = []
    for lo in range(0, len(keyframes), 8):
        pts = np.stack([pad_points(kf.points, max_points)
                        for kf in keyframes[lo:lo + 8]])
        out.append(encode_points_batch(torch.from_numpy(pts), cfg.alpha,
                                       cfg))
    return torch.cat(out)


def _capture_refusals() -> None:
    """Which linear-algebra calls a CUDA graph captures
    (``experiments.capture_probe``, each in a fresh interpreter): the
    registration graph needs ``solve_ex`` and ``inv_ex``. ``svd``, ``det``
    and ``eigh`` are refused, and no card path calls them: kernels R and C
    do their work."""
    from neural_spectral_codec_torch.experiments import capture_probe
    got = capture_probe.run()
    print(f"online: CUDA-graph capture of the verifier's linear algebra "
          f"{json.dumps(got)}", flush=True)
    _check(all(got[k]["captured"] and got[k]["replay_equals_eager"]
               for k in ("solve_ex", "inv_ex")),
           "online: the registration step's solver calls do not capture")


# device operations of a library eigen-solve or SVD (cuSOLVER, MAGMA),
# which no verifier path may enqueue on the card; point-to-point's step
# must enqueue no LU either (det's), while GICP and point-to-plane keep
# the LU of inv_ex and solve_ex, which capture (experiments.capture_probe)
LIBRARY_SOLVES = ("syev", "gesvd", "svdj", "gesdd", "eigh", "svd", "magma")
LU_SOLVES = ("getrf", "getrs", "geqrf")


def _same_prep(a, b) -> bool:
    """Two ``PreparedCloud``s of one cloud bit-equal: the points, mask and
    covariances or normals on the card, and the host's points."""
    import numpy as np
    import torch
    return np.array_equal(a.pts, b.pts) and all(
        (x is None) == (y is None) and (x is None or torch.equal(x, y))
        for x, y in ((a.padded, b.padded), (a.mask, b.mask),
                     (a.cov, b.cov), (a.normals, b.normals)))


def _verifier_window(v, points, target) -> tuple:
    """torch.profiler's device operations of one ``prepare`` of ``points``
    and one registration against ``target`` through the verifier's graphs,
    after each's graph exists: (the operations by name and count, what in
    them breaks the rule: a library eigen-solve or SVD, in point-to-point
    an LU, a pageable copy, or more host copies than the prepare's one
    upload and the pair's upload of its initial transform and its one
    fetch)."""
    from collections import Counter

    from neural_spectral_codec_torch.utils.timing import device_ops
    ops = [op for op, _ in device_ops(
        lambda: v.verify(v.prepare(points), target))]
    banned = LIBRARY_SOLVES + (LU_SOLVES if v.method == "icp" else ())
    faults = [op for op in ops if any(s in op.lower() for s in banned)]
    faults += [op for op in ops if "Pageable" in op]
    to_dev = [op for op in ops if "HtoD" in op]
    to_host = [op for op in ops if "DtoH" in op]
    if not ops or len(to_dev) > 2 or len(to_host) > 1:
        faults += to_dev + to_host + ["(no device operation)"] * (not ops)
    names = Counter(op.split("(")[0][:60] for op in ops)
    return dict(names.most_common()), faults


def _verifier_backends(pipe, device) -> dict:
    """The stage-1 candidates of the last VERIFY_QUERIES queries, each
    against the snapshot its query saw, verified by the native backend
    (the run's) and by the torch backend on the card, once through its
    graphs and once eagerly (``use_graph=False``): native and torch accept
    the same candidates (the largest transform difference printed); on
    every cloud ``prepare`` through its graph (kernels K and C, one replay)
    equals the eager prepare bit for bit; on every pair the registration
    graph's T, fitness and RMSE equal the eager step's bit for bit, with
    kernel N credited 31 launches a replay. The same for point-to-plane and
    point-to-point (kernel R, 30 launches a replay) on the first two
    queries' candidates; point-to-point's T also within T_TOL of the plain
    step on the CPU from the same clouds. Each verifier captures nothing
    after its ``warmup()``; the censuses show C in the prepare graphs and R
    in the point-to-point graph; a torch.profiler window over a prepare
    and a pair of each method shows no library eigen-solve or SVD (and in
    point-to-point no LU, which det would run; GICP's and point-to-plane's
    LU are their inv_ex and solve_ex) and no host copy beyond the
    prepare's upload and the pair's upload and fetch.
    Prints ms a pair of each (graph, eager, native), prepare's ms a cloud
    through its graph and eagerly (and its host part: the numpy voxel grid
    and padding), the graphs' nodes and capture seconds."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.retrieval import nearest_kernel
    from neural_spectral_codec_torch.retrieval import pca_kernel
    from neural_spectral_codec_torch.retrieval import verification as V
    ret = pipe.retrieval
    nat = ret.verifier
    kfs = pipe.selector.keyframes
    queries = [kf for i, kf in enumerate(kfs)
               if (i + 1) % 10 == 0][-VERIFY_QUERIES:]
    out = {}
    for method in ("gicp", "point_to_plane", "icp"):
        kw = dict(method=method, fitness_threshold=nat.fitness_threshold,
                  rmse_threshold=nat.rmse_threshold,
                  max_iterations=nat.max_iterations,
                  voxel_downsample=nat.voxel_downsample,
                  max_points=nat.max_points, backend="torch")
        graph_v = V.GeometricVerifier(device=device, **kw)
        eager_v = V.GeometricVerifier(use_graph=False, device=device, **kw)
        cpu_v = (V.GeometricVerifier(device="cpu", **kw)
                 if method == "icp" else None)
        t0 = time.perf_counter()
        graph_v.warmup()
        warm_s = time.perf_counter() - t0
        captures0 = graph_v.captures
        native = method == nat.method
        times = {"native": [], "graph": [], "eager": [], "prepare": [],
                 "prepare_eager": [], "prepare_host": []}
        pairs, t_diff, disagree, unequal = 0, 0.0, [], []
        prep_unequal, clouds, cpu_diff = [], 0, 0.0
        solves = nat.max_iterations if method == "icp" else 0

        def prepared(points):
            """The cloud through the graph and eagerly, timed; equal."""
            nonlocal clouds
            t0 = time.perf_counter()
            g = graph_v.prepare(points)
            torch.cuda.synchronize()
            times["prepare"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            e = eager_v.prepare(points)
            torch.cuda.synchronize()
            times["prepare_eager"].append(time.perf_counter() - t0)
            clouds += 1
            if not _same_prep(g, e):
                prep_unequal.append(clouds)
            return g

        for kf in queries[:None if native else 2]:
            cands = ret.query(kf, verify=False,
                              as_of_size=kf.keyframe_id + 1)
            qt = prepared(kf.points)
            t0 = time.perf_counter()          # its host part alone
            V._pad(V.voxel_downsample(kf.points, nat.voxel_downsample),
                   nat.max_points)
            times["prepare_host"].append(time.perf_counter() - t0)
            qn = nat.prepare(kf.points) if native else None
            qc = cpu_v.prepare(kf.points) if cpu_v is not None else None
            for c in cands:
                target = ret.keyframes[c.database_idx]
                if target.points is None:           # a resumed record
                    continue
                dt = prepared(target.points)
                launches = (nearest_kernel.KERNEL.launches,
                            pca_kernel.KABSCH.launches)
                t0 = time.perf_counter()
                ok_t, T_t, info_t = graph_v.verify(qt, dt)
                times["graph"].append(time.perf_counter() - t0)
                _check((nearest_kernel.KERNEL.launches - launches[0],
                        pca_kernel.KABSCH.launches - launches[1])
                       == (nat.max_iterations + 1, solves), "online: a "
                       "registration replay did not credit kernel N's "
                       "searches or kernel R's solves")
                t0 = time.perf_counter()
                eager = eager_v._register_torch(qt, dt, None)
                times["eager"].append(time.perf_counter() - t0)
                graphed = graph_v._register_torch(qt, dt, None)
                if not (np.array_equal(graphed[0], eager[0])
                        and graphed[1:] == eager[1:]):
                    unequal.append((kf.keyframe_id, target.keyframe_id))
                if cpu_v is not None:
                    on_cpu = cpu_v._register_torch(
                        qc, cpu_v.prepare(target.points), None)
                    cpu_diff = max(cpu_diff, float(
                        np.abs(on_cpu[0] - graphed[0]).max()))
                pairs += 1
                if not native:
                    continue
                dn = nat.prepare(target.points)
                t0 = time.perf_counter()
                ok_n, T_n, info_n = nat.verify(qn, dn)
                times["native"].append(time.perf_counter() - t0)
                if ok_n != ok_t:
                    disagree.append((kf.keyframe_id, target.keyframe_id,
                                     info_n["fitness"], info_n["rmse"],
                                     info_t["fitness"], info_t["rmse"]))
                elif ok_n:
                    t_diff = max(t_diff, float(np.abs(T_n - T_t).max()))
        window, window_faults = _verifier_window(graph_v,
                                                 queries[-1].points, dt)
        midstream = graph_v.captures - captures0
        exe = next(e for e in V.cached_executables()
                   if e.graphed and e.mode == V.MODES[method]
                   and e.device == device)
        pexe = next((e for e in V.cached_prepares()
                     if e.graph is not None and e.device == device
                     and e.mode == V.PREPARE_MODES[method]), None)
        pc = pexe.census if pexe is not None else None
        med = {k: 1e3 * statistics.median(v) if v else None
               for k, v in times.items()}
        out[method] = {"pairs": pairs, "clouds": clouds,
                       "max_transform_diff": t_diff,
                       "disagreements": disagree, "graph_unequal": unequal,
                       "prepare_unequal": prep_unequal,
                       "cpu_transform_diff": cpu_diff if cpu_v else None,
                       "ms_graph": med["graph"], "ms_eager": med["eager"],
                       "ms_native": med["native"],
                       "prepare_ms": med["prepare"],
                       "prepare_eager_ms": med["prepare_eager"],
                       "prepare_host_ms": med["prepare_host"],
                       "census": exe.census, "prepare_census": pc,
                       "capture_s": exe.capture_s,
                       "prepare_capture_s": pexe.capture_s if pexe else None,
                       "midstream_captures": midstream, "warmup_s": warm_s,
                       "window_ops": sum(window.values()),
                       "kernels_per_step": exe.census["kernels"]
                       / nat.max_iterations}
        print(f"online: verifier {method} on the stage-1 candidates of "
              f"{len(queries) if native else 2} queries: {pairs} pairs; ms "
              f"a pair (median, prepared clouds) graph {med['graph']}, "
              f"eager {med['eager']}, native {med['native']}; prepare "
              f"{med['prepare']} ms a cloud through its graph, "
              f"{med['prepare_eager']} eagerly, of which the host's voxel "
              f"grid and padding {med['prepare_host']}; graph == eager bit "
              f"for bit on {pairs - len(unequal)}/{pairs} pairs and "
              f"{clouds - len(prep_unequal)}/{clouds} prepared clouds; "
              f"registration graph {exe.census['nodes']} nodes "
              f"({exe.census['kernels']} kernels, {exe.census['nearest']} "
              f"kernel N of cluster width "
              f"{exe.census['nearest_cluster_width']}, "
              f"{exe.census['kabsch']} kernel R, {exe.census['memcpy']} "
              f"copies, {exe.census['memset']} memsets; "
              f"{out[method]['kernels_per_step']:.2f} kernels a step over "
              f"{nat.max_iterations} steps), captured in "
              f"{exe.capture_s:.3f} s; prepare graph " + (
                  f"{pc['nodes']} nodes ({pc['kernels']} kernels, "
                  f"{pc['knn']} kernel K, {pc['knn_pca']} kernel C, "
                  f"{pc['memcpy']} copies, {pc['memset']} memsets), captured "
                  f"in {pexe.capture_s:.3f} s" if pc else
                  "none (an upload and copies)") +
              f"; warmup() {warm_s:.3f} s, {midstream} graphs captured "
              f"after it; " + (f"point-to-point T vs the CPU plain step "
                               f"{cpu_diff:.3e}; " if cpu_v else "") +
              f"native vs torch disagreements {disagree}, largest transform "
              f"difference {t_diff:.3e}; a prepare and a pair enqueue "
              f"{json.dumps(window)}", flush=True)
        _check(not window_faults, f"online: verifier {method}: a prepare "
               f"and a pair enqueue {window_faults[:4]} ({len(window_faults)}"
               f" a library solve, a pageable copy or a host copy beyond "
               f"the three designed ones)")
        _check(pairs > 0 and not unequal, f"online: {method} registration "
               f"graph != eager step on {unequal}")
        _check(not prep_unequal, f"online: {method} prepare graph != eager "
               f"prepare on clouds {prep_unequal}")
        _check(not disagree, f"online: verifier backends disagree on "
               f"{disagree}")
        _check(exe.graph is not None and eager_v.captures == 0
               and midstream == 0, "online: no registration graph, one for "
               "the eager step, or a graph captured after warmup()")
        _check(exe.census["kabsch"] == solves and (
            method == "icp" or (pc is not None and pc["knn"] == 1
                                and pc["knn_pca"] == 1)),
            f"online: {method}: kernel R or C missing from its graph")
        _check(cpu_v is None or cpu_diff <= T_TOL, f"online: point-to-point "
               f"on the card {cpu_diff:.3e} from the CPU plain step")
    return out


def _online_graphs(pipe, rep: dict, stats0: dict, device) -> None:
    """Phase 8's serving graphs: mid-stream captures (0 after warmup()),
    replays a keyframe, and per captured executable its bucket, flags,
    nodes and capture seconds; the graph pool's bytes."""
    from neural_spectral_codec_torch.models import serving
    n_kf = len(pipe.selector.keyframes)
    replays = rep["serving_replays"]          # in the loop, not warmup()
    eager = serving.STATS["eager_steps"] - stats0["eager_steps"]
    ret = pipe.retrieval.retriever
    mine = [e for e in serving.cached_executables() if e.graph is not None
            and e._retriever is not None and e._retriever() is ret]
    print(f"online: serving graphs: {len(mine)} captured by warmup(), "
          f"mid-stream captures {rep['midstream_captures']} (expected 0), "
          f"{serving.STATS['captures'] - stats0['captures']} captures in "
          f"all, {replays} replays in the loop for {n_kf} keyframes "
          f"({replays / max(n_kf, 1):.3f} a keyframe), {eager} eager steps;"
          f" graph pool {serving.POOL.bytes(device) / 2**20:.1f} MiB",
          flush=True)
    for e in sorted(mine, key=lambda e: (e.shape.n_nodes,
                                         e.shape.do_query)):
        print(f"online: bucket {e.shape.n_nodes} query {e.shape.do_query}: "
              f"captured in {e.capture_s:.3f} s, {e.census['nodes']} nodes "
              f"({e.census['kernels']} kernels, {e.census['memcpy']} "
              f"copies, {e.census['memset']} memsets), K3 cooperative "
              f"{e.census['project_cooperative']}/{e.census['project']}",
              flush=True)
    _check(rep["midstream_captures"] == 0 and eager == 0,
           f"online: {rep['midstream_captures']} serving graphs captured "
           f"mid-stream, {eager} eager steps")
    _check(replays == n_kf, f"online: {replays} replays for {n_kf} "
           "keyframes")


def _serve_trace(device, frames, cap: int, serve_ms: float) -> None:
    """Device operations of the one-dispatch serving step: a fresh
    session of TRACE_FRAMES keyframes (sync loop closing, the same
    capacity, so each query scans as many rows), warmed up (its graphs
    captured) before torch.profiler starts; per keyframe the device time,
    the operations and the largest ones by time, and the device's busy
    share of the main run's serve_step."""
    from collections import defaultdict

    from neural_spectral_codec_torch.experiments.online_latency import (
        TimedLoader, inference_config)
    from neural_spectral_codec_torch.models import LocalUpdateGNN
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline)
    from neural_spectral_codec_torch.utils.timing import device_ops
    cfg = inference_config(retrieval={"database_capacity": cap},
                           deployment={"warmup": False,
                                       "async_loop_closing": False},
                           monitoring={"enabled": False})
    pipe = NeuralSpectralCodecPipeline(cfg, device=device)
    pipe.warmup()
    ops = device_ops(lambda: pipe.run_online(
        TimedLoader(frames[:TRACE_FRAMES]), loop_closure_interval=10))
    by_name = defaultdict(float)
    for name, us in ops:
        by_name[name[:60]] += us / TRACE_FRAMES
    dev_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    local = LocalUpdateGNN(pipe.model, k_hops=pipe.local_update_hops)
    mgr, ret = pipe.graph_manager, pipe.retrieval.retriever
    node = len(mgr.keyframes) - 1
    t0 = time.perf_counter()
    for _ in range(20):
        sub, mapping, _, n_slots = local._local(mgr, node)
    sub_ms = 1e3 * (time.perf_counter() - t0) / 20
    scan = frames[0]["points"]          # unpadded: staging pads it
    exe = local._executable(scan, sub, n_slots, pipe.encoder.alpha,
                            pipe.encoder_config, ret,
                            int(min(pipe.retrieval.top_k, ret.capacity)),
                            False, pipe.encoder.max_points)
    split = _host_split(exe, ret, lambda at, eff: exe.stage(
        scan, sub, mapping[node], at, eff))
    # the last scratch execution's row was put back; a replay writes it
    # again beyond the database's size, where no query reads
    print(f"online: host ms of a keyframe step's parts: k-hop subgraph "
          f"and core {sub_ms:.4f}, {json.dumps(split)} (bucket {n_slots}, "
          f"no query, a {len(scan)}-point scan padded in staging; median "
          f"of 20 scratch executions); device ms of one replay "
          f"{_replay_ms(exe):.5f}", flush=True)
    print(f"online: torch.profiler over {TRACE_FRAMES} keyframes: "
          f"{len(ops) / TRACE_FRAMES:.1f} device operations and "
          f"{dev_ms:.4f} ms of device time per keyframe, "
          f"{100 * dev_ms / serve_ms:.1f}% of the main run's serve_step "
          f"({serve_ms:.3f} ms); largest, µs per keyframe: "
          f"{[(n, round(us, 2)) for n, us in top]}; mid-stream captures "
          f"{pipe.profiler.events.get('midstream_captures', 0)}",
          flush=True)


def _split_eval(device, frames) -> dict:
    """Phase 8's split mode (``deployment.fused_encode`` false, sync, no
    resumed map): SPLIT_FRAMES frames, where each keyframe's descriptor
    comes from the encoder and its k-hop refresh is one replay of its
    bucket's eval graph (``gnn.EvalExecutable``). Every eval step of the
    session (warm-up included) is recorded and run again eagerly on the
    same padded subgraph: bit-equal. The same frames through the fused
    encode + refresh (``fused_encode`` true): every keyframe's embedding
    within SPLIT_EMB_TOL of the split session's. 0 eval or query graphs
    captured after ``warmup()``, one eval replay a keyframe; keyframe
    p50/p95; the wall and device ms of one bucket's step through its
    graph and eagerly. Returns the split session's launches."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch
    from neural_spectral_codec_torch.experiments.online_latency import (
        inference_config, run)
    from neural_spectral_codec_torch.models import gnn
    from neural_spectral_codec_torch.utils.timing import device_ops
    calls = []
    forward_full = gnn.LocalUpdateGNN.forward_full

    def recorded(self, graph):
        out = forward_full(self, graph)
        calls.append((self.model, graph, out.numpy().copy()))
        return out

    runs = {}
    for name, fused in (("split", False), ("fused", True)):
        cfg = inference_config(
            retrieval={"database_capacity": SPLIT_FRAMES},
            deployment={"fused_encode": fused, "fused_query": False,
                        "async_loop_closing": False},
            monitoring={"enabled": False})
        torch.manual_seed(SEED + 60)        # the same random GNN in both
        with (contextlib.nullcontext() if fused else mock.patch.object(
                gnn.LocalUpdateGNN, "forward_full", recorded)):
            (pipe, _, rep), launches = _counted(lambda: run(
                frames[:SPLIT_FRAMES], cfg, device,
                warmup_scans=ONLINE_WARM_SCANS))
        emb = np.stack([kf.embedding for kf in pipe.graph_manager.keyframes])
        runs[name] = (pipe, rep, launches, emb)
    pipe, rep, launches, emb = runs["split"]
    same = True
    for model, g, got in calls:
        exe = gnn.eval_executable(model, g.features.shape[0], g.max_degree,
                                  g.edge_feats.shape[2], device,
                                  use_graph=False)
        want, _ = exe.run({"features": g.features, "neighbors": g.neighbors,
                           "mask": g.mask, "edge_feats": g.edge_feats})
        same = same and np.array_equal(got, want["emb"])
    fused_emb = runs["fused"][3]
    gap = (float(np.abs(emb - fused_emb).max())
           if emb.shape == fused_emb.shape else math.inf)
    n_kf = len(pipe.selector.keyframes)
    model, g, _ = calls[-1]
    vals = {"features": g.features, "neighbors": g.neighbors,
            "mask": g.mask, "edge_feats": g.edge_feats}
    bucket = {}
    for form in ("graph", "eager"):
        exe = gnn.eval_executable(model, g.features.shape[0], g.max_degree,
                                  g.edge_feats.shape[2], device,
                                  use_graph=form == "graph")
        bucket[form] = {
            "wall_ms": _p50_ms(lambda: exe.run(vals)),
            "device_ms": sum(us for _, us in device_ops(
                lambda: exe.run(vals), calls=5)) / 5 / 1e3}
    print(f"split eval: {n_kf} keyframes, {len(calls)} eval steps "
          f"recorded, graph vs eager bit-equal {same}; embeddings vs the "
          f"fused session max abs {gap:.3e}; eval replays "
          f"{rep['eval_replays']}, captured mid-stream "
          f"{rep['midstream_captures']} eval/serving and "
          f"{rep['query_midstream_captures']} query graphs; keyframe "
          f"{json.dumps(rep['keyframe'])}; stage means ms "
          f"{json.dumps(rep['stage_mean_ms'])}; bucket "
          f"{g.features.shape[0]} step {json.dumps(bucket)}; launches "
          f"{launches}", flush=True)
    _check(same, "split eval: a graph replay differs from the eager step")
    _check(gap <= SPLIT_EMB_TOL, f"split eval: embeddings {gap:.3e} from "
           "the fused session's")
    _check(rep["midstream_captures"] == 0
           and rep["query_midstream_captures"] == 0
           and rep["eval_replays"] == n_kf,
           f"split eval: {rep['midstream_captures']} eval and "
           f"{rep['query_midstream_captures']} query graphs captured "
           f"mid-stream, {rep['eval_replays']} replays for {n_kf} keyframes")
    _check(launches["project"] > 0 and launches["spectral"] > 0,
           f"split eval: a kernel of the path never launched: {launches}")
    return launches


def _full_graph_eval(device, frames) -> dict:
    """Phase 8's full-graph mode (``gnn.use_local_updates`` false, sync,
    no resumed map) on the split sessions' SPLIT_FRAMES frames: each
    keyframe's descriptor comes from the encoder and the whole window's
    forward is one replay of its bucket's eval graph
    (``LocalUpdateGNN.forward_full``; ``warmup()`` captures the buckets 8
    up to that of ``max_active_nodes``). Every forward of the session,
    warm-up included, is recorded and run again through the same
    executable eagerly on the same padded graph: bit-equal; every
    keyframe's forward within SPLIT_EMB_TOL of ``gnn_forward`` op by op
    on the unpadded graph. 0 eval or query graphs captured after
    ``warmup()``, one eval replay a keyframe, no op-by-op forward in the
    session, K3 (or K2) and K1 launched. Then the top bucket at the
    configured window: a graph of ``max_active_nodes`` nodes (seeded
    descriptors on a circle with revisit edges), its padded step through
    the graph bit-equal to the eager step and within SPLIT_EMB_TOL of the
    op-by-op forward; the wall and device ms of the three, the device ms
    of their copies and their device operations a call. Returns the
    session's launches."""
    from unittest import mock

    import numpy as np
    import torch
    from neural_spectral_codec_torch.experiments.online_latency import (
        inference_config, run)
    from neural_spectral_codec_torch.keyframe.graph import (
        TemporalGraphManager, graph_to_tensors, pad_graph)
    from neural_spectral_codec_torch.keyframe.selector import Keyframe
    from neural_spectral_codec_torch.models import gnn
    from neural_spectral_codec_torch.utils.timing import device_ops
    calls = []
    forward_full = gnn.LocalUpdateGNN.forward_full
    bucket = gnn.LocalUpdateGNN.bucket

    def recorded(self, graph):
        out = forward_full(self, graph)
        calls.append((graph, out.numpy().copy()))
        return out

    cfg = inference_config(
        retrieval={"database_capacity": SPLIT_FRAMES},
        gnn={"use_local_updates": False},
        deployment={"async_loop_closing": False},
        monitoring={"enabled": False})
    torch.manual_seed(SEED + 62)
    forwards = gnn.STATS["eager_forwards"]
    with mock.patch.object(gnn.LocalUpdateGNN, "forward_full", recorded):
        (pipe, _, rep), launches = _counted(lambda: run(
            frames[:SPLIT_FRAMES], cfg, device,
            warmup_scans=ONLINE_WARM_SCANS))
    forwards = gnn.STATS["eager_forwards"] - forwards
    model, window = pipe.model, pipe.graph_manager.max_active_nodes
    dev = next(model.parameters()).device
    n_kf = len(pipe.selector.keyframes)
    n_warm = len(calls) - n_kf

    def eager(g):
        p = pad_graph(g, bucket(g.n_nodes))
        exe = gnn.eval_executable(model, p.n_nodes, p.max_degree,
                                  p.edge_feats.shape[2], dev,
                                  use_graph=False)
        return exe.run(p._asdict())[0]["emb"][:g.n_nodes]

    def op_by_op(g):
        return gnn.gnn_forward(model, graph_to_tensors(g, dev)).cpu()

    same = all(np.array_equal(got, eager(g)) for g, got in calls)
    gap = max(float(np.abs(got - op_by_op(g).numpy()).max())
              for g, got in calls[n_warm:])
    warm_buckets = sorted(bucket(g.n_nodes) for g, _ in calls[:n_warm])
    print(f"full graph: {n_kf} keyframes, {len(calls)} forwards recorded "
          f"({n_warm} in warmup(), buckets {warm_buckets}), graph vs "
          f"eager executable bit-equal {same}; embeddings vs the op-by-op "
          f"forward max abs {gap:.3e}; eval replays {rep['eval_replays']}, "
          f"captured mid-stream {rep['midstream_captures']} eval/serving "
          f"and {rep['query_midstream_captures']} query graphs; op-by-op "
          f"forwards in the session {forwards}; keyframe "
          f"{json.dumps(rep['keyframe'])}; stage means ms "
          f"{json.dumps(rep['stage_mean_ms'])}; launches {launches}",
          flush=True)
    _check(warm_buckets == [8 << i for i in range(
        bucket(window).bit_length() - 3)],
        f"full graph: warmup() ran buckets {warm_buckets}")
    _check(same, "full graph: a graph replay differs from the eager step")
    _check(gap <= SPLIT_EMB_TOL, f"full graph: embeddings {gap:.3e} from "
           "the op-by-op forward's")
    _check(rep["midstream_captures"] == 0
           and rep["query_midstream_captures"] == 0
           and rep["eval_replays"] == n_kf and forwards == 0,
           f"full graph: {rep['midstream_captures']} eval and "
           f"{rep['query_midstream_captures']} query graphs captured "
           f"mid-stream, {rep['eval_replays']} replays for {n_kf} "
           f"keyframes, {forwards} op-by-op forwards")
    _check((launches["project"] > 0 or launches["ring_fold"] > 0)
           and launches["spectral"] > 0,
           f"full graph: a kernel of the path never launched: {launches}")

    rng = np.random.default_rng(SEED + 63)
    mgr = TemporalGraphManager(temporal_neighbors=pipe.temporal_neighbors,
                               max_active_nodes=window)
    lap = 200                  # keyframes a lap of a 120 m circle
    for i in range(window):
        h = rng.random(model.input_dim).astype(np.float32) ** 4
        pose = np.eye(4)
        a = 2 * math.pi * i / lap
        pose[:2, 3] = 60 * math.cos(a), 60 * math.sin(a)
        mgr.add_keyframe(Keyframe(keyframe_id=i, scan_id=i,
                                  timestamp=float(i), pose=pose,
                                  points=None, descriptor=h / h.sum()))
    for q in range(lap, window, 10):
        mgr.add_loop_closure_edge(q, q - lap)
    g = mgr.get_graph()
    top = bucket(g.n_nodes)
    vals = pad_graph(g, top)._asdict()
    exes = {form: gnn.eval_executable(model, top, g.max_degree,
                                      g.edge_feats.shape[2], dev,
                                      use_graph=form == "graph")
            for form in ("graph", "eager")}
    captures = gnn.STATS["captures"]
    out = {form: exe.run(vals)[0]["emb"] for form, exe in exes.items()}
    top_same = np.array_equal(out["graph"], out["eager"])
    top_gap = float(np.abs(out["graph"][:g.n_nodes]
                           - op_by_op(g).numpy()).max())
    timed = {"graph": lambda: exes["graph"].run(vals),
             "eager": lambda: exes["eager"].run(vals),
             "op_by_op": lambda: op_by_op(g)}
    ms = {}
    for form, fn in timed.items():
        ops = device_ops(fn, calls=5)
        ms[form] = {"wall_ms": _p50_ms(fn),
                    "device_ms": sum(us for _, us in ops) / 5 / 1e3,
                    "copy_ms": sum(us for name, us in ops
                                   if name.startswith("Memcpy")) / 5 / 1e3,
                    "device_ops": len(ops) / 5}
    print(f"full graph: top bucket {top} at the configured window of "
          f"{g.n_nodes} nodes ({g.n_edges} edges): graph vs eager step "
          f"bit-equal {top_same}, vs the op-by-op forward max abs "
          f"{top_gap:.3e}; ms {json.dumps(ms)}; eval graph pool "
          f"{gnn.POOL.bytes(dev) / 2**20:.1f} MiB", flush=True)
    _check(gnn.STATS["captures"] == captures,
           f"full graph: bucket {top} was not captured by warmup()")
    _check(top_same, f"full graph: bucket {top}'s replay differs from its "
           "eager step")
    _check(top_gap <= SPLIT_EMB_TOL, f"full graph: bucket {top} "
           f"{top_gap:.3e} from the op-by-op forward")
    return launches


def _concurrent_captures(device, frames) -> dict:
    """Phase 8's last sessions, CONCURRENT_FRAMES frames each with the
    torch verifier (one prepare graph replay a cloud, one registration
    graph replay a pair) on the card. First async with ``warmup()``: the
    main path of kernels N, K and C (counted), verification ms a query
    and keyframe p50/p95/max; neither a serving nor a registration graph
    captured mid-stream. Then serving
    graphs captured while the loop-closing worker replays registration
    graphs: async without the serving warm-up (the verifier warmed by its
    own ``warmup()``) and the executable cache dropped every 20 frames, so
    that each later step captures its graph (``thread_local`` capture)
    beside the worker's backlog; every capture counted, none of the
    verifier's. Last, async with ``warmup()`` and ``fused_query`` false:
    the worker runs each stage-1 query through the query graph (Q = 1,
    captured by ``warmup()``; replays counted, none captured mid-stream).
    The loop closures of all three async sessions must equal the same
    session's run synchronously. Returns the first session's launches."""
    from neural_spectral_codec_torch.experiments.online_latency import (
        TimedLoader, inference_config, latency_report)
    from neural_spectral_codec_torch.models import serving
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline)
    from neural_spectral_codec_torch.retrieval import (
        retriever as retriever_mod)

    class Dropping(TimedLoader):
        def __getitem__(self, idx):
            if idx and idx % 20 == 0:
                serving.clear_cache()
            return super().__getitem__(idx)

    runs = {}
    for name, warm, mode, loader_cls, fused_query in (
            ("warm_async", True, True, TimedLoader, True),
            ("dropping_async", False, True, Dropping, True),
            ("dropping_sync", False, False, Dropping, True),
            ("split_async", True, True, TimedLoader, False)):
        cfg = inference_config(
            retrieval={"verification_backend": "torch",
                       "database_capacity": CONCURRENT_FRAMES},
            deployment={"warmup": warm, "async_loop_closing": mode,
                        "fused_query": fused_query},
            monitoring={"enabled": False})
        pipe = NeuralSpectralCodecPipeline(cfg, device=device)
        if not warm:
            pipe.retrieval.verifier.warmup()
        loader = loader_cls(frames[:CONCURRENT_FRAMES])
        replays0 = retriever_mod.STATS["replays"]
        edges, launches = _counted(lambda: pipe.run_online(
            loader, loop_closure_interval=10))
        rep = latency_report(loader, pipe, ONLINE_WARM_SCANS, 100.0)
        ev, prof = pipe.profiler.events, pipe.profiler
        runs[name] = {
            "edges": sorted((e["source_id"], e["target_id"]) for e in edges),
            "serving_captures": ev.get("midstream_captures", 0),
            "verifier_captures": ev.get("verifier_midstream_captures", 0),
            "query_captures": ev.get("query_midstream_captures", 0),
            "query_replays": retriever_mod.STATS["replays"] - replays0,
            "loop_s": loader.fetch_times[-1] - loader.fetch_times[0],
            "verify_s": prof.totals["verification"],
            "verify_ms_query": 1e3 * prof.totals["verification"]
            / max(prof.counts["verification"], 1),
            "queries": prof.counts["verification"],
            "keyframe": rep["keyframe"], "launches": launches}
        r = runs[name]
        print(f"online: torch verifier, {name}: verification "
              f"{r['verify_ms_query']:.3f} ms a query over {r['queries']} "
              f"queries ({r['verify_s']:.3f} s against {r['loop_s']:.2f} s of "
              f"loop), keyframe {json.dumps(r['keyframe'])}; captured "
              f"mid-stream: {r['serving_captures']} serving, "
              f"{r['verifier_captures']} registration, "
              f"{r['query_captures']} query graphs; {r['query_replays']} "
              f"query graph replays; "
              f"{len(r['edges'])} loop closures; launches {launches}",
              flush=True)
    warm, drop, sync, split = (runs[k] for k in (
        "warm_async", "dropping_async", "dropping_sync", "split_async"))
    print(f"online: loop closures of the torch-verifier sessions equal the "
          f"synchronous run's: {warm['edges'] == sync['edges']} (warm "
          f"async), {drop['edges'] == sync['edges']} (dropping async), "
          f"{split['edges'] == sync['edges']} (split async: the worker's "
          f"queries through the query graph)", flush=True)
    _check(all(r["verifier_captures"] == 0 for r in runs.values())
           and all(r["serving_captures"] == 0 and r["query_captures"] == 0
                   for r in (warm, split)),
           "online: graphs captured mid-stream after warm-up")
    _check(split["query_replays"] > 0 and split["edges"] == sync["edges"],
           f"online: the async worker's queries ({split['query_replays']} "
           "query graph replays) changed the loop closures")
    _check(all(warm["launches"][k] > 0 for k in ("nearest", "knn",
                                                  "knn_pca")),
           f"online: a kernel of the verifier's path never launched: "
           f"{warm['launches']}")
    _check(drop["serving_captures"] >= 2 * (CONCURRENT_FRAMES // 20 - 1)
           and sync["edges"] and warm["edges"] == sync["edges"]
           and drop["edges"] == sync["edges"], "online: captures beside "
           "the verifier thread changed the loop closures or were not "
           "counted")
    return warm["launches"]


def _online(device, keep_store: Path) -> dict:
    """Phase 8: the online loop (``run_online``) at full width against a
    resumed 100,000-record map, then the verifier's paths; returns their
    launches by path. The final store is copied to ``keep_store`` for
    phase 10."""
    import shutil

    import numpy as np
    import torch
    from neural_spectral_codec_torch.data.synthetic import SyntheticLoader
    from neural_spectral_codec_torch.experiments.online_latency import (
        inference_config, run)
    from neural_spectral_codec_torch.models import serving
    from neural_spectral_codec_torch.retrieval.two_stage import (
        TwoStageRetrieval)

    cap = STORE_ROWS + ONLINE_FRAMES
    cfg = inference_config(retrieval={"database_capacity": cap})
    print("online: configs/inference.yaml over default.yaml, except "
          "retrieval.spatial_filter_distance 0 (with ground-truth poses "
          "the 50 m filter drops every true revisit), the synthetic stream "
          f"in place of a dataset, and retrieval.database_capacity {cap} "
          f"(the {STORE_ROWS}-record map plus this session's keyframes)",
          flush=True)
    dim = (cfg["encoding"]["target_elevation_bins"]
           * cfg["encoding"]["n_bins"])
    with tempfile.TemporaryDirectory(prefix="nsc_online_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        n = _write_store(tmp / "map.bin", dim, SEED + 40)
        size = (tmp / "map.bin").stat().st_size
        print(f"online: store of {n} records, {size / 1e6:.1f} MB, written "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        base = SyntheticLoader(n_frames=ONLINE_FRAMES, seed=SEED + 41,
                               n_points=ONLINE_POINTS, loops=2.0)
        frames = [base[i] for i in range(ONLINE_FRAMES)]
        print(f"online: {ONLINE_FRAMES} frames of {ONLINE_POINTS} points "
              f"generated in {time.perf_counter() - t0:.2f} s", flush=True)
        for name in ("run1.bin", "run2.bin"):
            shutil.copyfile(tmp / "map.bin", tmp / name)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats0 = dict(serving.STATS)
        (pipe, edges, rep), launches = _counted(lambda: run(
            frames, cfg, device, warmup_scans=ONLINE_WARM_SCANS,
            database_path=str(tmp / "run1.bin"), resume_database=True,
            output_g2o=str(tmp / "loops.g2o")))
        _online_graphs(pipe, rep, stats0, device)
        peak = torch.cuda.max_memory_allocated() / 2**30
        kfs = pipe.selector.keyframes
        ret = pipe.retrieval.retriever
        print(f"online: one-dispatch serving, async loop closing, "
              f"{len(kfs)} keyframes, {len(edges)} loop closures, database "
              f"{ret.database_size} rows, wall {rep['wall_s']:.2f} s, "
              f"warmup {rep['warmup_s']:.3f} s, peak device memory "
              f"{peak:.3f} GiB, launches {launches}", flush=True)
        print(f"online: per-keyframe latency (host clock between fetches, "
              f"after {ONLINE_WARM_SCANS} warm-up scans) "
              f"{json.dumps(rep['keyframe'])}; warm-up scans "
              f"{json.dumps(rep['warmup_scans'])}; keyframes over "
              f"{rep['budget_ms']:.0f} ms: {rep['keyframes_over_budget']}",
              flush=True)
        print(f"online: stage means ms {json.dumps(rep['stage_mean_ms'])}, "
              f"calls {json.dumps(rep['stage_calls'])}", flush=True)
        _check(len(edges) > 0, "online: the second lap closed no loop")
        _check(all(e["fitness"] >= 0.3 and e["rmse"] <= 0.5
                   for e in edges), "online: an edge below the gates")
        _check("EDGE_SE3:QUAT" in (tmp / "loops.g2o").read_text(),
               "online: no EDGE_SE3:QUAT in the g2o export")
        _check(ret.database_size == STORE_ROWS + len(kfs),
               f"online: database {ret.database_size} rows, not "
               f"{STORE_ROWS} + {len(kfs)}")
        _check(launches["project"] > 0 and launches["spectral"] > 0,
               f"online: a kernel of the path never launched: {launches}")

        t0 = time.perf_counter()
        want = _cpu_descriptors(kfs, pipe.encoder_config,
                                pipe.encoder.max_points)
        got = torch.from_numpy(np.stack([kf.descriptor for kf in kfs]))
        err = float((got - want).abs().max())
        print(f"online: descriptors vs the CPU plain encoder max abs "
              f"{err:.3e} ({time.perf_counter() - t0:.2f} s)", flush=True)
        _check(err <= DESC_TOL, f"online: descriptors differ from the CPU "
               f"path by {err:.3e} > {DESC_TOL}")

        _capture_refusals()
        _, backend_launches = _counted(
            lambda: _verifier_backends(pipe, device))
        _check(all(backend_launches[k] > 0 for k in (
            "nearest", "knn", "knn_pca", "kabsch")), f"online: a kernel of "
            f"the verifier's paths never launched: {backend_launches}")
        _serve_trace(device, frames, cap, rep["stage_mean_ms"]["serve_step"])
        verify = _concurrent_captures(device, frames)
        split_eval = _split_eval(device, frames)
        full_graph = _full_graph_eval(device, frames)

        split_cfg = inference_config(retrieval={"database_capacity": cap},
                                     deployment={"fused_query": False,
                                                 "async_loop_closing":
                                                 False})
        _, split_edges, split_rep = run(
            frames, split_cfg, device, warmup_scans=ONLINE_WARM_SCANS,
            database_path=str(tmp / "run2.bin"), resume_database=True)
        key = lambda es: sorted((e["source_id"], e["target_id"]) for e in es)
        print(f"online: sync split mode {len(split_edges)} loop closures, "
              f"per-keyframe latency {json.dumps(split_rep['keyframe'])}, "
              f"stage means ms {json.dumps(split_rep['stage_mean_ms'])}",
              flush=True)
        _check(key(split_edges) == key(edges), "online: the split mode's "
               "edge set differs from the one-dispatch mode's")
        _check(split_rep["query_midstream_captures"] == 0,
               f"online: {split_rep['query_midstream_captures']} query "
               "graphs captured mid-stream in the split mode")

        t0 = time.perf_counter()
        back = TwoStageRetrieval(n_bins=dim, capacity=cap,
                                 device=device)
        n_back = back.load_database(str(tmp / "run1.bin"))
        rows, rows0 = back.retriever._db_rows, ret._db_rows
        same_map = torch.equal(rows[:STORE_ROWS], rows0[:STORE_ROWS])
        new_err = float((rows[STORE_ROWS:n_back]
                         - rows0[STORE_ROWS:n_back]).abs().max())
        same_pos = torch.equal(back.retriever._db_pos[:n_back],
                               ret._db_pos[:n_back])
        same_ids = [k.keyframe_id for k in back.keyframes] == \
            [k.keyframe_id for k in pipe.retrieval.keyframes]
        print(f"online: save/load round trip of the final store: {n_back} "
              f"records in {time.perf_counter() - t0:.2f} s; the map's rows "
              f"bit-equal {same_map}, this session's rows within "
              f"{new_err:.3e} (the uint16 codec), positions equal "
              f"{same_pos}, ids equal {same_ids}", flush=True)
        _check(n_back == ret.database_size and same_map and same_pos
               and same_ids and new_err <= dim / 65535.0,
               "online: the saved store does not restore the rows")
        shutil.copyfile(tmp / "run1.bin", keep_store)
    return {"online": launches, "verify_backends": backend_launches,
            "verify": verify, "split_eval": split_eval,
            "full_graph": full_graph}


def _sensor_scan(pose, elev_deg, n_points: int, world, seed: int, device,
                 sweep: bool):
    """(n_points, 5) float32 sensor-frame [x, y, z, intensity, beam] of
    one scan of ``world`` (``SyntheticWorld``'s cylinders, its sampling:
    surface points within 70 m drawn in proportion to 1 / distance, 2 cm
    of noise) through a sensor with beams at ``elev_deg``, drawn on
    ``device`` from ``seed``: each point snapped to its nearest beam,
    points outside the beams' field of view dropped, and ``n_points`` of
    the rest kept. ``sweep`` orders them ring-major from the lowest beam
    up, azimuth increasing (a KITTI ``.bin``); otherwise by azimuth step,
    all beams at each step (firing-interleaved)."""
    import numpy as np
    import torch
    f64 = dict(dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    px, py = float(pose[0, 3]), float(pose[1, 3])
    reach = int(math.ceil(70.0 / world.cell))
    ci0, cj0 = math.floor(px / world.cell), math.floor(py / world.cell)
    ci, cj = np.meshgrid(np.arange(ci0 - reach, ci0 + reach + 1),
                         np.arange(cj0 - reach, cj0 + reach + 1),
                         indexing="ij")
    present, cx, cy, rad, height = world._cell_landmark(ci.ravel(),
                                                        cj.ravel())
    cx, cy, rad, height = (torch.as_tensor(v[present], **f64)
                           for v in (cx, cy, rad, height))
    w = torch.clamp(1.0 / (torch.hypot(cx - px, cy - py) + 1e-6), max=1.0)
    beams = torch.deg2rad(torch.as_tensor(elev_deg, **f64))
    R = torch.as_tensor(pose[:3, :3], **f64)
    t = torch.as_tensor(pose[:3, 3], **f64)
    parts, kept = [], 0
    while kept < n_points:                 # about 3 draws a kept point
        n = 3 * n_points
        pick = torch.multinomial(w, n, replacement=True, generator=gen)
        ang = 2 * math.pi * torch.rand(n, generator=gen, **f64)
        zz = torch.rand(n, generator=gen, **f64) * height[pick] - 1.7
        world_pts = torch.stack([cx[pick] + rad[pick] * torch.cos(ang),
                                 cy[pick] + rad[pick] * torch.sin(ang),
                                 zz], dim=1)
        world_pts += 0.02 * torch.randn(world_pts.shape, generator=gen,
                                        **f64)
        local = (world_pts - t) @ R
        rho = torch.hypot(local[:, 0], local[:, 1])
        el = torch.atan2(local[:, 2], rho)
        beam = torch.bucketize(el, (beams[1:] + beams[:-1]) / 2)
        ok = ((el >= beams[0] - 0.01) & (el <= beams[-1] + 0.01)
              & (torch.linalg.vector_norm(local, dim=1) <= 70.0))
        local, rho, beam = local[ok], rho[ok], beam[ok]
        local[:, 2] = rho * torch.tan(beams[beam])
        parts.append(torch.cat([local, beam[:, None].to(torch.float64)],
                               dim=1))
        kept += len(local)
    pts = torch.cat(parts)[:n_points]
    az = torch.atan2(pts[:, 1], pts[:, 0]) + math.pi      # [0, 2 pi]
    if sweep:
        key = pts[:, 3] * 8 + az
    else:
        key = torch.floor(az * (1800 / (2 * math.pi))) * 256 + pts[:, 3]
    pts = pts[torch.argsort(key)]
    inten = torch.clamp(
        1.0 - torch.linalg.vector_norm(pts[:, :3], dim=1) / 70.0, 0.0, 1.0)
    return torch.cat([pts[:, :3], inten[:, None], pts[:, 3:]], dim=1).to(
        torch.float32).cpu().numpy()


def _write_datasets(root: Path, device) -> dict:
    """Phase 9's three sequences on disk (DATA_SEQS): KITTI
    ``sequences/00`` (``.bin`` float32 rows, ``poses.txt``), NCLT
    (12-byte records at 5 mm, a ground-truth CSV of ZYX Euler angles),
    HeLiPR (22-byte records with ring ids, quaternion ground truth);
    returns {name: (frames, points a scan)}."""
    import numpy as np
    from neural_spectral_codec_torch.data.synthetic import (
        SyntheticWorld, loop_trajectory)
    out = {}
    for k, (name, (elev, n_pts, n)) in enumerate(DATA_SEQS.items()):
        world = SyntheticWorld(seed=SEED + 90 + k)
        poses = loop_trajectory(n, radius=120.0, loops=2.0)
        n_points = 0
        if name == "kitti":
            seq = root / "kitti" / "sequences" / "00"
            (seq / "velodyne").mkdir(parents=True)
            (seq / "poses.txt").write_text("\n".join(
                " ".join(f"{v:.17g}" for v in T[:3].reshape(-1))
                for T in poses) + "\n")
        elif name == "nclt":
            seq = root / "nclt" / NCLT_DATE
            (seq / "velodyne_sync").mkdir(parents=True)
            ts = 1326059182636482 + 100_000 * np.arange(n)
            yaw = np.arctan2(poses[:, 1, 0], poses[:, 0, 0])
            (seq / f"groundtruth_{NCLT_DATE}.csv").write_text("\n".join(
                ",".join(f"{v:.17g}" for v in (t, *T[:3, 3], 0.0, 0.0, y))
                for t, T, y in zip(ts, poses, yaw)) + "\n")
            rec_t = np.dtype([("x", "<u2"), ("y", "<u2"), ("z", "<u2"),
                              ("i", "u1"), ("p", "u1"), ("e", "<u4")])
        else:
            seq = root / "helipr" / HELIPR_SEQ
            (seq / "LiDAR" / "Velodyne").mkdir(parents=True)
            (seq / "LiDAR_GT").mkdir()
            ts = 1_600_000_000_000_000_000 + 100_000_000 * np.arange(n)
            half = np.arctan2(poses[:, 1, 0], poses[:, 0, 0]) / 2
            (seq / "LiDAR_GT" / "Velodyne_gt.txt").write_text("\n".join(
                " ".join([str(t)] + [f"{v:.17g}" for v in (
                    *T[:3, 3], 0.0, 0.0, np.sin(h), np.cos(h))])
                for t, T, h in zip(ts, poses, half)) + "\n")
            rec_t = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                              ("i", "<f4"), ("r", "<u2"), ("t", "<f4")])
        for i in range(n):
            scan = _sensor_scan(poses[i], elev, n_pts, world,
                                SEED * 100_003 + 1000 * k + i, device,
                                sweep=name == "kitti")
            pts = np.ascontiguousarray(scan[:, :4])
            if name == "kitti":
                pts.tofile(seq / "velodyne" / f"{i:06d}.bin")
            elif name == "nclt":               # all within 70 m
                rec = np.zeros(len(pts), rec_t)
                for j, f in enumerate("xyz"):
                    rec[f] = np.round((pts[:, j] + 100.0) / 0.005)
                rec["i"] = np.round(pts[:, 3] * 255)
                rec.tofile(seq / "velodyne_sync" / f"{ts[i]}.bin")
            elif name == "helipr":
                rec = np.zeros(len(pts), rec_t)
                for j, f in enumerate("xyzi"):
                    rec[f] = pts[:, j]
                rec["r"] = scan[:, 4]
                rec["t"] = np.linspace(0.0, 0.1, len(pts))
                rec.tofile(seq / "LiDAR" / "Velodyne" / f"{ts[i]}.bin")
            n_points += len(pts)
        out[name] = (n, n_points / n)
    return out


def _data_config(base: str, root: Path, **sections) -> dict:
    """``configs/<base>`` (over default.yaml) with the three sequences as
    its test (and train) datasets and the given sections updated."""
    from neural_spectral_codec_torch.utils.config import load_config
    cfg = load_config(str(ROOT / "configs" / base))
    seqs = [{"type": "kitti", "root": str(root / "kitti"),
             "sequences": ["00"]},
            {"type": "nclt", "root": str(root / "nclt"),
             "sequences": [NCLT_DATE]},
            {"type": "helipr", "root": str(root / "helipr"),
             "sequences": [HELIPR_SEQ]}]
    cfg["data"]["datasets"] = {"train": seqs, "val": seqs[:1],
                               "test": seqs}
    for k, v in sections.items():
        cfg.setdefault(k, {}).update(v)
    return cfg


def _write_yaml(cfg: dict, path: Path) -> str:
    import yaml
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


class _Spy:
    """Records what the pipeline's sequence pass and the evaluation
    return inside a ``with`` block (the entry points keep both to
    themselves); the originals are restored on exit."""

    def __init__(self):
        from neural_spectral_codec_torch import evaluation, pipeline
        self._targets = ((pipeline.NeuralSpectralCodecPipeline,
                          "_process_sequence", self.keyframes_of),
                         (evaluation, "evaluate_place_recognition",
                          self.metrics_of))
        self.sequences, self.evaluations = [], []

    def keyframes_of(self, orig):
        def run(pipe, loader, *a, **kw):
            kfs = orig(pipe, loader, *a, **kw)
            self.sequences.append((pipe, kfs))
            return kfs
        return run

    def metrics_of(self, orig):
        def run(emb, poses, *a, **kw):
            out = orig(emb, poses, *a, **kw)
            self.evaluations.append((emb, poses, a, kw, out))
            return out
        return run

    def __enter__(self):
        self._saved = [(obj, name, getattr(obj, name))
                       for obj, name, _ in self._targets]
        for (obj, name, wrap), (_, _, orig) in zip(self._targets,
                                                    self._saved):
            setattr(obj, name, wrap(orig))
        return self

    def __exit__(self, *exc):
        for obj, name, orig in self._saved:
            setattr(obj, name, orig)


class _RestoreLogging:
    """The CLIs configure the root logger (console and a file under
    ./logs); put it back afterwards so later phases print as before."""

    def __enter__(self):
        import logging
        root = logging.getLogger()
        self._saved = (root, root.handlers[:], root.level)
        return self

    def __exit__(self, *exc):
        root, handlers, level = self._saved
        for h in root.handlers:
            if h not in handlers:
                h.close()
        root.handlers[:] = handlers
        root.setLevel(level)


def _eval_same(got: dict, want: dict, emb) -> float:
    """Card vs CPU ``evaluate_place_recognition`` on the same embeddings:
    recall@k, precision@1 and the query count exact, precision, recall and
    F1 along the curve within 1e-6. The thresholds tau are top-1 distances
    through |q|² + |e|² − 2 q·e in float32, which cancels near 0 and which
    cuBLAS and the CPU accumulate in different orders, so tau² is held to
    TAU2_ULPS ulps of the largest squared norm. Returns the largest tau²
    difference."""
    import numpy as np
    for k in ("n_queries", "recall@1", "recall@5", "recall@10",
              "precision@1", "f1@1"):
        _check(got[k] == want[k], f"evaluation: card {k} {got[k]} != CPU "
               f"{want[k]}")
    gc, wc = got["precision_recall_curve"], want["precision_recall_curve"]
    for k in ("precision", "recall", "f1"):
        _check(len(gc[k]) == len(wc[k]) and np.allclose(
            gc[k], wc[k], rtol=0, atol=1e-6), f"evaluation: card {k} curve "
            f"{gc[k]} != CPU {wc[k]}")
    gt, wt = np.array(gc["tau"]), np.array(wc["tau"])
    fin = np.isfinite(wt)
    tol = TAU2_ULPS * float(np.spacing(np.float32(
        (np.asarray(emb, np.float64) ** 2).sum(axis=1).max())))
    err = float(np.abs(gt[fin] ** 2 - wt[fin] ** 2).max()) if fin.any() \
        else 0.0
    _check(np.array_equal(np.isfinite(gt), fin) and err <= tol,
           f"evaluation: card tau² off the CPU's by {err:.3e} > {tol:.3e}")
    return err


def _bench_run(name: str, cfg_path: str, gnn_pt: str, out: Path, device,
               cpu_cfgs: dict) -> tuple:
    """One ``run_benchmark`` CLI run on the card with the spies on; checks
    descriptors against the CPU plain encoder, the evaluation against the
    CPU's and the rotation check; returns (results, launches, spy)."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch import benchmark_cli, evaluation
    with _Spy() as spy, _RestoreLogging():
        t0 = time.perf_counter()
        res, launches = _counted(lambda: benchmark_cli.main(
            ["--config", cfg_path, "--checkpoint", gnn_pt, "--output",
             str(out), "--device", str(device)]))
        wall = time.perf_counter() - t0
    _check(json.loads(out.read_text())["mean"] == res["mean"],
           f"{name}: the results JSON differs from the returned results")
    pipe = spy.sequences[0][0]
    print(f"{name}: run_benchmark {wall:.2f} s, scans by encoder path "
          f"{pipe.encoder.path_counts}, launches {launches}", flush=True)
    for seq, m in res["sequences"].items():
        print(f"{name}: sequence {seq}: {m['n_keyframes']} keyframes, "
              f"{m['n_queries']} queries, recall@1/5/10 {m['recall@1']:.4f}/"
              f"{m['recall@5']:.4f}/{m['recall@10']:.4f}, best F1 "
              f"{m['best_f1']:.4f}, encode {m['encode_time_s']:.3f} s, "
              f"query {m['avg_query_time_ms']:.4f} ms", flush=True)
    inv = res["rotation_invariance"]
    print(f"{name}: rotation invariance max {inv['max_difference']:.3e}, "
          f"mean {inv['mean_difference']:.3e}, passed {inv['passed']}; "
          f"mean {json.dumps(res['mean'])}", flush=True)
    _check(inv["passed"], f"{name}: rotation invariance failed {inv}")
    _check(len(res["sequences"]) == 3 and all(
        m["n_queries"] > 0 for m in res["sequences"].values()),
        f"{name}: a sequence without queries {res['sequences']}")

    t0 = time.perf_counter()
    err = 0.0
    for pipe, kfs in spy.sequences:
        want = _cpu_descriptors(kfs, cpu_cfgs[name], pipe.encoder.max_points)
        got = torch.from_numpy(np.stack([kf.descriptor for kf in kfs]))
        err = max(err, float((got - want).abs().max()))
    t_err = 0.0
    for emb, poses, a, kw, got in spy.evaluations:
        want = evaluation.evaluate_place_recognition(
            emb, poses, *a, **{**kw, "device": "cpu"})
        t_err = max(t_err, _eval_same(got, want, emb))
    print(f"{name}: {sum(len(k) for _, k in spy.sequences)} keyframe "
          f"descriptors vs the CPU plain encoder max abs {err:.3e}; "
          f"evaluation on the card equals the CPU's (tau² within "
          f"{t_err:.3e}) ({time.perf_counter() - t0:.2f} s)", flush=True)
    _check(err <= DESC_TOL, f"{name}: descriptors differ from the CPU path "
           f"by {err:.3e} > {DESC_TOL}")
    return res, launches, spy


def _ingest(cfg: dict, device, want_kfs) -> dict:
    """``_process_sequence`` over the three sequences, a fresh pipeline
    each pass (as ``run_benchmark`` has), with ``system.io_prefetch``
    "always", "off", "off", "always": scans/s of each (host clock; the
    pass ends with the descriptors on the host), descriptors bit-equal
    across modes; their distance from the benchmark run's is printed."""
    import numpy as np
    from neural_spectral_codec_torch.pipeline import (
        NeuralSpectralCodecPipeline, _loaders_from_config)
    cfg = copy.deepcopy(cfg)
    rates = {"always": [], "off": []}
    want = [np.stack([kf.descriptor for kf in kfs]) for kfs in want_kfs]
    first, vs_bench = None, 0.0
    for mode in ("always", "off", "off", "always"):
        cfg["system"]["io_prefetch"] = mode
        pipe = NeuralSpectralCodecPipeline(cfg, device=device)
        loaders = _loaders_from_config(cfg, "test")
        n = sum(len(ld) for ld in loaders)
        t0 = time.perf_counter()
        got = [np.stack([kf.descriptor for kf in
                         pipe._process_sequence(ld, sequence_id=i)])
               for i, ld in enumerate(loaders)]
        rates[mode].append(n / (time.perf_counter() - t0))
        first = first or got
        _check(all(np.array_equal(g, f) for g, f in zip(got, first)),
               f"ingest: io_prefetch {mode} changed a descriptor")
        vs_bench = max(vs_bench, max(float(np.abs(g - w).max())
                                     for g, w in zip(got, want)))
        del pipe
    print(f"ingest: _process_sequence over {n} scans, scans/s (always, "
          f"off, off, always): {rates['always'][0]:.1f}, "
          f"{rates['off'][0]:.1f}, {rates['off'][1]:.1f}, "
          f"{rates['always'][1]:.1f}; descriptors bit-equal with read-ahead "
          f"on and off, {vs_bench:.3e} from the benchmark run's", flush=True)
    return rates


def _online_cli(cfg_path: str, device) -> tuple:
    """``pipeline.main --mode online`` on the KITTI sequence; returns
    (pipeline, launches, per-keyframe latency report). Each frame
    fetch is stamped on the host clock (a wrapper around
    ``frame_source``'s getter) for the per-keyframe latency."""
    import contextlib
    import types

    from neural_spectral_codec_torch import pipeline
    from neural_spectral_codec_torch.experiments.online_latency import (
        latency_report)
    stamps = types.SimpleNamespace(fetch_times=[])
    orig = pipeline.frame_source

    @contextlib.contextmanager
    def stamped(loader, config=None):
        with orig(loader, config) as get:
            def timed(idx):
                stamps.fetch_times.append(time.perf_counter())
                return get(idx)
            yield timed

    pipeline.frame_source = stamped
    try:
        with _RestoreLogging():
            pipe, launches = _counted(lambda: pipeline.main(
                ["--config", cfg_path, "--mode", "online", "--device",
                 str(device)]))
    finally:
        pipeline.frame_source = orig
    rep = latency_report(stamps, pipe, 10,
                         float(pipe.config["deployment"]["max_latency_ms"]))
    return pipe, launches, rep


def _datasets_and_evaluation(device, gnn_pt: str) -> dict:
    """Phase 9: the dataset front end and the evaluation suite from
    dataset directories: ``run_benchmark`` (default and ring-major
    encoders), read-ahead on and off, ``pipeline --mode online`` and
    ``--mode train``; returns {path: launches}."""
    from neural_spectral_codec_torch import pipeline
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig)
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="nsc_data_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        sizes = _write_datasets(root, device)
        print("data: " + ", ".join(f"{k} {n} frames of {p:.0f} points"
                                   for k, (n, p) in sizes.items())
              + f" written in {time.perf_counter() - t0:.2f} s", flush=True)
        bench = {"quality": {"check_rotation_invariance": True},
                 "system": {"io_prefetch": "always"}}
        cfgs = {"bench": _data_config("inference.yaml", root, **bench),
                "bench_ring": _data_config(
                    "inference.yaml", root, **bench,
                    encoding={"ring_major": True, "n_elevation": 64})}
        cpu_cfgs = {}
        for name, cfg in cfgs.items():
            enc = cfg["encoding"]
            cpu_cfgs[name] = SpectralEncoderConfig(
                n_elevation=enc["n_elevation"], n_azimuth=enc["n_azimuth"],
                n_bins=enc["n_bins"],
                target_elevation_bins=enc["target_elevation_bins"],
                alpha=enc["alpha"], epsilon=enc["epsilon"],
                interpolate_empty=enc["interpolate_empty"],
                elevation_range_deg=tuple(enc["elevation_range"]),
                max_range=enc["max_range"], min_range=enc["min_range"],
                elevation_mode=enc["elevation_mode"])
        spies = {}
        for name, need, unused in (("bench", ("project", "spectral"),
                                    ("ring_fold",)),
                                   ("bench_ring", ("ring_fold", "spectral"),
                                    ())):
            path = _write_yaml(cfgs[name], root / f"{name}.yaml")
            res, launches, spies[name] = _bench_run(
                name, path, gnn_pt, root / f"{name}.json", device, cpu_cfgs)
            _check(all(launches[k] > 0 for k in need) and
                   all(launches[k] == 0 for k in unused),
                   f"{name}: unexpected launches {launches}")
            by_path[name] = launches
        _ingest(cfgs["bench"], device,
                [k for _, k in spies["bench"].sequences])

        lap = DATA_SEQS["kitti"][2] // 2
        online = _data_config("inference.yaml", root,
                              retrieval={"spatial_filter_distance": 0.0},
                              model={"checkpoint_path": gnn_pt},
                              loop_closing={"output_path":
                                            str(root / "loops.g2o")},
                              database={"storage_path": str(root / "db.bin")},
                              system={"io_prefetch": "always"})
        online["data"]["datasets"]["test"] = online["data"]["datasets"][
            "test"][:1]
        pipe, launches, rep = _online_cli(
            _write_yaml(online, root / "online.yaml"), device)
        by_path["online_cli"] = launches
        _check((root / "loops.g2o").exists(),
               "online_cli: no g2o file (no loop closure)")
        edges = [ln.split() for ln in (root / "loops.g2o").read_text()
                 .splitlines() if ln.startswith("EDGE_SE3:QUAT")]
        scan_of = {kf.keyframe_id: kf.scan_id
                   for kf in pipe.selector.keyframes}
        pairs = [(scan_of[int(e[1])], scan_of[int(e[2])]) for e in edges]
        print(f"online_cli: {len(pipe.selector.keyframes)} keyframes, "
              f"{len(edges)} loop closures (scan pairs {pairs}), "
              f"per-keyframe latency {json.dumps(rep['keyframe'])}, stage "
              f"means ms {json.dumps(rep['stage_mean_ms'])}, launches "
              f"{launches}", flush=True)
        _check(len(edges) > 0 and all(s >= lap > t and abs(s - t - lap) <= 1
                                      for s, t in pairs),
               f"online_cli: loop closures {pairs} not from the second lap "
               "to its place on the first")
        _check(launches["project"] > 0 and launches["spectral"] > 0,
               f"online_cli: a kernel of the path never launched {launches}")

        train = _data_config("training.yaml", root,
                             training={"n_epochs": 1},
                             system={"checkpoint_dir": str(root / "ckpt")})
        with _RestoreLogging():
            t0 = time.perf_counter()
            trainer, launches = _counted(lambda: pipeline.main(
                ["--config", _write_yaml(train, root / "train.yaml"),
                 "--mode", "train", "--device", str(device)]))
            wall = time.perf_counter() - t0
        by_path["train_cli"] = launches
        ckpt = root / "ckpt" / "final_model.pt"
        print(f"train_cli: one epoch over {sum(n for n, _ in sizes.values())}"
              f" frames in {wall:.2f} s, losses {trainer.train_losses}, best "
              f"R@1 {trainer.best_val_metric:.4f}, launches {launches}",
              flush=True)
        _check(ckpt.exists() and len(trainer.train_losses) == 1 and
               all(math.isfinite(v) for v in trainer.train_losses),
               f"train_cli: losses {trainer.train_losses}, checkpoint "
               f"{ckpt.exists()}")
        _check(launches["project"] > 0 and launches["spectral"] > 0,
               f"train_cli: a kernel of the path never launched {launches}")
    return by_path


def _rank_graphs(device) -> None:
    """Phase 9, the evaluation's ranking (``evaluation.RankExecutable``):
    ``evaluate_place_recognition`` through the graphs equals the same
    steps run eagerly on the card and the CPU's (``_eval_same``), on
    RANK_CPU_NODES ``synthetic_city`` descriptors in query chunks of
    RANK_CPU_CHUNK (the last padded) and on tied embeddings; one executable
    a shape. Then BIG_NODES embeddings through the graph and eagerly (wall,
    host clock) and the ranking pool's MiB."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch import evaluation
    from neural_spectral_codec_torch.experiments.scale_100k import (
        synthetic_city)

    desc, poses, _ = synthetic_city(RANK_CPU_NODES)
    tied, tposes = _tied_recall_input()
    for name, emb, ps, chunk in (("synthetic_city", desc, poses,
                                  RANK_CPU_CHUNK),
                                 ("tied", tied, tposes, 16)):
        evaluation.clear_cache()
        got = {g: evaluation.evaluate_place_recognition(
            emb, ps, query_chunk=chunk, device=device, use_graph=g)
            for g in (True, False)}
        want = evaluation.evaluate_place_recognition(
            emb, ps, query_chunk=chunk, device="cpu")
        graphs = [e for e in evaluation.cached_executables()
                  if e.graph is not None]
        _check(got[True] == got[False] and len(graphs) == 1,
               f"ranking graph ({name}): the graph's evaluation differs "
               f"from the eager step's, or {len(graphs)} graphs")
        err = _eval_same(got[True], want, emb)
        n_chunks = -(-got[True]["n_queries"] // chunk)
        print(f"ranking graph ({name}): {len(emb)} embeddings, "
              f"{got[True]['n_queries']} queries in {n_chunks} chunks of "
              f"{chunk} (the last padded): graph == eager on the card, == "
              f"the CPU (tau² within {err:.3e}); recall@1 "
              f"{got[True]['recall@1']:.4f}", flush=True)
    _check(evaluation.STATS["replays"] > 0,
           f"ranking: no graph replay {evaluation.STATS}")

    desc, poses, _ = synthetic_city(BIG_NODES)
    evaluation.clear_cache()
    wall = {}
    for use_graph in (True, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluation.evaluate_place_recognition(
            desc, poses, device=device, use_graph=use_graph)
        torch.cuda.synchronize()
        wall.setdefault(use_graph, []).append(time.perf_counter() - t0)
        _check(0.0 <= res["recall@1"] <= 1.0 and res["n_queries"] > 0,
               f"ranking at {BIG_NODES}: {res}")
    print(f"ranking graph: {BIG_NODES} embeddings x {desc.shape[1]}, "
          f"{res['n_queries']} queries in chunks of 4096: evaluation wall "
          f"{wall[True][1]:.3f} s through the graph (first, with its "
          f"capture, {wall[True][0]:.3f} s), {wall[False][0]:.3f} s eagerly;"
          f" recall@1 {res['recall@1']:.4f}; ranking pool "
          f"{evaluation.POOL.bytes(device) / 2**20:.1f} MiB", flush=True)
    evaluation.clear_cache()
    torch.cuda.empty_cache()


def _meshes(device) -> list:
    """Phase 10's meshes: every CUDA card (printed), four logical shards
    of the first, and, where the machine has more than one card, up to
    four distinct cards."""
    import torch
    from neural_spectral_codec_torch.parallel import Mesh, create_mesh
    every = create_mesh()
    print(f"parallel: create_mesh() over {[str(d) for d in every.devices]}",
          flush=True)
    meshes = [("logical", Mesh([device] * PAR_SHARDS))]
    if torch.cuda.device_count() > 1:
        meshes.append(("cards", create_mesh(min(PAR_SHARDS,
                                                torch.cuda.device_count()))))
    return meshes


def _sharded_encoders(device, meshes) -> dict:
    """Phase 10: both sharded encoders on PAR_SCANS full-density scans,
    PAR_SCANS / PAR_SHARDS a shard, against the unsharded batch encoder
    on the card (SHARD_TOL; each scan is encoded on its own) and the CPU
    plain path (DESC_TOL); returns {path: launches}."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.ops.ring_path import (
        encode_points_ring_batch, make_structured_ring_scans)
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig, encode_points_batch)
    from neural_spectral_codec_torch.parallel import make_sharded_encoder
    from neural_spectral_codec_torch.parallel.encode import (
        make_sharded_ring_encoder)

    cfg = SpectralEncoderConfig()
    rows = tuple(range(N_RINGS))
    inputs = (
        ("sharded_encode", "random order",
         _general_scans(PAR_SCANS, SEED + 50)[:, :PAR_POINTS], None),
        ("sharded_encode", "sweep order",
         _sweep_scans(PAR_SCANS, SEED + 51)[:, :PAR_POINTS], None),
        ("sharded_ring_encode", "ring rows", make_structured_ring_scans(
            PAR_SCANS, N_RINGS, PER_RING, cfg.projection, seed=SEED + 52),
         rows))
    by_path = {}
    for path, name, pts, r in inputs:
        x = torch.from_numpy(np.ascontiguousarray(pts))

        def single(t):
            return (encode_points_batch(t, cfg.alpha, cfg) if r is None else
                    encode_points_ring_batch(t, cfg.alpha, cfg, r))
        xd = x.to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = single(xd)
        torch.cuda.synchronize()
        single_ms = 1e3 * (time.perf_counter() - t0)
        cpu = single(x)
        for mname, mesh in meshes:
            enc = (make_sharded_encoder(cfg, mesh) if r is None else
                   make_sharded_ring_encoder(cfg, mesh, r))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, launches = _counted(lambda: enc(xd, cfg.alpha))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            err = float((got - want).abs().max())
            err_cpu = float((got.cpu() - cpu).abs().max())
            kernel = "project" if r is None else "ring_fold"
            print(f"parallel: {path} {name} on {mname} {mesh}: "
                  f"{tuple(got.shape)} on {got.device}, {err:.3e} from the "
                  f"unsharded encoder, {err_cpu:.3e} from the CPU plain "
                  f"path; host ms {ms:.2f} (unsharded {single_ms:.2f}, "
                  f"scans on {device}); launches {launches}", flush=True)
            _check(got.device == mesh.devices[0] and
                   tuple(got.shape) == (PAR_SCANS, cfg.output_dim) and
                   err <= SHARD_TOL and err_cpu <= DESC_TOL,
                   f"{path} {name}: {err:.3e} / {err_cpu:.3e}")
            _check(launches[kernel] == mesh.size and
                   launches["spectral"] == mesh.size,
                   f"{path} {name}: launches {launches}")
            acc = by_path.setdefault(path, dict.fromkeys(launches, 0))
            for k, v in launches.items():
                acc[k] += v
    return by_path


def _planted_rows(device, metric: str, seed: int):
    """PAR_ROWS rows (^4 histograms or normal embeddings) and positions
    over 20 km, in chunks on the card, with PAR_QUERIES of them planted
    as the queries' answers 5 · MIN_DIST from each query's position."""
    import numpy as np
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    planted = (np.arange(PAR_QUERIES) * 3121 + 17) % PAR_ROWS
    chunks, queries, qpos = [], [None] * PAR_QUERIES, [None] * PAR_QUERIES
    for lo in range(0, PAR_ROWS, 10_000):
        h = (torch.rand((10_000, 800), generator=gen, device=device) ** 4
             if metric == "wasserstein" else
             torch.randn((10_000, 800), generator=gen, device=device))
        pos = (torch.rand((10_000, 3), generator=gen, device=device)
               - 0.5) * 20_000.0
        for j in np.flatnonzero((planted >= lo) & (planted < lo + 10_000)):
            queries[j] = h[planted[j] - lo].clone()
            qpos[j] = (pos[planted[j] - lo]
                       - torch.tensor([5 * MIN_DIST, 0, 0], device=device))
        chunks.append((h, pos))
    return (chunks, planted, torch.stack(queries).cpu().numpy(),
            torch.stack(qpos).cpu().numpy())


def _p50_ms(fn, calls: int = 20) -> float:
    """Median host ms of ``fn`` (a query, which fetches its answer) over
    ``calls`` calls after one warm-up."""
    import torch
    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _sharded_retrieval(device, mesh) -> dict:
    """Phase 10: the row-sharded database against the unsharded one at
    PAR_ROWS × 800 in three modes: PAR_QUERIES planted queries (spatial
    filter MIN_DIST), ``update_rows`` on four slabs, ``exclude_last`` and
    ``as_of_size``; indices equal (ties included), distances within 1e-6
    (uint16: one code); the sharded query through its graph
    (``QueryExecutable`` over ``rank``) against the same retriever's query
    step run eagerly, bit for bit, with no capture after warm-up and none
    counted op by op. Returns ({mode: (sharded, unsharded, sharded eager)
    query ms}, the kernels' launches in the sharded graph's first batch of
    each mode: its capture's warm-up and one replay)."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.parallel import (
        ShardedWassersteinRetriever)
    from neural_spectral_codec_torch.retrieval import WassersteinRetriever
    from neural_spectral_codec_torch.retrieval import retriever as _retriever

    out, launches = {}, {}
    for i, (metric, storage) in enumerate((("wasserstein", "float32"),
                                           ("wasserstein", "uint16"),
                                           ("l2", "float32"))):
        mode = f"{metric}/{storage}"
        tol = 4 / 65535 if storage == "uint16" else 1e-6
        chunks, planted, q, qpos = _planted_rows(device, metric,
                                                 SEED + 53 + i)
        rets = (ShardedWassersteinRetriever(
                    mesh, n_bins=800, capacity=PAR_ROWS, metric=metric,
                    storage=storage),
                WassersteinRetriever(n_bins=800, capacity=PAR_ROWS,
                                     metric=metric, storage=storage,
                                     device=device),
                ShardedWassersteinRetriever(
                    mesh, n_bins=800, capacity=PAR_ROWS, metric=metric,
                    storage=storage, use_graph=False))
        _check(rets[0].rows_per_shard * mesh.size == PAR_ROWS,
               f"retrieval: slabs of {rets[0].rows_per_shard} rows")
        for h, pos in chunks:
            for r in rets:
                r.add_to_database(h, pos)
        del chunks
        kw = dict(top_k=TOP_K, query_positions=qpos,
                  spatial_min_distance=MIN_DIST)
        (ia, da), counts = _counted(lambda: rets[0].query_batch(q, **kw))
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
        (ib, db), (ic, dc) = (r.query_batch(q, **kw) for r in rets[1:])
        _check(np.array_equal(ia, ic) and np.array_equal(da, dc),
               f"retrieval {mode}: the sharded query graph differs from its "
               f"eager step")
        _check(np.array_equal(ia, ib) and np.array_equal(ia[:, 0], planted)
               and float(np.abs(da - db).max()) <= tol,
               f"retrieval {mode}: sharded != unsharded or planted row not "
               f"top-1 ({int((ia != ib).sum())} indices differ)")
        fresh = (torch.rand((4, 800), device=device) ** 4
                 if metric == "wasserstein"
                 else torch.randn((4, 800), device=device)).cpu().numpy()
        rows = np.array([1, PAR_ROWS // 4 + 1, PAR_ROWS // 2 + 2,
                         PAR_ROWS - 1])
        for r in rets:
            r.update_rows(rows, fresh)
        (ua, _), (ub, _), (uc, _) = (r.query_batch(fresh, top_k=TOP_K)
                                     for r in rets)
        excl = [r.query_batch(q, top_k=TOP_K, exclude_last=30_000)[0]
                for r in rets]
        snap = [r.query(q[5], top_k=TOP_K, as_of_size=60_000,
                        exclude_last=5)[0] for r in rets]
        _check(np.array_equal(ua, ub) and np.array_equal(ua, uc)
               and np.array_equal(ua[:, 0], rows),
               f"retrieval {mode}: update_rows")
        _check(all(np.array_equal(excl[0], e) for e in excl[1:])
               and excl[0].max() < 70_000,
               f"retrieval {mode}: exclude_last")
        _check(all(np.array_equal(snap[0], e) for e in snap[1:])
               and snap[0].max() < 59_995,
               f"retrieval {mode}: as_of_size")
        captures, by_op = _retriever.STATS["captures"], \
            _retriever.STATS["sharded"]
        ms = [_p50_ms(lambda: r.query(q[3], top_k=TOP_K,
                                      query_position=qpos[3],
                                      spatial_min_distance=MIN_DIST))
              for r in rets]
        batch_ms = [_p50_ms(lambda: r.query_batch(q, **kw), calls=5)
                    for r in rets]
        _check(_retriever.STATS["captures"] == captures and
               _retriever.STATS["sharded"] == by_op,
               f"retrieval {mode}: a capture after warm-up or a query op by "
               f"op")
        out[mode] = {"query_ms_p50": ms[0], "unsharded_query_ms_p50": ms[1],
                     "eager_query_ms_p50": ms[2],
                     "batch_ms_p50": batch_ms[0],
                     "unsharded_batch_ms_p50": batch_ms[1],
                     "eager_batch_ms_p50": batch_ms[2]}
        print(f"parallel: retrieval {mode}, {PAR_ROWS} rows in "
              f"{mesh.size} slabs of {rets[0].rows_per_shard}: "
              f"{PAR_QUERIES} planted queries top-1, indices equal to the "
              f"unsharded retriever's, distances {float(np.abs(da - db).max()):.3e}"
              f" apart; update_rows, exclude_last, as_of_size equal; the "
              f"graph bit-equal to its eager step; one query p50 "
              f"{ms[0]:.3f} ms through the graph (eager {ms[2]:.3f}, "
              f"unsharded {ms[1]:.3f}), {PAR_QUERIES} queries "
              f"{batch_ms[0]:.3f} ms (eager {batch_ms[2]:.3f}, unsharded "
              f"{batch_ms[1]:.3f})", flush=True)
        del rets
        torch.cuda.empty_cache()
    return out, launches


def _sharded_two_stage(device, mesh, store: Path) -> None:
    """Phase 10: two-stage retrieval on the sharded mesh against the
    unsharded one, both loaded from phase 8's final store (the map and
    the session's keyframes); every session keyframe queried against the
    snapshot it was inserted into, as the online loop queries."""
    import numpy as np
    from neural_spectral_codec_torch.experiments.online_latency import (
        inference_config)
    from neural_spectral_codec_torch.retrieval.two_stage import (
        TwoStageRetrieval)

    r = inference_config()["retrieval"]
    opts = dict(n_bins=800, capacity=STORE_ROWS + ONLINE_FRAMES,
                top_k=r["top_k"], context_window=r["context_window"],
                spatial_filter_distance=r["spatial_filter_distance"],
                device=device)
    t0 = time.perf_counter()
    plain = TwoStageRetrieval(**opts)
    sharded = TwoStageRetrieval(mesh=mesh, **opts)
    n = [ts.load_database(str(store)) for ts in (plain, sharded)]
    load_s = time.perf_counter() - t0
    _check(n[0] == n[1] > STORE_ROWS and not sharded.can_fuse_serving(),
           f"two-stage: loaded {n}, can_fuse_serving "
           f"{sharded.can_fuse_serving()}")
    n_cand = 0
    for i in range(STORE_ROWS, n[0]):
        c1, c2 = (ts._global_retrieval(ts.keyframes[i], as_of_size=i + 1)
                  for ts in (plain, sharded))
        _check([c.database_idx for c in c1] == [c.database_idx for c in c2]
               and np.allclose([c.distance for c in c1],
                               [c.distance for c in c2], rtol=0, atol=1e-6),
               f"two-stage: keyframe {i} candidates differ")
        n_cand += len(c1)
    print(f"parallel: two-stage on {mesh}: phase 8's store ({n[0]} records, "
          f"both loaded in {load_s:.2f} s), {n[0] - STORE_ROWS} session "
          f"keyframes queried at their snapshots, {n_cand} candidates equal "
          f"to the unsharded ones; can_fuse_serving False", flush=True)


def _step_ms(step, steps: int = PAR_STEPS) -> float:
    """ms per call of ``step`` (a train step) over ``steps`` calls after
    one warm-up, host clock, synchronised."""
    import torch
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def _sharded_run(device, mesh, mode: str, graph, base, batches,
                 use_graph: bool) -> tuple:
    """A fresh full-width model with ``base``'s weights, capturable Adam
    and a dropout generator seeded as phase 10's single-device step's,
    through ``ShardedTrainStepExecutable`` (``mode`` "dp" or "nodes") for
    the (triplets, mask) device ``batches``: (losses, model and Adam state,
    the executable)."""
    import torch
    from neural_spectral_codec_torch.models import SpectralGNN
    from neural_spectral_codec_torch.parallel.train import (
        ShardedTrainStepExecutable)
    from neural_spectral_codec_torch.training.trainer import make_optimizer
    model = SpectralGNN()
    model.load_state_dict(base.state_dict())
    model.to(device)
    opt = make_optimizer(model)
    gen = torch.Generator(device=device).manual_seed(SEED + 55)
    exe = ShardedTrainStepExecutable(
        model, opt, mesh, mode == "nodes", graph.n_nodes, graph.max_degree,
        graph.edge_feats.shape[2], PAR_TRIPLETS, 0.1, 1.0, False, gen,
        use_graph)
    exe.load_graph(graph)
    losses = [exe.run({"triplets": t, "tmask": m}, fetch=False)[0]["loss"]
              for t, m in batches]
    state = [v.detach().clone() for v in model.state_dict().values()]
    for st in opt.state_dict()["state"].values():
        state += [v.clone() for _, v in sorted(st.items())]
    return [float(x) for x in losses], state, exe


def _sharded_plans(device, mesh, graph, batches) -> None:
    """Phase 10: kernel G against its plain version and the CPU's
    ``index_add_``, bit for bit, at the plans the sharded train steps
    build: each node slab's neighbour gather into the PAR_NODES-row
    transform, each DP replica's whole-graph neighbour gather, and the
    triplet gathers of the first and the last (padded) batch, whole
    (node-sharded) and cut into one slab a replica (DP). Every position
    carries a random gradient; ``valid`` (the graph's mask, the triplet
    mask) must leave the masked ones out of G's segments, so the CPU
    sums only the valid positions."""
    import torch
    from neural_spectral_codec_torch.models import gather_kernel as gk
    from neural_spectral_codec_torch.parallel.mesh import data_sharding
    from neural_spectral_codec_torch.parallel.train import place_graph

    plans = {}
    slabs = place_graph(graph, mesh, True)
    whole = place_graph(graph, mesh, False)[0]
    for name, g in ([(f"node slab {s}", g) for s, g in enumerate(slabs)]
                    + [("DP replica", whole)]):
        plans[f"{name} neighbours"] = (g.neighbors.reshape(-1),
                                       g.mask.reshape(-1), 256)
    for name, (t, m) in (("first", batches[0]), ("padded last",
                                                 batches[-1])):
        for j, col in enumerate(("anchor", "positive", "negative")):
            plans[f"{name} batch's {col}s"] = (t[:, j], m, 800)
            for k, (_, sl) in enumerate(data_sharding(mesh, len(t))):
                plans[f"{name} batch's DP slab {k} {col}s"] = (
                    t[sl, j], m[sl], 800)
    gen = torch.Generator(device=device).manual_seed(SEED + 59)
    left_out = 0
    for name, (idx, valid, width) in plans.items():
        plan = gk.make_plan(idx, PAR_NODES, valid)
        grad = torch.randn(idx.numel(), width, generator=gen, device=device)
        got = gk.gather_bwd_cuda(grad, plan, PAR_NODES)
        keep = valid.cpu()
        want = torch.zeros(PAR_NODES, width).index_add_(
            0, idx.cpu()[keep], grad.cpu()[keep])
        _check(torch.equal(got, gk.gather_bwd_plain(grad, plan, PAR_NODES))
               and torch.equal(got.cpu(), want),
               f"gather_bwd kernel != plain version / CPU index_add_ on the "
               f"sharded step's {name} plan")
        left_out += int((~keep).sum())
    print(f"parallel: gather_bwd bit-equal to the plain version and the "
          f"CPU's index_add_ over the valid positions at the sharded "
          f"steps' {len(plans)} plans into {PAR_NODES} rows ({len(slabs)} "
          f"node slabs' and a DP replica's neighbours; the first and the "
          f"padded last batch's triplet columns, whole and in "
          f"{mesh.size} DP slabs); {left_out} masked positions with a "
          f"random gradient left out", flush=True)


def _sharded_graphs(device, mesh, graph, base, tri, mask) -> tuple:
    """Phase 10: the DP and node-sharded train steps through their
    captured graphs (``parallel.train.ShardedTrainStepExecutable``):
    first kernel G at the plans those steps build (``_sharded_plans``);
    then each step against its eager step and two fresh runs against each
    other: PAR_RUNS Adam steps (the last batch with PAR_PADDED padded
    triplets) leave the same losses, parameters, BatchNorm buffers and
    Adam state, bit for bit; the first loss within 1e-5 relative of the
    single-device step's from the same weights and generator; G's nodes
    in each graph from ``graph_census``; one capture a run and none after
    it; ms a step through the graph and eagerly with the device-busy
    share. Returns
    ({mode: timings}, G's launches in the counted graph runs)."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.experiments.parallel_profile import (
        _profile)
    from neural_spectral_codec_torch.keyframe.graph import graph_to_tensors
    from neural_spectral_codec_torch.models import SpectralGNN
    from neural_spectral_codec_torch.training import trainer as trmod
    from neural_spectral_codec_torch.training.trainer import (
        make_optimizer, train_step)

    rng = np.random.default_rng(SEED + 58)
    batches = [(tri, mask)] + [
        (torch.from_numpy(rng.integers(0, PAR_NODES, (PAR_TRIPLETS, 3))).to(
            device), mask.clone()) for _ in range(PAR_RUNS - 1)]
    batches[-1][1][PAR_TRIPLETS - PAR_PADDED:] = False
    batches[-1][0][PAR_TRIPLETS - PAR_PADDED:] = 0
    _sharded_plans(device, mesh, graph, batches)
    model = SpectralGNN()
    model.load_state_dict(base.state_dict())
    model.to(device)
    opt = make_optimizer(model)
    gen = torch.Generator(device=device).manual_seed(SEED + 55)
    g1 = graph_to_tensors(graph, device)
    single = [float(train_step(model, opt, g1, t[:, 0], t[:, 1], t[:, 2], m,
                               0.1, generator=gen)) for t, m in batches]
    del model, opt, g1
    timings, launches = {}, None
    for mode in ("dp", "nodes"):
        before = dict(trmod.STATS)
        (la, sa, ea), counts = _counted(lambda: _sharded_run(
            device, mesh, mode, graph, base, batches, True))
        captures = trmod.STATS["captures"] - before["captures"]
        replays = trmod.STATS["replays"] - before["replays"]
        launches = counts if launches is None else {
            k: v + counts[k] for k, v in launches.items()}
        lb, sb, _ = _sharded_run(device, mesh, mode, graph, base, batches,
                                 True)
        lc, sc, ec = _sharded_run(device, mesh, mode, graph, base, batches,
                                  False)
        census = ea.census
        same_runs = la == lb and all(torch.equal(a, b)
                                     for a, b in zip(sa, sb))
        same_eager = la == lc and all(torch.equal(a, c)
                                      for a, c in zip(sa, sc))
        rel = abs(la[0] - single[0]) / abs(single[0])
        drift = max(abs(a - b) / abs(b) for a, b in zip(la, single))
        print(f"parallel: {mode} train graph on {mesh}, {PAR_NODES} nodes, "
              f"{PAR_RUNS} Adam steps (last batch {PAR_PADDED} padded): "
              f"captured in {ea.capture_s:.3f} s, {census['nodes']} nodes "
              f"({census['kernels']} kernels, {census['memcpy']} copies, "
              f"{census['memset']} memsets), G nodes {census['gather_bwd']}"
              f" (want {ea.gathers()}); captures {captures}, replays "
              f"{replays}; G launches {counts['gather_bwd']}; losses "
              f"{la}; graph = eager bit for bit {same_eager}, two fresh "
              f"graph runs bit-equal {same_runs}; first loss {rel:.3e} "
              f"relative from the single-device step's (later steps "
              f"{drift:.3e})", flush=True)
        _check(census["gather_bwd"] == ea.gathers() and captures == 1
               and replays == PAR_RUNS - 1
               and counts["gather_bwd"] == PAR_RUNS * ea.gathers(),
               f"{mode} train graph: census {census['gather_bwd']}, "
               f"captures {captures}, replays {replays}, launches "
               f"{counts['gather_bwd']}")
        _check(same_runs and same_eager and rel <= 1e-5,
               f"{mode} train graph: runs equal {same_runs}, eager equal "
               f"{same_eager}, first loss {rel:.3e} from one device")
        t = {}
        for name, exe in (("graph", ea), ("eager", ec)):
            before = trmod.STATS["captures"]
            t[name] = _profile(lambda: exe.run(
                {"triplets": tri, "tmask": mask}, fetch=False))
            _check(trmod.STATS["captures"] == before,
                   f"{mode} train {name}: a capture after warm-up")
        timings[mode] = t
        print(f"parallel: {mode} train ms a step, graph "
              f"{t['graph']['wall_ms']:.3f} (device "
              f"{t['graph']['device_ms']:.3f}, busy "
              f"{t['graph']['busy_share']:.3f}, "
              f"{t['graph']['ops']:.0f} ops), eager "
              f"{t['eager']['wall_ms']:.3f} (device "
              f"{t['eager']['device_ms']:.3f}, busy "
              f"{t['eager']['busy_share']:.3f}, {t['eager']['ops']:.0f} "
              f"ops)", flush=True)
        del ea, ec, sa, sb, sc
        torch.cuda.empty_cache()
    return timings, launches


def _sharded_eval_recall(device, mesh, model, emb_1, graph, poses) -> dict:
    """Phase 10: the node-sharded eval forward (``ShardedEvalExecutable``)
    and the sharded Recall@{1,5,10} (on a one-device mesh the
    single-device ``RecallExecutable``) through their graphs against
    their eager steps (bit for bit, counts equal) and the single-device
    forward (1e-5) and recall (equal); no capture on a second call; wall
    ms of each."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.models import gnn
    from neural_spectral_codec_torch.parallel.train import (
        ShardedEvalExecutable)
    from neural_spectral_codec_torch.training import validation
    from neural_spectral_codec_torch.training.validation import recall_at_ks

    args = (model, mesh, True, graph.n_nodes, graph.max_degree,
            graph.edge_feats.shape[2])
    embs, out = {}, {}
    for use_graph in (True, False):
        exe = ShardedEvalExecutable(*args, use_graph)
        embs[use_graph] = exe.run(graph._asdict())[0]["emb"]
        before = gnn.STATS["captures"]
        out[f"eval_ms_{'graph' if use_graph else 'eager'}"] = _p50_ms(
            lambda: exe.run(graph._asdict()), calls=5)
        _check(gnn.STATS["captures"] == before and
               (exe.graph is not None) == use_graph,
               "sharded eval: a capture after warm-up")
        del exe
    err = float(np.abs(embs[True] - emb_1.cpu().numpy()).max())
    _check(np.array_equal(embs[True], embs[False]) and err <= 1e-5,
           f"sharded eval graph: eager equal "
           f"{np.array_equal(embs[True], embs[False])}, {err:.3e} from one "
           f"device")
    emb = emb_1.cpu().numpy()
    recall = {}
    for name, kw in (("graph", dict(mesh=mesh)),
                     ("eager", dict(mesh=mesh, use_graph=False)),
                     ("single", dict(device=device))):
        recall_at_ks(emb, poses, (1, 5, 10), **kw)
        before = validation.STATS["captures"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recall[name] = recall_at_ks(emb, poses, (1, 5, 10), **kw)
        out[f"recall_s_{name}"] = time.perf_counter() - t0
        _check(validation.STATS["captures"] == before,
               f"sharded recall {name}: a capture on the second call")
    _check(recall["graph"] == recall["eager"] == recall["single"],
           f"sharded recall: {recall}")
    validation.clear_cache()
    print(f"parallel: sharded eval graph on {mesh}: bit-equal to its eager "
          f"step, {err:.3e} from one device, p50 ms graph "
          f"{out['eval_ms_graph']:.3f}, eager {out['eval_ms_eager']:.3f}; "
          f"sharded Recall@1/5/10 {recall['graph']} equal through the "
          f"graph, eagerly and on one device; wall s graph "
          f"{out['recall_s_graph']:.4f}, eager {out['recall_s_eager']:.4f},"
          f" one device {out['recall_s_single']:.4f}", flush=True)
    return out


def _sharded_training(device, mesh) -> dict:
    """Phase 10: the full-width SpectralGNN on a PAR_NODES-node graph with
    PAR_TRIPLETS triplets, DP and node-sharded on ``mesh`` against the
    single-device step from the same weights and dropout generator: loss
    within 1e-5 relative, each gradient within 3e-5 + 1e-5·max|g|
    (tests/test_parallel.py's bar) except the gauge biases (true gradient
    0: rounding noise on both sides, as in phase 7a); the sharded eval
    forward within 1e-5, the sharded recall equal; then the sharded
    programs through their graphs (``_sharded_graphs``,
    ``_sharded_eval_recall``); then bf16. Returns (ms per step by mode
    and the graphs' timings, G's launches in the counted graph runs)."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.experiments.scale_100k import (
        synthetic_city)
    from neural_spectral_codec_torch.keyframe.graph import (
        build_graph, graph_to_tensors)
    from neural_spectral_codec_torch.models import SpectralGNN
    from neural_spectral_codec_torch.models.gnn import (
        gauge_parameters, gnn_forward)
    from neural_spectral_codec_torch.parallel import make_sharded_train_step
    from neural_spectral_codec_torch.parallel.train import (
        make_sharded_eval_step, place_graph)
    from neural_spectral_codec_torch.training.trainer import (
        make_optimizer, train_step)
    from neural_spectral_codec_torch.training.validation import (
        recall_loop_closure)

    desc, poses, _ = synthetic_city(PAR_NODES)
    graph = build_graph(desc, poses, temporal_neighbors=5)
    tri = torch.from_numpy(np.random.default_rng(SEED + 54).integers(
        0, PAR_NODES, (PAR_TRIPLETS, 3))).to(device)
    mask = torch.ones(PAR_TRIPLETS, dtype=torch.bool, device=device)
    base = SpectralGNN(generator=torch.Generator().manual_seed(SEED))
    g1 = graph_to_tensors(graph, device)

    def make(mode, opt_cls, compute_dtype=None):
        model = SpectralGNN(compute_dtype=compute_dtype)
        model.load_state_dict(base.state_dict())
        model.to(device)
        opt = (torch.optim.SGD(model.parameters(), lr=0.0) if opt_cls is None
               else make_optimizer(model))
        gen = torch.Generator(device=device).manual_seed(SEED + 55)
        clip = None if opt_cls is None else 1.0
        if mode == "single":
            return model, lambda: train_step(
                model, opt, g1, tri[:, 0], tri[:, 1], tri[:, 2], mask, 0.1,
                grad_clip=clip, generator=gen)
        placed = place_graph(graph, mesh, mode == "nodes")
        step = make_sharded_train_step(model, opt, mesh,
                                       shard_nodes=mode == "nodes",
                                       grad_clip=clip)
        return model, lambda: step(placed, tri[:, 0], tri[:, 1], tri[:, 2],
                                   mask, 0.1, gen)

    got = {}
    for mode in ("single", "dp", "nodes"):
        model, step = make(mode, None)
        loss = float(step())
        got[mode] = (loss, {k: p.grad.detach().cpu()
                            for k, p in model.named_parameters()})
    l1, g1s = got["single"]
    gauge = gauge_parameters(base)
    for mode in ("dp", "nodes"):
        loss, grads = got[mode]
        worst = max((float((grads[k] - g).abs().max())
                     / (3e-5 + 1e-5 * float(g.abs().max())), k)
                    for k, g in g1s.items() if k not in gauge)
        noise = max(float((grads[k] - g1s[k]).abs().max()) for k in gauge)
        print(f"parallel: train {mode} on {mesh}, {PAR_NODES} nodes, "
              f"{PAR_TRIPLETS} triplets: loss {loss:.6f} (one device "
              f"{l1:.6f}), worst gradient {worst[1]} at {worst[0]:.3f} of "
              f"the bar; the {len(gauge)} gauge biases (true gradient 0, "
              f"not held) differ by up to {noise:.3e}", flush=True)
        _check(abs(loss - l1) <= 1e-5 * abs(l1) and worst[0] <= 1.0,
               f"train {mode}: loss {loss} vs {l1}, gradient {worst}")

    ms = {mode: _step_ms(make(mode, "adam")[1])
          for mode in ("single", "dp", "nodes")}
    model, _ = make("single", None)
    emb_1 = gnn_forward(model.eval(), g1)
    emb_sh = make_sharded_eval_step(model, mesh, shard_nodes=True)(
        place_graph(graph, mesh, True))
    eval_err = float((emb_sh - emb_1).abs().max())
    kw = dict(k=1, distance_threshold=5.0, skip_frames=30)
    r1 = recall_loop_closure(emb_1.cpu().numpy(), poses, device=device, **kw)
    rm = recall_loop_closure(emb_1.cpu().numpy(), poses, mesh=mesh, **kw)
    print(f"parallel: ms per step single {ms['single']:.3f}, DP "
          f"{ms['dp']:.3f}, node-sharded {ms['nodes']:.3f}; sharded eval "
          f"forward {eval_err:.3e} from one device; recall@1 {rm[0]:.4f} "
          f"over {rm[1]} queries (one device {r1[0]:.4f} over {r1[1]})",
          flush=True)
    _check(eval_err <= 1e-5 and rm == r1 and rm[1] > 0,
           f"sharded eval {eval_err:.3e}, recall {rm} vs {r1}")
    del emb_sh
    ms["graphs"], launches = _sharded_graphs(device, mesh, graph, base, tri,
                                             mask)
    ms.update(_sharded_eval_recall(device, mesh, model, emb_1, graph, poses))

    # -- bf16: the same step and forward with mixed precision ------------
    m16, step16 = make("single", None, torch.bfloat16)
    out16 = gnn_forward(m16.eval(), g1)
    cpu16 = SpectralGNN(compute_dtype=torch.bfloat16)
    cpu16.load_state_dict(m16.state_dict())
    out_cpu = gnn_forward(cpu16.eval(), graph_to_tensors(graph, "cpu"))
    scale = max(float(emb_1.abs().max()), 1.0)
    err32 = float((out16 - emb_1).abs().max())
    err_cpu = float((out16.cpu() - out_cpu).abs().max())
    loss16 = step16()
    grads_ok = all(p.grad.dtype == torch.float32 and
                   bool(torch.isfinite(p.grad).all())
                   for p in m16.parameters())
    ms["bf16"] = _step_ms(make("single", "adam", torch.bfloat16)[1])
    print(f"parallel: bf16 step loss {float(loss16):.6f} "
          f"({loss16.dtype}), gradients float32 and finite {grads_ok}; "
          f"bf16 forward {err32:.3e} from float32 (bar "
          f"{3e-2 * scale:.3e}), {err_cpu:.3e} from the CPU's bf16 forward "
          f"(bar {1e-2 * scale:.3e}); ms per step float32 "
          f"{ms['single']:.3f}, bf16 {ms['bf16']:.3f}", flush=True)
    _check(math.isfinite(float(loss16)) and loss16.dtype == torch.float32
           and grads_ok and out16.dtype == torch.float32
           and err32 <= 3e-2 * scale and err_cpu <= 1e-2 * scale,
           f"bf16: loss {float(loss16)}, grads {grads_ok}, forward "
           f"{err32:.3e} / {err_cpu:.3e}")
    return ms, launches


def _bf16_serving(device) -> None:
    """Phase 10: ``serve_step`` with a bf16 model ranks by its own
    embeddings (an L2 database): each request's center embedding,
    computed beforehand by the bf16 eval forward and planted among
    10,000 random rows outside the spatial filter, comes back top-1."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.keyframe.graph import (
        build_graph, graph_to_tensors)
    from neural_spectral_codec_torch.models import SpectralGNN, serve_step
    from neural_spectral_codec_torch.ops.spectral import SpectralEncoderConfig
    from neural_spectral_codec_torch.models.serving import encode_scan
    from neural_spectral_codec_torch.retrieval import WassersteinRetriever

    cfg = SpectralEncoderConfig()
    rng = np.random.default_rng(SEED + 56)
    desc0 = rng.random((N_NODES, cfg.output_dim)).astype(np.float32) ** 4
    desc0 /= desc0.sum(axis=1, keepdims=True)
    poses = np.tile(np.eye(4), (N_NODES, 1, 1))
    poses[:, 0, 3] = np.arange(N_NODES) * 2.0
    graph_np = build_graph(desc0, poses)
    model = SpectralGNN(generator=torch.Generator().manual_seed(SEED),
                        compute_dtype=torch.bfloat16).to(device).eval()
    scans = torch.from_numpy(_general_scans(8, SEED + 57)).to(device)
    centers = [100 + 100 * j for j in range(8)]
    ret = WassersteinRetriever(n_bins=cfg.output_dim, capacity=10_008,
                               metric="l2", device=device)
    ret.add_to_database(torch.randn((10_000, cfg.output_dim),
                                    device=device),
                        (torch.rand((10_000, 3), device=device) - 0.5)
                        * 20_000.0)
    qps = []
    for j, c in enumerate(centers):
        g = graph_to_tensors(graph_np, device)
        with torch.no_grad():
            g.features[c] = encode_scan(scans[j], cfg.alpha, cfg)
            emb = model(g.features, g.neighbors, g.mask, g.edge_feats)[c]
        qp = torch.tensor([poses[c, 0, 3], 0.0, 0.0, MIN_DIST],
                          device=device)
        ret.add_to_database(emb[None], (qp[:3] + torch.tensor(
            [5 * MIN_DIST, 0, 0], device=device))[None])
        qps.append(qp)
    for j, c in enumerate(centers):
        graph = graph_to_tensors(graph_np, device)
        _, emb, idx, dist = serve_step(ret, model, scans[j], cfg.alpha,
                                       graph, c, qps[j], TOP_K,
                                       do_insert=False, config=cfg)
        _check(emb.dtype == torch.float32 and int(idx[0]) == 10_000 + j,
               f"bf16 serve: request {j} top-1 {int(idx[0])} "
               f"({float(dist[0]):.3e}), not {10_000 + j}")
    print(f"parallel: bf16 serve_step on {len(centers)} requests: the "
          f"planted embedding top-1 of an L2 database of "
          f"{ret.database_size} rows each time", flush=True)


def _parallel(device, store: Path) -> dict:
    """Phase 10: the multi-device layer on the card; returns the launches
    of its kernel paths."""
    from neural_spectral_codec_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    meshes = _meshes(device)
    by_path = _sharded_encoders(device, meshes)
    mesh = meshes[0][1]
    query_ms, by_path["sharded_query"] = _sharded_retrieval(device, mesh)
    _check(by_path["sharded_query"]["query"] > 0 and
           by_path["sharded_query"]["query_group"] > 0,
           f"phase 10: the sharded query graph never ran kernel Q's group "
           f"regime {by_path['sharded_query']}")
    _sharded_two_stage(device, mesh, store)
    step_ms, by_path["parallel_train"] = _sharded_training(device, mesh)
    _check(by_path["parallel_train"]["gather_bwd"] > 0,
           f"phase 10: G never launched {by_path['parallel_train']}")
    _bf16_serving(device)
    out, by_path["dryrun"] = _counted(lambda: dryrun_multichip(
        PAR_SHARDS, devices=[device] * PAR_SHARDS))
    _check(all(by_path["dryrun"][k] > 0
               for k in ("project", "ring_fold", "spectral")),
           f"dryrun launches {by_path['dryrun']}")
    print("parallel: " + json.dumps({"query": query_ms, "ms_per_step":
                                     step_ms, "dryrun": out}), flush=True)
    print(f"parallel: phase 10 wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    return by_path


def _one_call(name: str, run, launches: dict) -> tuple:
    """``run`` under ``_counted``; its launches must be one of each
    kernel in ``launches`` and none of the others."""
    out, got = _counted(run)
    want = {k: launches.get(k, 0) for k in got}
    _check(got == want, f"{name}: launches {got}, expected {want}")
    return out, got


def _single_scan(device) -> dict:
    """Phase 11: the single-scan API on the card. ``SpectralEncoder`` on
    one full-density ring-major scan (133,632 points, cut to 131,072) and
    ``forward`` on BATCH random-order scans: equal to
    ``encode_points_batch`` on the same padded input (difference 0),
    within DESC_TOL of the CPU plain path, one projection and one
    spectral launch a call; ``encode_range_image`` and the functional
    ``encode_range_image`` one spectral launch; ``project_points`` equal
    to the CPU image. Returns {path: launches}."""
    import numpy as np
    import torch
    from neural_spectral_codec_torch.ops.range_image import (
        pad_points, project_points)
    from neural_spectral_codec_torch.ops.ring_path import (
        make_structured_ring_scans)
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoder, encode_points_batch, encode_range_image)

    enc, cpu_enc = SpectralEncoder(device=device), SpectralEncoder(
        device="cpu")
    cfg = enc.config
    _check(enc.max_points == 131_072, "SpectralEncoder.max_points is "
           f"{enc.max_points}, not 131,072")
    full = make_structured_ring_scans(1, N_RINGS, PER_RING, cfg.projection,
                                      seed=SEED + 40)[0].reshape(-1, 4)
    by_path = {}
    got, by_path["encode_points"] = _one_call(
        "encode_points", lambda: enc.encode_points(full),
        {"project": 1, "spectral": 1})
    padded = torch.from_numpy(pad_points(full, enc.max_points)).to(device)
    want = encode_points_batch(padded[None], cfg.alpha, cfg)[0].cpu().numpy()
    uncut = encode_points_batch(torch.from_numpy(full[None]).to(device),
                                cfg.alpha, cfg)[0].cpu().numpy()
    on_cpu = cpu_enc.encode_points(full)
    err, cut = float(np.abs(got - on_cpu).max()), float(
        np.abs(got - uncut).max())
    print(f"single scan: encode_points on {len(full)} points (cut to "
          f"{enc.max_points}): {float(np.abs(got - want).max()):.3e} from "
          f"encode_points_batch, {err:.3e} from the CPU, {cut:.3e} from "
          "the uncut scan", flush=True)
    _check(np.array_equal(got, want) and err <= DESC_TOL and cut > 0,
           "encode_points: not the batch encoder's descriptor of the cut "
           f"scan (CPU {err:.3e}, uncut {cut:.3e})")

    clouds = list(_general_scans(BATCH, SEED + 41))
    got, by_path["forward"] = _one_call(
        "forward", lambda: enc(clouds), {"project": 1, "spectral": 1})
    batch = torch.from_numpy(np.stack([pad_points(c, enc.max_points)
                                       for c in clouds])).to(device)
    want = encode_points_batch(batch, cfg.alpha, cfg).cpu().numpy()
    err = float(np.abs(got - cpu_enc.forward(clouds)).max())
    print(f"single scan: forward on {BATCH} scans: "
          f"{float(np.abs(got - want).max()):.3e} from encode_points_batch, "
          f"{err:.3e} from the CPU", flush=True)
    _check(np.array_equal(got, want) and err <= DESC_TOL
           and got.shape == (BATCH, enc.output_dim),
           f"forward: not the batch encoder's descriptors (CPU {err:.3e})")

    x = torch.from_numpy(clouds[0]).to(device)
    img, by_path["project_points"] = _one_call(
        "project_points", lambda: project_points(x, cfg.projection),
        {"project": 1})
    n_diff = int((img.cpu() != project_points(x.cpu(),
                                              cfg.projection)).sum())
    print(f"single scan: project_points, {n_diff} of {img.numel()} pixels "
          "differ from the CPU image", flush=True)
    _check(n_diff == 0, "project_points: the card's image differs from "
           "the CPU's")
    img_np = img.cpu().numpy()
    got, by_path["encode_range_image"] = _one_call(
        "encode_range_image", lambda: enc.encode_range_image(img_np),
        {"spectral": 1})
    err = float(np.abs(got - cpu_enc.encode_range_image(img_np)).max())
    got_f, by_path["encode_range_image_fn"] = _one_call(
        "encode_range_image (function)",
        lambda: encode_range_image(img, cfg.alpha, cfg), {"spectral": 1})
    err_f = float((got_f.cpu() - encode_range_image(
        img.cpu(), cfg.alpha, cfg)).abs().max())
    print(f"single scan: encode_range_image {err:.3e} from the CPU, the "
          f"function (no interpolation) {err_f:.3e}", flush=True)
    _check(max(err, err_f) <= DESC_TOL, "encode_range_image: card vs CPU "
           f"{err:.3e} / {err_f:.3e}")
    return by_path


def _entry(device) -> dict:
    """Phase 11: the port's ``entry()`` on the card. Its ``fn`` runs the
    static step of its shapes, a CUDA graph captured at the first call
    (then one projection and one spectral launch credited a call; K3's node
    read back as cooperative): its outputs bit-equal to the same step op
    by op (``forward_eager``) and, against the same function on the CPU
    (the model copied), descriptors within DESC_TOL and embeddings within
    EMB_TOL. p50 wall ms over ENTRY_CALLS calls and the device time of
    one call (torch.profiler), through the graph and eagerly. Returns its
    launches."""
    import torch
    from neural_spectral_codec_torch import entry as E
    from neural_spectral_codec_torch.utils.timing import device_ops

    fn, args = E.entry(device)
    cpu_args = tuple(copy.deepcopy(a).cpu() for a in args)
    fn(*args)        # captures: its warm-up run launches the kernels too
    (desc, emb), launches = _one_call("entry", lambda: fn(*args),
                                      {"project": 1, "spectral": 1})
    exe = E.forward_executable(args[0], args[2], args[3], args[5])
    eager_d, eager_e = E.forward_eager(*args)
    same = torch.equal(desc, eager_d) and torch.equal(emb, eager_e)
    want_d, want_e = fn(*cpu_args)
    d_err = float((desc.cpu() - want_d).abs().max())
    e_err = float((emb.cpu() - want_e).abs().max())
    _check(same, "entry: the graph's outputs differ from the eager step's")
    _check(d_err <= DESC_TOL and e_err <= EMB_TOL
           and bool(torch.isfinite(emb).all()),
           f"entry: descriptors {d_err:.3e}, embeddings {e_err:.3e} from "
           "the CPU")
    _check(exe.graph is not None and exe.census["project_cooperative"] == 1,
           f"entry: no graph, or K3's node not cooperative ({exe.census})")
    times = {}
    for form, step in (("graph", fn), ("eager", E.forward_eager)):
        wall = []
        for _ in range(ENTRY_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        ops = device_ops(lambda: step(*args), calls=5)
        times[form] = {"p50_wall_ms": statistics.median(wall),
                       "device_ms": sum(us for _, us in ops) / 5 / 1e3,
                       "operations": len(ops) / 5}
    c = exe.census
    print(f"entry: {tuple(args[0].shape)} scans, graph vs eager bit-equal "
          f"{same}, descriptors {d_err:.3e} and embeddings {e_err:.3e} "
          f"from the CPU; graph of {c['nodes']} nodes ({c['kernels']} "
          f"kernels), K3 cooperative {c['project_cooperative']}/"
          f"{c['project']}, captured in {exe.capture_s:.3f} s; "
          f"{json.dumps(times)}", flush=True)
    return launches


def _finite(what: str, obj) -> None:
    """Every number in a (nested) result is finite."""
    if isinstance(obj, dict):
        for v in obj.values():
            _finite(what, v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _finite(what, v)
    elif isinstance(obj, float):
        _check(math.isfinite(obj), f"{what}: a non-finite number")


def _experiments(device) -> dict:
    """Phase 11: the ported root experiments on the card (each must run
    and give finite numbers; recall is a check, not a quality figure),
    ``density_defense``'s ray cast bit-equal to the CPU's, and the
    native voxel IoU. Returns {path: launches}."""
    import numpy as np
    from neural_spectral_codec_torch.data.pose_utils import (
        compute_overlap, relative_pose)
    from neural_spectral_codec_torch.data.synthetic import SyntheticWorld
    from neural_spectral_codec_torch.experiments import (
        cross_sensor_uplift, degraded_recall, density_defense,
        retrieval_latency, selection_divergence)
    from neural_spectral_codec_torch.native import voxel_overlap

    by_path = {}
    out = retrieval_latency.main(["--size", "100000", "--queries", "32",
                                  "--single", "--device", str(device)])
    _finite("retrieval_latency", out)
    _check(out["parity"]["one_code_violations"] == 0,
           f"retrieval_latency: uint16 ranking off the one-code rule "
           f"{out['parity']}")
    for row in out["rows"]:
        b, one = row["batched"], row["single"]
        print(f"retrieval_latency: {row['size']} rows {row['storage']}: "
              f"ms a query batched(32) device {_fmt_ms(b['device_ms'])} "
              f"wall {_fmt_ms(b['wall_ms'])}, single device "
              f"{_fmt_ms(one['device_ms'])} wall {_fmt_ms(one['wall_ms'])}",
              flush=True)
    worlds = (("scene", density_defense.make_scene, 0.0, (0.0, 0.0)),
              ("loop pose", lambda r: density_defense.make_world_for_loop(
                  r, 60.0), 1.3, (60.0, 0.0)))
    for what, make, yaw, pos in worlds:
        scans = []
        for dev in (device, "cpu"):
            rng = np.random.default_rng(SEED + 43)
            lo, hi = make(rng)
            scans.append(density_defense.raycast(lo, hi, yaw, rng, pos=pos,
                                                 device=dev))
        same = scans[0].tobytes() == scans[1].tobytes()
        print(f"density_defense: ray cast of a {what} ({len(lo)} boxes), "
              f"card {'equal' if same else 'NOT equal'} to the CPU bit for "
              "bit", flush=True)
        _check(same, f"density_defense: the card's ray cast of a {what} "
               "differs from the CPU's")
    t0 = time.perf_counter()
    out, by_path["density_defense"] = _counted(
        lambda: density_defense.main(["--device", str(device)]))
    _finite("density_defense", out)
    print(f"density_defense: {time.perf_counter() - t0:.1f} s, recall "
          f"{out['recall']}", flush=True)
    runs = {"degraded_recall": (degraded_recall, ["--frames", "200",
                                                  "--epochs", "3"]),
            "cross_sensor_uplift": (cross_sensor_uplift, [
                "--frames", "80", "--epochs", "2"])}
    for name, (mod, argv) in runs.items():
        t0 = time.perf_counter()
        with _RestoreLogging():
            out, by_path[name] = _counted(
                lambda: mod.main(argv + ["--device", str(device)]))
        _finite(name, out)
        print(f"{name}: {time.perf_counter() - t0:.1f} s, {out}", flush=True)
    for name, launches in by_path.items():
        _check(launches["project"] > 0 and launches["spectral"] > 0,
               f"{name}: launches {launches}")
    out = selection_divergence.main(["--frames", "60"])
    _finite("selection_divergence", out)

    world, rng = SyntheticWorld(seed=3), np.random.default_rng(SEED + 42)
    p0, p1 = np.eye(4), np.eye(4)
    p1[0, 3] = 1.0
    a = world.scan(p0, n_points=16384, rng=rng)[:, :3]
    b = world.scan(p1, n_points=16384, rng=rng)[:, :3]
    T = relative_pose(p0, p1)
    stride = -(-len(a) // 5000)
    for vox in (0.2, 2.0):
        nat = voxel_overlap(a, b, T, voxel=vox)
        num = compute_overlap(a[::stride], b[::stride], T, voxel_size=vox)
        print(f"voxel_overlap: voxel {vox} native {nat:.7f} numpy "
              f"{num:.7f}", flush=True)
        _check(abs(nat - num) <= OVERLAP_TOL, f"voxel_overlap {nat} vs "
               f"numpy {num}")
    return by_path


def _rest_of_api(device) -> dict:
    """Phase 11: the single-scan API, ``entry()``, the experiments."""
    t0 = time.perf_counter()
    by_path = _single_scan(device)
    by_path["entry"] = _entry(device)
    by_path.update(_experiments(device))
    from neural_spectral_codec_torch.utils.timing import gpu_label
    print(f"phase 11 wall {time.perf_counter() - t0:.2f} s on {gpu_label()}",
          flush=True)
    return by_path


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one "
                         "card")
    from neural_spectral_codec_torch import _build, resolve_device
    from neural_spectral_codec_torch.keyframe.graph import (
        build_graph, graph_to_tensors)
    from neural_spectral_codec_torch.models import SpectralGNN, serve_step
    from neural_spectral_codec_torch.models import serving as serving_mod
    from neural_spectral_codec_torch.models.serving import (
        encode_scan, warm_serve_step)
    from neural_spectral_codec_torch.ops import (
        projection_kernel, ring_kernel, spectral_kernel)
    from neural_spectral_codec_torch.ops.range_image import (
        project_points_batch_plain)
    from neural_spectral_codec_torch.ops.ring_path import (
        make_structured_ring_scans, project_rings_batch_plain)
    from neural_spectral_codec_torch.ops.spectral import (
        SpectralEncoderConfig, encode_images_plain)
    from neural_spectral_codec_torch.retrieval import WassersteinRetriever
    from neural_spectral_codec_torch.utils.timing import gpu_label

    # -- 1. device ---------------------------------------------------------
    device = resolve_device("cuda")
    print(gpu_label(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 3. each kernel against its plain version on the card --------------
    cfg = SpectralEncoderConfig()
    proj = cfg.projection
    rows = tuple(range(N_RINGS))
    alpha = cfg.alpha
    gen = torch.from_numpy(_general_scans(BATCH, SEED + 1)).to(device)
    rings = torch.from_numpy(make_structured_ring_scans(
        BATCH, N_RINGS, PER_RING, proj, seed=SEED + 2)).to(device)

    got = projection_kernel.project_points_cuda(gen, proj)
    want = project_points_batch_plain(gen, proj)
    _check(torch.equal(got, want), "projection kernel != plain version "
           f"({int((got != want).sum())} pixels differ)")
    proj_err = float((got - want).abs().max())
    imgs = want.clone()
    _check_cpu_image("project", got, project_points_batch_plain(
        gen.cpu(), proj))
    sweep = torch.from_numpy(_sweep_scans(BATCH, SEED + 8)).to(device)
    for order, x in (("random", gen), ("sweep", sweep)):
        for x_b in (x[:1].contiguous(), x):
            got = projection_kernel.project_points_cuda(x_b, proj)
            want_b = project_points_batch_plain(x_b, proj)
            _check(torch.equal(got, want_b), f"projection kernel != plain "
                   f"version ({order} order, B={x_b.shape[0]}, "
                   f"{int((got != want_b).sum())} pixels differ)")
            proj_err = max(proj_err, float((got - want_b).abs().max()))
    print("project: bit-equal to the plain version in random and sweep "
          "order at B=1 and B=8", flush=True)

    got = ring_kernel.project_rings_cuda(rings, proj, rows)
    want = project_rings_batch_plain(rings, proj, rows)
    _check(torch.equal(got, want), "ring kernel != plain version "
           f"({int((got != want).sum())} pixels differ)")
    ring_err = float((got - want).abs().max())
    _check_cpu_image("ring_fold", got, project_rings_batch_plain(
        rings.cpu(), proj, rows))

    g = torch.Generator(device=device).manual_seed(SEED + 3)
    imgs[1] *= torch.rand(imgs[1].shape, generator=g, device=device) < 0.02
    imgs[2, :3] = 0.0
    imgs[2, 10:14] = 0.0
    imgs[3] = 0.0
    got = spectral_kernel.encode_images_cuda(imgs, alpha, cfg)
    want = encode_images_plain(imgs, alpha, cfg)
    spec_err = float((got - want).abs().max())
    _check(spec_err <= SPECTRAL_TOL,
           f"spectral kernel vs plain: max abs {spec_err:.3e}")
    _check(bool(torch.all(torch.isfinite(got))) and
           float((got[3] - 1.0 / cfg.output_dim).abs().max()) < 1e-9,
           "spectral kernel: non-finite output or no uniform fallback")

    rings1 = rings[:1].contiguous()
    got = ring_kernel.project_rings_cuda(rings1, proj, rows)
    _check(torch.equal(got, project_rings_batch_plain(rings1, proj, rows)),
           "ring kernel != plain version at B=1")
    _spectral_shapes(gen)
    _edge_cases(device)

    # per kernel at B=8 (and B=1): wrapper, kernel alone, plain, bound
    pix_bytes = 4 * cfg.n_elevation * cfg.n_azimuth
    n_out = cfg.target_elevation_bins * cfg.n_bins
    imgs1 = imgs[:1].contiguous()
    gen1 = gen[:1].contiguous()
    serving = {
        "project": (lambda x: (lambda: projection_kernel.project_points_cuda(
            x, proj)), lambda: project_points_batch_plain(gen, proj),
            gen, gen1, lambda x: _bound(4 * x.numel()
                                        + pix_bytes * x.shape[0])),
        "ring_fold": (lambda x: (lambda: ring_kernel.project_rings_cuda(
            x, proj, rows)), lambda: project_rings_batch_plain(
                rings, proj, rows), rings, rings1,
            lambda x: _bound(4 * x.numel() + pix_bytes * x.shape[0])),
        "spectral": (lambda x: (lambda: spectral_kernel.encode_images_cuda(
            x, alpha, cfg)), lambda: encode_images_plain(imgs, alpha, cfg),
            imgs, imgs1, lambda x: _bound(4 * x.numel() + 4 * n_out
                                          * x.shape[0],
                                          _spectral_ops(x, cfg))),
    }
    _only_kernel("spectral", serving["spectral"][0](imgs))
    _only_kernel("ring_fold", serving["ring_fold"][0](rings))
    _only_kernel("project", serving["project"][0](gen))
    timing = {}
    for name, (call, plain, x8, x1, bound) in serving.items():
        bound_ms, bound_by = bound(x8)
        b1 = _device_times(name, call(x1))
        wrapper_ms = _time_ms(call(x8))
        timing[name] = {"ms": wrapper_ms, "wrapper_ms": wrapper_ms,
                        "plain_ms": _time_ms(plain),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "bound_ms_b1": bound(x1)[0],
                        "device_ms_b1": b1["device_ms"],
                        "queued_ms_b1": b1["queued_ms"],
                        **_device_times(name, call(x8))}
        t = timing[name]
        print(f"kernel {name}: B={BATCH} device {t['device_ms']:.5f} ms "
              f"(profiler {t['profiler_ms']}, queued bare "
              f"{t['queued_ms']:.5f}), wrapper {t['wrapper_ms']:.5f} ms, "
              f"plain {t['plain_ms']:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}); B=1 device {t['device_ms_b1']:.5f} ms "
              f"(queued bare {t['queued_ms_b1']:.5f}), bound "
              f"{t['bound_ms_b1']:.5f} ms", flush=True)
    sweep1 = sweep[:1].contiguous()
    for key, x in (("sweep", sweep), ("sweep_b1", sweep1)):
        t = _device_times("project", serving["project"][0](x))
        timing["project"][f"device_ms_{key}"] = t["device_ms"]
        timing["project"][f"queued_ms_{key}"] = t["queued_ms"]
    t = timing["project"]
    print(f"kernel project, sweep order: B={BATCH} device "
          f"{t['device_ms_sweep']:.5f} ms (queued bare "
          f"{t['queued_ms_sweep']:.5f}), B=1 device "
          f"{t['device_ms_sweep_b1']:.5f} ms (queued bare "
          f"{t['queued_ms_sweep_b1']:.5f})", flush=True)
    timing.update(_probe_kernels(device))
    timing.update(_search_kernels(device))
    timing.update(_pca_kernels(device))
    timing.update(_query_kernel_cases(device))

    # -- 4. serve ----------------------------------------------------------
    rng = np.random.default_rng(SEED + 4)
    ring_req = make_structured_ring_scans(N_REQUESTS // 2, N_RINGS, PER_RING,
                                          proj, seed=SEED + 5)
    gen_req = _general_scans(N_REQUESTS // 2, SEED + 6)
    requests = [(ring_req[j // 2], rows) if j % 2 == 0
                else (gen_req[j // 2], None) for j in range(N_REQUESTS)]

    t0 = time.perf_counter()
    cpu_desc = torch.stack([encode_scan(torch.from_numpy(p), alpha, cfg, r)
                            for p, r in requests])
    print(f"serve: CPU plain descriptors of {N_REQUESTS} scans in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    desc0 = rng.random((N_NODES, cfg.output_dim)).astype(np.float32) ** 4
    desc0 /= desc0.sum(axis=1, keepdims=True)
    poses = np.tile(np.eye(4), (N_NODES, 1, 1))
    poses[:, 0, 3] = np.arange(N_NODES) * 2.0        # straight line, 2 m
    loops = [(i, i + 500) for i in range(0, 500, 25)]
    graph_np = build_graph(desc0, poses, loop_closures=loops)
    graph = graph_to_tensors(graph_np, device)
    graph_cpu = graph_to_tensors(graph_np, "cpu")

    model_cpu = SpectralGNN(generator=torch.Generator().manual_seed(SEED))
    model_cpu.eval()
    model = copy.deepcopy(model_cpu).to(device).eval()

    centers = [100 + 25 * j for j in range(N_REQUESTS)]
    qps = [np.array([poses[c, 0, 3], 0.0, 0.0, MIN_DIST], np.float32)
           for c in centers]
    ret = WassersteinRetriever(n_bins=cfg.output_dim,
                               capacity=DB_ROWS + N_REQUESTS, device=device)
    gdb = torch.Generator(device=device).manual_seed(SEED + 7)
    planted = (np.arange(N_REQUESTS) * 3121 + 17) % DB_ROWS
    chunk = 10_000
    for lo in range(0, DB_ROWS, chunk):
        h = torch.rand((chunk, cfg.output_dim), generator=gdb,
                       device=device) ** 4
        pos = (torch.rand((chunk, 3), generator=gdb, device=device)
               - 0.5) * 20_000.0
        for j in np.flatnonzero((planted >= lo) & (planted < lo + chunk)):
            h[planted[j] - lo] = cpu_desc[j].to(device)
            pos[planted[j] - lo] = torch.from_numpy(
                qps[j][:3] + np.array([5 * MIN_DIST, 0, 0], np.float32))
        ret.add_to_database(h, pos)
    torch.cuda.synchronize()
    print(f"serve: database {ret.database_size} rows x {cfg.output_dim} "
          f"float32 ({ret.database_size * cfg.output_dim * 4 / 1e6:.0f} MB) "
          f"on {device}", flush=True)

    # build the serving executables of both path forms before the clock
    # starts: scratch executions that leave the database as it was, the
    # graphed ones (captured here) and the eager ones (not counted)
    for use_graph in (True, False):
        for p, r in requests[:2]:
            warm_serve_step(ret, model, p, alpha, graph, centers[0], TOP_K,
                            config=cfg, row_of_ring=r, use_graph=use_graph)
    torch.cuda.synchronize()
    graphed = {("ring" if e.shape.row_of_ring else "general"): e
               for e in serving_mod.cached_executables() if e.graph is not None}
    for form, e in graphed.items():
        c = e.census
        print(f"serve: {form} step captured in {e.capture_s:.3f} s: "
              f"{c['nodes']} graph nodes ({c['kernels']} kernels, "
              f"{c['memcpy']} copies, {c['memset']} memsets); projection "
              f"nodes {c['project']}, cooperative {c['project_cooperative']}"
              f"; ring-fold nodes {c['ring_fold']}; spectral nodes "
              f"{c['spectral']}, cluster width {c['spectral_cluster_width']}"
              f" (node attribute {c['spectral_cluster_dim']})", flush=True)
    _check(graphed["general"].census["project"] == 1 and
           graphed["general"].census["project_cooperative"] == 1 and
           graphed["ring"].census["ring_fold"] == 1 and
           all(e.census["spectral"] == 1 for e in graphed.values()),
           "serve: a captured step lacks its kernels or K3's cooperative "
           "launch")
    g_split = graph_to_tensors(graph_np, device)
    split = _host_split(graphed["general"], ret, lambda at, eff: graphed[
        "general"].stage(requests[1][0], g_split, centers[1], at, eff,
                         qps[1]))
    print(f"serve: host ms of a general request's parts (median of 20 "
          f"scratch executions) {json.dumps(split)}", flush=True)
    snapshot = (ret._db_rows.clone(), ret._db_pos.clone(),
                ret.database_size)

    def serve_all(use_graph: bool):
        """The 32 requests from the snapshot: latencies and answers."""
        ret._db_rows.copy_(snapshot[0])
        ret._db_pos.copy_(snapshot[1])
        ret.database_size = snapshot[2]
        g = graph_to_tensors(graph_np, device)
        torch.cuda.synchronize()
        lat, res = [], []
        for j, (p, r) in enumerate(requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()        # the scan arrives on the host
            out = serve_step(ret, model, p, alpha, g, centers[j], qps[j],
                             TOP_K, do_query=True, do_insert=True,
                             config=cfg, row_of_ring=r, use_graph=use_graph)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            res.append(tuple(t.cpu() for t in out))
        rows = slice(snapshot[2], ret.database_size)
        return lat, res, (ret._db_rows[rows].clone(), ret._db_pos[rows].clone())

    kernels = _all_kernels()
    for k in kernels.values():
        k.launches = 0
    lat_ms, results, inserted = serve_all(True)
    launches = {n: k.launches for n, k in kernels.items()}
    print(f"serve: {N_REQUESTS} requests through replayed graphs, latency "
          f"p50 {statistics.median(lat_ms):.3f} ms, max {max(lat_ms):.3f} ms,"
          f" launches {launches}", flush=True)
    replay_ms = {form: _replay_ms(e) for form, e in graphed.items()}
    print(f"serve: device ms of one replay (CUDA events over 50 replays) "
          f"{json.dumps(replay_ms)}; graph pool "
          f"{serving_mod.POOL.bytes(device) / 2**20:.1f} MiB", flush=True)
    lat_eager, results_eager, inserted_eager = serve_all(False)
    print(f"serve: the same {N_REQUESTS} requests eagerly, latency p50 "
          f"{statistics.median(lat_eager):.3f} ms, max "
          f"{max(lat_eager):.3f} ms", flush=True)
    emb_gap = max(float((a[1] - b[1]).abs().max())
                  for a, b in zip(results, results_eager))
    dist_gap = max(float((a[3] - b[3]).abs().max())
                   for a, b in zip(results, results_eager))
    same_desc = all(torch.equal(a[0], b[0])
                    for a, b in zip(results, results_eager))
    same_idx = all(torch.equal(a[2], b[2])
                   for a, b in zip(results, results_eager))
    same_rows = all(torch.equal(a, b)
                    for a, b in zip(inserted, inserted_eager))
    print(f"serve: graph replay vs eager: descriptors bit-equal {same_desc},"
          f" embeddings max abs {emb_gap:.3e}, indices equal {same_idx}, "
          f"distances max abs {dist_gap:.3e}, inserted rows equal "
          f"{same_rows}", flush=True)
    _check(same_desc and same_idx and same_rows and emb_gap <= GRAPH_EMB_TOL,
           "serve: the replayed graphs disagree with the eager step")

    desc_err = emb_err = 0.0
    for j, (desc, emb, idx, dist) in enumerate(results):
        _check(int(idx[0]) == int(planted[j]),
               f"request {j}: top-1 {int(idx[0])} != planted row "
               f"{int(planted[j])} (dist {dist[:3].tolist()})")
        _check(bool(torch.all(torch.isfinite(desc))) and
               bool(torch.all(torch.isfinite(emb))), f"request {j}: "
               "non-finite output")
        desc_err = max(desc_err, float((desc - cpu_desc[j]).abs().max()))
        graph_cpu.features[centers[j]] = cpu_desc[j]
        with torch.no_grad():
            emb_cpu = model_cpu(graph_cpu.features, graph_cpu.neighbors,
                                graph_cpu.mask, graph_cpu.edge_feats)
        emb_err = max(emb_err, float((emb - emb_cpu).abs().max()))
    print(f"serve: top-1 planted row on {N_REQUESTS}/{N_REQUESTS}; "
          f"descriptor max abs err vs CPU {desc_err:.3e}, embedding "
          f"{emb_err:.3e}", flush=True)
    _check(desc_err <= DESC_TOL, f"descriptors differ from the CPU path by "
           f"{desc_err:.3e} > {DESC_TOL}")
    _check(emb_err <= EMB_TOL, f"embeddings differ from the CPU path by "
           f"{emb_err:.3e} > {EMB_TOL}")
    _check(all(launches[k] > 0
               for k in ("spectral", "ring_fold", "project", "query")),
           f"a kernel of the path never launched: {launches}")
    serving_mod.clear_cache()
    _, query_launches = _counted(lambda: _query_graphs(
        device, ret, cpu_desc.numpy(), qps, planted))
    _check(query_launches["query"] > 0 and query_launches["query_dist"] > 0
           and query_launches["query_group"] > 0,
           f"query graphs: kernel Q (or its group regime) never launched "
           f"{query_launches}")
    by_path = {"serve": launches, "query_graphs": query_launches}

    # -- 5. the stage-profile entry points ---------------------------------
    by_path.update(_probe_paths())

    # -- 6. structured-scan entry point ------------------------------------
    by_path["structured"] = _structured(device)

    keep = tempfile.TemporaryDirectory(prefix="nsc_gnn_")
    gnn_pt = Path(keep.name) / "gnn.pt"
    try:
        # -- 7. training ---------------------------------------------------
        timing.update(_training_kernels(device))
        timing.update(_mining_entries(device))
        _train_step_vs_cpu(device)
        _training_graphs(device)
        by_path.update(_mining_graphs(device))
        by_path.update(_train_entry(device, gnn_pt))
        by_path["scale"] = _scale(device)

        # -- 8. the online loop --------------------------------------------
        store = Path(keep.name) / "map.bin"
        by_path.update(_online(device, store))
        _check(by_path["online"]["query"] > 0,
               f"online: kernel Q never launched {by_path['online']}")

        # -- 9. datasets and evaluation ------------------------------------
        by_path.update(_datasets_and_evaluation(device, str(gnn_pt)))
        _rank_graphs(device)

        # -- 10. the multi-device layer, bf16 --------------------------------
        by_path.update(_parallel(device, store))
    finally:
        keep.cleanup()

    # -- 11. the single-scan API, entry(), the experiments ----------------
    by_path.update(_rest_of_api(device))

    # -- 12. record --------------------------------------------------------
    meta = {
        "spectral": ("neural_spectral_codec_torch/csrc/spectral.cu",
                     "neural_spectral_codec_tpu/ops/pallas_spectral.py:169",
                     spec_err),
        "ring_fold": ("neural_spectral_codec_torch/csrc/ring_fold.cu",
                      "neural_spectral_codec_tpu/ops/pallas_ring.py:248",
                      ring_err),
        "project": ("neural_spectral_codec_torch/csrc/project.cu",
                    "neural_spectral_codec_tpu/ops/pallas_compact.py:142",
                    proj_err),
        "ring_probe": ("neural_spectral_codec_torch/csrc/ring_probe.cu",
                       "experiments/ring_stage_probe.py:163",
                       timing["ring_probe"]["max_abs_err"]),
        "roll_floor": ("neural_spectral_codec_torch/csrc/roll_floor.cu",
                       "experiments/ring_stage_probe.py:200",
                       timing["roll_floor"]["max_abs_err"]),
        "roll_min_chain": ("neural_spectral_codec_torch/csrc/roll_floor.cu",
                           "experiments/profile_hotpath.py:254",
                           timing["roll_min_chain"]["max_abs_err"]),
        # no pl.pallas_call: XLA work inside the JAX programs
        "nearest": ("neural_spectral_codec_torch/csrc/nearest.cu",
                    "neural_spectral_codec_tpu/retrieval/verification.py:124",
                    timing["nearest"]["max_abs_err"]),
        "knn": ("neural_spectral_codec_torch/csrc/knn.cu",
                "neural_spectral_codec_tpu/retrieval/verification.py:64",
                timing["knn"]["max_abs_err"]),
        "knn_pca": ("neural_spectral_codec_torch/csrc/knn_pca.cu",
                    "neural_spectral_codec_tpu/retrieval/verification.py:85",
                    timing["knn_pca"]["max_abs_err"]),
        "kabsch": ("neural_spectral_codec_torch/csrc/kabsch.cu",
                   "neural_spectral_codec_tpu/retrieval/verification.py:133",
                   timing["kabsch"]["max_abs_err"]),
        "mine": ("neural_spectral_codec_torch/csrc/mine.cu",
                 "neural_spectral_codec_tpu/training/miner.py:54",
                 timing["mine"]["max_abs_err"]),
        "gather_bwd": ("neural_spectral_codec_torch/csrc/gather_bwd.cu",
                       "neural_spectral_codec_tpu/training/trainer.py:73",
                       timing["gather_bwd"]["max_abs_err"]),
        "mine_counts": ("neural_spectral_codec_torch/csrc/mine.cu",
                        "neural_spectral_codec_tpu/training/miner.py:64",
                        timing["mine_counts"]["max_abs_err"]),
        "mine_rows": ("neural_spectral_codec_torch/csrc/mine.cu",
                      "neural_spectral_codec_tpu/training/miner.py:99",
                      timing["mine_rows"]["max_abs_err"]),
        "mine_draw_mask": ("neural_spectral_codec_torch/csrc/mine.cu",
                           "neural_spectral_codec_tpu/training/miner.py:108",
                           timing["mine_draw_mask"]["max_abs_err"]),
        "select": ("neural_spectral_codec_torch/csrc/select.cu",
                   "neural_spectral_codec_tpu/training/miner.py:102",
                   timing["select"]["max_abs_err"]),
        "query": ("neural_spectral_codec_torch/csrc/query.cu",
                  "neural_spectral_codec_tpu/retrieval/retriever.py:139",
                  timing["query"]["max_abs_err"]),
        "query_dist": ("neural_spectral_codec_torch/csrc/query.cu",
                       "neural_spectral_codec_tpu/retrieval/retriever.py:106",
                       timing["query_dist"]["max_abs_err"]),
    }
    # "ms" keeps the meaning it had in earlier records: the wrapper's time
    # per call (one event pair per call; for the probes, loops of 200 calls)
    record = []
    for name, (source, replaces, err) in meta.items():
        t = timing[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": sum(v[name] for v in by_path.values()),
                 "launches_by_path": {p: v[name] for p, v in by_path.items()},
                 "max_abs_err": err, "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"],
                 "library_ms": t.get("library_ms"),
                 "library_note": NO_LIBRARY[name],
                 "device_ms": t["device_ms"], "wrapper_ms": t["wrapper_ms"],
                 "profiler_ms": t["profiler_ms"],
                 "queued_ms": t["queued_ms"]}
        for key in ("device_ms_b1", "queued_ms_b1", "bound_ms_b1",
                    "device_ms_sweep", "queued_ms_sweep",
                    "device_ms_sweep_b1", "queued_ms_sweep_b1",
                    "device_ms_cold", "device_ms_cold_b1", "yardstick_ms",
                    "share_of_bound", "solve_device_ms", "device_ms_bf16",
                    "device_ms_triplets", "library_ms_triplets",
                    "bound_ms_triplets"):
            if key in t:
                entry[key] = t[key]
        entry.update({k: v for k, v in t.items()
                      if k.startswith(("device_ms_random", "device_ms_mined",
                                       "longest_segment_", "rows_", "draw_",
                                       "pos_", "frames_", "scan_",
                                       "model_", "device_ms_f32",
                                       "device_ms_u16", "device_ms_l2",
                                       "wrapper_ms_", "old_chain_ms_",
                                       "plain_ms_", "yardstick_ms_",
                                       "bound_ms_", "bound_by_",
                                       "merge_ms_"))})
        if name == "project":
            entry["also_replaces"] = \
                "neural_spectral_codec_tpu/ops/pallas_densify.py:76"
        if name == "mine":
            entry["draw_launches"] = sum(v["mine_draw"]
                                         for v in by_path.values())
        if name in ("query", "query_dist"):
            # the group regime's launches (Q > 1) of both entries together
            entry["group_launches_by_path"] = {
                p: v["query_group"] for p, v in by_path.items()}
        if name not in ("spectral", "ring_fold", "project", "ring_probe",
                        "roll_floor", "roll_min_chain"):
            entry["replaces_note"] = "not a pl.pallas_call site: the XLA " + {
                "nearest": "correspondence search of _icp_kernel (:124-131)",
                "knn": "k-NN selection of _knn_cov_matrices (:64-73)",
                "knn_pca": "PCA of _knn_cov_matrices (:64-73) and the eigh "
                           "of _knn_covariances (:85) and _knn_normals (:77)",
                "kabsch": "weights of _icp_kernel's correspondences "
                          "(:129-131) and its p2p_step after the argmin: "
                          "the gather, sums, SVD and det (:133-146)",
                "mine": "masks, counts, categorical positive draw and tiled "
                        "W1 running argmin of _mine_chunk (:54-98)",
                "gather_bwd": "transpose of the row gathers in train_step's "
                              "gradient (the triplet gathers, :86, and the "
                              "GAT's jnp.take(h, neighbors), "
                              "models/gnn.py:70)",
                "mine_counts": "masks and counts of _mine_chunk (:59-66, "
                               ":110) for the random strategy",
                "mine_rows": "W1 block, masked with +inf, of _mine_chunk "
                             "(:99-100) for the semi-hard strategy",
                "mine_draw_mask": "categorical draws of _mine_chunk over the "
                                  "positives (:67-68) and the negatives "
                                  "(:107-109)",
                "select": "argsort and take at count // 2 of _mine_chunk "
                          "(:101-105)",
                "query": "W1 or L2 against every row, the size and spatial "
                         "masks and the exact smallest-k of _query_math "
                         "(:139-159) and _query_batch_kernel (:106-136), "
                         "which the serving step runs (models/gnn.py:274)",
                "query_dist": "the same body's masked distances, for k "
                              "above K_MAX (the wrapper ranks them with "
                              "smallest_k)"}[name]
        record.append(entry)
    from neural_spectral_codec_torch import entry as entry_mod
    from neural_spectral_codec_torch.models import gnn
    from neural_spectral_codec_torch.retrieval import retriever, verification
    from neural_spectral_codec_torch.utils import timing as timing_mod
    print(f"profiler: {timing_mod.REPEATED_SESSIONS} torch.profiler "
          f"sessions lost a marker and were repeated; "
          f"{timing_mod.LOST_LEAD_IN} lead-in records lost; lead-in now "
          f"{timing_mod.LEAD_IN} kernels", flush=True)
    # eager_steps: the comparison runs (use_graph off); eager_forwards,
    # sharded and sharded_op_by_op: the declared op-by-op paths (the
    # evaluation's forward a sequence, the dry run's and this script's
    # references; the op-by-op sharded programs, here phase 10's
    # comparison runs)
    from neural_spectral_codec_torch.training import (
        miner, trainer, validation)
    counts = {"serving": serving_mod.STATS,
              "registration": verification.STATS,
              "prepare": verification.PREPARE_STATS, "query": retriever.STATS,
              "eval": gnn.STATS, "entry": entry_mod.STATS,
              "mining": miner.STATS, "train": trainer.STATS,
              "validation": validation.STATS}
    print(f"graphs, whole run: {json.dumps(counts)}", flush=True)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
