#!/usr/bin/env python3
"""Drive the port's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py [--seed N]

Phases, each announced with the seconds elapsed since start:

1. device: the card's name, count, and ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` builds the CUDA kernels of ``decagon_tpu_torch/csrc`` and
   ``g++`` the native host library (``decagon_tpu_torch/native``), which
   phase 3's split draws its large negative sets with;
3. serving state: the paper-scale polypharmacy-like graph (19,081
   proteins, 645 drugs, 963 side effects), its split, the device graph
   and seeded random weights (hidden 64 -> 32), as ``bench.py`` headlines;
4. kernels against their plain versions, on the card, on the main path's
   own inputs: the paired forward on drug-drug (963 pairs, N = 645) and
   PPI (1 pair, N = 19,081) at both layers, the scorer in DEDICOM and
   bilinear mode over ~0.94M edges, with f32 tables (K5) and bf16 tables
   cast once, as the scorer passes them (K5-bf16, also held within 1e-2
   of K5); errors, two calls bitwise
   equal, CUDA-event times (for the scorer also its device time alone, a
   replayed CUDA graph), bounds, and for the paired forward the
   ``torch.bmm`` yardstick (``library_ms``), the sweep kernel's registers
   and blocks an SM and the schedule's waves;
5. serve: launch counters set to 0, then one embedding, the pooled
   drug-drug evaluation on the validation and the test edges, and one
   evaluation each of PPI, protein->drug and drug->protein; every
   kernel must have launched and every output must be finite; then the
   validation evaluation once more through an evaluator built with
   ``sddmm_impl="pallas"``, which must launch K5 and give the same
   metrics (its launches are counted apart from the serve run's); then
   the warm pooled validation evaluation split into its parts
   (``decagon_tpu_torch/scripts/profile_sddmm.split_evaluation``: staging,
   the scorer's device ms from CUDA events, the device-to-host copy, the
   host metrics), which must give the evaluator's metrics and launch K5,
   and in each clocked call the parts and the rest of the call must add
   up to the call's own total within 5% (whether the clocked calls' median
   lies within the unclocked calls' interquartile range is logged: three
   calls on a shared host cannot hold it reliably);
6. small-input reference: on a small graph, the slice through the
   kernels against the slice through the plain versions (which the CPU
   tests hold against the JAX package), on the card, layer by layer;
7. train: launch counters set to 0, then ``make_train_step`` at paper
   scale (dropout 0.1, batch 512, hinge, bf16 Adam moments and large
   gradients): 4 steps on drug-drug (DEDICOM) and 2 on PPI (bilinear);
   losses, step ms, the forward/backward/Adam split from CUDA events, and
   the launches, which must be > 0 for both paired kernels.  The paired
   kernels' operands of the first step are recorded for phase 8.  Then
   one step's gradients through the kernels against the same step
   through the plain versions, same dropout bits and negatives;
8. kernels against plain versions, training: the keep-scale forward
   (K1/K2-ds) and the backward (K3/K4, with keep-scales into f32 and
   without into bf16) on the operands phase 7 recorded, plus a K > 1,
   N > 4096 case; errors, bitwise repeatability, CUDA-event times,
   bounds, the ``torch.bmm`` yardstick, registers, blocks an SM and
   waves;
9. small-input training: 3 Adam steps through the kernels and through
   the plain versions from the same state, bits and negatives;
10. trainer (paper scale): launch counters set to 0, then the ``Trainer``
   with the default ``TrainConfig`` (bf16 moments and large gradients) in
   chunks of 32 steps: one warm-up chunk and 2 timed ones; ms per step,
   edges/s in ``bench.py``'s schema, peak memory, the launches (both
   paired kernels > 0, the multi-tensor Adam K7 exactly once a step: one
   launch updates every leaf), and the gap to phase 7's single-step time;
11. one-pass Adam (K7) against its plain version: first the main path's
   whole leaf tree at paper scale (phase 10's parameters and bf16
   moments, seeded f32 gradients, those of 2^20 elements or more rounded
   to bf16 in the kernel, plus a view off 16-byte alignment and a length
   that is not a multiple of 8) in one launch, bitwise equal to
   ``adam_apply_ref``, with the device times (a replayed CUDA graph) of
   the kernel, the kernel after a separate gradient cast, the plain chain
   and ``torch.optim.Adam(fused=True)`` over the same leaves with f32
   moments (it keeps no bf16 moments beside f32 parameters), and the
   bounds; then one leaf at a time: the paper leaf ``[1, 19081, 64]``,
   P6's ``[1926, 64, 645]`` in f32 and in P6's bf16, a length that is not
   a multiple of 8 and a view off 16-byte alignment, in place;
12. trainer chunks (paper scale), each of 4 steps from a copy of phase
   10's state with the launch counters set to 0 just before: the default
   config through K7 (one launch a step) and through its plain version
   (``make_chunked_train_step`` given ``make_optimizer(cfg,
   one_pass=adam_apply_ref)``, which no config reaches), parameters,
   moments and losses bitwise equal; the same pair with
   ``lazy_decoder_adam`` (the encoder's leaves through K7, the decoder's
   through the lazy row Adam), bitwise equal; then ``pallas_adam`` with
   f32 moments and gradients (its gate's leaf in place, in the same
   launch) against the plain version at that config;
12b. grouped trainer (paper scale): the quality run's ``TrainConfig``
   (``decagon_tpu_torch/scripts/quality_full.py``: batch 512, hinge with
   margin 0.1, the balanced schedule, ``relation_group=8`` batches an
   optimization step, lr 3e-3 decayed by a cosine over a few hundred
   optimization steps to a tenth, chunks of 32 steps) on phase 3's graph
   from a copy of phase 10's state; launch counters set to 0, then one
   warm-up chunk and 1 timed one: ms a grouped step and a batch; every
   loss finite, both paired kernels launched and K7 exactly once an
   optimization step (not once a batch).  Then the quality run's evaluation
   of an epoch on the trained parameters (one embedding, the pooled
   validation and test sweeps): seconds and launches, logged apart from the
   main path's.  Then one grouped chunk of 4 steps
   from a copy of the state, through K7 and through its plain version
   (``make_grouped_chunked_train_step`` given ``make_optimizer(cfg,
   one_pass=adam_apply_ref)``), parameters, moments and losses bitwise
   equal;
13. dummy config on the card: the port's copy of the JAX package's
   ``test_dummy_config_learns_into_reference_band`` (500 genes, 400
   drugs, 3 side effects; the ``Trainer`` in chunks of 50), whose last
   epoch runs with a ``MetricsLogger`` and a ``Checkpointer`` in a
   temporary directory; the checkpoint is restored into a fresh
   ``Trainer``;
14. sparse state: phase 3's graph and split as the sparse regime builds
   them (``scripts/bench_sparse_regime.py`` ``paper_cap``: no dense or
   mask stack, the CSR layouts of K6 on every edge type, no fused stream);
   build seconds, each layout's rows, edges and longest row, memory;
15. K6 against its plain version on the sparse path's own operands: every
   edge type, both layers, forward and backward (a seeded cotangent over
   the transposed layout), both precisions; errors, bitwise
   repeatability, CUDA-event ms of the kernel, the plain version and
   ``torch.sparse.mm`` on the same CSR (f32), bounds;
16. sparse training (paper scale, ``spmm_impl="pallas"``): launch counters
   set to 0, then ``make_train_step`` at "default" (2 drug-drug steps, 1
   PPI) with the forward / backward / Adam split, the ``Trainer`` at
   "default" (chunks of 8: one warm-up, 2 timed; ms per step, edges/s,
   peak memory, K7's launches a step, which must be 1) and the pooled
   drug-drug evaluation with bf16 scoring; K6 and K5-bf16 must launch and
   the paired kernels not.  Then one
   step's gradients through K6 against its plain version at both
   precisions, and one step with ``remat`` against the same step without
   it (gradients, K6 launches, peak memory);
17. small-input sparse checks: on the small graph with every layout,
   "pallas" and "fused_pallas" through K6 against their plain versions,
   layer by layer, at both precisions, and 3 Adam steps with
   "fused_pallas" at "default";
18. probes: the ports of the JAX package's paired-kernel probes P1-P5
   (``decagon_tpu_torch/scripts/probe_*``) at their shapes (the
   ``[964, 645, 645]`` int8 stack, K = 963, N = 645, H = 64; P1 and P4
   also at K = 4): each kernel against its plain version (P5 bit for bit,
   P1-P3 within 1e-5 of the largest output, P4 by the bf16 rule), two
   calls bitwise equal, P1's and P4's numpy oracles, P2's ``both`` and
   P3's ``two_dots`` bit for bit against K1/K2 on the same inputs, and
   K1-K4's registers beside the parent tree's; then, launch counters set
   to 0, CUDA-event times of each kernel, its plain version and, for P5,
   ``torch.sum``, with bounds, and P5 on the device alone (a replayed CUDA
   graph) with its GB/s beside the card's 3.35 TB/s; K1's phase-4 time is
   printed beside P3's parts, and P5's int8 read beside P3's ``dma_only``.
   P5 streams the used relations in tiles of n2 16-byte vectors on a grid
   of SMs x resident blocks (its grid, blocks an SM and registers are
   printed), loads software-pipelined, ``conv`` through the paired sweep's
   own ``s8x4_to_bf16``, the blocks' rows added in a fixed order in the
   same launch.  P1-P4 run the paired sweep (P1 at the schedule's cut and
   at one relation a block; P2 and P3 on parts policies at the schedule's
   cut and at kb relations a block).  P6's launches are those of its timing in
   phase 11.  P1-P4's library call is ``torch.bmm``, one a half, at their
   shape;
19. framework shell: ``python -m decagon_tpu_torch.cli`` as a user runs it,
   in-process on the card: a config file for the dummy dataset (500
   proteins, 400 drugs, 3 side effects) at full width (hidden 64 -> 32,
   batch 512), one epoch in chunks of 50 with the iteration CSV, the
   held-out-edge CSV, a checkpoint and the npy export; launch counters set
   to 0 just before, read just after (logged apart from the main path's):
   both paired kernels and K5 must launch, every metric lie in [0, 1].
   Then ``predict.export`` from that checkpoint; the CLI's kernels held
   against their plain versions at its own shapes, with phases 4 and 8's
   tolerances (K1/K2 on the restored parameters, K1/K2-ds and K3/K4 on
   the operands of its first step, K5 on its validation sweep); the
   numpy predictor on relation 0's artifacts and recorded edges, whose
   probabilities must equal the card evaluator's edge by edge (to
   ``SDDMM_REL_TOL`` of the largest logit, or 1) and whose AUROC must
   equal the evaluator's within 1e-4; and one greedy
   selection round (``GreedyActiveLearner`` wired by ``cli.train_once``),
   which must score through K5.

20. mesh (``decagon_tpu_torch/parallel``), in two parts.  (a), right
   after phase 16 on phase 14's graph and split: a world of one rank over
   NCCL, a (1, 1) mesh, the sharded graph with K6's layouts on every edge
   type (seconds, GiB); launch counters set to 0, then the mesh
   ``Trainer`` at batch 512 in chunks of 8 (one warm-up, 2 timed; ms a
   step beside phase 16's ``Trainer``) and the evaluator through
   its ``embed_fn`` on relation (1, 1, 0)'s validation edges, which must
   launch K6 and K5, and whose K5 scores must match the plain scorer on
   the same operands; one deterministic step (dropout 0, the same negative
   uniforms) against phase 16's single-process sparse step and against
   the mesh's own ``"pallas_ref"`` step (the loss to ``SPMM_REL_TOL``,
   gradients to ``SPARSE_GRAD_TOL["highest"]``), and K6 against its plain
   version on that step's recorded operands.  (b), at the end: 4
   processes over gloo on this card (a (2, 2) mesh, the dummy config at
   full width, batch 512), "auto" with ``shard_weights`` and "pallas" with
   K6 in every rank: one deterministic step's loss and gradients and the
   embeddings against the single process on the card, K6 launched in
   every rank of the "pallas" run and held against its plain version on
   each rank's own operands, the library of phase 2 loaded, not built
   again.  The mesh launches of (a)
   are added to the main path's.  The ranks of (b) are started with phase
   19, after the last phase whose kernel times enter the report, and do
   their work while phases 19, 22 and 23 run here.
21. sparse regime beyond the paper's scale, run after phase 20 (a) and
   before 17: ``decagon_tpu_torch/scripts/bench_sparse_regime.py``'s
   ``beyond_paper`` config (19,081 proteins, 1,600 drugs, 963 side effects
   with transposes, 6M drug-drug edges; no stack, K6's layouts on every
   edge type), its host graph, split and layouts built through that
   script's own functions by a process of this script's (``--prepare-beyond``)
   started after phase 1, at low priority, while phases 2-20 (a) run, then
   loaded and moved to the card (each stage's seconds, the wait, the
   layouts, the would-be 9.2 GiB drug-drug bf16 stack beside the card's
   memory); K6 against its plain version on the drug-drug layouts (both
   layers, forward and backward, both precisions, with the launch plan
   each call took: the rows join K6's cases); then, launch counters set to
   0, the ``Trainer`` at "default" with ``remat`` off and on from one
   state drawn on the card (one warm-up chunk of 4 and one timed; ms a
   step, peak GiB), one grouped chunk of 32 optimization steps at the
   quality run's ``TrainConfig`` (``scripts/quality_sparse_regime.py``)
   and one evaluation of an epoch: K6 and K5 must launch, K7 once an
   optimization step, K1-K4 never (these launches join the main path's);
   then one drug-drug step's gradients through K6 against its plain
   version at "default", and with ``remat`` against without.
22. ported scripts at a small size, run before phase 20 (b) on one host
   thread while that phase's ranks work (they start with phase 19; each
   phase reports its own failure): seven of the eight ports of the JAX
   package's profilers and quality runs (``decagon_tpu_torch/scripts/``
   ``quality_run``, ``bench_scale`` at "pallas", ``probe_fullscale``,
   ``bench_paired``, ``profile_fullscale_step``, ``profile_factored_ops``,
   ``profile_sddmm``; ``profile_epoch`` and ``bench_scale``'s "xla" line
   were cut to pay for phase 25 and phase 24's additions) through its own functions,
   on the card, at the sizes of its CPU tests (200 proteins, 40 drugs, 4
   side effects): its record must hold the JAX artifact's fields (the
   top-level keys of ``artifacts/perf/<name>.json``, the keys of the line
   ``scripts/bench_scale.py`` prints, read from its text, and the JAX
   quality CSV's columns; nothing of the JAX package is imported), every
   number in it must be finite, and the kernels it names must have
   launched (K7 in every trainer's steps, K5 in every evaluation, K1-K4 on
   the paired paths, K6 where the CSR layouts are read).  The launches
   are the scripts' own, apart from the main path's.
23. the dummy config's quality tools and the step and optimizer probes at
   a small size, right after phase 22 and in the same way: the nine ports
   ``quality_ablation`` (its ``lazy_adam`` variant), ``quality_probe``
   (``refproto``), ``oracle_ceiling`` (host numpy), ``schedule_ablation``
   (``bal_g8``), ``perf_probe`` ("pallas"), ``perf_probe2``,
   ``probe_adam``, ``probe_adam_bf16`` and ``probe_dense_layout``, each
   through its own functions at the sizes of its CPU tests
   (``tests/test_torch_scripts_quality.py``, ``test_torch_scripts_probes.py``):
   the record must hold the JAX record's fields (the keys of an entry of
   ``artifacts/quality/ablation.json``, ``schedule_ablation.json`` and
   ``oracle_ceiling.json``, the top-level keys of
   ``artifacts/perf/adam_probe.json`` and
   ``artifacts/quality/adam_bf16_moments.json``; for the scripts that only
   print, the fields of their printed lines), every number must be
   finite, and K7 must launch once an optimization step of every trainer
   and of ``probe_adam``'s one-pass and flat Adams, K5 in every evaluation
   and K6 on every "pallas" line; ``probe_dense_layout``'s two bf16 forms
   must hold the f32 product within 2^-8 of its largest magnitude (half a
   bf16 step) and each other within 2^-7.  The dummy graph's trainers of
   ``quality_run`` (phase 22), ``quality_ablation`` and ``quality_probe``
   run one epoch each, ``perf_probe`` its "pallas" lines only (its "xla"
   lines share their path).
24. the mesh scripts at a small size (the sizes of
   ``tests/test_torch_scripts_mesh.py``: 200 proteins, 40 drugs, 4 side
   effects), each through its own functions, in three parts.  (a), in phase
   20 (a)'s world of one NCCL rank before it is destroyed:
   ``bench_sharded`` (the single ``Trainer`` and the (1, 1) mesh's, each
   pipelined, synced and chunked, their first steps on the same injected
   draws within ``MESH_LOSS_TOL``), ``diag_sharded`` (no profile) and
   ``hlo_overlap_schedule``'s step with overlap on and off, whose
   collectives NCCL starts asynchronously: the predicted pairs with overlap
   on, none off.  (b), in phase 20 (b)'s ranks right after their phase 20
   work (so it runs while this process runs phases 19, 22, 23 and 25): the
   last rank takes the single process's trace with its points saved, then
   ``multihost_bench``'s (2, 2) traces with f32 and bf16 row reductions and
   the mesh at the saved points with each, ``hlo_collectives``' inventory
   and ``hlo_overlap_schedule``'s step on and off in that world, then two
   worlds of two ranks: ``multihost_sim`` and ``multihost_overlap`` with
   ``comm_overlap`` on in one, off in the other; this process holds the
   (2, 2) trace to the single process's (``multihost_bench.EXACT_TOL``),
   the teacher-forced rule (``multihost_bench.judge``: it must hold on the
   f32 mesh and reject the bf16 one), the inventory's activation terms to
   the formulas, the schedule to no pair (gloo stages every collective of
   a CUDA tensor), on and off to one loss head.  (c) ``scaling_model`` from the
   checked-in records.  Every record holds its JAX fields, every number is
   finite, and K7 launches once a step in every rank and every trainer
   (these launches join K7's line).
25. the public-data ingest at a small scale (``ingest_fullsize.ingest`` at
   ``INGEST_SCALE``: ~10,500 combo rows in the JAX fixture's formats),
   while phase 20 (b)'s ranks run: the native parse equal to the Python
   parse, ``load_public_dataset``, the split, two "xla" steps (K7 once a
   step), then on ``bench.py``'s headline device graph two paired steps
   (K1-K4, K7) and the pooled evaluation with f32 and bf16 tables (K5,
   K5-bf16); every launch counted joins the kernel report.

The line before the kernel report is ``{"phase_seconds": {...}}``: each
phase's seconds by its number (a phase run in parts, "24a" and "24b", also
under "24").

The paired kernels K1/K2 (forward) and K3/K4 (backward) share one sweep
(``decagon_tpu_torch/csrc/paired_core.cuh``): a bf16 operand pass, then
16-byte ``cp.async`` mask staging in a three-stage ring with one barrier a
chunk, each warp converting the bytes it consumes, ``ldmatrix`` /
``ldmatrix.trans`` and ``mma.sync`` with the row scales applied in
registers, and relations and contraction cut into whole waves by
``ops/spmm_paired.paired_schedule``.

The sparse kernel K6 (``decagon_tpu_torch/csrc/spmm_tiled.cu``) sums
short rows (at most 32 edges) chunk by chunk from shared memory, with the
source table there too where it fits, gives each segment of a longer row
(at most 256 edges, cut at source windows) a group of lanes with 16-byte
loads, and adds a long row's partial sums in order in a second pass.  The scorer K5
(``decagon_tpu_torch/csrc/sddmm.cu``) gives an edge one to four lanes,
keeps its product row in registers and reads the d x d matrices from
shared memory, staged once a block; K5-bf16 reads bf16 tables, 16 bytes
(8 elements) a load.  The optimizer K7 (``decagon_tpu_torch/csrc/adam.cu``)
updates every leaf of a step in one launch: a table of up to 48 leaves
passed by value, a run of blocks a leaf, 8 elements a thread in 16-byte
vectors, the gradient's bf16 cast done as it is read.

The lines before the last are the phase seconds, the kernel report (one
JSON object) and the ``nvidia-smi`` line; the last line is ``{"ok": true,
"device": ...}``.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.  Any failure raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()

from decagon_tpu_torch.scripts.probing import (  # noqa: E402
    card, cuda_ms, device_ms, sddmm_cases, spmm_cases,
)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s,
# bf16 tensor-core and plain f32 FLOP/s.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# Kernel-vs-plain tolerances.  Paired forward and backward: both round the
# same operands to bf16 and the products are exact, so only the f32 sums
# differ (tensor-core accumulation and order): max error <= 1e-4 of the
# largest output.  A bf16 backward output may then round to the
# neighbouring bf16 value (one ulp, <= 2^-7 of the element), so it is held
# elementwise to 2^-7 |plain| + 1e-4 max|plain|.  Scorer: f32 throughout,
# order only: <= 1e-5 of max(1, largest score).
PAIRED_REL_TOL = 1e-4
BF16_ULP = 2.0 ** -7
SDDMM_REL_TOL = 1e-5
# K5-bf16 against K5 (phase 4): bf16 tables move a score by up to ~2^-8 of
# each of its terms; the reference states ~1e-2 relative.  Held to 1e-2
# of the largest "highest" score.
SDDMM_BF16_TOL = 1e-2
# K6 against its plain version (phases 15, 17): the same roundings, f32
# sums in other orders (segment, then partials, against index_add_'s):
# <= 1e-5 of the largest output.
SPMM_REL_TOL = 1e-5
# Timed calls of K6 and of torch.sparse.mm a case (phase 15): the smaller
# edge types take ~0.03 ms, where a few calls read the host's noise.
SPMM_REPS = 20
# Whole-step gradients, kernels against plain versions (same parameters,
# dropout bits and negatives), each leaf to 2^-6 of its largest magnitude.
# The kernels and the plain versions sum in f32 in other orders, and the
# path from the loss back to a layer-1 weight gradient holds up to four
# bf16 roundings that such differences can flip, each at most 2^-8 of its
# value (8-bit significand): the layer-2 operand (projection times column
# scale), the layer-2 backward's bf16 output or its a * ct, the layer-1
# a * ct, and on the paired types the keep-scale backward, where the
# kernel rounds a * ct and the plain version (autograd of paired_ref_ds,
# as in the JAX package) rounds the product.  4 x 2^-8 = 2^-6.  Each
# kernel alone, on identical inputs, is held to 1e-4 in phase 8.
STEP_GRAD_TOL = 2.0 ** -6
# Phase 16, one step's gradients through K6 against its plain version:
# "highest" to 1e-4 of each leaf's max (f32 sums in other orders, as the
# CPU tests hold the encoder); "default" to STEP_GRAD_TOL, since layer 2's
# projection and every cotangent K6 reads are rounded to bf16 after f32
# sums that the two paths take in other orders, and a flipped rounding of
# one cotangent element moves each gradient element it reaches by up to
# 2^-7 of its term.
SPARSE_GRAD_TOL = {"highest": 1e-4, "default": STEP_GRAD_TOL}
# remat against no remat (phase 16): the same kernels on the same bits
# (drawn before the checkpointed region), deterministic algorithms: equal
# bits expected; held to 1e-6 of each leaf's max.
REMAT_TOL = 1e-6
SPARSE_TRAIN_STEPS = {(1, 1): 2, (0, 0): 1}
SPARSE_CHUNK, SPARSE_WINDOWS = 8, 2
# Phase 16's Trainer runs at "default" only (its "highest" Trainer was cut
# to keep the run in its time budget; bench_sparse_regime.py's pallas_f32
# times "highest" at every size).
SPARSE_TRAINER_PRECISIONS = ("default",)
TRAIN_STEPS = {(1, 1): 4, (0, 0): 2}
TRAINER_CHUNK = 32
TRAINER_WINDOWS = 2
PALLAS_CHUNK = 4
# Phase 12b: the quality run's grouped Trainer (batches an optimization
# step, chunk in optimization steps, timed chunks after one warm-up, the
# cosine's horizon in optimization steps).
GROUP, GROUPED_CHUNK, GROUPED_WINDOWS, GROUPED_LR_STEPS = 8, 32, 1, 300
# Phase 12 holds the ``pallas_adam`` chunk against the plain version's to
# this share of each leaf's largest magnitude where the two are not equal
# bit for bit (the kernel rounds as the plain chain does); the default
# config's chunk must be equal bit for bit.
PALLAS_REL_TOL = 1e-6
# Epochs of the dummy-config gate (phase 13).  The JAX test reads after 3,
# where the port's pooled test AUROC reaches 0.62 for only some trainer
# seeds; after 8 every seed swept clears it by 0.027 or more
# (``python -m decagon_tpu_torch.scripts.quality_sweep``).
GATE_EPOCHS = 8
# Phase 5's split of the warm pooled evaluation: clocked calls of the
# evaluator, each beside one without the clocks.
SPLIT_REPS = 3

PAPER = dict(
    n_proteins=19081, n_drugs=645, n_side_effects=963,
    min_edges_per_relation=500, total_drugdrug_edges=4_651_131,
    ppi_attachment=37, seed=7,
)
SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=6, min_edges_per_relation=20,
    ppi_attachment=5, seed=7,
)


# (number, start) of every phase, in order: ``phase_seconds``.
PHASES = []


def phase(name: str, number: str) -> None:
    PHASES.append((number, time.perf_counter() - T0))
    print(f"[{time.perf_counter() - T0:7.1f}s] phase: {name}", flush=True)


def phase_seconds() -> dict:
    """Each phase's seconds, up to the next phase's start; a phase run in
    parts ("24a", "24b") also gets its sum under its number."""
    out = {}
    ends = [t for _, t in PHASES[1:]] + [time.perf_counter() - T0]
    for (number, start), end in zip(PHASES, ends):
        out[number] = out.get(number, 0.0) + end - start
        if number[:-1].isdigit() and number[-1].isalpha():
            out[number[:-1]] = out.get(number[:-1], 0.0) + end - start
    return {k: round(v, 2) for k, v in out.items()}


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s]   {msg}", flush=True)


def build_state(kw, device, seed):
    import torch

    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator

    t = time.perf_counter()
    graph = make_polypharmacy_like_graph(**kw)
    log(f"graph {time.perf_counter() - t:.1f}s: "
        f"{ {et: len(r) for et, r in sorted(graph.relations.items())} } relations")
    t = time.perf_counter()
    splits = split_graph(graph, val_frac=0.05, test_frac=0.05, seed=1)
    log(f"split {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    dg = build_device_graph(
        graph, splits, densify_max_cells=1_000_000_000,
        dense_factored=True, dense_paired=True, build_fused=False, device=device,
    )
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"device graph {time.perf_counter() - t:.1f}s; paired edge types "
        f"{sorted(k for k, a in dg.adj.items() if a.pair_mask is not None)}; "
        f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    model = DecagonModel(
        ModelConfig(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="paired"), dg
    )
    params = model.init_params(torch.Generator().manual_seed(seed), dg)
    evaluator = AccuracyEvaluator(model, graph, splits, device=device)
    return graph, splits, dg, model, params, evaluator


def paired_cases(dg, params, model):
    """(label, p4, mask, scales) for both paired edge types and both
    layers, with the main path's own operands."""
    import torch

    from decagon_tpu_torch.models.encoder import _project_t, encode_layer

    h1 = encode_layer(params, dg, "enc1", dg.features, True, model.config.spmm_impl)
    cases = []
    for key, src in (("1,1", "1"), ("0,0", "0")):
        adj = dg.adj[key]
        p2 = _project_t(h1[src], params["enc2"][key]).to(torch.bfloat16).contiguous()
        for layer, p4 in (("layer 1 f32", params["enc1"][key]), ("layer 2 bf16", p2)):
            cases.append((f"({key}) {layer}", p4, adj.pair_mask, adj.pair_scales))
    return cases


def bmm_library_ms(mask, qd, qt):
    """CUDA-event ms of the ``torch.bmm`` yardstick (``paired_bmm``: one
    call a half) on the direct and transposed operands ``[K, H, N]``.  The
    mask's bf16 copy, the operands' layout, the row scales and the sum
    over relations stay outside the timed region."""
    from decagon_tpu_torch.ops.spmm_paired import paired_bmm, paired_bmm_inputs

    m16, qd, qt = paired_bmm_inputs(mask, qd, qt)
    return cuda_ms(lambda: paired_bmm(m16, qd, qt), reps=5)


def sweep_fields(which, k, n, h, device):
    """The paired sweep kernel's registers and blocks an SM (as the card
    reports them) and the schedule's cut and waves for one call."""
    from decagon_tpu_torch.ops.spmm_paired import kernel_info, launch_schedule

    info = kernel_info(which, device.index or 0)
    sched = launch_schedule(which, k, n, h, device)
    return dict(registers=info["registers"], blocks_per_sm=info["blocks_per_sm"],
                splits=[sched.rel_splits, sched.con_splits], blocks=sched.blocks,
                waves=sched.waves)


def check_paired(dg, params, model):
    import torch

    from decagon_tpu_torch.ops.spmm_paired import paired_fwd, paired_operands, paired_ref

    rows = []
    for label, p4, mask, scales in paired_cases(dg, params, model):
        got = paired_fwd(p4, mask, scales)
        again = paired_fwd(p4, mask, scales)
        want = paired_ref(p4, mask, scales)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"paired_fwd {label}: two calls differ")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        k, h, n = p4.shape[1], p4.shape[2], p4.shape[3]
        nnz = int(torch.count_nonzero(mask))
        nbytes = mask.numel() + p4.numel() * p4.element_size() + scales.numel() * 4 + n * h * 4
        flops = 4 * h * nnz  # two products over the mask's nonzeros
        row = dict(
            case=label, K=k, N=n, H=h, dtype=str(p4.dtype).replace("torch.", ""),
            max_abs_err=err, rel_err=err / scale,
            bitwise_repeat=True,
            ms=cuda_ms(lambda: paired_fwd(p4, mask, scales), reps=5),
            plain_ms=cuda_ms(lambda: paired_ref(p4, mask, scales), reps=3),
            library_ms=bmm_library_ms(mask, *paired_operands(p4, scales)),
            bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=flops / BF16_FLOPS * 1e3,
            **sweep_fields("fwd", k, n, h, p4.device),
        )
        log(json.dumps(row))
        if not row["rel_err"] <= PAIRED_REL_TOL:
            raise AssertionError(f"paired_fwd {label}: relative error {row['rel_err']:.3g} > {PAIRED_REL_TOL}")
        rows.append(row)
    return rows


def sddmm_flops(name, ks, rows, n_rows, d):
    """The least f32 operations the scores need on this data: the d x d
    product of a row with its relation's matrix once per distinct
    (row, relation) pair, then per edge the column's scaling and the dot
    product.  DEDICOM: 2d^2 + d per pair (z_r * d_k, then @ G), 3d per
    edge; bilinear: 2d^2 per pair (z_r @ R_k), 2d per edge."""
    import torch

    pairs = torch.unique(ks.long() * n_rows + rows.long()).numel()
    b = ks.numel()
    if name == "dedicom":
        return pairs * (2 * d * d + d) + b * 3 * d
    if name == "bilinear":
        return pairs * 2 * d * d + b * 2 * d
    raise ValueError(f"no operation count for {name!r}")


def check_sddmm(dg, params, emb, splits, seed):
    """K5 and K5-bf16 against their plain versions on each case; K5-bf16
    also within ``SDDMM_BF16_TOL`` of K5.  Returns (f32 rows, bf16 rows)."""
    import torch

    from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges, sddmm_plain

    rows_out = {"highest": [], "default": []}
    for label, zr, zc, ks, rows, cols, kw in sddmm_cases(dg, params, emb, splits, seed):
        scores = {}
        for precision, tag in (("highest", ""), ("default", ", bf16 tables")):
            # K5-bf16 takes the bf16 tables that the scorer casts once a pass.
            cast = (lambda t: t.to(torch.bfloat16)) if precision == "default" else (lambda t: t)
            tr, tc = cast(zr), cast(zc)
            tkw = {k: cast(v) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}

            def kernel():
                return sddmm_edges(tr, tc, ks, rows, cols, precision=precision, **tkw)

            def plain():
                return sddmm_plain(zr, zc, ks, rows, cols, precision=precision, **kw)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            scores[precision] = got
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            b, d = ks.numel(), zr.shape[1]
            itemsize = 2 if precision == "default" else 4
            tables = {t.data_ptr(): t.numel() * itemsize for t in (zr, zc, *kw.values())
                      if isinstance(t, torch.Tensor)}
            row = dict(
                case=label + tag, edges=b, d=d, max_abs_err=err, rel_err=err / scale,
                ms=cuda_ms(kernel, reps=10), device_ms=device_ms([kernel], 10),
                plain_ms=cuda_ms(plain, reps=3),
                bytes_ms=(16 * b + sum(tables.values())) / HBM_BYTES_S * 1e3,
                ops_ms=sddmm_flops(kw["name"], ks, rows, zr.shape[0], d) / F32_FLOPS * 1e3,
            )
            if precision == "default":
                high = scores["highest"]
                row["rel_to_highest"] = ((got - high).abs().max() / high.abs().max()).item()
            log(json.dumps(row))
            if not row["rel_err"] <= SDDMM_REL_TOL:
                raise AssertionError(f"sddmm {label}{tag}: error {err:.3g} > {SDDMM_REL_TOL} x {scale:.3g}")
            if not row.get("rel_to_highest", 0.0) <= SDDMM_BF16_TOL:
                raise AssertionError(f"sddmm {label}{tag}: {row['rel_to_highest']:.3g} from "
                                     f"'highest', past {SDDMM_BF16_TOL}")
            rows_out[precision].append(row)
    return rows_out["highest"], rows_out["default"]


def serve(graph, splits, dg, model, params, evaluator):
    """The requests, through the evaluator a user calls; then the
    validation sweep through an evaluator with ``sddmm_impl="pallas"``."""
    import dataclasses

    import torch

    from decagon_tpu_torch.models.model import DecagonModel
    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.timing import hard_sync
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator

    cuda_build.reset_launches()
    t = time.perf_counter()
    emb = evaluator.embeddings(params, dg)
    hard_sync(emb)
    log(f"embedding {1e3 * (time.perf_counter() - t):.1f} ms")
    for key, n in (("0", dg.num_nodes[0]), ("1", dg.num_nodes[1])):
        if tuple(emb[key].shape) != (n, 32) or not bool(torch.isfinite(emb[key]).all()):
            raise AssertionError(f"embedding {key}: shape {tuple(emb[key].shape)} or non-finite")
    results = {}
    for use_test in (False, True):
        t = time.perf_counter()
        s = evaluator.evaluate_all_drug_drug(params, dg, use_test=use_test, embeddings=emb)
        results[f"drug-drug {'test' if use_test else 'val'}"] = (s, time.perf_counter() - t)
    for key in ((0, 0, 0), (0, 1, 0), (1, 0, 0)):
        t = time.perf_counter()
        s = evaluator.evaluate(params, dg, key, embeddings=emb)
        results[f"relation {key}"] = (s, time.perf_counter() - t)
    counts = dict(cuda_build.LAUNCHES)
    forced = AccuracyEvaluator(
        DecagonModel(dataclasses.replace(model.config, sddmm_impl="pallas"), dg), graph, splits,
        device=dg.device,
    )
    cuda_build.reset_launches()
    t = time.perf_counter()
    s = forced.evaluate_all_drug_drug(params, dg, use_test=False, embeddings=emb)
    results["drug-drug val, sddmm_impl='pallas'"] = (s, time.perf_counter() - t)
    forced_counts = dict(cuda_build.LAUNCHES)
    if forced_counts["sddmm"] <= 0:
        raise AssertionError("sddmm_impl='pallas' did not launch K5")
    auto = results["drug-drug val"][0]
    if (s.auroc, s.auprc, s.apk) != (auto.auroc, auto.auprc, auto.apk):
        raise AssertionError(f"sddmm_impl='pallas' metrics {s} differ from 'auto' {auto}")
    for name, (s, secs) in results.items():
        log(f"{name}: auroc {s.auroc:.4f} auprc {s.auprc:.4f} apk {s.apk:.4f} ({1e3 * secs:.1f} ms)")
        for v in (s.auroc, s.auprc, s.apk):
            if not 0.0 <= v <= 1.0:
                raise AssertionError(f"{name}: metric {v} outside [0, 1]")
    log(f"launches {counts}; the sweep with sddmm_impl='pallas' (not in the report's "
        f"counts) {forced_counts}")
    for name in ("paired_fwd", "sddmm"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the serving path")
    from decagon_tpu_torch.scripts.profile_sddmm import split_evaluation

    split = split_evaluation(evaluator, params, dg, emb, reps=SPLIT_REPS)
    log(f"the warm pooled validation evaluation split: "
        f"{json.dumps({k: split[k] for k in split['parts'] + ['parts_sum_ms', 'other_ms']})} "
        f"against {split['whole_ms_median']:.2f} ms (interquartile {split['whole_ms_q1']:.2f}-"
        f"{split['whole_ms_q3']:.2f}, clocked {split['clocked_total_ms_median']:.2f}; within: "
        f"{split['clocked_within_whole_iqr']}), each call's parts and rest within "
        f"{split['call_residual_share_max']:.2%} of its total, scorer launches "
        f"{split['scoring_launches']}")
    if not split["scoring_launches"].get("sddmm") or not all(
            split[k] >= 0 for k in split["parts"]) or split["auroc"] != auto.auroc \
            or not split["parts_add_up_in_each_call"]:
        raise AssertionError(f"the evaluation split: {split}")
    return counts, split


def small_reference(device):
    """The whole slice through the kernels against the same slice through
    the plain versions (the path the CPU tests hold against the JAX
    package), on a small graph, on the card, with the same weights, one
    layer at a time: layer 1 on the features, layer 2 on the kernels'
    layer-1 output, and the evaluator on the kernels' embeddings, each to
    the CPU tests' 1e-4.

    Run end to end instead, the two paths feed layer 2 different h1, and
    the layer-2 projection, rounded to bf16 before the aggregation, can
    then round to neighbouring bf16 values; the count of such operands
    and the end-to-end difference are printed, not held to a bound."""
    import dataclasses

    import torch

    from decagon_tpu_torch.models.encoder import _project_t, encode_layer
    from decagon_tpu_torch.models.model import DecagonModel
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator

    def hold(label, got, want, tol=1e-4):
        for key in want:
            if not torch.isfinite(got[key]).all():
                raise AssertionError(f"small graph {label} {key} is not finite")
            err = (got[key] - want[key]).abs().max().item()
            bound = tol * max(1.0, want[key].abs().max().item())
            log(f"small graph {label} {key}: max abs err {err:.3g} (bound {bound:.3g})")
            if not err <= bound:
                raise AssertionError(f"small graph {label} {key} differs by {err}")

    graph, splits, dg, model, params, ev = build_state(SMALL, device, seed=0)
    plain = DecagonModel(
        dataclasses.replace(model.config, spmm_impl="paired_ref", sddmm_impl="jnp"), dg
    )
    ev_plain = AccuracyEvaluator(plain, graph, splits, device=device)
    h1 = encode_layer(params, dg, "enc1", dg.features, True, "paired")
    h1_plain = encode_layer(params, dg, "enc1", dg.features, True, "paired_ref")
    hold("layer 1", h1, h1_plain)
    emb = encode_layer(params, dg, "enc2", h1, False, "paired")
    hold("layer 2 on the same h1", emb, encode_layer(params, dg, "enc2", h1, False, "paired_ref"))
    for key in ("1,1", "0,0"):
        src = key[0]
        p2, p2_plain = (
            _project_t(h[src], params["enc2"][key]).to(torch.bfloat16)
            for h in (h1, h1_plain)
        )
        log(f"small graph ({key}) layer-2 bf16 operands that differ when each path "
            f"runs its own layer 1: {int((p2 != p2_plain).sum())} of {p2.numel()}")
    emb_plain = ev_plain.embeddings(params, dg)
    log("small graph embeddings end to end, max abs differences: " + ", ".join(
        f"{k} {(emb[k] - emb_plain[k]).abs().max().item():.3g}" for k in emb))
    a = ev.evaluate_all_drug_drug(params, dg, embeddings=emb)
    b = ev_plain.evaluate_all_drug_drug(params, dg, embeddings=emb)
    log(f"small graph drug-drug auroc/auprc/apk {a.auroc:.6f} {a.auprc:.6f} {a.apk:.6f} "
        f"(kernels), {b.auroc:.6f} {b.auprc:.6f} {b.apk:.6f} (plain), same embeddings")
    for m in ("auroc", "auprc", "apk"):
        if not abs(getattr(a, m) - getattr(b, m)) <= 1e-4:
            raise AssertionError(f"small graph {m} differs between kernels and plain versions")


def _paired_bytes_ops(mask, k, h, n, in_bytes, out_bytes):
    """Least bytes (each input once, each output once) and operations
    (two products over the mask's nonzeros) of one paired call."""
    import torch

    nnz = int(torch.count_nonzero(mask))
    return mask.numel() + in_bytes + out_bytes + k * 4 * n * 4, 4 * h * nnz


def _bwd_hold(got, want, bf16):
    """(max abs error, error relative to the largest plain value); raises
    past the bound (module constants)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    top = want.abs().max().item()
    bound = PAIRED_REL_TOL * top + (BF16_ULP * want.abs() if bf16 else 0.0)
    if not bool((err <= bound).all()):
        raise AssertionError(f"relative error {err.max().item() / top:.3g} past the bound")
    return err.max().item(), err.max().item() / top


class Recorder:
    """Wraps the paired kernels' wrappers to keep the operands of the
    keep-scale forwards and of the backwards, one per (edge type, layer),
    while ``on`` (the operands themselves: a step does not change them,
    it makes new parameters)."""

    def __init__(self):
        import decagon_tpu_torch.ops.spmm_paired as sp

        self.sp = sp
        self.orig = (sp.paired_fwd, sp.paired_bwd)
        self._fwd, self._bwd = {}, {}
        self.on = False

        def fwd(p4, mask, scales, ds=None):
            if self.on and ds is not None:
                self._fwd.setdefault(mask.data_ptr(), (p4, mask, scales, ds))
            return self.orig[0](p4, mask, scales, ds)

        def bwd(ct, mask, scales, ds, out_dtype):
            if self.on and (mask.data_ptr(), ds is None) not in self._bwd:
                self._bwd[(mask.data_ptr(), ds is None)] = (
                    ct.detach().clone(), mask, scales, ds, out_dtype)
            return self.orig[1](ct, mask, scales, ds, out_dtype)

        sp.paired_fwd, sp.paired_bwd = fwd, bwd

    @property
    def fwd(self):
        return list(self._fwd.values())

    @property
    def bwd(self):
        return list(self._bwd.values())

    def close(self):
        self.sp.paired_fwd, self.sp.paired_bwd = self.orig

    def require(self, where):
        """Raises unless both paired edge types' keep-scale forwards and
        both layers' backwards were recorded."""
        if not all(r[3] is not None for r in self.fwd) or len(self.fwd) != 2 or len(self.bwd) != 4:
            raise AssertionError(f"{where}: recorded {len(self.fwd)} ds forwards, "
                                 f"{len(self.bwd)} backwards")


def _batch(splits, et, k, n, seed):
    import numpy as np
    import torch

    edges = splits[et + (k,)].train
    idx = np.random.default_rng(seed).integers(0, edges.shape[0], n)
    return (torch.from_numpy(edges[idx, 0].astype(np.int32)).cuda(),
            torch.from_numpy(edges[idx, 1].astype(np.int32)).cuda())


def _draws(dg, params, model, cfg, gen):
    """One step's dropout bits per layer and negative uniforms, drawn from
    ``gen``, for feeding two paths the same randomness."""
    import torch

    from decagon_tpu_torch.models.encoder import draw_layer_bits

    c = model.config
    bits = draw_layer_bits(params, dg, gen, c.dropout, c.spmm_impl, c.per_relation_dropout_max)
    return bits, torch.rand(cfg.batch_size, generator=gen, device=gen.device)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in tree:
            out.update(_leaves(tree[key], f"{prefix}/{key}"))
        return out
    return {prefix: tree}


def timed_steps(step, params, state, dg, splits, et, n_steps, seed, step_no, on_step=None):
    """``n_steps`` calls of a ``make_train_step`` step on edge type ``et``,
    each timed on the host clock and split into forward, backward and Adam
    by CUDA events; ``on_step(i)`` runs before step ``i`` (and ``on_step(
    None)`` after it).  Returns (params, state, summary, next step_no)."""
    import statistics

    import torch

    from decagon_tpu_torch.train.step import step_generator

    times, splits_ms, losses = [], [], []
    for i in range(n_steps):
        k = i % dg.num_relations(et)
        rows, cols = _batch(splits, et, k, 512, seed + i)
        events = {"start": torch.cuda.Event(enable_timing=True)}

        def marks(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        if on_step is not None:
            on_step(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        events["start"].record()
        params, state, loss = step(params, state, dg, k, rows, cols,
                                   step_generator(seed, step_no, "cuda"), marks=marks)
        step_no += 1
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
        if on_step is not None:
            on_step(None)
        loss = float(loss)
        if not loss == loss or loss in (float("inf"), float("-inf")):
            raise AssertionError(f"train step {et} {i}: loss {loss} is not finite")
        losses.append(loss)
        splits_ms.append({
            "forward": events["start"].elapsed_time(events["forward"]),
            "backward": events["forward"].elapsed_time(events["backward"]),
            "adam": events["backward"].elapsed_time(events["update"]),
        })
        log(f"train {et} step {i} (relation {k}): loss {loss:.4f}, {times[-1]:.1f} ms "
            f"(forward {splits_ms[-1]['forward']:.1f}, backward "
            f"{splits_ms[-1]['backward']:.1f}, adam {splits_ms[-1]['adam']:.1f} ms, CUDA events)")
    rest = splits_ms[1:] or splits_ms
    summary = dict(
        steps=n_steps, losses=losses,
        step_ms_median_after_first=statistics.median(times[1:] or times),
        **{f"{p}_ms_median": statistics.median(x[p] for x in rest)
           for p in ("forward", "backward", "adam")},
    )
    log(f"train {et} summary {json.dumps(summary)}")
    return params, state, summary, step_no


def train(dg, params, model, splits, seed):
    """The training path through the entry points a user calls; returns
    (launch counts, recorder, summary)."""
    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.train.step import TrainConfig, make_optimizer, make_train_step

    cfg = TrainConfig(batch_size=512, loss="hinge", adam_moments_dtype="bfloat16",
                      grad_dtype="bfloat16")
    opt = make_optimizer(cfg)
    state = opt.init(params)
    step_no = 0
    rec = Recorder()
    summary = {}

    def record_first(i):
        rec.on = i == 0

    cuda_build.reset_launches()
    for et, n_steps in TRAIN_STEPS.items():
        step = make_train_step(model, et, cfg, opt)
        params, state, summary[str(et)], step_no = timed_steps(
            step, params, state, dg, splits, et, n_steps, seed, step_no, on_step=record_first)
    counts = dict(cuda_build.LAUNCHES)
    rec.close()
    log(f"train launches {counts}; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("paired_fwd", "paired_bwd"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the training path")
    rec.require("train")
    return counts, rec, summary, params


def hold_gradients(label, got, want, tol=STEP_GRAD_TOL):
    """Each gradient leaf through the kernels against the plain versions',
    to ``tol`` of the leaf's largest magnitude; logs every leaf, then
    raises if any is past the bound.  Returns the worst relative error."""
    worst, bad = 0.0, []
    for name, w in want.items():
        err = (got[name].float() - w.float()).abs().max().item()
        rel = err / max(w.abs().max().item(), 1e-30)
        worst = max(worst, rel)
        log(f"{label} {name}: max abs err {err:.3g}, {rel:.3g} of its max "
            f"(bound {tol:.3g})")
        if not rel <= tol:
            bad.append(name)
    if bad:
        raise AssertionError(f"{label}: {bad} past the bound")
    return worst


def step_gradients(dg, params, model, splits, seed):
    """One (1,1) step's loss and gradients through the kernels against the
    same step through the plain versions (``spmm_impl="paired_ref"``),
    with the same parameters, dropout bits and negatives."""
    import dataclasses

    import torch

    from decagon_tpu_torch.models.model import DecagonModel
    from decagon_tpu_torch.train.step import TrainConfig, make_loss_fn, value_and_grad

    cfg = TrainConfig(batch_size=512)
    plain = DecagonModel(dataclasses.replace(model.config, spmm_impl="paired_ref"), dg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    bits, u = _draws(dg, params, model, cfg, gen)
    rows, cols = _batch(splits, (1, 1), 7, cfg.batch_size, seed + 100)
    out = []
    for m in (model, plain):
        loss, grads = value_and_grad(make_loss_fn(m, (1, 1), cfg), params, dg, 7, rows, cols,
                                     None, None, layer_bits=bits, neg_u=u)
        out.append((float(loss), _leaves(grads)))
    (lk, gk), (lp, gp) = out
    log(f"step gradients: loss {lk:.6f} (kernels) {lp:.6f} (plain)")
    if not abs(lk - lp) <= STEP_GRAD_TOL * abs(lp):
        raise AssertionError("step loss differs between kernels and plain versions")
    return hold_gradients("step gradient", gk, gp)


def check_training_kernels(dg, rec, synthetic=True):
    """K1/K2-ds and K3/K4 against their plain versions on the operands the
    first train step gave them (recorded on ``dg``'s layout, edge types
    told apart by mask shape), plus, with ``synthetic``, a K > 1, N > 4096
    case."""
    import torch

    from decagon_tpu_torch.ops.spmm_paired import (
        paired_bwd, paired_bwd_operands, paired_bwd_ref, paired_fwd, paired_operands,
        paired_ref_ds,
    )

    names = {tuple(a.pair_mask.shape): key for key, a in dg.adj.items()
             if a.pair_mask is not None}
    fwd_rows, bwd_rows = [], []
    for p4, mask, scales, ds in rec.fwd:
        got = paired_fwd(p4, mask, scales, ds)
        again = paired_fwd(p4, mask, scales, ds)
        want = paired_ref_ds(p4, mask, scales, ds)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("paired_fwd with keep-scales: two calls differ")
        err, rel = _bwd_hold(got, want, bf16=False)
        k, h, n = p4.shape[1], p4.shape[2], p4.shape[3]
        nbytes, flops = _paired_bytes_ops(mask, k, h, n, p4.numel() * 4 + ds.numel() * 4, n * h * 4)
        row = dict(case=f"({names[tuple(mask.shape)]}) layer 1 f32, keep-scales", K=k, N=n, H=h,
                   max_abs_err=err, rel_err=rel, bitwise_repeat=bool(torch.equal(got, again)),
                   ms=cuda_ms(lambda: paired_fwd(p4, mask, scales, ds), reps=5),
                   plain_ms=cuda_ms(lambda: paired_ref_ds(p4, mask, scales, ds), reps=3),
                   library_ms=bmm_library_ms(mask, *paired_operands(p4, scales, ds)),
                   bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=flops / BF16_FLOPS * 1e3,
                   **sweep_fields("fwd", k, n, h, p4.device))
        row["x_bound"] = row["ms"] / max(row["bytes_ms"], row["ops_ms"])
        log(json.dumps(row))
        fwd_rows.append(row)

    cases = [(f"({names[tuple(r[1].shape)]}) layer {1 if r[3] is not None else 2}, "
              f"{'keep-scales, f32' if r[3] is not None else 'bf16'}", *r) for r in rec.bwd]
    if synthetic:
        g = torch.Generator().manual_seed(5)
        k, n, h = 3, 5000, 64
        big = dict(
            mask=(torch.rand((k, n, n), generator=g) < 0.01).to(torch.int8).cuda(),
            scales=torch.rand((k, 4, n), generator=g).cuda(),
            ds=torch.where(torch.rand((k, 2, n), generator=g) < 0.9, 1 / 0.9, 0.0).float().cuda(),
            ct=torch.randn((h, n), generator=g).cuda(),
        )
        cases += [(f"synthetic K={k} N={n} {lbl}", big["ct"], big["mask"], big["scales"], d, dt)
                  for lbl, d, dt in (("keep-scales, f32", big["ds"], torch.float32),
                                     ("bf16", None, torch.bfloat16))]
    for label, ct, mask, scales, ds, dt in cases:
        got = paired_bwd(ct, mask, scales, ds, dt)
        again = paired_bwd(ct, mask, scales, ds, dt)
        want = paired_bwd_ref(ct, mask, scales, ds, torch.float32)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"paired_bwd {label}: two calls differ")
        err, rel = _bwd_hold(got, want, bf16=dt == torch.bfloat16)
        kk, (h, n) = mask.shape[0], ct.shape
        out_bytes = 2 * kk * h * n * (2 if dt == torch.bfloat16 else 4)
        in_bytes = h * n * 4 + (ds.numel() * 4 if ds is not None else 0)
        nbytes, flops = _paired_bytes_ops(mask, kk, h, n, in_bytes, out_bytes)
        row = dict(case=label, K=kk, N=n, H=h, out=str(dt).replace("torch.", ""),
                   max_abs_err=err, rel_err=rel, bitwise_repeat=True,
                   ms=cuda_ms(lambda: paired_bwd(ct, mask, scales, ds, dt), reps=5),
                   plain_ms=cuda_ms(lambda: paired_bwd_ref(ct, mask, scales, ds, dt), reps=3),
                   library_ms=bmm_library_ms(
                       mask, *paired_bwd_operands(ct, scales, kk).flip(0)),
                   bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=flops / BF16_FLOPS * 1e3,
                   **sweep_fields("bwd", kk, n, h, ct.device))
        row["x_bound"] = row["ms"] / max(row["bytes_ms"], row["ops_ms"])
        log(json.dumps(row))
        if not label.startswith("synthetic"):
            bwd_rows.append(row)
    return fwd_rows, bwd_rows


def adam_steps(label, dg, splits, model, plain, grad_tol, n_steps=3):
    """``n_steps`` Adam steps on drug-drug along ``model``'s trajectory; at
    each step ``plain`` starts from the same parameters, optimizer state,
    dropout bits and negatives (each piece on the same inputs, as the
    small-input reference does).  The loss and each gradient leaf are held
    to ``grad_tol`` of the leaf's largest magnitude.  The updated
    parameters: Adam moves each element by up to about the learning rate
    whatever the gradient's size, so an element whose gradient is near 0
    can move in opposite directions on the two paths; the bound is 2 * lr
    per element (with 2^-10 of it for the f32 rounding of the update and of
    the sum), and the count of elements beyond 1e-4 of the leaf's max is
    printed."""
    import torch

    from decagon_tpu_torch.train.step import (
        TrainConfig, apply_optimizer, cast_grads, make_loss_fn, make_optimizer, value_and_grad,
    )

    params = model.init_params(torch.Generator().manual_seed(0), dg)
    cfg = TrainConfig(batch_size=64)
    opt = make_optimizer(cfg)
    state = opt.init(params)
    gen = torch.Generator(device="cuda").manual_seed(3)
    bound = 2 * cfg.learning_rate * (1 + 2.0 ** -10)
    for s in range(n_steps):
        bits, u = _draws(dg, params, model, cfg, gen)
        k = s % dg.num_relations((1, 1))
        rows, cols = _batch(splits, (1, 1), k, cfg.batch_size, s)
        res = {}
        for name, m in (("kernels", model), ("plain", plain)):
            loss, grads = value_and_grad(make_loss_fn(m, (1, 1), cfg), params, dg, k, rows, cols,
                                         None, None, layer_bits=bits, neg_u=u)
            new, new_state = apply_optimizer(opt, cfg, cast_grads(cfg, grads), state, params)
            res[name] = (float(loss), _leaves(grads), _leaves(new), new, new_state)
        (lk, gk, pk, params, state), (lp, gp, pp, _, _) = res["kernels"], res["plain"]
        worst = hold_gradients(f"{label} step {s} gradient", gk, gp, grad_tol)
        perr = max((pk[n] - w).abs().max().item() for n, w in pp.items())
        beyond = sum(int(((pk[n] - w).abs() > 1e-4 * w.abs().max()).sum()) for n, w in pp.items())
        total = sum(w.numel() for w in pp.values())
        log(f"{label} step {s}: loss {lk:.6f} / {lp:.6f} (kernels / plain); worst "
            f"gradient leaf error {worst:.3g} of its max; updated "
            f"parameters max abs err {perr:.3g} (bound {bound:.3g}), {beyond} of {total} "
            "beyond 1e-4 of their leaf's max")
        if not (abs(lk - lp) <= grad_tol * abs(lp) and perr <= bound):
            raise AssertionError(f"{label} step {s}: kernels and plain versions differ")


def small_training(device):
    """3 Adam steps through the paired kernels and through the plain
    versions (``adam_steps``), gradients to ``STEP_GRAD_TOL``."""
    import dataclasses

    from decagon_tpu_torch.models.model import DecagonModel

    _, splits, dg, model, _, _ = build_state(SMALL, device, seed=0)
    plain = DecagonModel(dataclasses.replace(model.config, spmm_impl="paired_ref"), dg)
    adam_steps("small training", dg, splits, model, plain, STEP_GRAD_TOL)


def _clone(tree, dtype=None):
    import torch

    if isinstance(tree, dict):
        return {key: _clone(value, dtype) for key, value in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone() if dtype is None else tree.detach().to(dtype, copy=True)
    return tree


def trainer_phase(graph, splits, dg, model, seed, step_ms):
    """The ``Trainer`` at paper scale with the default configuration, in
    chunks; returns (launch counts, summary, trainer state)."""
    import torch

    from decagon_tpu_torch.bench import config_metrics, graph_nnz, steady_state_ms
    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.train.step import TrainConfig
    from decagon_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(batch_size=512, scan_chunk=TRAINER_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(model, graph, splits, dg, cfg, seed=seed)
    cuda_build.reset_launches()
    timing = steady_state_ms(trainer, TRAINER_CHUNK, TRAINER_WINDOWS)
    counts = dict(cuda_build.LAUNCHES)
    losses = timing.pop("losses")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"trainer losses not finite: {losses.tolist()}")
    summary = dict(
        steps=len(losses), chunk=TRAINER_CHUNK, first_losses=losses[:4].tolist(),
        last_losses=losses[-4:].tolist(), **config_metrics(graph_nnz(dg), timing),
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        single_step_ms_phase7=step_ms,
        chunk_minus_single_step_ms=timing["median_ms"] - step_ms,
        launches=counts,
    )
    summary["adam_launches_per_step"] = counts["adam"] / len(losses)
    log(f"trainer summary {json.dumps(summary)}")
    log(f"trainer: {summary['ms_per_step_median']:.3f} ms a step (median), peak memory "
        f"{summary['peak_memory_gib']:.2f} GiB, K7 {summary['adam_launches_per_step']:g} "
        "launch(es) a step")
    for name in ("paired_fwd", "paired_bwd"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the Trainer's path")
    if counts["adam"] != len(losses):
        raise AssertionError(f"K7 launched {counts['adam']} times in {len(losses)} steps "
                             "(one launch a step updates every leaf)")
    return counts, summary, _clone(trainer.state_dict())


# Phase 11's leaf tree: the main path's leaves at paper scale (phase 10's
# parameters and bf16 moments) plus a leaf that is a view off 16-byte
# alignment and one whose length is not a multiple of 8; device-timed calls
# a variant.
TREE_EXTRA = {"unaligned": (1_048_581, 3), "odd": (1_000_003, 0)}
TREE_ITERS = 10


def adam_tree(state, seed):
    """(grads, Adam state, params, round_grad) for phase 11: copies of
    ``state``'s parameters and bf16 moments, seeded f32 gradients (those
    of at least 2^20 elements rounded to bf16 by the kernel, as the
    default ``TrainConfig`` asks), and ``TREE_EXTRA``'s two leaves."""
    import torch

    from decagon_tpu_torch.ops.optim import tree_map
    from decagon_tpu_torch.train.step import TrainConfig, grad_rounding

    params = _clone(state["params"])
    device = next(iter(_leaves(params).values())).device
    gen = torch.Generator(device=device).manual_seed(seed)
    opt = {"m": _clone(state["opt_state"]["m"]), "v": _clone(state["opt_state"]["v"]),
           "t": state["opt_state"]["t"]}
    params["extra"], opt["m"]["extra"], opt["v"]["extra"] = {}, {}, {}
    for name, (n, offset) in TREE_EXTRA.items():
        draw = lambda dt, scale=1.0: (scale * torch.randn(  # noqa: E731
            n + offset, generator=gen, device=device)).to(dt)[offset:]
        params["extra"][name] = draw(torch.float32)
        opt["m"]["extra"][name] = draw(torch.bfloat16, 1e-3)
        opt["v"]["extra"][name] = draw(torch.bfloat16, 1e-3).abs()
    grads = tree_map(lambda p: 1e-3 * torch.randn(p.shape, generator=gen, device=device),
                     params)
    return grads, opt, params, grad_rounding(TrainConfig())


def check_adam_tree(state, seed):
    """The main path's whole leaf tree through K7 (one launch, the gradient
    cast in registers) against ``adam_apply_ref`` on the card, bit for bit;
    then device times (``TREE_ITERS`` calls in a replayed CUDA graph) of the
    kernel, the kernel after ``cast_grads``' separate cast, the plain
    chain, and ``torch.optim.Adam(fused=True)`` over the same leaves with
    f32 moments (it keeps no bf16 moments beside f32 parameters); bytes
    and operations bounds of the kernel's own work."""
    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.ops.optim import adam_apply, adam_apply_ref
    from decagon_tpu_torch.scripts.probe_adam_onepass import onepass_flops
    from decagon_tpu_torch.train.step import ADAM_B1, ADAM_B2, ADAM_EPS, TrainConfig, cast_grads

    grads, opt, params, rounds = adam_tree(state, seed)
    kw = dict(lr=1e-3, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS)
    leaves = _leaves(params)
    n = sum(p.numel() for p in leaves.values())
    cuda_build.reset_launches()
    got = adam_apply(grads, opt, params, **kw, round_grad=rounds)
    torch.cuda.synchronize()
    launches = cuda_build.LAUNCHES["adam"]
    want = adam_apply_ref(grads, opt, params, **kw, round_grad=rounds)
    worst, unequal = 0.0, []
    for kind, a, b in (("p", got[0], want[0]), ("m", got[1]["m"], want[1]["m"]),
                       ("v", got[1]["v"], want[1]["v"])):
        for name, w in _leaves(b).items():
            x = _leaves(a)[name]
            if x.dtype != w.dtype or not torch.equal(x, w):
                unequal.append(f"{kind}{name}")
            worst = max(worst, (x.float() - w.float()).abs().max().item() if w.numel() else 0.0)
    del got, want
    log(f"adam leaf tree: {len(leaves)} leaves, {n} elements, {launches} launch(es); "
        f"{len(unequal)} outputs not bitwise equal {unequal[:8]}")
    if unequal or launches != 1:
        raise AssertionError("K7 over the leaf tree differs from adam_apply_ref or took "
                             f"{launches} launches")
    nbytes = sum(x.numel() * x.element_size() for tree in (grads, opt["m"], opt["v"], params)
                 for x in _leaves(tree).values())
    nbytes += sum(x.numel() * x.element_size() for tree in (opt["m"], opt["v"], params)
                  for x in _leaves(tree).values())
    cast = TrainConfig()
    row = dict(
        case=f"paper leaf tree, {len(leaves)} leaves", leaves=len(leaves), elements=n,
        shapes={k: list(p.shape) for k, p in leaves.items()}, bitwise=True,
        max_abs_err=worst, launches_per_call=launches,
        ms=device_ms([lambda: adam_apply(grads, opt, params, **kw, round_grad=rounds)],
                     TREE_ITERS),
        cast_first_ms=device_ms([lambda: adam_apply(cast_grads(cast, grads), opt, params, **kw)],
                                TREE_ITERS),
        plain_ms=device_ms([lambda: adam_apply_ref(grads, opt, params, **kw, round_grad=rounds)],
                           TREE_ITERS),
        library_ms=_fused_adam_ms(grads, opt, params, kw),
        library="torch.optim.Adam(fused=True), f32 moments (it keeps no bf16 moments beside "
                "f32 parameters)",
        bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=onepass_flops(n) / F32_FLOPS * 1e3,
    )
    row["x_bound"] = row["ms"] / max(row["bytes_ms"], row["ops_ms"])
    row["gb_s"] = nbytes / row["ms"] / 1e6
    log(json.dumps({k: v for k, v in row.items() if k != "shapes"}))
    log(f"adam leaf tree shapes {json.dumps(row['shapes'])}")
    torch.cuda.empty_cache()
    return row


def _fused_adam_ms(grads, opt, params, kw):
    """Device ms of one ``torch.optim.Adam(fused=True, capturable=True)``
    step over copies of the tree's leaves, f32 moments from the tree's."""
    import torch

    qs = []
    for name, p in _leaves(params).items():
        q = p.detach().clone().requires_grad_(True)
        q.grad = _leaves(grads)[name].clone()
        qs.append((q, name))
    adam = torch.optim.Adam([q for q, _ in qs], lr=kw["lr"], betas=(kw["b1"], kw["b2"]),
                            eps=kw["eps"], fused=True, capturable=True)
    adam.step()
    m, v = _leaves(opt["m"]), _leaves(opt["v"])
    for q, name in qs:
        adam.state[q]["exp_avg"].copy_(m[name])
        adam.state[q]["exp_avg_sq"].copy_(v[name])
    ms = device_ms([adam.step], TREE_ITERS)
    del adam, qs
    return ms


def check_adam(device, state, seed):
    """Phase 11: the main path's leaf tree (``check_adam_tree``), then the
    one-leaf cases of K7 and its bf16 instantiation against the plain
    chain.  P6's case (``scripts/probe_adam_onepass.py``'s own) is timed
    with the launch counters set to 0 just before and read just after:
    its launches."""
    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.scripts.probe_adam_onepass import make_case, run_case, time_case

    tree_row = check_adam_tree(state, seed)
    cases = [
        ("paper leaf enc1/1,0 [1, 19081, 64] f32", (1, 19081, 64), torch.float32, 0, 20),
        ("P6 shape [1926, 64, 645] f32", (1926, 64, 645), torch.float32, 0, 10),
        ("P6 case [1926, 64, 645] bf16 g/m/v", (1926, 64, 645), torch.bfloat16, 0, 10),
        ("odd length 1,000,003 f32", (1_000_003,), torch.float32, 0, 20),
        ("view at offset 3, 1,048,581 f32", (1_048_581,), torch.float32, 3, 20),
    ]
    rows, p6_launches = [], None
    for label, shape, dtype, offset, iters in cases:
        case = make_case(shape, dtype, device, seed=len(rows), offset=offset)
        if dtype == torch.bfloat16:
            row = run_case(label, case, iters, time_it=False)
            cuda_build.reset_launches()
            time_case(row, case, iters)
            p6_launches = cuda_build.LAUNCHES["adam"]
        else:
            row = run_case(label, case, iters)
        row["x_bound"] = row["ms"] / max(row["bytes_ms"], row["ops_ms"])
        log(json.dumps(row))
        rows.append(row)
        torch.cuda.empty_cache()
    if not p6_launches:
        raise AssertionError("P6's probe path never launched the one-pass Adam")
    return tree_row, rows, p6_launches


def _chunk_state(trainer):
    state = trainer.opt_state
    if "enc" in state:  # the lazy decoder Adam's halves
        state = {kind: {**state["enc"][kind], **state["dec"][kind]} for kind in "mv"}
    return _leaves(trainer.params), _leaves(state["m"]), _leaves(state["v"])


def _lazy_state(opt_state):
    """Phase 10's fused Adam state as ``lazy_decoder_adam``'s: the encoder's
    leaves as they are, the decoder's moments in f32 (the lazy row Adam
    keeps them in the parameters' dtype), one step count."""
    def half(keep, dtype=None):
        return {kind: _clone({key: tree for key, tree in opt_state[kind].items()
                              if (key == "dec") == keep}, dtype) for kind in "mv"}

    import torch

    return {"enc": dict(half(False), t=opt_state["t"]),
            "dec": dict(half(True, torch.float32), t=opt_state["t"])}


def optimizer_chunks(graph, splits, dg, model, seed, state):
    """Phase 12: chunks of ``PALLAS_CHUNK`` steps from copies of phase 10's
    ``state``, each with the launch counters set to 0 just before: the
    default config through K7 and through the plain version
    (``make_chunked_train_step`` given ``make_optimizer(cfg,
    one_pass=adam_apply_ref)``, a path no ``TrainConfig`` field reaches),
    the same pair with ``lazy_decoder_adam`` (the encoder's leaves through
    K7, the decoder's through the lazy row Adam), then ``pallas_adam``
    with f32 moments and gradients (its gate's leaves in place) and the
    plain version at that config.  Parameters and moments must be bitwise
    equal (within ``PALLAS_REL_TOL`` for ``pallas_adam``, as before);
    returns the launch counts of the kernel chunks and a summary."""
    import dataclasses

    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.ops.optim import adam_apply_ref
    from decagon_tpu_torch.timing import hard_sync
    from decagon_tpu_torch.train.step import TrainConfig, make_chunked_train_step, make_optimizer
    from decagon_tpu_torch.train.trainer import Trainer

    default = TrainConfig(batch_size=512, scan_chunk=PALLAS_CHUNK)
    f32 = dataclasses.replace(default, pallas_adam=True, adam_moments_dtype="float32",
                              grad_dtype="float32")
    opt32 = {"m": _clone(state["opt_state"]["m"], torch.float32),
             "v": _clone(state["opt_state"]["v"], torch.float32), "t": state["opt_state"]["t"]}
    lazy = dataclasses.replace(default, lazy_decoder_adam=True)
    starts = {"default": state, "lazy_decoder_adam": dict(
        state, opt_state=_lazy_state(state["opt_state"])), "pallas_adam": dict(
        state, opt_state=opt32)}
    out, counts, summary = {}, {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label, cfg in (("default", default), ("lazy_decoder_adam", lazy),
                           ("pallas_adam", f32)):
            for plain in (False, True):
                trainer = Trainer(model, graph, splits, dg, cfg, seed=seed,
                                  init_state=_clone(starts[label]))
                if plain:
                    # pallas_adam picks the leaves updated in place; the
                    # plain version writes new tensors for every leaf.
                    plain_cfg = dataclasses.replace(cfg, pallas_adam=False)
                    trainer._chunk_fn = make_chunked_train_step(
                        model, dg, plain_cfg, make_optimizer(plain_cfg, one_pass=adam_apply_ref))
                epoch = trainer.scheduler.epoch()
                batches = [next(epoch) for _ in range(PALLAS_CHUNK)]
                cuda_build.reset_launches()
                losses = trainer.train_chunk(batches, PALLAS_CHUNK)
                hard_sync(trainer.params)
                out[plain] = (dict(cuda_build.LAUNCHES), losses.cpu(), _chunk_state(trainer))
                del trainer
            (kc, lk, got), (pc, lp, want) = out[False], out[True]
            log(f"{label} chunk: adam launches {kc['adam']} through K7, {pc['adam']} through "
                f"the plain version; losses {lk.tolist()} / {lp.tolist()}")
            if kc["adam"] != PALLAS_CHUNK or pc["adam"] != 0:
                raise AssertionError(f"{label}: K7 launched {kc['adam']} times in "
                                     f"{PALLAS_CHUNK} steps, {pc['adam']} in the plain chunk")
            worst, unequal = 0.0, []
            for kind, a, b in zip("pmv", got, want):
                for name, w in b.items():
                    if a[name].dtype == w.dtype and torch.equal(a[name], w):
                        continue
                    unequal.append(f"{kind}{name}")
                    err = (a[name].float() - w.float()).abs().max().item()
                    worst = max(worst, err / max(w.float().abs().max().item(), 1e-30))
            log(f"{label} chunk through K7 against the plain version: {len(unequal)} leaves not "
                f"bitwise equal {unequal[:8]}, worst {worst:.3g} of the leaf's max")
            if label != "pallas_adam":
                same = not unequal and torch.equal(lk, lp)
            else:
                same = worst <= PALLAS_REL_TOL and torch.allclose(lk, lp, rtol=1e-5, atol=0.0)
            if not same:
                raise AssertionError(f"{label}: the chunk through K7 differs from the plain one")
            counts[label] = kc
            summary[label] = dict(steps=PALLAS_CHUNK, launches=kc["adam"],
                                  bitwise_equal=not unequal, unequal_leaves=unequal,
                                  worst_rel_err=worst)
    finally:
        torch.use_deterministic_algorithms(False)
    return {name: sum(c[name] for c in counts.values()) for name in counts["default"]}, summary


def grouped_trainer(graph, splits, dg, model, evaluator, seed, state):
    """Phase 12b: the quality run's grouped, balanced, cosine-decayed
    ``Trainer`` from a copy of phase 10's ``state``, timed, then the quality
    run's evaluation of an epoch on its parameters (one embedding, the
    pooled validation and test sweeps; launches and seconds), then one
    grouped chunk through K7 against its plain version; returns (launch
    counts of the timed run, summary)."""
    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.ops.optim import adam_apply_ref
    from decagon_tpu_torch.timing import hard_sync
    from decagon_tpu_torch.train.step import (
        TrainConfig, make_grouped_chunked_train_step, make_optimizer,
    )
    from decagon_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(batch_size=512, learning_rate=3e-3, loss="hinge", margin=0.1,
                      scan_chunk=GROUPED_CHUNK, schedule="balanced", relation_group=GROUP,
                      lr_schedule="cosine", lr_schedule_steps=GROUPED_LR_STEPS, lr_min_frac=0.1)
    per_call = GROUPED_CHUNK * GROUP
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(model, graph, splits, dg, cfg, seed=seed, init_state=_clone(state))
    epoch = trainer.scheduler.epoch()
    batches = [next(epoch) for _ in range(per_call * (GROUPED_WINDOWS + 1))]
    start_step = trainer.opt_step
    cuda_build.reset_launches()
    losses = [trainer.train_chunk(batches[:per_call], GROUPED_CHUNK)]
    hard_sync(trainer.params)
    times = []
    for rep in range(GROUPED_WINDOWS):
        lo = per_call * (1 + rep)
        t0 = time.perf_counter()
        losses.append(trainer.train_chunk(batches[lo:lo + per_call], GROUPED_CHUNK))
        hard_sync(trainer.params)
        times.append((time.perf_counter() - t0) / GROUPED_CHUNK)
    counts = dict(cuda_build.LAUNCHES)
    losses = torch.cat(losses).cpu()
    steps = trainer.opt_step - start_step
    ms = sorted(t * 1e3 for t in times)
    summary = dict(
        config=dict(relation_group=GROUP, schedule="balanced", lr=cfg.learning_rate,
                    lr_schedule="cosine", lr_schedule_steps=GROUPED_LR_STEPS,
                    chunk=GROUPED_CHUNK, start_opt_step=start_step),
        opt_steps=steps, batches=len(batches), window_ms_per_grouped_step=[t * 1e3 for t in times],
        ms_per_grouped_step_min=ms[0], ms_per_batch_min=ms[0] / GROUP,
        first_losses=losses[:4].tolist(), last_losses=losses[-4:].tolist(),
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30, launches=counts,
        adam_launches_per_opt_step=counts["adam"] / steps,
    )
    log(f"grouped trainer: {summary['ms_per_grouped_step_min']:.3f} ms a grouped step of {GROUP} "
        f"batches ({summary['ms_per_batch_min']:.3f} ms a batch, min of {GROUPED_WINDOWS} "
        f"windows {summary['window_ms_per_grouped_step']}), peak memory "
        f"{summary['peak_memory_gib']:.2f} GiB, launches {counts}")
    if not bool(torch.isfinite(losses).all()) or len(losses) != steps:
        raise AssertionError(f"grouped trainer: {len(losses)} losses for {steps} steps, "
                             f"not all finite: {losses.tolist()}")
    if steps != GROUPED_CHUNK * (GROUPED_WINDOWS + 1) or trainer.global_step - state[
            "global_step"] != len(batches):
        raise AssertionError(f"grouped trainer: {steps} optimization steps for {len(batches)} "
                             f"batches in groups of {GROUP}")
    if counts["adam"] != steps:
        raise AssertionError(f"grouped trainer: K7 launched {counts['adam']} times in {steps} "
                             f"optimization steps of {GROUP} batches (one launch a step)")
    for name in ("paired_fwd", "paired_bwd"):
        if counts[name] <= 0:
            raise AssertionError(f"grouped trainer: kernel {name} never launched")
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    emb = evaluator.embeddings(trainer.params, dg)
    val = evaluator.evaluate_all_drug_drug(trainer.params, dg, embeddings=emb)
    test = evaluator.evaluate_all_drug_drug(trainer.params, dg, use_test=True, embeddings=emb)
    summary["evaluation"] = dict(seconds=time.perf_counter() - t0, val_auroc=val.auroc,
                                 test_auroc=test.auroc,
                                 launches={k: v for k, v in cuda_build.LAUNCHES.items() if v})
    del emb
    log(f"grouped trainer's evaluation (embedding, pooled validation and test): "
        f"{json.dumps(summary['evaluation'])}")
    if not all(0.0 <= a <= 1.0 for a in (val.auroc, test.auroc)):
        raise AssertionError(f"grouped trainer's evaluation: AUROC {val.auroc}, {test.auroc}")
    start = trainer.state_dict()
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for plain in (False, True):
            copy = Trainer(model, graph, splits, dg, cfg, seed=seed, init_state=_clone(start))
            if plain:
                copy._chunk_fn = make_grouped_chunked_train_step(
                    model, dg, cfg, make_optimizer(cfg, one_pass=adam_apply_ref))
            epoch = copy.scheduler.epoch()
            group = [next(epoch) for _ in range(PALLAS_CHUNK * GROUP)]
            cuda_build.reset_launches()
            chunk_losses = copy.train_chunk(group, PALLAS_CHUNK)
            hard_sync(copy.params)
            out[plain] = (dict(cuda_build.LAUNCHES)["adam"], chunk_losses.cpu(), _chunk_state(copy))
            del copy
    finally:
        torch.use_deterministic_algorithms(False)
    (ka, lk, got), (pa, lp, want) = out[False], out[True]
    unequal = [f"{kind}{name}" for kind, a, b in zip("pmv", got, want) for name in b
               if not (a[name].dtype == b[name].dtype and torch.equal(a[name], b[name]))]
    log(f"grouped chunk through K7 against the plain version: adam launches {ka} / {pa}, "
        f"losses {lk.tolist()} / {lp.tolist()}, {len(unequal)} leaves not bitwise equal")
    if ka != PALLAS_CHUNK or pa != 0:
        raise AssertionError(f"grouped chunk: K7 launched {ka} times in {PALLAS_CHUNK} steps, "
                             f"{pa} in the plain chunk")
    if unequal or not torch.equal(lk, lp):
        raise AssertionError(f"grouped chunk through K7 differs from the plain one: {unequal[:8]}")
    summary["plain_chunk"] = dict(steps=PALLAS_CHUNK, launches=ka, bitwise_equal=True)
    del trainer
    return counts, summary


def checkpoint_round_trip(trainer, evaluator, seed):
    """One ``MetricsLogger`` epoch with a ``Checkpointer`` (in a temporary
    directory), then a fresh ``Trainer`` restored from it: the same state,
    on the same device."""
    import tempfile

    import torch

    from decagon_tpu_torch.train.checkpoint import Checkpointer
    from decagon_tpu_torch.train.logger import MetricsLogger
    from decagon_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(f"{tmp}/ck", max_to_keep=2, every_n_iterations=10**9)
        logger = MetricsLogger(evaluator, f"{tmp}/log", checkpointer=ck,
                               every_n_iterations=10**9, quiet=True)
        trainer.iteration_hook, trainer.epoch_hook = logger.on_iteration, logger.on_epoch_end
        trainer.train(num_epochs=1)
        logger.close()
        with open(logger.path) as f:
            lines = f.read().splitlines()
        fresh = Trainer(trainer.model, trainer.graph, trainer.splits, trainer.device_graph,
                        trainer.config, seed=seed + 1)
        if not fresh.try_resume(ck):
            raise AssertionError("no checkpoint to restore")
        saved, restored = trainer.state_dict(), fresh.state_dict()
        same = (saved["global_step"], saved["opt_step"]) == (restored["global_step"],
                                                             restored["opt_step"])
        for tree in ("params", "opt_state"):
            a, b = _leaves(saved[tree]), _leaves(restored[tree])
            same = same and a.keys() == b.keys() and all(
                torch.equal(a[k], b[k]) and a[k].device == b[k].device
                if isinstance(a[k], torch.Tensor) else a[k] == b[k] for k in a)
        log(f"metrics log {len(lines)} lines, last {lines[-1]!r}; checkpoint at step "
            f"{ck.latest_step()} restored equal: {same}")
        if not same or ck.latest_step() != trainer.global_step:
            raise AssertionError("checkpoint round trip differs")


def dummy_gate(device, seed):
    """The port's copy of the JAX package's dummy-config quality gate; its
    last epoch is ``checkpoint_round_trip``'s."""
    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_synthetic_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
    from decagon_tpu_torch.train.step import TrainConfig
    from decagon_tpu_torch.train.trainer import Trainer

    graph = make_synthetic_graph(n_genes=500, n_drugs=400, n_drugdrug_types=3, seed=0)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.0, seed=1)
    dg = build_device_graph(graph, splits, device=device)
    model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.1), dg)
    cfg = TrainConfig(batch_size=512, learning_rate=1e-3, num_epochs=1, scan_chunk=50)
    trainer = Trainer(model, graph, splits, dg, cfg, seed=seed)
    evaluator = AccuracyEvaluator(model, graph, splits, device=device)
    before = evaluator.evaluate_all_drug_drug(trainer.params, dg, use_test=True).auroc
    t = time.perf_counter()
    trainer.train(num_epochs=GATE_EPOCHS - 1)
    checkpoint_round_trip(trainer, evaluator, seed)
    after = evaluator.evaluate_all_drug_drug(trainer.params, dg, use_test=True).auroc
    log(f"dummy config: pooled test AUROC {before:.4f} untrained, {after:.4f} after "
        f"{GATE_EPOCHS} epochs ({trainer.global_step} steps, {time.perf_counter() - t:.1f}s)")
    if not (0.4 <= before <= 0.6 and after >= 0.62 and after > before + 0.05):
        raise AssertionError(f"dummy config outside the reference band: {before} -> {after}")
    return dict(auroc_untrained=before, auroc_trained=after, epochs=GATE_EPOCHS,
                steps=trainer.global_step)


def sparse_state(graph, splits, device):
    """Phase 3's host graph and split as the sparse regime builds them
    (``scripts/bench_sparse_regime.py`` ``paper_cap``): no dense or mask
    stack, the CSR layouts of K6 on every edge type, no fused stream."""
    import torch

    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.ops.tiling import tiling_stats

    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    dg = build_device_graph(graph, splits, densify_max_cells=0, tile_for_pallas=True,
                            build_fused=False, device=device)
    torch.cuda.synchronize()
    summary = dict(build_s=time.perf_counter() - t,
                   device_gib=(torch.cuda.memory_allocated() - before) / 2**30, layouts={})
    for key, adj in sorted(dg.adj.items()):
        for direction in ("fwd", "bwd"):
            stats = tiling_stats(getattr(adj, f"tiles_{direction}"))
            summary["layouts"][f"({key}) {direction}"] = stats
            log(f"({key}) {direction}: {json.dumps(stats)}")
    log(f"sparse device graph {summary['build_s']:.1f}s, {summary['device_gib']:.2f} GiB "
        f"on the card; max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dg, summary


def sparse_model(dg, precision, **kw):
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig

    kw = {"spmm_impl": "pallas", **kw}
    return DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.1,
                                    spmm_precision=precision, **kw), dg)


def check_spmm(dg, params, keys=None, prefix=""):
    """K6 against its plain version at both precisions on each case of
    ``probing.spmm_cases`` (those of the edge types ``keys``, all if None;
    labels led by ``prefix``): error, bitwise repeatability, the launch plan
    the wrapper took, CUDA-event ms of the kernel, the plain version and
    ``torch.sparse.mm`` on the same CSR (f32; timed here only), and the
    bounds.  Returns (f32 rows, bf16 rows)."""
    import torch

    from decagon_tpu_torch.ops.spmm_pallas import PLANS, spmm_tiled, spmm_tiled_ref

    out = {"highest": [], "default": []}
    for label, p, _, tiles in spmm_cases(dg, params):
        if keys is not None and not any(label.startswith(f"({k})") for k in keys):
            continue
        label = prefix + label
        csr = torch.sparse_csr_tensor(tiles.row_ptr, tiles.col, tiles.val,
                                      size=(tiles.n_dst, tiles.n_src))
        lib = torch.sparse.mm(csr, p)
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, p), reps=SPMM_REPS)
        distinct = int(torch.unique(tiles.col).numel())
        e, h = tiles.nnz, p.shape[1]
        for precision in ("highest", "default"):
            PLANS.clear()
            got = spmm_tiled(p, tiles, precision)
            (plan,) = PLANS
            again = spmm_tiled(p, tiles, precision)
            want = spmm_tiled_ref(p, tiles, precision)
            torch.cuda.synchronize()
            top = max(want.abs().max().item(), 1e-30)
            err = (got - want).abs().max().item()
            itemsize = 2 if precision == "default" else 4
            nbytes = 8 * e + 4 * (tiles.n_dst + 1) + distinct * h * itemsize + tiles.n_dst * h * 4
            row = dict(
                case=label, precision=precision, rows=tiles.n_dst, nnz=e, H=h,
                distinct_sources=distinct, max_abs_err=err, rel_err=err / top,
                bitwise_repeat=bool(torch.equal(got, again)),
                plan=dict(zip(("vec", "rows_vec", "staged"), plan[5:])),
                ms=cuda_ms(lambda: spmm_tiled(p, tiles, precision), reps=SPMM_REPS),
                plain_ms=cuda_ms(lambda: spmm_tiled_ref(p, tiles, precision), reps=2),
                library_ms=library_ms,
                library_rel_err=((lib - want).abs().max() / top).item(),
                bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=2 * e * h / F32_FLOPS * 1e3,
            )
            row["x_bound"] = row["ms"] / max(row["bytes_ms"], row["ops_ms"])
            log(json.dumps(row))
            if not (row["rel_err"] <= SPMM_REL_TOL and row["bitwise_repeat"]):
                raise AssertionError(f"spmm_tiled {label} {precision}: error {row['rel_err']:.3g} "
                                     f"(bound {SPMM_REL_TOL}), repeat {row['bitwise_repeat']}")
            out[precision].append(row)
        del csr, lib
    return out["highest"], out["default"]


def sparse_training(graph, splits, dg, seed):
    """The sparse regime through the entry points a user calls, launch
    counters set to 0 first: ``make_train_step`` at "default" (2
    drug-drug steps, 1 PPI), the ``Trainer`` at ``SPARSE_TRAINER_PRECISIONS``
    (chunks of ``SPARSE_CHUNK``, one warm-up chunk and ``SPARSE_WINDOWS`` timed), and
    the pooled drug-drug evaluation with ``sddmm_precision="default"``.
    K6 and K5-bf16 must launch, the paired kernels never."""
    import torch

    from decagon_tpu_torch.bench import config_metrics, graph_nnz, steady_state_ms
    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
    from decagon_tpu_torch.train.step import TrainConfig, make_optimizer, make_train_step
    from decagon_tpu_torch.train.trainer import Trainer

    model = sparse_model(dg, "default", sddmm_precision="default")
    params = model.init_params(torch.Generator().manual_seed(seed), dg)
    cfg = TrainConfig(batch_size=512)
    opt = make_optimizer(cfg)
    state = opt.init(params)
    summary, step_no = {"steps": {}, "trainer": {}}, 0
    cuda_build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for et, n_steps in SPARSE_TRAIN_STEPS.items():
        step = make_train_step(model, et, cfg, opt)
        params, state, summary["steps"][str(et)], step_no = timed_steps(
            step, params, state, dg, splits, et, n_steps, seed, step_no)
    summary["steps"]["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    step_launches = dict(cuda_build.LAUNCHES)
    nnz = graph_nnz(dg)
    for precision in SPARSE_TRAINER_PRECISIONS:
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(sparse_model(dg, precision), graph, splits, dg,
                          TrainConfig(batch_size=512, scan_chunk=SPARSE_CHUNK), seed=seed)
        adam_before = cuda_build.LAUNCHES["adam"]
        timing = steady_state_ms(trainer, SPARSE_CHUNK, SPARSE_WINDOWS)
        losses = timing.pop("losses")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"sparse trainer ({precision}) losses not finite")
        summary["trainer"][precision] = dict(
            steps=len(losses), chunk=SPARSE_CHUNK, last_losses=losses[-4:].tolist(),
            **config_metrics(nnz, timing),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
            adam_launches_per_step=(cuda_build.LAUNCHES["adam"] - adam_before) / len(losses),
        )
        if summary["trainer"][precision]["adam_launches_per_step"] != 1:
            raise AssertionError(f"sparse trainer ({precision}): K7 did not launch once a step")
        log(f"sparse trainer ({precision}) {json.dumps(summary['trainer'][precision])}")
        del trainer
    t = time.perf_counter()
    scores = AccuracyEvaluator(model, graph, splits, device=dg.device).evaluate_all_drug_drug(
        params, dg)
    summary["eval_default"] = dict(auroc=scores.auroc, auprc=scores.auprc, apk=scores.apk,
                                   seconds=time.perf_counter() - t)
    counts = dict(cuda_build.LAUNCHES)
    summary["launches"] = counts
    summary["launches_per_step"] = {
        name: step_launches[name] / sum(SPARSE_TRAIN_STEPS.values()) for name in step_launches}
    log(f"sparse path: evaluation at sddmm 'default' {json.dumps(summary['eval_default'])}; "
        f"launches {counts} (the {sum(SPARSE_TRAIN_STEPS.values())} single steps: {step_launches})")
    if counts["spmm_tiled"] <= 0 or counts["sddmm_bf16"] <= 0:
        raise AssertionError(f"K6 or K5-bf16 never launched on the sparse path: {counts}")
    if counts["paired_fwd"] or counts["paired_bwd"]:
        raise AssertionError(f"a paired kernel launched on the sparse path: {counts}")
    if not all(0.0 <= v <= 1.0 for v in (scores.auroc, scores.auprc, scores.apk)):
        raise AssertionError(f"sparse evaluation metrics outside [0, 1]: {scores}")
    return counts, summary, params


def sparse_gradients(dg, params, splits, seed, precisions=("default", "highest")):
    """One drug-drug step's loss and gradients through K6 against its plain
    version ("pallas_ref") at each of ``precisions``, with the same bits and
    negatives; then the same step with ``remat`` against without it
    (the port's own draws from explicit generators): gradients, K6
    launches and peak memory of each."""
    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.train.step import TrainConfig, make_loss_fn, value_and_grad

    cfg = TrainConfig(batch_size=512)
    rows, cols = _batch(splits, (1, 1), 7, cfg.batch_size, seed + 100)
    out = {}
    for precision in precisions:
        model = sparse_model(dg, precision)
        gen = torch.Generator(device="cuda").manual_seed(seed + 100)
        bits, u = _draws(dg, params, model, cfg, gen)
        res = []
        for m in (model, sparse_model(dg, precision, spmm_impl="pallas_ref")):
            loss, grads = value_and_grad(make_loss_fn(m, (1, 1), cfg), params, dg, 7, rows, cols,
                                         None, None, layer_bits=bits, neg_u=u)
            res.append((float(loss), _leaves(grads)))
        (lk, gk), (lp, gp) = res
        log(f"sparse step gradients ({precision}): loss {lk:.6f} (K6) {lp:.6f} (plain)")
        tol = SPARSE_GRAD_TOL[precision]
        if not abs(lk - lp) <= tol * abs(lp):
            raise AssertionError(f"sparse step loss ({precision}) differs between K6 and plain")
        out[precision] = hold_gradients(f"sparse step gradient ({precision})", gk, gp, tol)
    remat = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for on in (False, True):
            model = sparse_model(dg, "default", remat=on)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = cuda_build.LAUNCHES["spmm_tiled"]
            loss, grads = value_and_grad(
                make_loss_fn(model, (1, 1), cfg), params, dg, 7, rows, cols,
                torch.Generator(device="cuda").manual_seed(seed + 7),
                torch.Generator(device="cuda").manual_seed(seed + 8))
            torch.cuda.synchronize()
            remat[on] = (float(loss), _leaves(grads), dict(
                peak_gib_above_start=(torch.cuda.max_memory_allocated() - base) / 2**30,
                spmm_tiled_launches=cuda_build.LAUNCHES["spmm_tiled"] - before))
    finally:
        torch.use_deterministic_algorithms(False)
    (l0, g0, m0), (l1, g1, m1) = remat[False], remat[True]
    worst = max((g1[n] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                for n, w in g0.items())
    equal = all(torch.equal(g1[n], w) for n, w in g0.items()) and l0 == l1
    out["remat"] = dict(loss=[l0, l1], bitwise_equal=equal, worst_rel_err=worst,
                        without=m0, with_remat=m1)
    log(f"remat: {json.dumps(out['remat'])}")
    if not (worst <= REMAT_TOL and abs(l0 - l1) <= REMAT_TOL * abs(l0)):
        raise AssertionError(f"remat changes the step: {worst:.3g} of a leaf's max")
    return out


# ---- phase 21: the sparse regime beyond the paper's scale -------------------
#
# ``bench_sparse_regime.py``'s ``beyond_paper`` config (1,600 drugs), built
# on the host by a process of its own (``--prepare-beyond``) while phases
# 3-20 (a) run on the card, then moved there.
BEYOND = "beyond_paper"
BEYOND_KEYS = ("1,1",)
# The Trainer with remat off and on: chunks of this many steps, one warm-up
# chunk and this many timed.
BEYOND_CHUNK, BEYOND_WINDOWS = 4, 1
BEYOND_BUILD_TIMEOUT_S = 600


def prepare_beyond(path: str) -> int:
    """``--prepare-beyond PATH``: phase 21's host graph, split and device
    graph on the CPU, through ``bench_sparse_regime``'s own building blocks,
    saved to ``path`` with the seconds of each stage."""
    import torch

    from decagon_tpu_torch.scripts import bench_sparse_regime as sr

    # Below the main process's priority: it runs beside phases 3-20 (a).
    os.nice(10)
    torch.set_num_threads(2)
    cfg = sr.CONFIGS[BEYOND]
    graph, splits, stages = sr.host_graph(cfg["n_drugs"], cfg["dd_edges"],
                                          cfg.get("renumber", False))
    dg = sr.sparse_device_graph(graph, splits, "cpu", stages)
    t = time.perf_counter()
    torch.save(dict(graph=graph, splits=splits, dg=dg, stages=stages), path + ".tmp",
               pickle_protocol=5)
    os.replace(path + ".tmp", path)
    stages["save_s"] = time.perf_counter() - t
    print(json.dumps(stages), flush=True)
    return 0


class BeyondBuild:
    """The process that prepares phase 21's graph (``prepare_beyond``); it
    is stopped, and its directory removed, on every way out of ``main``."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_beyond_")
        self.path = os.path.join(self.dir, "graph.pt")
        self.log = os.path.join(self.dir, "stages.json")
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--prepare-beyond", self.path],
                stdout=out)

    def result(self):
        """(graph, splits, CPU device graph, summary): waits for the
        process, then loads what it saved."""
        import torch

        t = time.perf_counter()
        rc = self.proc.wait(timeout=BEYOND_BUILD_TIMEOUT_S)
        waited = time.perf_counter() - t
        if rc != 0:
            raise AssertionError(f"phase 21's host build exited with {rc}")
        with open(self.log) as f:
            stages = json.loads(f.read().strip().splitlines()[-1])
        t = time.perf_counter()
        payload = torch.load(self.path, weights_only=False)
        summary = dict(stages_s=stages, waited_s=waited, load_s=time.perf_counter() - t)
        return payload["graph"], payload["splits"], payload["dg"], summary

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def beyond_state(build, device):
    """Phase 21's graph on the card: the host build's stages and wait,
    each layout's rows, edges and longest row, the would-be drug-drug bf16
    stack beside the card's memory, and the graph's memory there."""
    import torch

    from decagon_tpu_torch.scripts import bench_sparse_regime as sr

    graph, splits, dg_host, summary = build.result()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    dg = dg_host.to(device)
    torch.cuda.synchronize()
    del dg_host
    summary.update(
        to_card_s=time.perf_counter() - t,
        device_gib=(torch.cuda.memory_allocated() - before) / 2**30,
        dd_stack_gib=sr.stack_gib(dg),
        card_memory_gib=torch.cuda.get_device_properties(device).total_memory / 2**30,
        nnz=sr.graph_nnz(dg), layouts=sr.layout_stats(dg),
    )
    for key, stats in summary["layouts"].items():
        log(f"beyond_paper ({key}): {json.dumps(stats)}")
    log(f"beyond_paper state: {json.dumps({k: v for k, v in summary.items() if k != 'layouts'})}")
    return graph, splits, dg, summary


def beyond_paper(build, device, seed):
    """Phase 21 (after the paper graph's sparse state is freed): the
    ``beyond_paper`` graph on the card; K6 against its plain version on the
    drug-drug layouts (both layers, forward and backward, both precisions);
    then, launch counters set to 0, the ``Trainer`` at "default" with
    ``remat`` off and on from one state (chunks of ``BEYOND_CHUNK``: one
    warm-up, ``BEYOND_WINDOWS`` timed; ms a step, peak GiB above the
    graph), one grouped chunk at the quality run's ``TrainConfig``
    (``scripts/quality_sparse_regime.py``) and one evaluation of an epoch
    (embedding, pooled validation and test sweeps): K6 and K5 must launch,
    K7 once an optimization step, K1-K4 never.  Then one drug-drug step's
    gradients through K6 against its plain version, and with ``remat``
    against without.  Returns (launch counts, summary, K6 rows)."""
    import torch

    from decagon_tpu_torch.bench import steady_state_ms
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.scripts import quality_sparse_regime as quality
    from decagon_tpu_torch.timing import hard_sync
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
    from decagon_tpu_torch.train.step import TrainConfig, make_optimizer
    from decagon_tpu_torch.train.trainer import Trainer

    graph, splits, dg, summary = beyond_state(build, device)
    cfg = TrainConfig(batch_size=512, learning_rate=1e-3, scan_chunk=BEYOND_CHUNK)
    # One starting state for every trainer of the phase, drawn on the card
    # (the Trainer's own draw is on the host: ~200M weights here).
    t = time.perf_counter()
    params = sparse_model(dg, "default").init_params(
        torch.Generator(device=device).manual_seed(seed), dg)
    state = dict(params=params, opt_state=make_optimizer(cfg).init(params), global_step=0,
                 opt_step=0)
    hard_sync(params)
    summary["init_s"] = time.perf_counter() - t
    rows, bf16_rows = check_spmm(dg, state["params"], keys=BEYOND_KEYS, prefix=f"{BEYOND} ")
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    cuda_build.reset_launches()
    steps = 0
    summary["trainer"] = {}
    for remat in (False, True):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(sparse_model(dg, "default", remat=remat), graph, splits, dg, cfg,
                          seed=seed, init_state=_clone(state))
        adam_before = cuda_build.LAUNCHES["adam"]
        timing = steady_state_ms(trainer, BEYOND_CHUNK, BEYOND_WINDOWS)
        losses = timing.pop("losses")
        hard_sync(trainer.params)
        entry = dict(steps=len(losses), last_losses=losses[-4:].tolist(), **timing,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     peak_gib_above_graph=(torch.cuda.max_memory_allocated() - base) / 2**30,
                     adam_launches_per_step=(cuda_build.LAUNCHES["adam"] - adam_before)
                     / len(losses))
        summary["trainer"]["remat" if remat else "plain"] = entry
        log(f"beyond_paper trainer (remat {remat}): {json.dumps(entry)}")
        if not bool(torch.isfinite(losses).all()) or entry["adam_launches_per_step"] != 1:
            raise AssertionError(f"beyond_paper trainer (remat {remat}): losses not finite or "
                                 f"K7 not once a step: {entry}")
        steps += len(losses)
        del trainer

    qcfg = quality.train_config(quality.TRAIN)
    qmodel = DecagonModel(ModelConfig(**quality.MODEL), dg)
    trainer = Trainer(qmodel, graph, splits, dg, qcfg, seed=seed, init_state=_clone(state))
    epoch = trainer.scheduler.epoch()
    batches = [next(epoch) for _ in range(qcfg.scan_chunk * qcfg.relation_group)]
    torch.cuda.reset_peak_memory_stats()
    adam_before = cuda_build.LAUNCHES["adam"]
    t = time.perf_counter()
    losses = trainer.train_chunk(batches, qcfg.scan_chunk).cpu()
    grouped_s = time.perf_counter() - t
    adam = cuda_build.LAUNCHES["adam"] - adam_before
    summary["grouped_chunk"] = dict(
        opt_steps=len(losses), batches=len(batches), seconds=grouped_s,
        ms_per_grouped_step=grouped_s * 1e3 / len(losses), adam_launches=adam,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, last_losses=losses[-4:].tolist())
    log(f"beyond_paper grouped chunk (the quality run's config, not warmed): "
        f"{json.dumps(summary['grouped_chunk'])}")
    if not bool(torch.isfinite(losses).all()) or adam != len(losses) or len(losses) != \
            qcfg.scan_chunk:
        raise AssertionError(f"beyond_paper grouped chunk: {summary['grouped_chunk']}")
    steps += len(losses)
    sddmm_before = cuda_build.LAUNCHES["sddmm"]
    t = time.perf_counter()
    evaluator = AccuracyEvaluator(qmodel, graph, splits, device=device)
    emb = evaluator.embeddings(trainer.params, dg)
    val = evaluator.evaluate_all_drug_drug(trainer.params, dg, embeddings=emb)
    test = evaluator.evaluate_all_drug_drug(trainer.params, dg, use_test=True, embeddings=emb)
    summary["evaluation"] = dict(seconds=time.perf_counter() - t, val_auroc=val.auroc,
                                 test_auroc=test.auroc,
                                 sddmm_launches=cuda_build.LAUNCHES["sddmm"] - sddmm_before)
    del emb, trainer, evaluator
    counts = dict(cuda_build.LAUNCHES)
    summary["launches"] = counts
    log(f"beyond_paper evaluation of an epoch: {json.dumps(summary['evaluation'])}; launches "
        f"{counts}")
    if counts["spmm_tiled"] <= 0 or summary["evaluation"]["sddmm_launches"] <= 0:
        raise AssertionError(f"beyond_paper: K6 or K5 never launched: {counts}")
    if counts["adam"] != steps:
        raise AssertionError(f"beyond_paper: K7 launched {counts['adam']} times in {steps} "
                             "optimization steps")
    if counts["paired_fwd"] or counts["paired_bwd"]:
        raise AssertionError(f"beyond_paper: a paired kernel launched: {counts}")
    if not all(0.0 <= a <= 1.0 for a in (val.auroc, test.auroc)):
        raise AssertionError(f"beyond_paper evaluation: AUROC {val.auroc}, {test.auroc}")
    summary["gradients"] = sparse_gradients(dg, state["params"], splits, seed,
                                            precisions=("default",))
    del state, dg
    return counts, summary, rows + bf16_rows


# ---- phase 20: the mesh ---------------------------------------------------
#
# (a) runs after phase 16, on phase 14's sparse graph; (b) at the end.
MESH_CHUNK, MESH_WINDOWS = 8, 2
MESH_RANKS, MESH_SHAPE = 4, (2, 2)
# (b): the mesh against the single process on the card, as
# tests/test_parallel.py holds the JAX mesh against one device: the loss to
# 1e-5 relative, gradients to 2e-4 relative plus 1e-5 absolute, embeddings
# to 2e-5 relative plus 1e-6 absolute (f32 sums in other orders).
MESH_LOSS_TOL = 1e-5
MESH_GRAD_RTOL, MESH_GRAD_ATOL = 2e-4, 1e-5
MESH_EMB_RTOL, MESH_EMB_ATOL = 2e-5, 1e-6
MESH_TIMEOUT_S = 240
# The dummy config of phase 13 at full width.
MESH_DUMMY = dict(n_genes=500, n_drugs=400, n_drugdrug_types=3, seed=0)


class SpmmRecorder:
    """Wraps K6's wrapper to keep the operand of every call while open:
    one per (layout, width), i.e. per edge type, layer and direction."""

    def __init__(self):
        import decagon_tpu_torch.ops.spmm_pallas as spp

        self.spp, self.orig, self.calls = spp, spp.spmm_tiled, {}

        def record(p_flat, tiles, precision="highest"):
            self.calls.setdefault((id(tiles), p_flat.shape[1]),
                                  (p_flat.detach().clone(), tiles, precision))
            return self.orig(p_flat, tiles, precision)

        spp.spmm_tiled = record

    def close(self):
        self.spp.spmm_tiled = self.orig


class SddmmRecorder:
    """Wraps the scorer's K5 entry (``train.step.sddmm_edges``) to keep the
    operands and the result of every call while open."""

    def __init__(self):
        import decagon_tpu_torch.train.step as step

        self.step, self.orig, self.calls = step, step.sddmm_edges, []

        def record(*args, **kw):
            out = self.orig(*args, **kw)
            self.calls.append((args, kw, out))
            return out

        step.sddmm_edges = record

    def close(self):
        self.step.sddmm_edges = self.orig


def recorded_spmm_rows(rec, sg, label):
    """K6 against ``spmm_tiled_ref`` on every operand ``rec`` kept, each
    case named by its edge type in ``sg``, its layer and its direction;
    raises unless both directions were recorded.  The relative error is
    of the largest output."""
    import torch

    from decagon_tpu_torch.ops.spmm_pallas import spmm_tiled, spmm_tiled_ref

    names = {}
    for key, adj in sg.adj.items():
        names[id(adj.tiles_fwd)], names[id(adj.tiles_bwd)] = f"({key}) {{}} forward", \
            f"({key}) {{}} backward"
    rows_out = []
    for (_, h), (p, tiles, precision) in sorted(rec.calls.items(), key=lambda kv: -kv[0][1]):
        got, want = spmm_tiled(p, tiles, precision), spmm_tiled_ref(p, tiles, precision)
        if got.is_cuda:
            torch.cuda.synchronize(got.device)
        err = (got - want).abs().max().item()
        top = max(want.abs().max().item(), 1e-30)
        rows_out.append(dict(
            case=label + names[id(tiles)].format("layer 1" if h == 64 else "layer 2"),
            precision=precision, rows=tiles.n_dst, nnz=tiles.nnz, H=h, max_abs_err=err,
            rel_err=err / top))
    if not any("forward" in r["case"] for r in rows_out) or \
            not any("backward" in r["case"] for r in rows_out):
        raise AssertionError(f"{label}: K6's calls were not recorded in both directions: "
                             f"{[r['case'] for r in rows_out]}")
    return rows_out


def recorded_sddmm_rows(rec, label):
    """The scores K5 gave on every call ``rec`` kept against the plain
    scorer on the same operands, held as phase 4 holds them: within
    ``SDDMM_REL_TOL`` of max(1, largest score).  Raises unless a call was
    recorded."""
    import torch

    from decagon_tpu_torch.ops.sddmm_pallas import sddmm_plain

    if not rec.calls:
        raise AssertionError(f"{label}: the scorer never reached K5")
    rows_out = []
    for i, (args, kw, got) in enumerate(rec.calls):
        want = sddmm_plain(*args, **kw)
        if want.is_cuda:
            torch.cuda.synchronize(want.device)
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        row = dict(case=f"{label}, call {i}", edges=args[2].numel(), d=args[0].shape[1],
                   precision=kw.get("precision", "highest"), max_abs_err=err,
                   rel_err=err / scale)
        log(json.dumps(row))
        if not row["rel_err"] <= SDDMM_REL_TOL:
            raise AssertionError(f"sddmm {row['case']}: error {err:.3g} > {SDDMM_REL_TOL} x "
                                 f"{scale:.3g}")
        rows_out.append(row)
    return rows_out


def mesh_step(graph, splits, sg, dg_sparse, mesh, seed):
    """One deterministic drug-drug step (dropout 0, the same negative
    uniforms) through the (1, 1) mesh against the single-process sparse
    step on phase 14's graph (``spmm_impl="pallas"``) and against the same
    mesh step through K6's plain version (``"pallas_ref"``), at "highest":
    the loss to ``SPMM_REL_TOL`` of its size, each gradient leaf to
    ``SPARSE_GRAD_TOL["highest"]`` of its largest.  K6's operands of the
    mesh step are recorded, and K6 is held against its plain version on
    each.  Returns (summary, K6 rows)."""
    import dataclasses

    import torch

    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.parallel.sharded import make_sharded_grads_fn
    from decagon_tpu_torch.train.step import (
        TrainConfig, make_loss_fn, step_generator, value_and_grad,
    )

    cfg = TrainConfig(batch_size=512)
    det = ModelConfig(hidden1=64, hidden2=32, dropout=0.0, spmm_impl="auto")
    mesh_model = DecagonModel(det, sg)
    single_model = DecagonModel(dataclasses.replace(det, spmm_impl="pallas"), dg_sparse)
    params = mesh_model.init_params(torch.Generator().manual_seed(seed), sg)
    rows, cols = _batch(splits, (1, 1), 7, cfg.batch_size, seed + 200)
    u = torch.rand(cfg.batch_size, generator=torch.Generator(device=sg.device).manual_seed(seed + 200),
                   device=sg.device)
    rec = SpmmRecorder()
    try:
        loss_m, grads_m = make_sharded_grads_fn(mesh_model, (1, 1), cfg, mesh, sg)(
            params, sg, 7, rows, cols, step_generator(seed, 0, sg.device), neg_u=u)
        torch.cuda.synchronize()
    finally:
        rec.close()
    loss_s, grads_s = value_and_grad(make_loss_fn(single_model, (1, 1), cfg), params, dg_sparse,
                                     7, rows, cols, None, None, neg_u=u)
    ref_model = DecagonModel(dataclasses.replace(det, spmm_impl="pallas_ref"), sg)
    loss_r, grads_r = make_sharded_grads_fn(ref_model, (1, 1), cfg, mesh, sg)(
        params, sg, 7, rows, cols, step_generator(seed, 0, sg.device), neg_u=u)
    lm, ls, lr = float(loss_m), float(loss_s), float(loss_r)
    log(f"mesh step: loss {lm:.6f} (mesh, K6) {lr:.6f} (mesh, \"pallas_ref\") {ls:.6f} "
        f"(single process)")
    if not (abs(lm - ls) <= SPMM_REL_TOL * abs(ls) and abs(lm - lr) <= SPMM_REL_TOL * abs(lr)):
        raise AssertionError(f"mesh step loss {lm} against {ls} (single) and {lr} (pallas_ref)")
    worst = hold_gradients("mesh step gradient", _leaves(grads_m), _leaves(grads_s),
                           SPARSE_GRAD_TOL["highest"])
    worst_ref = hold_gradients("mesh step gradient against \"pallas_ref\"", _leaves(grads_m),
                               _leaves(grads_r), SPARSE_GRAD_TOL["highest"])
    rows_out = recorded_spmm_rows(rec, sg, "mesh ")
    for row in rows_out:
        log(json.dumps(row))
        if not row["rel_err"] <= SPMM_REL_TOL:
            raise AssertionError(f"K6 on the mesh operands {row['case']}: {row['rel_err']:.3g}")
    return dict(loss={"mesh": lm, "single": ls, "pallas_ref": lr}, worst_grad_rel_err=worst,
                worst_grad_rel_err_pallas_ref=worst_ref), rows_out


def mesh_paper(graph, splits, dg_sparse, seed, phase16_ms):
    """Phase 20 (a): the (1, 1) NCCL mesh in this process at paper scale,
    full width.  The sharded graph with K6's layouts on every edge type
    (seconds and GiB); launch counters set to 0, then the mesh ``Trainer``
    (batch 512, chunks of ``MESH_CHUNK``: one warm-up, ``MESH_WINDOWS``
    timed) and the evaluator through its ``embed_fn`` on relation (1, 1,
    0)'s validation edges; K6 and K5 must launch, and K5's scores of that
    sweep (the evaluator's, on the ``embed_fn`` tables) are held against
    the plain scorer on the same operands to ``SDDMM_REL_TOL``.  Then
    ``mesh_step``.  Returns (launches, summary, K6 rows, K5 rows)."""
    import torch
    import torch.distributed as dist

    from decagon_tpu_torch.bench import config_metrics, graph_nnz, steady_state_ms
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from decagon_tpu_torch.parallel.rowshard import build_sharded_device_graph
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
    from decagon_tpu_torch.train.step import TrainConfig
    from decagon_tpu_torch.train.trainer import Trainer

    from decagon_tpu_torch.scripts.worlds import free_port

    device = dg_sparse.device
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(shape=(1, 1), backend="nccl")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        sg = build_sharded_device_graph(graph, splits, (1, 1), 0, device, tile_for_pallas=True)
        torch.cuda.synchronize()
        summary = dict(build_s=time.perf_counter() - t,
                       device_gib=(torch.cuda.memory_allocated() - before) / 2**30)
        log(f"sharded graph (1, 1): {summary['build_s']:.1f}s, {summary['device_gib']:.2f} GiB")
        if any(a.dense is not None or a.tiles_fwd is None for a in sg.adj.values()):
            raise AssertionError("the paper-scale sharded graph must be K6's on every edge type")
        model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="auto"),
                             sg)
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        trainer = Trainer(model, graph, splits, sg,
                          TrainConfig(batch_size=512, scan_chunk=MESH_CHUNK), seed=seed, mesh=mesh)
        timing = steady_state_ms(trainer, MESH_CHUNK, MESH_WINDOWS)
        losses = timing.pop("losses")
        t = time.perf_counter()
        rec = SddmmRecorder()
        try:
            scores = AccuracyEvaluator(model, graph, splits, embed_fn=trainer.embed_fn,
                                       device=device).evaluate(trainer.params, sg, (1, 1, 0))
            torch.cuda.synchronize()
        finally:
            rec.close()
        counts = dict(cuda_build.LAUNCHES)
        summary["trainer"] = dict(
            steps=len(losses), chunk=MESH_CHUNK, last_losses=losses[-4:].tolist(),
            shard_weights=trainer.shard_weights, **config_metrics(graph_nnz(sg), timing),
            phase16_default_ms_per_step_median=phase16_ms,
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        summary["eval"] = dict(auroc=scores.auroc, auprc=scores.auprc, apk=scores.apk,
                               seconds=time.perf_counter() - t)
        summary["launches"] = counts
        log(f"mesh trainer {json.dumps(summary['trainer'])}; evaluation "
            f"{json.dumps(summary['eval'])}; launches {counts}")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError("mesh trainer losses not finite")
        if counts["spmm_tiled"] <= 0 or counts["sddmm"] <= 0:
            raise AssertionError(f"K6 or K5 never launched on the mesh path: {counts}")
        if not all(0.0 <= v <= 1.0 for v in (scores.auroc, scores.auprc, scores.apk)):
            raise AssertionError(f"mesh evaluation metrics outside [0, 1]: {scores}")
        k5_rows = recorded_sddmm_rows(rec, "mesh (1, 1) evaluator, relation (1, 1, 0)")
        del trainer, rec
        summary["step"], k6_rows = mesh_step(graph, splits, sg, dg_sparse, mesh, seed)
        del sg
        phase("mesh scripts (a): bench_sharded and diag_sharded in this world of one NCCL rank",
              "24a")
        summary["scripts"] = mesh_scripts_nccl(device)
        phase("mesh (a): the world's teardown", "20a")
    finally:
        dist.destroy_process_group()
    return counts, summary, k6_rows, k5_rows


def _dummy_world(device, seed):
    """Phase 13's graph and split, a drug-drug batch and its negative
    uniforms, the same in every process."""
    import numpy as np
    import torch

    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_synthetic_graph

    graph = make_synthetic_graph(**MESH_DUMMY)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.0, seed=1)
    edges = splits[(1, 1, 1)].train
    idx = np.random.default_rng(seed + 300).integers(0, edges.shape[0], 512)
    rows, cols = (torch.from_numpy(edges[idx, c].astype(np.int32)).to(device) for c in (0, 1))
    u = torch.rand(512, generator=torch.Generator(device=device).manual_seed(seed + 300),
                   device=device)
    return graph, splits, rows, cols, u


def _mesh_rank(rank, n_ranks, port, seed, device, results, script_ports=None):
    """One rank of phase 20 (b) on ``device`` (the card) over gloo: for "auto" (dense
    blocks, ``shard_weights``) and "pallas" (K6 on every edge type), one
    deterministic step's loss and gradients and the embeddings on the
    (2, 2) mesh; rank 0 sends them, every rank its launches and, for
    "pallas", K6 against its plain version on the step's operands of this
    rank (its round-robin slice's CSR, the backward into all of
    ``[K * n_j]``).  Results go to ``results`` tagged with their phase:
    20, then, given ``script_ports``, phase 24's scripts in the same world
    and two worlds of two ranks after it (``mesh_scripts_rank``)."""
    import traceback

    t0 = time.perf_counter()
    import torch
    import torch.distributed as dist

    try:
        from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
        from decagon_tpu_torch.ops import cuda_build
        from decagon_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, mesh_slot
        from decagon_tpu_torch.parallel.rowshard import build_sharded_device_graph
        from decagon_tpu_torch.parallel.sharded import (
            gather_relation_blocks, local_relation_block, make_sharded_embed_fn,
            make_sharded_grads_fn, shardable_weight_keys,
        )
        from decagon_tpu_torch.train.step import TrainConfig, step_generator

        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
            cuda_build.library()
        initialize_distributed(f"127.0.0.1:{port}", n_ranks, rank, backend="gloo")
        mesh = make_mesh(shape=MESH_SHAPE, backend="gloo")
        out = {"rank": rank, "library_cached": cuda_build.BUILD_INFO.get("cached")}
        graph, splits, rows, cols, u = _dummy_world(device, seed)
        cfg = TrainConfig(batch_size=512)
        for impl in ("auto", "pallas"):
            cuda_build.reset_launches()
            k6 = impl == "pallas"
            sg = build_sharded_device_graph(graph, splits, MESH_SHAPE, mesh_slot(mesh), device,
                                            tile_for_pallas=k6, tile_even_if_dense=k6)
            model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.0,
                                             spmm_impl=impl), sg)
            sw = impl == "auto" and bool(shardable_weight_keys(sg))
            params = model.init_params(torch.Generator().manual_seed(seed), sg)
            local = local_relation_block(params, sg) if sw else params
            rec = SpmmRecorder() if k6 else None
            try:
                loss, grads = make_sharded_grads_fn(model, (1, 1), cfg, mesh, sg,
                                                    shard_weights=sw)(
                    local, sg, 1, rows, cols, step_generator(seed, 0, device), neg_u=u)
            finally:
                if rec is not None:
                    rec.close()
            if sw:
                grads = gather_relation_blocks(grads, sg, mesh)
            emb = make_sharded_embed_fn(model, mesh, sg, shard_weights=sw)(local, sg)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            res = {"loss": float(loss), "shard_weights": sw,
                   "launches": dict(cuda_build.LAUNCHES)}
            if rec is not None:
                # K6 against its plain version on this rank's own operands
                # (after the launches are read: these do not count).
                res["k6_checks"] = recorded_spmm_rows(rec, sg, f"mesh rank {rank} ")
            if rank == 0:
                res["grads"] = {k: v.cpu().numpy() for k, v in _leaves(grads).items()}
                res["emb"] = {k: v.cpu().numpy() for k, v in emb.items()}
            out[impl] = res
        out["seconds"] = time.perf_counter() - t0
        results.put((20, rank, True, out))
    except BaseException:  # reported to the parent, which fails the phase
        results.put((20, rank, False, traceback.format_exc()))
        if dist.is_initialized():
            dist.destroy_process_group()
        return
    if script_ports is None:
        dist.destroy_process_group()
        return
    try:
        results.put((24, rank, True, mesh_scripts_rank(rank, script_ports, device)))
    except BaseException:  # reported to the parent, which fails phase 24
        results.put((24, rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_mesh_ranks(device, seed, scripts=False):
    """Start phase 20 (b)'s ``MESH_RANKS`` processes (``_mesh_rank``) on
    ``device``'s card, so that other work can run while they reach it;
    returns what ``mesh_ranks`` waits on (``stop_mesh_ranks`` ends them).
    ``scripts``: the ranks go on into phase 24 (``mesh_scripts`` waits)."""
    import torch
    import torch.multiprocessing as mp

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.scripts.worlds import free_port

    device = torch.device(device)
    if device.type == "cuda":
        cuda_build.library()
        device = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    # The ports of phase 24's two worlds of two ranks.
    script_ports = [free_port(), free_port()] if scripts else None
    procs = [ctx.Process(target=_mesh_rank, args=(rank, MESH_RANKS, port, seed, str(device),
                                                  results, script_ports), daemon=True)
             for rank in range(MESH_RANKS)]
    for p in procs:
        p.start()
    return dict(device=device, t0=t0, results=results, procs=procs, stash=[])


def stop_mesh_ranks(ranks):
    """Join the ranks of ``spawn_mesh_ranks``, killing those still alive."""
    for p in ranks["procs"]:
        p.join(timeout=10)
    for p in ranks["procs"]:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)


def collect_ranks(ranks, stage, timeout=MESH_TIMEOUT_S):
    """``{rank: payload}`` of every rank's ``stage`` result (messages of
    another stage are kept for their own call); raises as soon as a rank
    reports a failure (of any stage) or dies, or with no answer within
    ``timeout`` seconds."""
    import queue as queue_mod

    got, deadline = {}, time.monotonic() + timeout
    got.update((msg[1], msg[3]) for msg in ranks["stash"] if msg[0] == stage)
    ranks["stash"] = [msg for msg in ranks["stash"] if msg[0] != stage]
    while len(got) < MESH_RANKS:
        left = deadline - time.monotonic()
        if left <= 0:
            raise AssertionError(f"mesh ranks, phase {stage}: no answer within {timeout} s "
                                 f"(answered: {sorted(got)})")
        try:
            msg_stage, rank, ok, payload = ranks["results"].get(timeout=min(left, 5.0))
        except queue_mod.Empty:
            dead = [p.exitcode for p in ranks["procs"] if p.exitcode not in (None, 0)]
            if dead:
                raise AssertionError(f"a mesh rank died with exit code {dead[0]}")
            continue
        if not ok:
            raise AssertionError(f"mesh rank {rank} failed in phase {msg_stage}:\n{payload}")
        if msg_stage != stage:
            ranks["stash"].append((msg_stage, rank, ok, payload))
            continue
        got[rank] = payload
    return got


def mesh_ranks(device, seed, ranks=None):
    """Phase 20 (b): ``MESH_RANKS`` processes (``_mesh_rank``) spawned over
    gloo on ``device``'s card, a ``MESH_SHAPE`` mesh, the dummy config at
    full width (hidden 64 -> 32, batch 512), "auto" with ``shard_weights``
    and "pallas" with K6 in every rank (``tile_even_if_dense``).  Each
    holds one deterministic step's loss and gradients and the embeddings
    against the single process on the card (same graph built with the
    same impl, no paired or factored stacks; same negatives); K6 must
    launch in every rank of the "pallas" run and match its plain version
    there on that rank's operands to ``SPMM_REL_TOL``; the ranks load the
    library this process built.  ``ranks``: processes ``spawn_mesh_ranks``
    started already (by default they are started here, and ended after
    their phase 20 results).  A failed rank fails the phase and every rank
    is killed; ranks started with ``scripts`` go on into phase 24
    (``mesh_scripts`` ends them).  Returns a summary."""
    import numpy as np
    import torch

    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.train.step import TrainConfig, make_loss_fn, value_and_grad

    own = ranks is None
    ranks = ranks or spawn_mesh_ranks(device, seed)
    device, t0 = ranks["device"], ranks["t0"]
    try:
        graph, splits, rows, cols, u = _dummy_world(device, seed)
        cfg = TrainConfig(batch_size=512)
        want = {}
        for impl in ("auto", "pallas"):
            k6 = impl == "pallas"
            dg = build_device_graph(graph, splits, device=device, tile_for_pallas=k6,
                                    tile_even_if_dense=k6, build_fused=False)
            model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.0,
                                             spmm_impl=impl), dg)
            params = model.init_params(torch.Generator().manual_seed(seed), dg)
            loss, grads = value_and_grad(make_loss_fn(model, (1, 1), cfg), params, dg, 1, rows,
                                         cols, None, None, neg_u=u)
            with torch.no_grad():
                emb = model.embeddings(params, dg)
            want[impl] = (float(loss), {k: v.cpu().numpy() for k, v in _leaves(grads).items()},
                          {k: v.cpu().numpy() for k, v in emb.items()})
        got = collect_ranks(ranks, 20)
    except BaseException:
        stop_mesh_ranks(ranks)
        raise
    if own:
        stop_mesh_ranks(ranks)
    summary = {"seconds": time.perf_counter() - t0,
               "rank_seconds": [got[r]["seconds"] for r in range(MESH_RANKS)],
               "shape": list(MESH_SHAPE),
               "library_cached": [got[r]["library_cached"] for r in range(MESH_RANKS)]}
    for impl in ("auto", "pallas"):
        w_loss, w_grads, w_emb = want[impl]
        r0 = got[0][impl]
        losses = [got[r][impl]["loss"] for r in range(MESH_RANKS)]
        grad_err = max(
            float((np.abs(r0["grads"][n] - w) / (MESH_GRAD_RTOL * np.abs(w) + MESH_GRAD_ATOL)).max())
            for n, w in w_grads.items())
        emb_err = max(
            float((np.abs(r0["emb"][k] - w) / (MESH_EMB_RTOL * np.abs(w) + MESH_EMB_ATOL)).max())
            for k, w in w_emb.items())
        launches = [got[r][impl]["launches"]["spmm_tiled"] for r in range(MESH_RANKS)]
        summary[impl] = dict(loss_mesh=losses, loss_single=w_loss,
                             shard_weights=r0["shard_weights"],
                             grad_err_over_bound=grad_err, emb_err_over_bound=emb_err,
                             spmm_tiled_launches_per_rank=launches)
        if impl == "pallas":
            checks = [got[r][impl]["k6_checks"] for r in range(MESH_RANKS)]
            summary[impl]["k6_cases_per_rank"] = [len(c) for c in checks]
            summary[impl]["k6_rel_err_per_rank"] = [max(row["rel_err"] for row in c)
                                                    for c in checks]
        log(f"mesh ranks ({impl}): {json.dumps(summary[impl])}")
        if not all(abs(lm - w_loss) <= MESH_LOSS_TOL * abs(w_loss) for lm in losses):
            raise AssertionError(f"mesh ranks ({impl}): losses {losses} against {w_loss}")
        if not (grad_err <= 1.0 and emb_err <= 1.0):
            raise AssertionError(f"mesh ranks ({impl}): gradients {grad_err:.3g}, embeddings "
                                 f"{emb_err:.3g} of their bounds")
    if summary["auto"]["shard_weights"] is not True:
        raise AssertionError("mesh ranks (auto): shard_weights did not engage")
    if not all(n > 0 for n in summary["pallas"]["spmm_tiled_launches_per_rank"]):
        raise AssertionError(f"K6 did not launch in every rank: {summary['pallas']}")
    if not all(e <= SPMM_REL_TOL for e in summary["pallas"]["k6_rel_err_per_rank"]):
        raise AssertionError(f"K6 against its plain version on a rank's operands: "
                             f"{summary['pallas']['k6_rel_err_per_rank']} past {SPMM_REL_TOL}")
    if not all(summary["library_cached"]):
        raise AssertionError("a mesh rank built the kernels again")
    log(f"mesh ranks: {summary['seconds']:.1f}s from the spawn, each rank "
        f"{[round(t, 1) for t in summary['rank_seconds']]}s from its start")
    return summary


# ---- phase 24: the mesh scripts at a small size ------------------------------
#
# (a) runs in phase 20 (a)'s world of one NCCL rank before it is destroyed,
# (b) in phase 20 (b)'s ranks after their phase 20 work (then in two worlds of
# two ranks), checked by this process after phase 20 (b), with (c) the
# scaling model on the host.  The sizes of the scripts' CPU tests
# (``tests/test_torch_scripts_mesh.py``).
#
# Why (b) does not start its worlds with ``scripts/worlds.run_world``, as the
# scripts do: each world of fresh processes pays some 8 s a rank to import
# torch and reach the card, more than the phases this one's cost is taken
# from.  Phase 20 (b)'s ranks are on the card already, so they run the
# scripts' own rank functions in turn; their messages carry their phase
# (20 or 24), so that ``collect_ranks`` can take each phase's in its turn.
MESH_SCRIPT_GRAPH = dict(n_proteins=200, n_drugs=40, n_side_effects=4, seed=7, planted_rank=4)
MESH_SCRIPT_STEPS, MESH_SCRIPT_BATCH = 3, 64
MESH_SCRIPT_TIMING = {"pipelined": (1, 1), "synced": (1, 1), "chunked": (1, 1)}


def jax_mesh_fields(name):
    """The JAX fields a mesh script's record (or entry) keeps: the keys of
    an entry of its JAX artifact, for ``diag_sharded`` those of the ``res``
    ``scripts/diag_sharded.py`` prints (read from its text)."""
    import ast

    root = os.path.dirname(os.path.abspath(__file__))
    if name == "diag_sharded":
        with open(os.path.join(root, "scripts", "diag_sharded.py")) as f:
            tree = ast.parse(f.read())
        return tuple(sorted({"backend", "single_cost", "sharded_cost"} | {
            n.slice.value for n in ast.walk(tree) if isinstance(n, ast.Subscript)
            and getattr(n.value, "id", None) == "res" and isinstance(n.slice, ast.Constant)}))
    file, path = {"bench_sharded": ("sharded_bench_tpu", ()),
                  "multihost_bench": ("multihost_bench", ("configs", "4proc_2x2")),
                  "multihost_overlap": ("multihost_overlap", ("overlap_on",)),
                  "hlo_collectives": ("hlo_collectives", ("meshes", "2x4")),
                  "scaling_model": ("scaling_model", ())}[name]
    with open(os.path.join(root, "artifacts", "perf", f"{file}.json")) as f:
        record = json.load(f)
    for key in path:
        record = record[key]
    return tuple(k for k in record if k != "fullscale_963rel")


def _k7_per_step(name, launches):
    """Raise unless K7 launched once a step in every entry of ``launches``
    (name -> launches a step)."""
    bad = {k: v for k, v in launches.items() if v.get("adam") != 1.0}
    if bad:
        raise AssertionError(f"{name}: K7 not once a step: {bad}")


def mesh_scripts_nccl(device):
    """Phase 24 (a), in phase 20 (a)'s world of one NCCL rank: ``bench_sharded``
    (the single ``Trainer`` and the (1, 1) mesh's, each pipelined, synced
    and chunked, and their first step on the same injected draws, which
    must agree to ``MESH_LOSS_TOL``) and ``diag_sharded`` (its ablations
    and flop counts; no profile) at the CPU tests' size; each record holds
    the JAX fields, its numbers are finite and K7 launches once a step of
    every trainer; then ``hlo_overlap_schedule``'s step with overlap on and
    off in this world, where the starts are asynchronous
    (``check_schedule``).  Returns each script's seconds and K7's timed
    launches."""
    import torch

    from decagon_tpu_torch.scripts import bench_sharded, diag_sharded, hlo_overlap_schedule

    graph = {k: v for k, v in MESH_SCRIPT_GRAPH.items() if k != "planted_rank"}
    out = {}
    t0 = time.perf_counter()
    rec = bench_sharded.bench(device, graph_kw=graph, timing=MESH_SCRIPT_TIMING,
                              shapes=[(1, 1)], log=lambda msg: None)
    _k7_per_step("bench_sharded", rec["launches_per_step"])
    _script_record("bench_sharded", rec, jax_mesh_fields("bench_sharded"), ("adam",),
                   rec["launches_per_step"]["sharded_1x1_pipelined"])
    loss = rec["first_step_loss"]
    if not loss["max_abs_diff"] <= MESH_LOSS_TOL * abs(loss["single"]):
        raise AssertionError(f"bench_sharded: the (1, 1) mesh's first step against the single "
                             f"process's: {loss}")
    timing = MESH_SCRIPT_TIMING
    steps = {"pipelined": timing["pipelined"][0], "synced": timing["synced"][0],
             "chunk16": timing["chunked"][0] * timing["chunked"][1]}
    out["bench_sharded"] = dict(seconds=time.perf_counter() - t0, first_step_loss=loss,
                                adam_launches=sum(v.get("adam", 0) * steps[k.rsplit("_", 1)[1]]
                                                  for k, v in rec["launches_per_step"].items()))
    t0 = time.perf_counter()
    n = 1
    rec = diag_sharded.diag(device, graph_kw=graph, n=n, warmup=1, profile=False)
    steps = {k: v for k, v in rec["launches_per_call"].items() if k.endswith("_step")}
    _k7_per_step("diag_sharded", steps)
    _script_record("diag_sharded", rec, jax_mesh_fields("diag_sharded"), ("adam",),
                   rec["launches_per_call"]["sharded_step"])
    out["diag_sharded"] = dict(seconds=time.perf_counter() - t0,
                               adam_launches=sum(v["adam"] * n for v in steps.values()),
                               flops={k: rec[k]["flops"] for k in ("single_cost", "sharded_cost")})
    t0 = time.perf_counter()
    runs = {overlap: {0: hlo_overlap_schedule.rank_main(
        0, 1, 0, 1, 1, overlap, device=str(device), backend="nccl", graph_kw=MESH_SCRIPT_GRAPH,
        batch_size=MESH_SCRIPT_BATCH, threads=torch.get_num_threads())}
        for overlap in (True, False)}
    runs, adam = check_schedule("hlo_overlap_schedule (1, 1) NCCL", runs, asynchronous=True)
    out["hlo_overlap_schedule"] = dict(seconds=time.perf_counter() - t0, adam_launches=adam,
                                       **schedule_summary(runs))
    return out


def schedule_summary(runs):
    """``hlo_overlap_schedule``'s JAX fields of overlap on and off."""
    return {f"overlap_{'on' if overlap else 'off'}": {k: r[k] for k in (
        "async_collective_pairs", "pairs_with_compute_between", "total_compute_ops_inside_spans",
        "by_kind", "ops_issued_in_step")} for overlap, r in runs.items()}


def check_schedule(name, ranks_runs, asynchronous):
    """Raise unless ``hlo_overlap_schedule``'s runs (overlap -> rank ->
    result) give one loss on and off, no asynchronous start left unwaited
    (``hlo_overlap_schedule.variant``), K7 once in every rank's step, no
    pair with overlap off and, with overlap on, the script's predicted
    pairs in rank 0's schedule where the backend starts its collectives
    asynchronously (per layer one edge sum an edge type, all but the last
    with compute between, and as many row gathers) and none where it stages
    them.  Returns each setting's entry and K7's launches summed over every
    rank and both settings."""
    from decagon_tpu_torch.scripts import hlo_overlap_schedule

    runs = {o: hlo_overlap_schedule.variant(r) for o, r in ranks_runs.items()}
    on, off = runs[True], runs[False]
    n = len(on["edge_types"])
    want = (2 * 2 * n, 2 * (n - 1)) if asynchronous else (0, 0)
    got = (on["async_collective_pairs"], on["pairs_with_compute_between"])
    adam = [k for r in runs.values() for k in r["adam_launches_per_rank"]]
    if got != want or off["async_collective_pairs"] or on["loss"] != off["loss"] or \
            adam != [1] * len(adam):
        raise AssertionError(f"{name}: pairs {got} against {want}, overlap off "
                             f"{off['async_collective_pairs']}, losses {on['loss']} / "
                             f"{off['loss']}, K7 a rank (on, off) "
                             f"{on['adam_launches_per_rank']} / {off['adam_launches_per_rank']}")
    return runs, sum(adam)


def mesh_scripts_rank(rank, ports, device):
    """Phase 24 (b) in rank ``rank`` of phase 20 (b)'s world: the last rank
    takes ``multihost_bench``'s single-process trace, its points saved to a
    directory it shares with the others (and deletes); then
    ``multihost_bench``'s (2, 2) traces with f32 and bf16 row reductions,
    the (2, 2) mesh at the saved points with each reduction (its
    ``teacher_forced_rule``), ``hlo_collectives``' inventory of one step and
    ``hlo_overlap_schedule``'s step with overlap on and off in that world;
    then two worlds of two ranks (ranks 0 and 1 on ``ports[0]``, 2 and 3 on
    ``ports[1]``): ``multihost_sim`` and ``multihost_overlap`` with
    ``comm_overlap`` on in the first, off in the second.  Each through the
    script's own functions."""
    import torch.distributed as dist

    from decagon_tpu_torch.parallel.mesh import initialize_distributed
    from decagon_tpu_torch.scripts import (
        hlo_collectives, hlo_overlap_schedule, multihost_bench, multihost_overlap, multihost_sim,
    )

    kw = dict(device=str(device), graph_kw=MESH_SCRIPT_GRAPH, batch_size=MESH_SCRIPT_BATCH)
    last = MESH_RANKS - 1
    out, shared, seconds = {}, [None], {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    if rank == last:
        shared[0] = tempfile.mkdtemp(prefix="decagon_teacher_")
        out["single"] = multihost_bench.single_trace(MESH_SCRIPT_STEPS, str(device),
                                                     MESH_SCRIPT_GRAPH,
                                                     batch_size=MESH_SCRIPT_BATCH,
                                                     save_dir=shared[0])
    dist.broadcast_object_list(shared, src=last)
    lap("single")
    try:
        for dtype in ("float32", "bfloat16"):
            out[dtype] = multihost_bench.rank_main(rank, MESH_RANKS, 0, 2, 2, dtype,
                                                   steps=MESH_SCRIPT_STEPS, threads=1, **kw)
            lap(f"trace_{dtype}")
            out[f"teacher_{dtype}"] = multihost_bench.rank_main(
                rank, MESH_RANKS, 0, 2, 2, dtype, steps=MESH_SCRIPT_STEPS, threads=1,
                teacher_dir=shared[0], **kw)
            lap(f"teacher_{dtype}")
        dist.barrier()
    finally:
        if rank == last:
            shutil.rmtree(shared[0], ignore_errors=True)
    out["inventory"] = hlo_collectives.rank_main(rank, MESH_RANKS, 0, 2, 2, **kw)
    lap("inventory")
    out["schedule"] = {overlap: hlo_overlap_schedule.rank_main(rank, MESH_RANKS, 0, 2, 2,
                                                               overlap, **kw)
                       for overlap in (True, False)}
    lap("schedule")
    dist.destroy_process_group()
    pair, r = divmod(rank, 2)
    initialize_distributed(f"127.0.0.1:{ports[pair]}", 2, r, backend="gloo")
    if pair == 0:
        out["sim"] = multihost_sim.rank_main(r, 2, 0, device=str(device))
    out["overlap"] = multihost_overlap.rank_main(r, 2, 0, overlap=pair == 0,
                                                 steps=MESH_SCRIPT_STEPS, **kw)
    dist.destroy_process_group()
    lap("pairs")
    out["seconds"] = seconds
    return out


def mesh_scripts(device, ranks):
    """Phase 24 (b) and (c): the ranks' phase-24 results (the caller ends
    the ranks): the (2, 2) f32 trace equal on every rank and to the single
    process's on ``multihost_bench``'s small graph and draws within
    ``multihost_bench.EXACT_TOL``, the bf16 drift finite, the teacher-forced
    rule (``multihost_bench.rule_record``) holding on the f32 mesh and
    rejecting the bf16 one, the inventory's activation terms equal to the
    formulas on the tables the step exchanges, ``hlo_overlap_schedule``'s
    step with no pair (gloo stages a CUDA tensor's collectives), both
    ``multihost_sim`` ranks ``MULTIHOST_OK`` with one loss, ``comm_overlap``
    on and off with equal loss heads; each record with its JAX fields and
    finite numbers, K7 once a step in every rank; then the scaling model from
    the checked-in records.  Returns a summary."""
    import torch

    from decagon_tpu_torch.scripts import (
        hlo_collectives, multihost_bench, multihost_overlap, scaling_model,
    )

    t0 = time.perf_counter()
    got = collect_ranks(ranks, 24)
    out = {"wait_s": time.perf_counter() - t0,
           "rank_seconds": {part: max(got[r]["seconds"][part] for r in got)
                            for part in got[0]["seconds"]}}
    single = got[MESH_RANKS - 1]["single"]
    rec = {"configs": {"1proc_4dev_2x2": multihost_bench.summarize({0: single})}}
    for tag, dtype in (("4proc_2x2", "float32"), ("4proc_2x2_bf16", "bfloat16")):
        rec["configs"][tag] = multihost_bench.summarize({r: got[r][dtype] for r in got})
    multihost_bench.derive(rec)
    fields = jax_mesh_fields("multihost_bench")
    for tag, entry in rec["configs"].items():
        launches = entry["adam_launches_per_step"]
        _script_record(f"multihost_bench {tag}", entry, fields, ("adam",), {"adam": min(launches)})
        if launches != [1.0] * len(launches):
            raise AssertionError(f"multihost_bench {tag}: K7 a step per rank {launches}")
    if not rec["cross_process_equals_single_process"]:
        raise AssertionError(f"multihost_bench: the (2, 2) trace against the single process's: "
                             f"{rec['max_abs_vs_single_process']}")
    rule = multihost_bench.rule_record({
        multihost_bench.teacher_tag(2, 2, dtype): multihost_bench.teacher_entry(
            single["losses"], {r: got[r][f"teacher_{dtype}"] for r in got})
        for dtype in ("float32", "bfloat16")})
    if not (rule["holds_on_every_f32_mesh"] and rule["control_rejected"]):
        raise AssertionError(f"multihost_bench: the teacher-forced rule {json.dumps(rule)}")
    out["multihost_bench"] = {k: rec[k] for k in ("max_abs_vs_single_process",
                                                  "bf16_reduce_drift")}
    out["multihost_bench"]["teacher_forced_rule"] = rule
    rec_bench = rec["configs"]

    entry = hlo_collectives.mesh_entry(2, 2, {r: got[r]["inventory"] for r in got})
    _script_record("hlo_collectives 2x2", entry, jax_mesh_fields("hlo_collectives"), ("adam",),
                   {"adam": min(entry["adam_launches_per_step"])})
    want = entry["model_wire_prediction_per_edge_type"]
    if any(entry["counted_wire_mib"][t] != want[t] for t in ("act_edge_mib", "act_row_mib")) or \
            entry["adam_launches_per_step"] != [1] * MESH_RANKS:
        raise AssertionError(f"hlo_collectives: counted {entry['counted_wire_mib']} against "
                             f"{want}, K7 {entry['adam_launches_per_step']}")
    out["hlo_collectives"] = {k: entry[k] for k in ("counted_wire_mib", "hlo_total_tensor_mib")}
    entry_inv = entry

    # Gloo stages a CUDA tensor's collectives through the host: no pairs on
    # the card (CPU tensors are reduced asynchronously).
    schedules, adam_schedule = check_schedule(
        "hlo_overlap_schedule (2, 2) gloo",
        {overlap: {r: got[r]["schedule"][overlap] for r in got} for overlap in (True, False)},
        asynchronous=torch.device(device).type != "cuda")
    out["hlo_overlap_schedule"] = schedule_summary(schedules)

    sim = [got[r]["sim"] for r in (0, 1)]
    if not all(x["line"].startswith(f"MULTIHOST_OK pid={i}") for i, x in enumerate(sim)) or \
            sim[0]["loss"] != sim[1]["loss"] or sim[0]["launches"].get("adam") != 1:
        raise AssertionError(f"multihost_sim: {sim}")
    out["multihost_sim"] = {"lines": [x["line"] for x in sim],
                            "emb_max_abs_err": max(x["emb_max_abs_err"] for x in sim)}

    runs = {key: multihost_overlap.entry({i: got[r]["overlap"] for i, r in enumerate(ranks_)})
            for key, ranks_ in (("overlap_on", (0, 1)), ("overlap_off", (2, 3)))}
    for key, entry in runs.items():
        _script_record(f"multihost_overlap {key}", entry, jax_mesh_fields("multihost_overlap"),
                       ("adam",), {"adam": min(entry["adam_launches_per_step"])})
        if entry["adam_launches_per_step"] != [1.0, 1.0]:
            raise AssertionError(f"multihost_overlap {key}: K7 {entry['adam_launches_per_step']}")
    if runs["overlap_on"]["loss_head"] != runs["overlap_off"]["loss_head"]:
        raise AssertionError(f"multihost_overlap: on and off differ: {runs}")
    out["multihost_overlap"] = runs

    rec = scaling_model.scaling_model()
    _script_record("scaling_model", rec, jax_mesh_fields("scaling_model"), (), {})
    out["scaling_model_2x4_weight_sharded"] = rec["meshes"]["2x4"]["weight_sharded"]
    # K7's launches: the traces (the single process's too), the inventory's
    # step, the schedule's two steps, the simulation's step and the overlap
    # runs, every rank.
    out["adam_launches"] = (
        sum(sum(e["adam_launches_per_step"]) * MESH_SCRIPT_STEPS for e in rec_bench.values())
        + sum(entry_inv["adam_launches_per_step"]) + adam_schedule
        + sum(x["launches"]["adam"] for x in sim)
        + sum(sum(e["adam_launches_per_step"]) * MESH_SCRIPT_STEPS for e in runs.values()))
    out["seconds"] = time.perf_counter() - t0
    log(f"mesh scripts: {json.dumps(out)}")
    return out


def small_sparse(device):
    """On the small graph with every layout (tilings on every edge type and
    the fused stream): "pallas" and "fused_pallas" through K6 against
    "pallas_ref" / "fused_pallas_ref" at both precisions, layer by layer
    (layer 2 on K6's layer-1 output) to ``SPMM_REL_TOL`` of max(1, largest
    output); then 3 Adam steps with "fused_pallas" at "default" against
    its plain version (``adam_steps``)."""
    import torch

    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
    from decagon_tpu_torch.models.encoder import encode_layer

    graph = make_polypharmacy_like_graph(**SMALL)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.05, seed=1)
    dg = build_device_graph(graph, splits, tile_for_pallas=True, tile_even_if_dense=True,
                            device=device)
    for impl in ("pallas", "fused_pallas"):
        for precision in ("highest", "default"):
            model = sparse_model(dg, precision, spmm_impl=impl)
            params = model.init_params(torch.Generator().manual_seed(0), dg)
            kw = dict(spmm_precision=precision)
            h1 = encode_layer(params, dg, "enc1", dg.features, True, impl, **kw)
            h1_ref = encode_layer(params, dg, "enc1", dg.features, True, impl + "_ref", **kw)
            emb = encode_layer(params, dg, "enc2", h1, False, impl, **kw)
            emb_ref = encode_layer(params, dg, "enc2", h1, False, impl + "_ref", **kw)
            for label, got, want in (("layer 1", h1, h1_ref), ("layer 2", emb, emb_ref)):
                for key in want:
                    err = (got[key] - want[key]).abs().max().item()
                    bound = SPMM_REL_TOL * max(1.0, want[key].abs().max().item())
                    log(f"small sparse {impl} {precision} {label} {key}: max abs err {err:.3g} "
                        f"(bound {bound:.3g})")
                    if not (torch.isfinite(got[key]).all() and err <= bound):
                        raise AssertionError(f"small sparse {impl} {precision} {label} {key}")
    model = sparse_model(dg, "default", spmm_impl="fused_pallas")
    adam_steps("small sparse fused_pallas", dg, splits, model,
               sparse_model(dg, "default", spmm_impl="fused_pallas_ref"),
               SPARSE_GRAD_TOL["default"])


# Phase 18: the paired-kernel probes, each under its launch counter, with
# its source and the JAX probe it replaces.
PROBES = (
    ("probe_int8_bw", "decagon_tpu_torch/csrc/probe_int8_bw.cu", "scripts/probe_int8_bw.py:35"),
    ("probe_paired_parts", "decagon_tpu_torch/csrc/probe_paired.cu",
     "scripts/probe_paired_parts.py:36"),
    ("probe_paired_orient", "decagon_tpu_torch/csrc/probe_paired.cu",
     "scripts/probe_paired_orient.py:23"),
    ("probe_paired_bwd_idioms", "decagon_tpu_torch/csrc/paired_bwd.cu",
     "scripts/probe_paired_bwd_idioms.py:16"),
    ("probe_paired_idioms", "decagon_tpu_torch/csrc/paired_fwd.cu",
     "scripts/probe_paired_idioms.py:23"),
)
PROBE_REPS = 3
# Probes whose head case has a library call: two torch.bmm at their shape.
BMM_PROBES = ("probe_paired_parts", "probe_paired_orient", "probe_paired_idioms",
              "probe_paired_bwd_idioms")
# The sweep kernels' registers a thread on the tree these probes were
# redesigned from (K1/K2, K3/K4; ``-Xptxas -v`` on an H100 build): the
# probes' policies must leave them as they were.
PARENT_REGISTERS = {"fwd": 122, "bwd": 128}


def probes(device, seed, paired_rows):
    """P1-P5 at the JAX probes' shapes: each kernel against its plain
    version (P5 bit for bit, the others by their stated rules) and two
    calls bitwise equal, P1's and P4's numpy oracles at K = 4, P2's
    ``both`` and P3's ``two_dots`` against K1/K2 on the same inputs (bit
    for bit); then, with the launch counters set to 0, each probe's timing
    path (CUDA events: kernel, plain version, ``torch.sum`` for P5), read
    just after.  Returns the launch counts, each probe's rows, and the case
    that heads each probe's kernel entry (the int8 read at kb 2 beside
    ``torch.sum``, K1's work at the schedule's cut, the TPU probes' K = 963
    shapes)."""
    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.scripts import (
        probe_int8_bw as p5,
        probe_paired_bwd_idioms as p4b,
        probe_paired_idioms as p1,
        probe_paired_orient as p2,
        probe_paired_parts as p3,
        probing,
    )

    torch.cuda.empty_cache()
    g = torch.Generator(device=device).manual_seed(seed)
    m8 = p5.make_stack(device, seed)  # [964, 645, 645]: P5's stack, P2's and P3's mask
    m16 = m8.to(torch.bfloat16)
    p4 = torch.randn((2, p3.K, p3.H, p3.N), generator=g, device=device).to(torch.bfloat16)
    sc = p2.make_scales(device, seed, kpad=m8.shape[0], n=p3.N)
    small4 = p4b.numpy_inputs(seed=seed)
    small1 = p1.numpy_inputs(seed=seed)
    on = [torch.from_numpy(a).to(device) for a in (small4[0], small4[1].T.copy(), small4[2])]
    m963 = m8[:p4b.K_FULL]
    full4 = (m963, torch.randn((p4b.H, p4b.N), generator=g, device=device),
             torch.rand((p4b.K_FULL, 2, p4b.N), generator=g, device=device))
    _, pe_aug, po_aug = p1.device_inputs(device, seed=seed + 1)
    aug4 = (torch.from_numpy(small1[0]).to(device),
            torch.from_numpy(small1[5]).to(device, torch.bfloat16),
            torch.from_numpy(small1[6]).to(device, torch.bfloat16))
    groups = {
        "probe_int8_bw": p5.variants(m8, m16, p5.padded(m8)),
        "probe_paired_parts": p3.variants(m8, p4, kbs=(4, 8, None)),
        "probe_paired_orient": p2.variants(
            m8, p4, sc, m16, sweep=(("both", (2, 4, 8, None)), ("xe_only", (4, None)),
                                    ("xo_only", (4, None)), ("small_t", (4, None)))),
        "probe_paired_bwd_idioms": [p4b.variant(*on), p4b.variant(*full4)],
        "probe_paired_idioms": [p1.variant(*aug4, h=p1.H),
                                p1.variant(m963, pe_aug, po_aug, h=p1.H, kb=1),
                                p1.variant(m963, pe_aug, po_aug, h=p1.H)],
    }
    de, do = p4b.paired_bwd(*on)
    err4 = p4b.oracle_error(small4[0], small4[1], small4[2], de.float().cpu().numpy(),
                            do.float().cpu().numpy())
    err1 = p1.oracle_error(*small1[:5], p1.paired(*aug4, h=p1.H).cpu().numpy())
    log(f"numpy oracles at K = 4 (bound 2e-2, the JAX probes'): P4 {err4:.3g}, P1 {err1:.3g}")
    if not (err4 < 2e-2 and err1 < 2e-2):
        raise AssertionError("a probe misses its numpy oracle")
    checked = {name: {v.key: probing.check(v) for v in vs} for name, vs in groups.items()}
    # P2's both (int8) and P3's two_dots are K1/K2 at unit column scales:
    # the same sweep at the same cut, the same bits.
    from decagon_tpu_torch.ops.spmm_paired import kernel_info, paired_fwd

    k1_same = {
        "both_i8_sched": torch.equal(p2.paired_orient(m8, p4, sc, "both"),
                                     paired_fwd(p4, m963, p2.as_forward_scales(sc, p3.K))),
        "two_dots_sched": torch.equal(
            p3.paired_parts(m8, p4, "two_dots"),
            paired_fwd(p4, m963, torch.ones((p3.K, 4, p3.N), device=device))),
    }
    log(f"P2 both and P3 two_dots against K1/K2 on the same inputs, bit for bit: "
        f"{json.dumps(k1_same)}")
    if not all(k1_same.values()):
        raise AssertionError("P2's both or P3's two_dots differs from K1/K2")
    regs = {which: kernel_info(which, device.index or 0)["registers"] for which in ("fwd", "bwd")}
    log(f"K1-K4 registers a thread {json.dumps(regs)} (parent {json.dumps(PARENT_REGISTERS)}); "
        "the probes' instantiations: " + json.dumps({
            f"{mode}_{'bf16' if bf else 'i8'}_s{st}": dict(p3.probe_info(code, bf, st,
                                                                         device.index or 0))
            for mode, code, bf, st in (("both", probing.BOTH, False, 3),
                                       ("both", probing.BOTH, True, 3),
                                       ("both", probing.BOTH, True, 2),
                                       ("small_t", probing.SMALL_T, False, 3),
                                       ("dma", probing.DMA, False, 3))}))
    p5_grid = {name: dict(p5.kernel_info(kind, device.index or 0))
               for kind, name in ((0, "int8"), (1, "conv"), (2, "bf16"))}
    log("P5's grid (SMs x resident blocks an SM), blocks an SM, registers: " + json.dumps(
        {k: {f: g[f] for f in ("grid", "blocks_per_sm", "registers", "local_bytes")}
         for k, g in p5_grid.items()}))
    cuda_build.reset_launches()
    timed = {name: [probing.time_variant(v, PROBE_REPS, plain_reps=1) for v in vs]
             for name, vs in groups.items()}
    counts = dict(cuda_build.LAUNCHES)
    # After the counts: a CUDA graph's capture calls the wrapper, its
    # replays launch without it.
    alone = p5.device_rows(groups["probe_int8_bw"])
    rows = {}
    for name, vs in timed.items():
        if counts[name] <= 0:
            raise AssertionError(f"probe {name} never launched its kernel")
        # P5's rows add its device-alone time (its case names are its own).
        rows[name] = [{**checked[name][t["case"]], **t, **alone.get(t["case"], {})} for t in vs]
        for r in rows[name]:
            log(f"{name} {json.dumps(r)}")
    hbm = probing.HBM_BYTES_S / 1e9
    log("P5 on the device alone, GB/s beside the card's " + f"{hbm:.0f}: " + ", ".join(
        f"{r['case']} {r['device_ms']:.4f} ms {r['device_gbps']:.0f} "
        f"({r['device_gbps'] / hbm:.0%})" for r in rows["probe_int8_bw"]))
    heads = {"probe_int8_bw": "sum_int8_kb2", "probe_paired_parts": "two_dots_sched",
             "probe_paired_orient": "both_i8_sched",
             "probe_paired_bwd_idioms": f"paired_bwd_K{p4b.K_FULL}",
             "probe_paired_idioms": f"paired_K{p1.K_FULL}_sched"}
    # P1-P4's library call: K1's and K3's yardstick, one torch.bmm a half,
    # at their shape (K = 963, N = 645, H = 64, bf16 operands).
    q = torch.randn((2, p1.K_FULL, p1.H, p1.N), generator=g, device=device).to(torch.bfloat16)
    bmm_ms = bmm_library_ms(m963, q[0], q[1])
    del q
    for name in BMM_PROBES:
        for r in rows[name]:
            if r["case"] == heads[name]:
                r["library_ms"] = bmm_ms
    k1_ms = {r["case"]: r["ms"] for r in paired_rows if r["case"].startswith("(1,1)")}
    parts = {r["case"]: r["ms"] for r in rows["probe_paired_parts"]}
    orient = {r["case"]: r["ms"] for r in rows["probe_paired_orient"]}
    log(f"K1, phase 4, at (1,1): {json.dumps(k1_ms)} (layer 1 scales f32 operands, layer 2 "
        "bf16); beside it P3, the same sweep in parts at the schedule's cut, bf16 operands, "
        "no scales: " + ", ".join(f"{m} {parts[f'{m}_sched']:.3f}" for m in p3.MODES)
        + " ms; P2 at the schedule's cut: " + ", ".join(
            f"{c} {orient[c]:.3f}" for c in orient if c.endswith(("_sched", "_sched_s2")))
        + f" ms; P3 dma_only {parts['dma_only_sched']:.3f} ms (the ring's copies of the mask and "
        f"operands) beside P5's plain int8 read of the 964-relation stack "
        f"{rows['probe_int8_bw'][0]['device_ms']:.3f} ms and its conv "
        f"{rows['probe_int8_bw'][2]['device_ms']:.3f} ms (device alone)")
    p1_ms = {r["case"]: r["ms"] for r in rows["probe_paired_idioms"]}
    log(f"P1 on the sweep: {json.dumps(p1_ms)}; P4 on K3's sweep: "
        f"{rows['probe_paired_bwd_idioms'][-1]['ms']:.3f} ms; two torch.bmm at P1's and P4's "
        f"shape {bmm_ms:.3f} ms")
    log(f"probe launches {json.dumps({n: counts[n] for n in groups})}; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, rows, heads


# Phase 19: the CLI's config, the dummy dataset at full width.
SHELL_CONF = dict(
    DataSetType="DecagonDummyData", ActiveLearnerType="NoopActiveLearner", NumProteins=500,
    NumDrugs=400, NumDrugDrugRelationTypes=3, hidden1=64, hidden2=32, batch_size=512,
    NumEpochs=1, ScanChunk=50, NumIterationsPerLog=50, NumIterationsPerCheckpoint=10**9,
    MaxCheckpointsToKeep=1, ValFraction=0.05, TestFraction=0.0,
)
# The predictor (numpy, f64 products of the exported f32 tables) against
# the card's evaluator (f32 through K5) on the same edges.
SHELL_AUROC_TOL = 1e-4


def framework_shell(device, seed):
    """The port's CLI on the card, as a user runs it: ``cli.main`` on a
    config file (launch counters set to 0 just before, read just after),
    the export from its checkpoint, the numpy predictor against the card's
    evaluator on relation 0's recorded edges, and one greedy selection
    round through the scorer the CLI wires.  The kernels the CLI ran are
    held against their plain versions at its own shapes: K1/K2 on the
    restored parameters, K1/K2-ds and K3/K4 on the operands of its first
    step, K5 on its validation sweep; the evaluator's probabilities
    against the predictor's edge by edge.  (Phase 2 asserts that the
    native library, which the CLI's split uses, was built.)"""
    import csv
    import glob
    import math
    import tempfile

    import numpy as np
    import torch

    from decagon_tpu_torch import cli, native
    from decagon_tpu_torch.config import Config
    from decagon_tpu_torch.models.model import DecagonModel
    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.predict import export
    from decagon_tpu_torch.predict.predictor import NpPredictor, PredictionsInfo
    from decagon_tpu_torch.train.active import GreedyActiveLearner
    from decagon_tpu_torch.train.checkpoint import Checkpointer
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
    from decagon_tpu_torch.train.layout import (
        build_dataset, build_training_device_graph, training_graph,
    )
    from decagon_tpu_torch.train.step import make_generator

    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        conf = dict(SHELL_CONF, Seed=seed, ShouldCheckpoint=True, CheckpointDirectory=f"{tmp}/ck",
                    WriteNdarrays=True, NdarrayWriteDir=f"{tmp}/nd", NpSaveDir=f"{tmp}/export",
                    TestEdgeFilename=f"{tmp}/edges.csv", TrainIterationResultDir=f"{tmp}/results")
        path = f"{tmp}/conf.json"
        with open(path, "w") as f:
            json.dump(conf, f)
        rec = Recorder()
        rec.on = True
        try:
            cuda_build.reset_launches()
            t = time.perf_counter()
            cli.main(["--config", path])
            torch.cuda.synchronize()
            secs["cli"] = time.perf_counter() - t
            counts = dict(cuda_build.LAUNCHES)
        finally:
            rec.close()
        for name in ("paired_fwd", "paired_bwd", "sddmm"):
            if counts[name] <= 0:
                raise AssertionError(f"the CLI never launched {name}")
        rec.require("the CLI's first step")
        (log_path,) = glob.glob(f"{tmp}/results/decagon_iteration_results_*.csv")
        with open(log_path) as f:
            rows = list(csv.DictReader(f))
        for row in rows:
            for key in ("AUROC", "AUPRC", "APK"):
                v = float(row[key])
                if not (math.isfinite(v) and 0.0 <= v <= 1.0):
                    raise AssertionError(f"iteration CSV: {key} {v} outside [0, 1]")
        log(f"CLI {secs['cli']:.2f}s: {len(rows)} iteration rows, last {rows[-1]}; launches "
            f"(apart from the main path's) {counts}")

        t = time.perf_counter()
        export.main(["--config", path])
        secs["export"] = time.perf_counter() - t
        config = Config.from_json(path)
        graph, protein_ids, drug_ids, names = build_dataset(config)
        tg = training_graph(config, graph, protein_ids, drug_ids)
        dg = build_training_device_graph(config, tg, device)
        model = DecagonModel(config.model_config(), dg)
        params = Checkpointer(conf["CheckpointDirectory"]).restore_latest(
            {"params": model.init_params(make_generator(seed, device), dg)},
            partial=True)["params"]

        # The CLI's kernels at its own shapes (launches here are not counted).
        paired_rows = check_paired(dg, params, model)
        fwd_ds_rows, bwd_rows = check_training_kernels(dg, rec, synthetic=False)
        del rec
        evaluator = AccuracyEvaluator(model, tg.full, tg.splits, device=device)
        emb = evaluator.embeddings(params, dg)
        sddmm_rows, _ = check_sddmm(dg, params, emb, tg.splits, seed)

        want = evaluator.evaluate(params, dg, (1, 1, 0)).auroc
        t = time.perf_counter()
        (edges_csv,) = glob.glob(f"{tmp}/edges-*.csv")
        info = PredictionsInfo(conf["NpSaveDir"], edges_csv, tg.drug_ids)
        predictor = NpPredictor(info, names[0])
        got = predictor.predict()
        secs["predictor"] = time.perf_counter() - t
        # Edge by edge: the evaluator (K5, f32) against the predictor (f64
        # numpy over the exported tables) on the predictor's edges, which
        # index the training numbering (the config does not renumber).
        edges = np.vstack([predictor.neg_edges, predictor.pos_edges])[:, :2]
        card_probs = evaluator._probs(params, dg, (1, 1, 0), edges, embeddings=emb)
        p = np.clip(got.probabilities, 1e-12, 1 - 1e-12)
        logit_max = float(np.abs(np.log(p) - np.log1p(-p)).max())
        prob_err = float(np.abs(card_probs - got.probabilities).max())
        prob_bound = SDDMM_REL_TOL * max(1.0, logit_max)
        exported = np.load(f"{conf['NpSaveDir']}/embeddings.npy")
        logged = np.load(f"{conf['NdarrayWriteDir']}/embeddings.npy")
        log(f"export {secs['export']:.2f}s, embeddings {exported.shape} (the logger's at the same "
            f"step: max diff {np.abs(exported - logged).max():.3g}); predictor "
            f"{secs['predictor']:.3f}s: AUROC {got.auroc:.6f}, evaluator {want:.6f}, AUPRC "
            f"{got.auprc:.6f}, confusion {got.confusion_matrix.tolist()}; {len(edges)} edges' "
            f"probabilities, K5 against the predictor: max diff {prob_err:.3g} "
            f"(bound {prob_bound:.3g})")
        if not abs(got.auroc - want) <= SHELL_AUROC_TOL:
            raise AssertionError(f"predictor AUROC {got.auroc} against the evaluator's {want}")
        if not prob_err <= prob_bound:
            raise AssertionError(f"evaluator probabilities {prob_err:.3g} from the predictor's, "
                                 f"past {prob_bound:.3g}")
        del emb, evaluator, model, dg, params

        greedy = Config(dict(SHELL_CONF, Seed=seed, TrainIterationResultDir=f"{tmp}/greedy"))
        learner = GreedyActiveLearner(graph, test_set_proportion=0.3, init_train_proportion=0.5,
                                      seed=seed)
        masked, holdout = learner.get_update()
        t = time.perf_counter()
        cli.train_once(greedy, masked, holdout, "greedy", protein_ids, drug_ids, names,
                       learner=learner)
        secs["greedy_train"] = time.perf_counter() - t
        before = len(learner.possibilities)
        cuda_build.reset_launches()
        t = time.perf_counter()
        learner.get_update()
        torch.cuda.synchronize()
        secs["greedy_round"] = time.perf_counter() - t
        greedy_counts = dict(cuda_build.LAUNCHES)
        log(f"greedy: one epoch {secs['greedy_train']:.2f}s, a selection round over {before} "
            f"cells {secs['greedy_round']:.2f}s, {before - len(learner.possibilities)} unmasked; "
            f"launches {greedy_counts}")
        if greedy_counts["sddmm"] <= 0:
            raise AssertionError("the greedy round did not score through K5")
    checks = {row["case"]: row["rel_err"]
              for row in paired_rows + fwd_ds_rows + bwd_rows + sddmm_rows}
    return dict(seconds=secs, launches=counts, greedy_launches=greedy_counts,
                native_build_s=native.BUILD_INFO.get("seconds"), predictor_auroc=got.auroc,
                evaluator_auroc=want, predictor_auprc=got.auprc, iteration_rows=len(rows),
                kernel_rel_err=checks, prob_max_diff=prob_err, prob_bound=prob_bound)


# ---- phase 22: the ported scripts at a small size ---------------------------

# The graph of the scripts' CPU tests (``tests/test_torch_scripts_profile.py``).
SCRIPT_GRAPH = dict(n_proteins=200, n_drugs=40, n_side_effects=4, min_edges_per_relation=20,
                    total_drugdrug_edges=800, ppi_attachment=5, seed=7)
# The JAX artifact each script's record keeps the fields of.
JAX_ARTIFACTS = {"profile_epoch": "epoch_profile", "bench_paired": "paired_bench",
                 "profile_fullscale_step": "fullscale_step_profile",
                 "profile_factored_ops": "paired_op_profile", "profile_sddmm": "sddmm_profile",
                 "probe_adam": "adam_probe"}
# Phase 23's JAX quality records: the file, and the entry whose keys a record
# keeps (None: the top-level keys).
JAX_QUALITY = {"quality_ablation": ("ablation", "base"),
               "schedule_ablation": ("schedule_ablation", "ref_g1"),
               "oracle_ceiling": ("oracle_ceiling", "noise_0.15"),
               "probe_adam_bf16": ("adam_bf16_moments", None)}


def jax_fields(name):
    """The JAX fields of ``name``'s record: the top-level keys of its JAX
    artifact (plain JSON), for ``bench_scale``, which writes no file, the
    keys of the JSON line ``scripts/bench_scale.py`` prints (read from its
    text), for ``quality_run`` the JAX quality CSV's columns, for phase 23's
    quality tools the keys of an entry of their JAX record (``JAX_QUALITY``)."""
    import ast
    import csv

    root = os.path.dirname(os.path.abspath(__file__))
    if name in JAX_QUALITY:
        file, entry = JAX_QUALITY[name]
        with open(os.path.join(root, "artifacts", "quality", f"{file}.json")) as f:
            record = json.load(f)
        return tuple(record if entry is None else record[entry])
    if name == "quality_run":
        with open(os.path.join(root, "artifacts", "quality", "dummy_metrics.csv")) as f:
            return tuple(next(csv.reader(f)))
    if name == "bench_scale":
        with open(os.path.join(root, "scripts", "bench_scale.py")) as f:
            tree = ast.parse(f.read())
        (line,) = [n.args[0] for n in ast.walk(tree) if isinstance(n, ast.Call)
                   and getattr(n.func, "attr", None) == "dumps" and isinstance(n.args[0], ast.Dict)]
        return tuple(k.value for k in line.keys)
    with open(os.path.join(root, "artifacts", "perf", f"{JAX_ARTIFACTS[name]}.json")) as f:
        return tuple(json.load(f))


def _numbers(tree, path=""):
    """(path, value) of every number in a record."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _numbers(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _numbers(v, f"{path}[{i}]")
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield path, tree


def _script_record(name, record, fields, kernels, launches):
    """Raise unless ``record`` holds ``fields``, every number in it is
    finite and every kernel of ``kernels`` launched (``launches``)."""
    import math

    missing = [f for f in fields if f not in record]
    bad = [p for p, v in _numbers(record) if not math.isfinite(v)]
    silent = [k for k in kernels if not launches.get(k)]
    if missing or bad or silent:
        raise AssertionError(f"{name}: fields {missing} missing, {bad[:5]} not finite, "
                             f"kernels {silent} never launched ({launches})")
    log(f"{name}: {len(fields)} JAX fields, launches {json.dumps(launches)}")


def on_one_thread(fn, device):
    """``fn(device)`` on one host thread: phase 20 (b)'s ranks start on the
    other cores meanwhile."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(device)
    finally:
        torch.set_num_threads(threads)


def ported_scripts(device):
    """Phase 22: seven ported scripts' functions on the card at the sizes
    of their CPU tests, on one host thread; returns each one's seconds and
    launches."""
    return on_one_thread(_ported_scripts, device)


def _ported_scripts(device):
    import csv
    import tempfile

    from decagon_tpu_torch.scripts import (
        bench_paired, bench_scale, probe_fullscale, profile_factored_ops, profile_fullscale_step,
        profile_sddmm, quality_run,
    )

    quiet = lambda msg: None  # noqa: E731
    out = {}

    def done(name, t0, launches):
        out[name] = dict(seconds=time.perf_counter() - t0, launches=launches)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        graph = quality_run.make_synthetic_graph(n_genes=60, n_drugs=40, n_drugdrug_types=2,
                                                 seed=0)
        path, (epoch, val, test) = quality_run.train_to_plateau(
            "smoke", graph, max_epochs=1, eval_every=1, device=device, artifact_dir=tmp)
        with open(path) as f:
            header = next(csv.reader(f))
        with open(path.replace(".csv", ".meta.json")) as f:
            meta = json.load(f)
    last = meta["evaluations"][-1]
    launches = dict(adam=last["adam_launches_per_step"], **last["eval_launches"])
    _script_record("quality_run", dict(meta, columns=header),
                   ("columns", "evaluations", "aggregation", "stopped"), ("adam", "sddmm"),
                   launches)
    if header != list(jax_fields("quality_run")) or launches["adam"] != 1.0:
        raise AssertionError(f"quality_run: columns {header}, K7 {launches['adam']} a step")
    done("quality_run", t0, launches)

    t0 = time.perf_counter()
    (line,) = bench_scale.bench_scale(4, ["pallas"], device,
                                      graph_kw=dict(n_proteins=200, n_drugs=40, seed=7),
                                      chunk=2, densify_max_cells=0)
    launches = line["launches_per_step"]
    _script_record("bench_scale", line, jax_fields("bench_scale"), ("adam", "spmm_tiled"),
                   launches)
    done("bench_scale", t0, launches)

    t0 = time.perf_counter()
    rec = probe_fullscale.probe(probe_fullscale.parse_args([
        "--relations", "4", "--proteins", "200", "--drugs", "40", "--edges", "800",
        "--chunk", "2", "--steps", "2", "--densify-max-cells", "0", "--device", str(device)]),
        log=quiet)
    _script_record("probe_fullscale", rec, ("stages_s", "adj", "ms_per_step", "edges_per_s",
                                            "hbm_after_first_step"),
                   ("adam", "spmm_tiled"), rec["launches_per_step"])
    done("probe_fullscale", t0, rec["launches_per_step"])

    t0 = time.perf_counter()
    rec = bench_paired.bench_paired(device, graph_kw=SCRIPT_GRAPH, chunk=2, windows=2, reps=2)
    launches = dict(rec["ub_1,1"]["launches_per_call"]["fwdbwd_pair"],
                    **rec["step"]["paired"]["launches_per_step"])
    _script_record("bench_paired", rec, jax_fields("bench_paired"),
                   ("paired_fwd", "paired_bwd", "adam"), launches)
    done("bench_paired", t0, launches)

    t0 = time.perf_counter()
    rec = profile_fullscale_step.profile_step(device=device, graph_kw=SCRIPT_GRAPH, reps=2)
    launches = rec["launches_per_call"]["full_step"]
    _script_record("profile_fullscale_step", rec, jax_fields("profile_fullscale_step"),
                   ("adam",), launches)
    if rec["launches_per_call"]["adam_only"] != {"adam": 1.0}:
        raise AssertionError(f"adam_only: {rec['launches_per_call']['adam_only']}")
    done("profile_fullscale_step", t0, launches)

    t0 = time.perf_counter()
    rec = profile_factored_ops.profile_ops("paired", chunk=2, device=device,
                                           graph_kw=SCRIPT_GRAPH)
    _script_record("profile_factored_ops", rec, jax_fields("profile_factored_ops"),
                   ("paired_fwd", "paired_bwd", "adam"), rec["launches_per_step"])
    (plane,) = rec["planes"].values()
    if not plane["ops"] or sum(o["share"] for o in plane["ops"]) > 1 + 1e-9:
        raise AssertionError(f"profile_factored_ops: {plane}")
    done("profile_factored_ops", t0, rec["launches_per_step"])

    t0 = time.perf_counter()
    rec = profile_sddmm.profile_sddmm(device, graph_kw=SCRIPT_GRAPH, log=quiet)
    launches = dict(rec["production_auto_launches"],
                    **rec["pallas_kernel_compiled"]["highest"]["launches_per_call"])
    _script_record("profile_sddmm", rec, jax_fields("profile_sddmm"),
                   ("sddmm", "sddmm_bf16"), launches)
    done("profile_sddmm", t0, launches)
    return out


# ---- phase 25: the public-data ingest at a small scale -----------------------

# ``ingest_fullsize.draws``' scale: ~10,500 combo rows over 150 drugs and 5
# side effects, 3 of them past the 500-row filter.
INGEST_SCALE = 0.002


def ingest_small(device):
    """Phase 25: ``decagon_tpu_torch/scripts/ingest_fullsize.py``'s whole
    path at ``INGEST_SCALE`` through its own ``ingest``: the fixture's CSVs,
    the native parse equal to the Python parse, ``load_public_dataset``,
    the split, then both legs: two "xla" steps (K7 once a step) and, on the
    bench headline's device graph, two paired steps (K1-K4 and K7 once a
    step) and the pooled evaluation with f32 and bf16 tables (K5, K5-bf16).
    Losses finite, the evaluations' metrics in [0, 1].  Returns (launches,
    summary)."""
    from decagon_tpu_torch.scripts import ingest_fullsize

    rec = ingest_fullsize.ingest(str(device), INGEST_SCALE, log=lambda msg: None)
    xla, paired = rec["xla_steps"], rec["paired"]
    steps = ingest_fullsize.STEPS
    ev, ev_bf16 = paired["eval"], paired["eval_bf16_tables"]
    bad = []
    if not rec["native_vs_python_equal"]:
        bad.append("the native and Python parses differ")
    # Every large relation has 500 rows or more, every small one fewer.
    if rec["relations_after_filter"] != ingest_fullsize.counts(INGEST_SCALE)["n_big"]:
        bad.append(f"relations {rec['relations_after_filter']}")
    if not (rec["losses_finite"] and paired["losses_finite"]):
        bad.append(f"losses {xla['losses']} / {paired['losses']}")
    if xla["launches"] != {"adam": steps}:
        bad.append(f"xla launches {xla['launches']}")
    if paired["launches"].get("adam") != steps or not (
            paired["launches"].get("paired_fwd", 0) > 0
            and paired["launches"].get("paired_bwd", 0) > 0):
        bad.append(f"paired launches {paired['launches']}")
    if ev["launches"].get("sddmm", 0) <= 0 or ev_bf16["launches"].get("sddmm_bf16", 0) <= 0 \
            or not all(0.0 <= e[k] <= 1.0 for e in (ev, ev_bf16)
                       for k in ("auroc", "auprc", "apk")):
        bad.append(f"evaluations {ev}, {ev_bf16}")
    if paired["forms"].get("1,1") != "paired":
        bad.append(f"forms {paired['forms']}")
    if bad:
        raise AssertionError(f"ingest_fullsize at scale {INGEST_SCALE}: {bad}")
    launches = {}
    for counts in (xla["launches"], paired["launches"], ev["launches"], ev_bf16["launches"]):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    summary = {k: rec[k] for k in ("fixture", "native_parse", "python_parse",
                                   "relations_after_filter", "n_drugs", "n_proteins",
                                   "load_public_dataset_s", "split_and_device_graph_s",
                                   "two_cpu_train_steps_s", "stage_s", "wall_s")}
    summary.update(xla_launches=xla["launches"], paired_forms=paired["forms"],
                   paired_launches=paired["launches"], paired_ms_per_step=paired["ms_per_step"],
                   eval=ev, eval_bf16_tables=ev_bf16, launches=launches)
    log(f"ingest: {json.dumps(summary)}")
    return launches, summary


# ---- phase 23: the quality tools and the step and optimizer probes ----------

# The graphs of their CPU tests.
SCRIPT_DUMMY = dict(n_genes=60, n_drugs=40, n_drugdrug_types=2, seed=0)
SCRIPT_POLY = dict(n_proteins=200, n_drugs=40, n_side_effects=4, seed=7, planted_rank=4)


def quality_and_probes(device):
    """Phase 23: the nine ports of the dummy config's quality tools and the
    step and optimizer probes, on the card at the sizes of their CPU tests,
    on one host thread; returns each one's seconds and launches."""
    return on_one_thread(_quality_and_probes, device)


def _trainer_rows(name, rows):
    """Raise unless K7 launched once an optimization step and K5 in the
    evaluation of every row; returns the last row's launches."""
    for row in rows:
        if row["adam_launches_per_opt_step"] != 1.0 or not row["eval_launches"].get("sddmm"):
            raise AssertionError(f"{name}: K7 {row['adam_launches_per_opt_step']} an "
                                 f"optimization step, evaluation launches {row['eval_launches']}")
    return dict(adam=rows[-1]["adam_launches_per_opt_step"], **rows[-1]["eval_launches"])


def _quality_and_probes(device):
    from decagon_tpu_torch.scripts import (
        oracle_ceiling, perf_probe, perf_probe2, probe_adam, probe_adam_bf16,
        probe_dense_layout, quality_ablation, quality_probe, schedule_ablation,
    )

    quiet = lambda msg: None  # noqa: E731
    out = {}

    def done(name, t0, launches):
        out[name] = dict(seconds=time.perf_counter() - t0, launches=launches)

    t0 = time.perf_counter()
    rec = quality_ablation.run_variant("lazy_adam", quality_ablation.VARIANTS["lazy_adam"],
                                       max_epochs=1, eval_every=1, device=device,
                                       graph_kw=SCRIPT_DUMMY, log=quiet)
    launches = _trainer_rows("quality_ablation", rec["evaluations"])
    _script_record("quality_ablation", rec, jax_fields("quality_ablation"), ("adam", "sddmm"),
                   launches)
    done("quality_ablation", t0, launches)

    t0 = time.perf_counter()
    rec = quality_probe.run("refproto", epochs=1, val_frac=0.05, test_frac=0.0, device=device,
                            graph_kw=SCRIPT_DUMMY, log=quiet)
    launches = _trainer_rows("quality_probe", rec["evaluations"])
    _script_record("quality_probe", rec["evaluations"][-1],
                   ("epoch", "val_auroc", "test_auroc", "test_auprc", "seconds"),
                   ("adam", "sddmm"), launches)
    done("quality_probe", t0, launches)

    t0 = time.perf_counter()
    rec = oracle_ceiling.ceiling_for(0.15, graph_kw=dict(SCRIPT_GRAPH, planted_rank=4))
    for tag in jax_fields("oracle_ceiling"):
        _script_record("oracle_ceiling", rec[tag], ("oracle_auroc", "oracle_auprc", "n_scored"),
                       (), {})
    done("oracle_ceiling", t0, {})

    t0 = time.perf_counter()
    rec = schedule_ablation.schedule_ablation(["bal_g8"], epochs=1, device=device,
                                              graph_kw=SCRIPT_POLY, log=quiet)["bal_g8"]
    launches = _trainer_rows("schedule_ablation", rec["epochs"])
    _script_record("schedule_ablation", rec, jax_fields("schedule_ablation"), ("adam", "sddmm"),
                   launches)
    done("schedule_ablation", t0, launches)

    t0 = time.perf_counter()
    rec = perf_probe.perf_probe(["pallas"], chunk=2, device=device,
                                graph_kw=SCRIPT_DUMMY, reps=1, log=quiet)
    for impl, entry in rec["impls"].items():
        for line in perf_probe.LINES:
            kernels = (("adam",) if line in ("full_chunked_step", "step_flat_adam") else ()) + (
                ("spmm_tiled",) if impl == "pallas" else ())
            _script_record(f"perf_probe {impl} {line}", entry[line],
                           ("ms_per_step", "profile"), kernels, entry[line]["launches_per_step"])
    launches = rec["impls"]["pallas"]["full_chunked_step"]["launches_per_step"]
    done("perf_probe", t0, launches)

    t0 = time.perf_counter()
    rec = perf_probe2.perf_probe2(chunk=2, device=device, graph_kw=SCRIPT_DUMMY, reps=1,
                                  log=quiet)
    launches = rec["full_chunked_step_launches_per_step"]
    _script_record("perf_probe2", rec, ("full_chunked_step_ms", "encoder_fwd_det_False_ms",
                                        "encoder_fwd_det_True_ms", "tile_block", "rng"),
                   ("adam", "spmm_tiled"), launches)
    done("perf_probe2", t0, launches)

    t0 = time.perf_counter()
    rec = probe_adam.probe_adam(device=device, graph_kw=SCRIPT_GRAPH, batch_size=64, n=2,
                                log=quiet)
    launches = rec["launches_per_call"]
    _script_record("probe_adam", rec, jax_fields("probe_adam"), ("adam",), launches["adam_fused"])
    if launches["adam_fused"] != {"adam": 1.0} or launches["adam_flatten"] != {"adam": 1.0}:
        raise AssertionError(f"probe_adam: K7 launches a call {launches}")
    done("probe_adam", t0, launches)

    t0 = time.perf_counter()
    rec = probe_adam_bf16.probe_adam_bf16(device=device, quality_kw=SCRIPT_POLY,
                                          perf_kw=SCRIPT_GRAPH, epochs=1, chunk=2, chunks=1,
                                          log=quiet)
    launches = _trainer_rows("probe_adam_bf16", [e for dtype in probe_adam_bf16.DTYPES
                                                 for e in rec[f"poly50_epochs_{dtype}"]])
    _script_record("probe_adam_bf16", rec, jax_fields("probe_adam_bf16"), ("adam", "sddmm"),
                   launches)
    done("probe_adam_bf16", t0, launches)

    t0 = time.perf_counter()
    rec = probe_dense_layout.probe_dense_layout(device=device, graph_kw=SCRIPT_GRAPH, reps=1,
                                                log=quiet)
    for key in probe_dense_layout.KEYS:
        _script_record(f"probe_dense_layout {key}", rec[key],
                       ("einsum_ms", "mm2d_ms", "stack_gb", "out_dtype"), (), {})
        errs = {k: rec[key][k] for k in ("einsum_max_rel_err", "mm2d_max_rel_err",
                                          "forms_max_rel_diff")}
        if max(errs["einsum_max_rel_err"], errs["mm2d_max_rel_err"]) > 2 ** -8 or \
                errs["forms_max_rel_diff"] > 2 ** -7:
            raise AssertionError(f"probe_dense_layout {key}: the forms against the f32 "
                                 f"product and each other: {errs}")
    done("probe_dense_layout", t0, {})
    return out


# Kernels whose first port was redesigned for the card (marked in the report).
REDESIGNED = ("paired_fwd", "paired_bwd", "sddmm", "sddmm_bf16", "spmm_tiled", "adam",
              "probe_int8_bw", "probe_paired_parts", "probe_paired_orient",
              "probe_paired_bwd_idioms", "probe_paired_idioms")


def kernel_entry(name, source, replaces, launches, rows, library_rows=None, cases=None):
    """One kernel's line of the report, its numbers summed over ``rows``;
    ``library_ms`` summed over ``library_rows`` (None: no library call
    computes the function)."""
    bytes_ms = sum(r["bytes_ms"] for r in rows)
    ops_ms = sum(r["ops_ms"] for r in rows)
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None if library_rows is None else sum(r["library_ms"] for r in library_rows),
        redesigned=name in REDESIGNED, cases=rows if cases is None else cases,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="weights and random pairs")
    ap.add_argument("--prepare-beyond", metavar="PATH", default=None,
                    help="(internal) build phase 21's graph on the host into PATH")
    args = ap.parse_args(argv)
    if args.prepare_beyond:
        return prepare_beyond(args.prepare_beyond)

    phase("device", "1")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from decagon_tpu_torch import resolve_device

    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = card()
    log(f"{kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    beyond = BeyondBuild()
    try:
        return run_phases(args, device, kind, count, beyond)
    finally:
        beyond.stop()


def run_phases(args, device, kind, count, beyond) -> int:
    """Phases 2-24 (``main`` has run phase 1 and started phase 21's host
    build)."""
    import torch

    from decagon_tpu_torch.ops import cuda_build

    phase("build", "2")
    cuda_build.library()
    log(f"nvcc build {cuda_build.BUILD_INFO['seconds']:.1f}s")
    from decagon_tpu_torch import native

    if native.get_library() is None:
        raise AssertionError("g++ failed to build the native library")
    log(f"g++ build of the native library {native.BUILD_INFO['seconds']:.2f}s")
    for line in str(cuda_build.BUILD_INFO["ptxas"]).splitlines():
        if "Used" in line or "spill" in line:
            log("ptxas " + line.strip())

    phase("serving state (paper scale)", "3")
    torch.cuda.reset_peak_memory_stats()
    graph, splits, dg, model, params, evaluator = build_state(PAPER, device, args.seed)
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("kernels against plain versions", "4")
    paired_rows = check_paired(dg, params, model)
    emb = evaluator.embeddings(params, dg)
    sddmm_rows, sddmm_bf16_rows = check_sddmm(dg, params, emb, splits, args.seed)
    del emb
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("serve", "5")
    counts, serve_split = serve(graph, splits, dg, model, params, evaluator)

    phase("small-input reference", "6")
    small_reference(device)

    phase("train (paper scale)", "7")
    train_counts, rec, train_summary, _ = train(dg, params, model, splits, args.seed)
    step_gradients(dg, params, model, splits, args.seed)

    phase("kernels against plain versions, training", "8")
    fwd_ds_rows, bwd_rows = check_training_kernels(dg, rec)
    del rec
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("small-input training", "9")
    small_training(device)

    phase("trainer (paper scale)", "10")
    step_ms = train_summary[str((1, 1))]["step_ms_median_after_first"]
    trainer_counts, trainer_summary, state = trainer_phase(graph, splits, dg, model, args.seed,
                                                           step_ms)

    phase("one-pass Adam against plain versions", "11")
    adam_tree_row, adam_rows, p6_launches = check_adam(device, state, args.seed)

    phase("trainer chunks through K7 and its plain version, and with pallas_adam (paper scale)",
          "12")
    chunk_counts, chunk_summary = optimizer_chunks(graph, splits, dg, model, args.seed, state)

    phase("grouped trainer: the quality run's config (paper scale)", "12b")
    grouped_counts, grouped_summary = grouped_trainer(graph, splits, dg, model, evaluator,
                                                      args.seed, state)
    del state
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("dummy config on the card", "13")
    gate = dummy_gate(device, args.seed)

    phase("sparse state (paper scale)", "14")
    del dg, evaluator, model, params
    torch.cuda.empty_cache()
    dg_sparse, sparse_summary = sparse_state(graph, splits, device)

    phase("K6 against its plain version", "15")
    params_sparse = sparse_model(dg_sparse, "default").init_params(
        torch.Generator().manual_seed(args.seed), dg_sparse)
    spmm_rows, spmm_bf16_rows = check_spmm(dg_sparse, params_sparse)
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("sparse training (paper scale)", "16")
    sparse_counts, sparse_train, params_sparse = sparse_training(graph, splits, dg_sparse,
                                                                 args.seed)
    sparse_train["gradients"] = sparse_gradients(dg_sparse, params_sparse, splits, args.seed)
    del params_sparse

    phase("mesh (a): paper scale, a (1, 1) NCCL mesh", "20a")
    mesh_counts, mesh_paper_summary, mesh_k6_rows, mesh_k5_rows = mesh_paper(
        graph, splits, dg_sparse, args.seed,
        sparse_train["trainer"]["default"]["ms_per_step_median"])
    del dg_sparse
    torch.cuda.empty_cache()

    phase("sparse regime beyond the paper's scale (1,600 drugs)", "21")
    beyond_counts, beyond_summary, beyond_k6_rows = beyond_paper(beyond, device, args.seed)
    torch.cuda.empty_cache()
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("small-input sparse checks", "17")
    small_sparse(device)

    phase("probes", "18")
    probe_counts, probe_rows, probe_heads = probes(device, args.seed, paired_rows)

    # The ranks start after the last phase whose kernel times enter the
    # report, so that no CUDA-event time is taken while they share the card.
    phase(f"framework shell, while phase 20 (b)'s {MESH_RANKS} ranks start", "19")
    ranks = spawn_mesh_ranks(device, args.seed, scripts=True)
    try:
        shell = framework_shell(device, args.seed)
        phase("ported scripts at a small size", "22")
        scripts = ported_scripts(device)
        phase("the dummy config's quality tools and the step and optimizer probes at a small "
              "size", "23")
        quality_probes = quality_and_probes(device)
        phase("the public-data ingest at a small scale", "25")
        ingest_counts, ingest = ingest_small(device)

        phase(f"mesh (b): {MESH_RANKS} ranks over gloo on one card", "20b")
        mesh_ranks_summary = mesh_ranks(device, args.seed, ranks)
        phase("mesh scripts (b), (c): the ranks' worlds, then the scaling model", "24b")
        mesh_script_summary = dict(mesh_scripts(device, ranks),
                                   nccl=mesh_paper_summary.pop("scripts"))
        phase(f"mesh (b): the {MESH_RANKS} ranks' exit", "20b")
    finally:
        stop_mesh_ranks(ranks)

    phase("done", "done")
    launches = {name: counts[name] + train_counts[name] + trainer_counts[name]
                + chunk_counts[name] + grouped_counts[name] + sparse_counts[name]
                + mesh_counts[name] + beyond_counts[name] for name in train_counts}
    # Phase 24's own path: its K7 launches in the timed steps of its scripts.
    mesh_script_adam = int(round(
        mesh_script_summary["adam_launches"]
        + sum(v["adam_launches"] for v in mesh_script_summary["nccl"].values())))
    launches["adam"] += mesh_script_adam
    # Phase 25's path: the ingested graph's steps and evaluation.
    for name, n in ingest_counts.items():
        launches[name] += n
    log(f"launches on the main path: serve {counts}, train {train_counts}, trainer "
        f"{trainer_counts}, trainer chunks of phase 12 {chunk_counts}, grouped trainer "
        f"{grouped_counts}, sparse {sparse_counts}, mesh {mesh_counts}, beyond the paper's "
        f"scale {beyond_counts}")
    # K7's line: the main path's leaf tree (its library call, over the same
    # leaves, keeps f32 moments); the one-leaf cases are listed beside it.
    # P6's bf16 case has its own line.
    k7 = kernel_entry("adam", "decagon_tpu_torch/csrc/adam.cu", "decagon_tpu/ops/optim.py:133",
                      launches["adam"], [adam_tree_row], library_rows=[adam_tree_row],
                      cases=[adam_tree_row] + adam_rows)
    k7.update(library=adam_tree_row["library"], launches_by_phase={
        "train_steps_phase7": train_counts["adam"], "trainer_phase10": trainer_counts["adam"],
        "trainer_chunks_phase12": chunk_counts["adam"],
        "grouped_trainer_phase12b": grouped_counts["adam"], "sparse_phase16": sparse_counts["adam"],
        "mesh_phase20a": mesh_counts["adam"], "beyond_paper_phase21": beyond_counts["adam"],
        "mesh_scripts_phase24": mesh_script_adam, "ingest_phase25": ingest_counts["adam"]})
    report = {"kernels": [
        kernel_entry("paired_fwd", "decagon_tpu_torch/csrc/paired_fwd.cu",
                     "decagon_tpu/ops/spmm_paired.py:82", launches["paired_fwd"],
                     paired_rows + fwd_ds_rows, library_rows=paired_rows + fwd_ds_rows),
        kernel_entry("paired_bwd", "decagon_tpu_torch/csrc/paired_bwd.cu",
                     "decagon_tpu/ops/spmm_paired.py:182", launches["paired_bwd"],
                     bwd_rows, library_rows=bwd_rows),
        kernel_entry("sddmm", "decagon_tpu_torch/csrc/sddmm.cu",
                     "decagon_tpu/ops/sddmm_pallas.py:93", launches["sddmm"],
                     sddmm_rows, cases=sddmm_rows + mesh_k5_rows),
        kernel_entry("sddmm_bf16", "decagon_tpu_torch/csrc/sddmm.cu",
                     "decagon_tpu/ops/sddmm_pallas.py:93", launches["sddmm_bf16"],
                     sddmm_bf16_rows),
        # K6: the top-level numbers sum the f32 ("highest") cases, the
        # function torch.sparse.mm computes; every case of both precisions
        # is listed.
        kernel_entry("spmm_tiled", "decagon_tpu_torch/csrc/spmm_tiled.cu",
                     "decagon_tpu/ops/spmm_pallas.py:42", launches["spmm_tiled"],
                     spmm_rows, library_rows=spmm_rows,
                     cases=spmm_rows + spmm_bf16_rows + mesh_k6_rows + beyond_k6_rows),
        k7,
        # P6: the bf16 instantiation of K7 at the probe's shape, its
        # launches those of its own timing path in phase 11.
        kernel_entry("probe_adam_onepass", "decagon_tpu_torch/csrc/adam.cu",
                     "scripts/probe_adam_onepass.py:26", p6_launches,
                     [r for r in adam_rows if r["dtype"] == "bfloat16"]),
    ] + [
        kernel_entry(name, source, replaces, probe_counts[name], head,
                     library_rows=head if name in ("probe_int8_bw",) + BMM_PROBES else None,
                     cases=probe_rows[name])
        for name, source, replaces in PROBES
        for head in [[r for r in probe_rows[name] if r["case"] == probe_heads[name]]]
    ], "train": train_summary, "trainer": trainer_summary, "optimizer_chunks": chunk_summary,
        "grouped_trainer": grouped_summary,
        "dummy_gate": gate, "sparse_state": sparse_summary, "sparse_training": sparse_train,
        "beyond_paper": beyond_summary, "serve_split": serve_split, "ported_scripts": scripts,
        "quality_and_probe_scripts": quality_probes,
        "framework_shell": shell, "ingest": ingest,
        "mesh": {"paper": mesh_paper_summary, "ranks": mesh_ranks_summary},
        "mesh_scripts": mesh_script_summary}
    print(json.dumps({"phase_seconds": phase_seconds()}))
    print(json.dumps(report))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
