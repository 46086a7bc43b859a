#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the script exits
nonzero:

1. the card (``nvidia-smi`` name and power limit, torch's device name),
   the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``,
   and the l1 tile loop's fp32 instructions a column in ``cuobjdump -sass``
   of the built kernels, which set the l1 bound (``l1_ops_from_sass``);
2. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (each round of each cell below) plus ragged
   shapes, random reference masks and, for the survivor ordering, ties,
   -0.0/+0.0, +inf and NaN. Centrality sums and pairwise blocks must agree
   within rtol 1e-5 with a floor of 1e-5 of the largest value (plus the l2
   self-pair allowance, see ``_tolerance``); the ordering must be
   bit-equal. Each kernel is timed by CUDA-graph replay beside its bound,
   its plain version and, where one PyTorch call computes the same function,
   that call (``library_ms``; the port never calls it). The k-medoids
   cells' shapes are checked and timed in phase 4, after their runs. The
   pairwise kernels are also checked on both sides of their crossover
   ``PAIRWISE_S``, at d % 4 != 0, on a view that starts 4 bytes past a
   16-byte boundary and for bit-equal repeats, and both of their paths are
   timed on either side of the crossover; the Gram kernels' gemm path
   (``dot_pairwise`` and ``dot_centrality`` in fp32) is checked the same
   way (l2, sql2 and cosine, masks, d = 4096) and timed beside the tile
   path, the plain versions and ``x @ y.T`` on both sides of its crossover
   (``GEMM_FILL``); the Gram kernels' d split (fp32) on the embedding
   rounds of phases 8d and 10e at d = 92544 and 32000, at d = 92543 and on
   a misaligned view (l2, sql2 and cosine, masks, two launches bit-equal),
   and at each of those rounds both plans timed twice, the wrapper's plan
   required on the faster side wherever they differ by more than the
   noise; so are both paths of the two
   centrality kernels on either side of their crossovers (``l1_centrality``
   at d = 1024 and 4096 around ``CENTRALITY_S``, ``dot_centrality`` for l2
   at d = 784 and cosine at d = 2048 around ``DOT_CENTRALITY_S``; every
   centrality check also holds two launches bit-equal), and
   ``topk_smallest`` (one launch: the rank and the select) at each candidate
   tile and cluster, checked bit-equal to ``argsort(stable=True)[:keep]``
   for keep in {1, C // 2, C} on all-equal and int32-extreme keys and
   around its tile. Each ``find_medoid`` cell's centrality launches are
   split by shape class as in phase 4. The bf16 modes: ``dot_centrality``'s
   on the ragged shapes with masks (l2, sql2, cosine), on both paths around
   ``DOT_CENTRALITY_BF16_S``, and at every widened round shape of the
   phase-5 cells, timed beside its fp32 mode, its plain version and a
   two-call yardstick (``xr @ yr.T`` of pre-rounded rows, the finish and a
   row sum), by path and by shape; wherever it takes the stream path it
   must be bit-equal to the fp32 mode on pre-rounded rows;
   ``dot_pairwise``'s on both paths at the k-medoids pairwise shapes, timed
   beside its plain version, its fp32 mode and ``xr @ yr.T`` (no path
   calls it);
3. the single-query main path at full size: ``repro_torch.api.find_medoid``
   (corr_sh, budget 30 per arm) on the six cells below with the kernel
   launch counters zeroed just before each run and read just after. Each
   winner is held against the ``reference`` backend's on the card with the
   same key, and against the exact medoid (l1 at n=4096, d=512, the README
   command); the planted cells must answer 0. The first cell runs again
   with ``telemetry=True``: the same answer and pulls, telemetry rows whose
   pulls sum to the result's, the hardness present, and the device time of
   the telemetry rows and of the hardness printed (profiled);
4. bandit k-medoids at full width: ``repro_torch.api.kmedoids`` with the
   ``KMedoidsConfig`` defaults on the two cells below, counters zeroed just
   before the first call and held against counts derived from the round
   schedules and the refinement's bucket plan; the repeat must give the
   same medoids, the pulls must stay below n^2/10, the ARI against the
   planted labels must be >= 0.95, and the medoids and labels must equal
   the ``reference`` backend's on the card with the same key (or the costs
   agree to rtol 1e-5, both printed). Each cell's pairwise launches are
   split by shape class (kernel against library) and by path, and the main
   path must take both paths; the centrality kernel's launches likewise by
   class (skinny R-short and C-short, middle, masked refinement) and path,
   beside a two-call yardstick: the (C, R) distance block by one PyTorch
   call (``cdist``, ``cdist(p=1)``, ``1 - x @ y.T`` of unit rows) and a row
   sum or ``@ w``; both centrality kernels must take the stream path in
   both orientations and the tile path. Then ``topk_smallest`` at every C
   of the main path against ``argsort(stable=True)``, beside its rank-only
   mode and a one-element ``zero_()`` (the launch floor), and one line of
   exact PAM at n = 2048 (printed only);
5. the quantized path at full size: ``find_medoid(precision=...)`` on the
   four cells below with phase 3's data, key and budget, counters zeroed
   just before each run and held against one centrality launch per
   executed round (none on the plain quantized backends, and the fp32
   run's after a fallback); the pulls must be the schedule's plus the
   exact check's (plus the schedule's again after a fallback); the answer
   must be no worse in exact fp32 centrality than fp32 corr_sh's under the
   same key, 0 on the planted cell, and on the bf16 fused cells equal to
   the unfused ``quant_bf16`` backend's (or, both verified, of equal exact
   centrality);
6. serving at full width, counters zeroed before each run and held against
   the launches derived from the schedules (one pairwise launch per
   bootstrap and per mutation row, one centrality launch — plus one
   ``topk_smallest`` on ``pallas_fused_topk`` — per executed round of each
   re-run and each request a server dispatch answers; the padding slots
   run nothing), every launch checked and timed as in phase 2 (shapes
   with C * R * d >= BIG_ELEMS: checked against the plain version on
   BIG_ROWS rows of x, then one timed call each, the plain version's over
   all of x in row blocks); the launches of (c) and (d) are checked and
   timed after the serving, on their corpora's buffers, and their time is
   printed apart: (a) a ``MedoidServer`` under FIFO (l2, ``SRV_BACKEND``,
   d = 784, SRV_REQUESTS queries of n log-uniform in SRV_N, budget
   SRV_BUDGET per arm, max_batch SRV_BATCH, gap telemetry on, a
   ``TraceSession``) whose answers and pulls must equal the same server's
   on the ``reference`` backend (an answer may differ only where the last
   round's gap is within 2 rtol of its estimate); (b) the same traffic
   under EDF with a third of the requests on a deadline: answered + shed =
   submitted and the metrics reconcile; (c) a live l2 corpus
   (``maintain_medoid``, planted n0 = 20000, ``pallas_fused``, the
   exact-regime budget of ``serve.stream --verify``), LIVE_L2_STEPS
   mutations (70% inserts of planted rows, the incumbent deleted once),
   every served answer held by ``check_answer`` against a from-scratch
   bootstrap on the card and by the same rule against the reference
   backend's distances (plain PyTorch, no kernel) over the live rows; (d)
   the same on rnaseq20k_like (l1, d = 4096, ``pallas_fused_topk``),
   LIVE_L1_STEPS mutations, checked with ``check_answer`` at every 10th
   version and the last, against the reference where the incumbent goes;
   in both the maintained centralities at the end must lie within 1e-4
   (relative) of the reference's and the served answer pass its rule; (e)
   ``kmedoids_via_service`` on mnist_like (n = 20000, k = 10,
   ``pallas_fused``): ARI >= 0.95 and the refine pulls equal to the
   server's scheduled pulls, then ``ClusterStream.add`` of
   SERVICE_ARRIVALS points and each ``ClusterService`` route. The trace and
   exposition files of (a)-(d) (under ``build/chip_smoke/``) must pass
   ``repro_torch.obs.validate``;
7. the paper's baselines and the distributed engines at full width: (a) on
   mnist_zeros_like (n = 6424, d = 784, l2) and rnaseq20k_like (n = 20000,
   d = 4096, l1), ``find_medoid`` with ``algo="corr_sh"`` (pallas_fused),
   ``"meddit"`` (the facade's defaults: batch 64, sigma 1, a cap of 1000 n
   pulls), ``"rand"`` with RAND_REFS references and ``"exact"``, each with
   its medoid against exact's, pulls, wall, launches and peak memory;
   RAND's pulls must be n * refs, Med-dit's n + 64 a step below the cap
   plus a batch, with one ``threefry`` launch a chunk and one
   ``topk_smallest`` a step; Med-dit's steps, chunks and a profiled run's
   device busy share are printed, and a capped run (MEDDIT_CAPPED_CHUNKS
   chunks) on the captured graph with the kernel's draws must be bit-equal
   (medoid, pulls, means) to the same run eagerly on the plain draws;
   ``threefry`` is checked bit-equal to its plain loop at the main path's
   (K, B, n) and timed beside its bound (the chain's K hashes on one
   thread) and ``topk_smallest`` at (C = n, keep = 64); (b) v1 and v2
   through ``find_medoid(mesh=)`` at world size 1 on NCCL (an in-process
   group on a file store) on planted (n = 20000, d = 784, l2) and
   rnaseq20k_like (l1), pallas_fused: the planted medoid or exact's, one
   centrality launch a round and one ``topk_smallest`` a halving per shard;
8. the LM scaffold's serving path at full width (no kernel of its own: its
   attention and products are plain PyTorch): (a) ``launch.serve.Server``
   on internlm2-1.8b's full config in bf16 (weights from a seeded generator
   on the card), LM_REQUESTS requests of the CLI's prompts through
   LM_SLOTS slots, no kernel launched, steps and tokens as the schedule
   gives them, ms per prefill and per decode step, tokens/s, weight bytes
   and peak memory; then on an fp32 copy the serving invariant of
   ``tests/test_decode_consistency.py`` (prefill on S tokens and one decode
   step against the teacher-forced logits, rtol = atol = 2e-3); (b) two
   layers at that width on the card against the same weights on the CPU
   (fp32, rtol = atol = LM_CARD_CPU_TOL; greedy tokens equal wherever the
   top-two gap exceeds twice it); (c) gemma3-27b at full width cut to 7
   layers (local and global layers, both thetas) in fp32: the invariant on
   a 1536-token prompt (several query and KV blocks); (d) ``examples/embedding_medoid_torch.py``'s embeddings
   of 2048 sequences of 64 tokens on (a)'s weights, (2048, 92544) fp32:
   ``find_medoid`` (key 2, 20 per arm) on ``reference`` and
   ``pallas_fused``, each exact's medoid or within phase 3's gap rule, every
   ``dot_centrality`` launch checked against its plain version and timed
   (row 1e), then ``kmedoids`` (k = 8) and 6 uneven shards through a
   ``MedoidServer``, both on ``pallas_fused`` with derived launch counts
   and the ``reference`` backend's answers; (e) the sidecar
   (``examples/serve_lm_torch.py``'s 8 cosine queries of (512, 64)) on
   ``pallas_fused``, the ``reference`` backend's medoids;
9. the other LM families at full width (``phase9``; plain PyTorch, no
   kernel launched over the phase), each config's ``Server`` in bf16 from
   seed 0 on the card with P9_REQUESTS requests of P9_PROMPT tokens
   (max_new P9_NEW, P9_SLOTS slots; the VLM on zeroed image embeddings,
   whisper on zeroed frames, ``Server._extra``): ms a prefill and a decode
   step, tokens/s, peak memory and one decode step profiled; (a)
   granite-moe-3b-a800m, its served prefills' capacity drops, then decode
   vs forward (rtol = atol = LM_LOGIT_TOL) on an fp32 copy whose capacity
   factor is the expert count (nothing drops); (b) deepseek-v2-lite-16b,
   the same on an fp32 copy cut to DEEPSEEK_FP32_LAYERS layers; (c) its
   first P9_CARD_CPU_LAYERS layers in fp32 at the served capacity on the
   card against the CPU (LM_CARD_CPU_TOL, logits and caches, a prefill and
   LM_CARD_CPU_STEPS decode steps; greedy tokens equal wherever the
   top-two gap exceeds twice the bound, the routed experts equal wherever
   the K-th and (K+1)-th router probabilities differ by more than twice
   the largest card-vs-CPU probability difference, and at least one of the
   two compared); (d) llama-3.2-vision-11b, then its first group (4 self
   layers and a cross layer) in fp32 with the cross gate at P9_GATE on
   seeded image embeddings: decode vs forward and card vs CPU; (e)
   whisper-small, then at full depth in fp32 on seeded frames: decode vs
   forward and card vs CPU;
10. the recurrent families at full width (``phase10``; plain PyTorch, no
   kernel launched before 10e), phase 9's serving and checks: (a)
   xlstm-1.3b and (b) zamba2-2.7b served in bf16 (ms a prefill and a decode
   step, tokens/s, peak memory, a slot's recurrent state, one decode step
   profiled; xLSTM's prefill of one prompt profiled, sLSTM's loop over its
   64 steps, as ``phase10a_prefill`` does alone); (c) decode vs forward
   (LM_LOGIT_TOL) at full depth, B = P10_BATCH on a P10_PROMPT-token
   prompt (several of xLSTM's query and KV blocks, zamba2's SSD chunks
   with a ragged last one): zamba2 on an fp32 copy; xLSTM on a float64 copy, then on an fp32 copy as a reading held
   to no bound (its fp32 rounding, amplified over 48 layers, exceeds
   LM_LOGIT_TOL), and on one fp32 group; (d) one group of each (8 xLSTM
   layers; 6 Mamba2 blocks and the shared block) in fp32 on the card
   against the CPU on the logits and on every state (C, n, m; c, n, h, m;
   h, conv; k, v): zamba2 at LM_CARD_CPU_TOL, xLSTM at XLSTM_CARD_CPU_TOL;
   (e)
   ``examples/embedding_medoid_torch.py``'s embeddings of 2048 sequences
   of 64 tokens on (b)'s weights, (2048, 32000) fp32: ``find_medoid`` on
   ``reference`` and ``pallas_fused``, exact's medoid or within phase 3's
   gap rule, every ``dot_centrality`` launch checked against its plain
   version and timed (row 1h);
11. training on the card (``phase11``; plain PyTorch, no kernel launched
   over the phase): (a) ``repro_torch.launch.train.train`` on
   internlm2-1.8b at full width (d 2048, V 92544, bf16 weights, f32 AdamW
   moments), its 24 layers cut to TRAIN_LAYERS, on the data pipeline at
   ``SHAPES["train_4k"]``'s length of 4096, the batch of 256 cut to
   TRAIN_BATCH sequences in TRAIN_MICRO microbatches, remat, TRAIN_STEPS
   steps with step TRAIN_PROFILED_STEP profiled; then the same run to
   TRAIN_CKPT_EVERY steps with a checkpoint
   under ``build/chip_smoke/train/`` and resumed from it to TRAIN_STEPS
   (a second checkpoint): its losses bit-equal to the first run's under
   ``torch.use_deterministic_algorithms``, and the last loss below the
   first; printed: each step's loss and grad norm, ms a step (first and
   steady), tokens/s, peak memory, the profiled step's busy share and top
   device operations, and the step's bound (``train_step_ops``: the bf16
   products at the tensor cores' rate, the f32 unembedding and attention
   products at the fp32 rate); (b) P11B_LAYERS layers at full width in
   fp32 on a P11B_SEQ-token sequence (several q and KV blocks), card vs
   CPU: the loss, every gradient and the params after one AdamW step within
   TRAIN_CARD_CPU_TOL; (c) ``FlashTrain`` at full-width heads (16/8 of 128)
   against float64 autograd of softmax attention at S = P11C_SEQ (causal,
   window P11C_WINDOW, and non-causal with padded queries and keys) within
   FLASH_F64_TOL, then the peak memory of a forward and backward at S =
   P11C_MEM_SEQ for ``FlashTrain`` (held to FLASH_MEM_Q q's and
   FLASH_MEM_BLOCKS blocks, O(S Dh)) and for autograd through the blockwise
   loop; (d) one train step of each registered smoke config in fp32, card
   vs CPU within TRAIN_CARD_CPU_TOL.
12. the sharded trainer and the dry run (``phase12``; plain PyTorch over
   DTensor, no kernel launched over the phase): (a)
   ``repro_torch.launch.train.train`` under a world of one NCCL rank (a
   file store), so on ``elastic_remesh``'s (1, 1) ("data", "model") mesh
   with the state as DTensors of the partition specs, on internlm2-1.8b at
   full width cut to P12_LAYERS layers, P12_BATCH x P12_SEQ tokens,
   P12_STEPS steps, against the same call with no process group (one
   device): each step's loss within P12_LOSS_RTOL; then the sharded run to
   a checkpoint at P12_CKPT_EVERY under ``build/chip_smoke/train12/`` and
   resumed from it to P12_STEPS: its losses bit-equal to the uninterrupted
   sharded run's; ms a step sharded and unsharded (DTensor's host
   overhead) and peak memory printed; (b) ``python -m repro_torch.launch.dryrun`` in a subprocess a
   cell, started before phase 11 and run beside it on the host's CPU (a
   fake-backend world of 256 ranks, or 512 with ``--multi-pod``, the step
   under ``FakeTensorMode``): P12B_CELLS, the (arch x shape) cells and the
   distributed medoid engines' rows, each row printed and held to an
   ``ok`` status, live bytes and flops.

It then prints the kernels' JSON line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. It needs one CUDA card and the rest
of the repository beside it; without either it fails before printing any
result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUDGET_PER_ARM = 30
SEED = 0
RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12          # fp32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12      # bf16 on the tensor cores, dense
# fp32 operations a (c, r, k) element, counted as FP32_OPS_PER_S counts them
# (an FFMA is 2, one instruction a lane a cycle): the Gram's FFMA is 2; l1's
# is counted by phase 1 in cuobjdump -sass of the built tile kernels
# (l1_ops_from_sass), whose slab is 2 x 2 outputs by 32 columns a thread
GRAM_OPS = 2
FP32_OPS_PER_INSTR = 2
L1_SLAB = 128
# threefry.cu's chain: one threefry2x32 hash a step on one thread, about two
# dependent integer instructions a round over its 20 rounds plus the key
# injections (45, counted from the source), at an assumed 4 cycles each at
# the H100 SXM's 1980 MHz boost clock (data sheet)
HASH_DEPENDENT_INSTR = 45
INT_LATENCY_CYCLES = 4
SM_CLOCK_HZ = 1.98e9
HASH_S = HASH_DEPENDENT_INSTR * INT_LATENCY_CYCLES / SM_CLOCK_HZ
PALLAS = "src/repro/kernels/pairwise_distance.py"
# topk_smallest: the keeps every checked C is also held at (the select
# path's edge cases; SELECT_KEEP_LIMIT, the plan's largest, beside them),
# the largest C held
# against the plain version (O(C^2) comparisons), and the crossover grid of
# phase 4 (both paths timed at each keep <= C of each C)
TOPK_KEEPS = (1, 63, 64, 65)
TOPK_PLAIN_MAX = 65536
TOPK_CROSS_C = (512, 1024, 2048, 4096, 6424, 20000, 65536, 2 ** 20)
TOPK_CROSS_KEEP = (1, 64, 128, 256, 512, 1024)
# Phase 6 (serving): the server's traffic, the live corpora's streams, the
# size above which a launch is checked on BIG_ROWS rows of the plain version
SRV_REQUESTS = 32
SRV_N = (1000, 20000)
SRV_BUDGET = 24
SRV_BATCH = 8
SRV_BACKEND = "pallas_fused_topk"
SRV_DEADLINE_S = 4.0
LIVE_L2_STEPS = 200
LIVE_L1_STEPS = 40
SERVICE_ARRIVALS = 2000
PROFILE_MUTATIONS = 10
BIG_ELEMS = 1 << 34
BIG_ROWS = 512
# Phase 2's d split: the wrapper's plan may be slower than the unsplit one
# by the two repeats' spread, or by this share of the faster time where
# that is larger (the noise two plans within it are not told apart by)
SPLIT_NOISE = 0.03

# name, dataset, n, d, metric, backend
CELLS = (
    ("planted_l2_fused", "planted", 20000, 784, "l2", "pallas_fused"),
    ("planted_l2_topk", "planted", 20000, 784, "l2", "pallas_fused_topk"),
    ("rnaseq_l1_fused", "rnaseq20k_like", 20000, 4096, "l1", "pallas_fused"),
    ("netflix_cosine_fused", "netflix20k_like", 20000, 2048, "cosine",
     "pallas_fused"),
    ("mnist_l2_topk", "mnist_zeros_like", 6424, 784, "l2",
     "pallas_fused_topk"),
    ("planted_l2_pairwise", "planted", 20000, 784, "l2", "pallas_pairwise"),
)

# name, cluster dataset, n, d, k, metric, backend; KMedoidsConfig defaults
# (BUILD 16, SWAP 16, refine 20 per arm, one sweep, at most 8 swap rounds).
# n = 20000 at d = 784 is the MNIST scale of BanditPAM's experiments.
KM_CELLS = (
    ("kmedoids_mnist_l2_fused", "mnist_like", 20000, 784, 10, "l2",
     "pallas_fused"),
    ("kmedoids_rnaseq_l1_topk", "rnaseq_like", 20000, 1024, 8, "l1",
     "pallas_fused_topk"),
)
KM_BUILD = KM_SWAP = 16
KM_REFINE = 20
KM_MIN_BUCKET = 8

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "dot_centrality": ("src/repro_torch/kernels/csrc/dot_centrality.cu",
                       f"{PALLAS}:269"),
    "l1_centrality": ("src/repro_torch/kernels/csrc/l1_centrality.cu",
                      f"{PALLAS}:181"),
    # one launch for the TPU's rank and select kernels
    "topk_smallest": ("src/repro_torch/kernels/csrc/topk_smallest.cu",
                      f"{PALLAS}:355, {PALLAS}:366"),
    "dot_pairwise": ("src/repro_torch/kernels/csrc/dot_pairwise.cu",
                     f"{PALLAS}:82"),
    "l1_pairwise": ("src/repro_torch/kernels/csrc/l1_pairwise.cu",
                    f"{PALLAS}:121"),
    # the bf16 modes (compute_dtype="bfloat16") of the same two TPU kernels
    "dot_centrality_bf16": ("src/repro_torch/kernels/csrc/dot_centrality.cu",
                            f"{PALLAS}:269"),
    "dot_pairwise_bf16": ("src/repro_torch/kernels/csrc/dot_pairwise.cu",
                          f"{PALLAS}:82"),
    # no TPU kernel: XLA fuses Med-dit's draws into its while_loop
    "threefry": ("src/repro_torch/kernels/csrc/threefry.cu",
                 "none (the draws XLA fuses into "
                 "src/repro/core/meddit.py:86-87)"),
}
PAIRWISE = ("dot_pairwise", "l1_pairwise")
CENTRALITY = ("l1_centrality", "dot_centrality")
# No path of the port (or of the JAX package) calls dot_pairwise's bf16
# mode: its ledger entry sums one launch at each k-medoids pairwise shape
# of phase 2 and its main-path launch count stays 0.
UNCALLED = ("dot_pairwise_bf16",)

# Phase 7, the paper's comparison (bench_algorithms.py's datasets): dataset,
# n, d, metric; RAND's reference counts; Med-dit's capped comparison run
P7_CELLS = (("mnist_zeros_like", 6424, 784, "l2"),
            ("rnaseq20k_like", 20000, 4096, "l1"))
RAND_REFS = (30, 1000)
MEDDIT_BATCH = 64
MEDDIT_CAPPED_CHUNKS = 3
MEDDIT_PROFILED_CHUNKS = 8
# the distributed engines at world size 1: dataset, metric
P7_DIST = (("planted", "l2"), ("rnaseq20k_like", "l1"))

# Phase 8, the LM serving path at full width: the server (internlm2-1.8b,
# the CLI's prompts), the decode-vs-forward bound of
# tests/test_decode_consistency.py, the card-vs-CPU bound, gemma3's cut (its
# 6-layer window pattern plus one) and prompt (beyond its 1024 window), the
# embedding corpus, k-medoids, shards and the sidecar's batch
LM_ARCH = "internlm2-1.8b"
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_PROMPT, LM_NEW = 4, 256, 8, 64, 32
LM_LOGIT_TOL = 2e-3
# 8b's bound, as tests/test_torch_lm_gpu.py's: about 9x the largest error
# read on an H100 with TF32 off (1.1e-5); TF32 rounds each product's inputs
# to 2^-11 (4.9e-4) relative, five times the bound
LM_CARD_CPU_TOL = 1e-4
LM_CARD_CPU_STEPS = 4
GEMMA_LAYERS, GEMMA_PROMPT = 7, 1536
EMB_SEQS, EMB_LEN, EMB_BUDGET, EMB_K, EMB_QUERIES = 2048, 64, 20, 8, 6
SIDECAR_B, SIDECAR_N, SIDECAR_BUDGET = 8, 512, 24

# Phase 9, the other LM families at full width: the server's traffic (8a's
# prompts, half its requests and new tokens), 9b's cut of deepseek's fp32
# copy (its 27 layers in fp32 are 65 GB), 9c's card-vs-CPU depth and 9d's
# cross gates (zero at init, where the cross attention adds nothing)
P9_SLOTS, P9_MAX_LEN, P9_REQUESTS, P9_PROMPT, P9_NEW = 4, 256, 4, 64, 16
DEEPSEEK_FP32_LAYERS = 4
P9_CARD_CPU_LAYERS = 2
P9_GATE = 0.5

# Phase 10, the recurrent families at full width: phase 9's traffic, and
# 10c's prompt, which crosses xLSTM's 256-row query and 512-row KV blocks
# and zamba2's 256-step SSD chunks with a ragged last chunk
P10_PROMPT, P10_BATCH = 600, 2
# 10d's bounds for one xlstm-1.3b group on the card against the CPU (fp32,
# TF32 off; rtol = atol, each quantity its own). Read on an H100, the same
# to the last digit in two runs: logits 7.3e-4; mLSTM C 1.3e-4, n 4.3e-5,
# m 1.4e-4; sLSTM c 1.6e-3, n 7.8e-3, h 1.4e-4, m 6.9e-4. Each bound is
# about 4x its reading. They exceed LM_CARD_CPU_TOL because xLSTM on random
# weights amplifies last bits (exponential gates, sLSTM's recurrence,
# mLSTM's normaliser): moving a seeded half of the weights by one ulp
# (2^-24 relative) moves the card's own results by half to nearly all of
# these readings. TF32 rounds each product's inputs to 2^-11, 8192 ulps,
# and a wrong gate layout or state update moves them by O(1): both far past
# the bounds
XLSTM_CARD_CPU_TOL = {
    "logits": 3e-3, "mlstm.C": 5e-4, "mlstm.n": 2e-4, "mlstm.m": 6e-4,
    "slstm.c": 6e-3, "slstm.n": 3e-2, "slstm.h": 6e-4, "slstm.m": 3e-3}

# Phase 11, training on the card: 11a runs repro_torch.launch.train on
# internlm2-1.8b at full width on SHAPES["train_4k"]'s length, its 24
# layers cut to TRAIN_LAYERS (at 24 the phase took 192 s of a 939 s script
# on an H100 80GB HBM3: twelve 6.2 s steps and two 21 GiB checkpoints), its
# batch of 256 cut to TRAIN_BATCH sequences (TRAIN_MICRO microbatches;
# with 4 sequences a step took 5.6 s and the script 1027 s on an H100 80GB
# HBM3 machine with a slower host, so the batch was cut to 2), TRAIN_STEPS
# steps, then again with a checkpoint at TRAIN_CKPT_EVERY and resumed
# there (two checkpoints, one fewer than a run that writes both); 11b's cut
# and sequence (several q and KV blocks), 11c's flash shapes and 11d's
# batch (seq_len, batch)
TRAIN_LAYERS = 8
TRAIN_BATCH = 2
TRAIN_MICRO = 2
TRAIN_STEPS = 6
TRAIN_CKPT_EVERY = 3
TRAIN_PROFILED_STEP = 4
P11B_LAYERS = 2
P11B_SEQ = 1536
P11C_SEQ = 1536
P11C_WINDOW = 1024
P11C_MEM_SEQ = 8192
P11D_SHAPE = (32, 2)
# 11b and 11d, card vs CPU in fp32 with TF32 off: the loss within rtol
# "loss", the grad norm and every gradient within rtol "grad" (gradients
# with atol "grad" x the model's largest |gradient|), the params after the
# AdamW step within 2 lr an element and "update" of the update's norm
TRAIN_CARD_CPU_TOL = {"loss": 1e-5, "grad": 1e-4, "update": 1e-3}
# xLSTM's "update" in 11d: its exponential gates amplify last bits (see
# XLSTM_CARD_CPU_TOL); read on an H100: 2.69e-3
TRAIN_UPDATE_TOL_XLSTM = 1e-2
# 11c: f32 FlashTrain against float64 autograd, rtol and atol of the
# largest |value| (tests/test_torch_train_flash.py's); its memory bound:
# FLASH_MEM_Q x q's f32 bytes + FLASH_MEM_BLOCKS x one (H, 512, 1024) f32
# block, O(S Dh)
FLASH_F64_TOL = (1e-4, 2e-5)
FLASH_MEM_Q = 32
FLASH_MEM_BLOCKS = 16

# Phase 12, the sharded trainer and the dry run: 12a's cut of
# internlm2-1.8b (full width, P12_LAYERS of its 24 layers), batch, steps and
# checkpoints, and its bound against the unsharded run; 12b's dry runs, each
# the arguments of one ``python -m repro_torch.launch.dryrun`` (pure FSDP
# with the batch over all 256 ranks, so fused_xent's full-logits branch;
# the sequence-sharded decode caches of a KV-head-sharded attention
# (gemma3, zamba2), of xLSTM's 4 heads cut by the model axis and of
# whisper past its position table; the 512-rank mesh; the medoid engines,
# v2 at the reference's defaults and v1 at n = 2^16: at the defaults v1
# scores ~1.26M references a rank 32 at a time (the reference backend's l1
# loop, a few fake ops a block), past the time limit), and the time limit
# of each subprocess
P12_LAYERS = 4
P12_BATCH, P12_SEQ = 2, 2048
P12_STEPS, P12_CKPT_EVERY = 4, 2
P12_LOSS_RTOL = 1e-6
P12B_CELLS = (
    ("--arch", "internlm2-1.8b", "--shape", "train_4k"),
    ("--arch", "internlm2-1.8b", "--shape", "decode_32k"),
    ("--arch", "gemma3-27b", "--shape", "decode_32k"),
    ("--arch", "zamba2-2.7b", "--shape", "decode_32k"),
    ("--arch", "xlstm-1.3b", "--shape", "decode_32k"),
    ("--arch", "whisper-small", "--shape", "decode_32k"),
    ("--arch", "xlstm-1.3b", "--shape", "long_500k"),
    ("--arch", "internlm2-1.8b", "--shape", "decode_32k", "--multi-pod"),
    ("--medoid-engine", "v2"),
    ("--medoid-engine", "v1", "--n", str(1 << 16)),
)
P12B_TIMEOUT_S = 300

# Phase 5, the quantized path: name, dataset, n, d, metric, precision, base
# backend; find_medoid at BUDGET_PER_ARM on phase 3's data.
Q_CELLS = (
    ("planted_l2_bf16_fused", "planted", 20000, 784, "l2", "bf16",
     "pallas_fused"),
    ("netflix_cosine_bf16_fused", "netflix20k_like", 20000, 2048, "cosine",
     "bf16", "pallas_fused"),
    ("rnaseq_l1_bf16_fused", "rnaseq20k_like", 20000, 4096, "l1", "bf16",
     "pallas_fused"),
    ("mnist_l2_int8", "mnist_zeros_like", 6424, 784, "l2", "int8",
     "reference"),
)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _device_op(name: str) -> str:
    """A device activity's kernel name, shortened to the kernel and the
    last functor or pair type in its template arguments (``void
    at::native::vectorized_elementwise_kernel<2, ...BitwiseAndFunctor<long>
    ...>`` -> ``vectorized_elementwise_kernel BitwiseAndFunctor``)."""
    m = re.match(r"void\s+(?:.*?::)?(\w+)[<(]", name)
    if m is None:
        return name[:60]
    tags = re.findall(r"(\w+(?:Functor|_functor|Pair|Op))\b", name)
    return f"{m.group(1)} {tags[-1]}" if tags else m.group(1)


def l1_sass_counts(sass: str) -> list:
    """The fp32 arithmetic of each l1 tile kernel in ``cuobjdump -sass``
    output: (kernel, FADD a - b, FADD with a |x| operand, other FADD,
    FFMA, LDS). The tile loop's slab is 2 x 2 outputs by 32 columns a
    thread, 128 (c, r, k) elements."""
    rows = []
    for blk in sass.split("Function : ")[1:]:
        name = blk.split("\n", 1)[0].strip()
        if "tile_kernel" not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9._]*)"
                         r"([^;]*);", blk)
        fadd = [a for op, a in ops if op == "FADD"]
        absf = sum("|" in a for a in fadd)
        sub = sum("|" not in a and "-" in a for a in fadd)
        vw = re.search(r"ELi(\d+)E(?:Lb[01]E)?EEv", name)
        rows.append((f"tile_kernel VW={vw.group(1) if vw else '?'}", sub, absf,
                     len(fadd) - absf - sub,
                     sum(op == "FFMA" for op, _ in ops),
                     sum(op.startswith("LDS") for op, _ in ops)))
    return rows


def l1_ops_from_sass(bdir) -> float:
    """fp32 operations a (c, r, k) element of the l1 tile loop, as
    FP32_OPS_PER_S counts them: FP32_OPS_PER_INSTR for each FADD a - b and
    FADD acc + |t| of a tile kernel's L1_SLAB-element slab, read from
    ``cuobjdump -sass`` of the built ``l1_pairwise`` and ``l1_centrality``
    in ``bdir``. Prints the counts, and fails unless cuobjdump ran and
    every tile kernel issues exactly one of each a column: a separate
    FABS or another form of the sum would leave the count untrue."""
    from repro_torch.kernels import build

    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    per_elem = []
    for src in ("l1_pairwise", "l1_centrality"):
        got = subprocess.run(
            [str(cuobjdump), "-sass", str(Path(bdir) / f"lib{src}.so")],
            capture_output=True, text=True, timeout=300)
        _require(got.returncode == 0, f"phase1 sass {src}: cuobjdump -sass "
                 f"failed: {got.stderr.strip()[:200]}")
        rows = l1_sass_counts(got.stdout)
        print(f"phase1 sass {src} (cuobjdump -sass; a slab is {L1_SLAB} "
              f"elements a thread): " + "; ".join(
                  f"{k}: {sub} FADD a - b, {absf} FADD acc + |t|, {rest} "
                  f"other FADD, {ffma} FFMA, {lds} LDS"
                  for k, sub, absf, rest, ffma, lds in rows), flush=True)
        _require(bool(rows) and all(sub == absf == L1_SLAB
                                    for _, sub, absf, *_ in rows),
                 f"phase1 sass {src}: the tile loop is not one FADD a - b "
                 f"and one FADD acc + |t| a column: {rows}")
        per_elem += [(sub + absf) / L1_SLAB for _, sub, absf, *_ in rows]
    return FP32_OPS_PER_INSTR * max(per_elem)


def _ops_s(nops: float, tensor_cores: bool = False) -> float:
    """The least time for ``nops`` operations at the rate of the units that
    do them: bf16 tensor-core products or fp32 outside the tensor cores."""
    return nops / (BF16_TC_OPS_PER_S if tensor_cores else FP32_OPS_PER_S)


def _bound_s(nbytes: float, ops_s: float) -> tuple[float, float]:
    """(bytes time, operations time) of one launch; ``ops_s`` from
    _ops_s."""
    return nbytes / HBM_BYTES_PER_S, ops_s


class Ledger:
    """Per-kernel sums of time, bound and error over the launches of the
    main path, one entry per (kernel, shape) launch."""

    def __init__(self):
        self.rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes_s": 0.0,
                         "ops_s": 0.0, "bound_s": 0.0, "library_ms": None,
                         "max_abs_err": 0.0, "launches": 0,
                         "paths": Counter()}
                     for k in KERNELS}

    def add(self, name, ms, plain_ms, nbytes, ops_s, err, library_ms=None):
        row = self.rows[name]
        b, o = _bound_s(nbytes, ops_s)
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["bytes_s"] += b
        row["ops_s"] += o
        row["bound_s"] += max(b, o)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if library_ms is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + library_ms

    def note_err(self, name, err):
        row = self.rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)

    def line(self) -> str:
        out = []
        for name, (src, replaces) in KERNELS.items():
            row = self.rows[name]
            out.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": row["launches"],
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_s"] * 1e3,
                "bound_by": ("bytes" if row["bytes_s"] >= row["ops_s"]
                             else "operations"),
                "library_ms": row["library_ms"]})
            if row["paths"]:   # the main path's launches by kernel path,
                # as the wrappers counted them (PATH_LAUNCHES)
                out[-1]["paths"] = dict(sorted(row["paths"].items()))
        return json.dumps({"kernels": out})


class Launches(dict):
    """The wrappers' counts read just after a main-path run: launches by
    kernel (the dict; ``LAUNCHES``) and, in ``paths``, by (kernel, path)
    (``PATH_LAUNCHES``)."""

    def __init__(self, launches, paths):
        super().__init__(launches)
        self.paths = Counter(paths)


def profiled(call):
    """One call under torch.profiler: (device activities, device busy
    ms, top five device operations by device time), or None where the
    profiler saw no device activity. Reads the profiler's raw events:
    its own event tree (``events()``, ``key_averages()``) takes minutes
    to build for the ~10^5 device activities of a k-medoids call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            v = by_name.setdefault(_device_op(e.name()), [0, 0.0])
            v[0] += 1
            v[1] += (e.end_ns() - e.start_ns()) / 1e6
    if not by_name:
        return None
    top = sorted(by_name.items(), key=lambda kv: kv[1][1],
                 reverse=True)[:5]
    return (sum(v[0] for v in by_name.values()),
            sum(v[1] for v in by_name.values()),
            [(k, c, ms) for k, (c, ms) in top])


def busy_note(busy, steady_s):
    if busy is None:
        return ("device busy: not measured (the profiler saw no device "
                "activity)")
    top = ", ".join(f"{k} x{c} {ms:.2f} ms" for k, c, ms in busy[2])
    return (f"profiled call: {busy[0]} device activities, busy "
            f"{busy[1]:.2f} ms = {busy[1] / (steady_s * 1e3):.1%} of the "
            f"unprofiled repeat; top device ops: {top}")


def prefill_note(prefill, what) -> None:
    """One call of ``prefill`` timed (after a warm-up call) and profiled:
    ms a prefill beside its device activities."""
    import torch
    prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"{what} one prefill of {P9_PROMPT} tokens at batch 1 "
          f"{secs * 1e3:.2f} ms; {busy_note(profiled(prefill), secs)}",
          flush=True)


def phase10a_prefill(dev) -> None:
    """10a's profiled prefill alone: xlstm-1.3b's full config in bf16
    (seed 0) on one of the CLI's prompts. With ``PYTHONPATH`` at another
    checkout's ``src`` it measures that tree's model code the same way
    (parent against change in one call)."""
    from repro_torch.launch.serve import Server, prompts
    srv = Server("xlstm-1.3b", smoke=False, batch_slots=P9_SLOTS,
                 max_len=P9_MAX_LEN, device=dev)
    tok = prompts(1, P9_PROMPT, srv.cfg.vocab_size, dev)[0]
    prefill_note(lambda: srv.model.prefill(srv.params, {"tokens": tok[None]},
                                           P9_MAX_LEN),
                 "phase10a xlstm-1.3b")


def phase7_meddit(dev, steps: int = 25600, reps: int = 3) -> None:
    """Phase 7's two Med-dit cells alone, on the chunk graph: µs a step of
    ``reps`` runs of ``steps`` steps (after one run that builds the kernels
    and captures the graph), then device activities and busy µs a step of
    MEDDIT_PROFILED_CHUNKS chunks profiled. With ``PYTHONPATH`` at another
    checkout's ``src`` it measures that tree the same way (parent against
    change in one call)."""
    import torch

    import repro_torch
    from repro_torch.convert import data_from_numpy
    from repro_torch.core.meddit import CHUNK, meddit_medoid
    from repro_torch.data.medoid_datasets import DATASETS
    from repro_torch.engine import rng

    tree = os.path.relpath(Path(repro_torch.__file__).resolve().parents[2],
                           ROOT)
    prof = MEDDIT_PROFILED_CHUNKS * CHUNK
    for ds, n, d, metric in P7_CELLS:
        x = data_from_numpy(DATASETS[ds][1](SEED, n, d), dev)
        key = rng.fold_in(rng.key(SEED, dev), 1)

        def run(k):
            out = meddit_medoid(x, key, metric=metric,
                                max_pulls=n + MEDDIT_BATCH * k)
            torch.cuda.synchronize()
            return out

        res = run(steps)
        us = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = run(steps)
            us.append((time.perf_counter() - t0) / steps * 1e6)
        run(prof)
        busy = profiled(lambda: run(prof))
        note = ("device activities: not measured" if busy is None else
                f"{busy[0] / prof:.2f} device activities a step, "
                f"{busy[1] * 1e3 / prof:.2f} us busy a step")
        print(f"phase7 meddit alone ({tree}) {ds} n={n}: {steps} steps, us "
              f"a step {' / '.join(f'{u:.1f}' for u in us)}; "
              f"{MEDDIT_PROFILED_CHUNKS} chunks profiled: {note}; medoid "
              f"{int(res.medoid)} pulls {int(res.pulls)}", flush=True)


def lm_close(what, got, want, tol):
    """|got - want| <= tol + tol |want| everywhere (numpy's allclose
    rule, rtol = atol = tol; ``tol`` None: only finite); returns the
    largest |got - want|."""
    import torch

    got, want = got.double(), want.double().to(got.device)
    err = (got - want).abs()
    _require(bool(torch.isfinite(got).all()), f"{what}: non-finite")
    _require(tol is None or bool((err <= tol + tol * want.abs()).all()),
             f"{what}: max err {float(err.max())} beyond rtol = atol = "
             f"{tol}")
    return float(err.max())


def executed_rounds(n: int, budget: int) -> list:
    """The rounds one run_halving executes for (n, budget)."""
    from repro_torch.engine.schedule import round_schedule, stop_round

    rounds = round_schedule(n, budget)
    return rounds[: stop_round(rounds) + 1]


def embed_round_shapes() -> list:
    """The (C, R) of every Gram launch of phases 8d and 10e on the
    EMB_SEQS embedding rows: find_medoid's rounds, k-medoids' BUILD and SWAP
    rounds, its (n, k) cache and (1, n) row, the refinement's buckets and
    the shards' server buckets (powers of two)."""
    n = EMB_SEQS
    shapes = {(s.survivors, s.num_refs)
              for rd in (executed_rounds(n, EMB_BUDGET * n),
                         executed_rounds(n, KM_BUILD * n)) for s in rd}
    shapes |= {(n, EMB_K), (1, n)}
    for nb in (2 ** k for k in range(3, 12)):
        shapes |= {(s.survivors, s.num_refs)
                   for budget in (KM_REFINE, SRV_BUDGET)
                   for s in executed_rounds(nb, budget * nb)}
    return sorted(shapes)


def halving_plan(rounds, score_kern: str, topk: bool,
                 masked: bool = False, half: bool = False) -> list:
    """The launches of one run_halving, as (kernel, C, R, masked): the score
    kernel at each round's (s_r, t_r) and, on the topk backend, one
    topk_smallest launch at each round before the output round, as
    (kernel, C, keep, False): keep = C (the ordering of the survivors), or
    with ``half`` ceil(C / 2) (the distributed engines' selection)."""
    plan = []
    for i, rd in enumerate(rounds):
        plan.append((score_kern, rd.survivors, rd.num_refs, masked))
        if topk and i < len(rounds) - 1:
            s = rd.survivors
            plan.append(("topk_smallest", s, -(-s // 2) if half else s,
                         False))
    return plan


def widened_plan(n: int, metric: str, precision: str, backend: str) -> list:
    """Every kernel launch of one quantized find_medoid call whose margins
    held: one centrality launch per executed round at the widened loop's
    shape (the band's buffer width, or the output round's, by t_r), none in
    the probe or the exact check; none at all on the plain quantized
    backends, whose Gram is torch's."""
    from repro_torch.engine.halving import WIDEN_SLACK
    from repro_torch.engine.schedule import Schedule
    from repro_torch.quant import backend_for

    if backend_for(precision, backend) != "quant_bf16_fused":
        return []
    kern = "l1_centrality" if metric == "l1" else "dot_centrality_bf16"
    sched = Schedule.from_budget(n, BUDGET_PER_ARM * n)
    stk = sched.stacked(n, slack=WIDEN_SLACK)
    plan = [(kern, band.width, t, False)
            for band in stk.bands for t in band.num_refs]
    out_cap = min(n, WIDEN_SLACK * stk.sizes[stk.r_stop])
    return plan + [(kern, out_cap, sched[stk.r_stop].num_refs, False)]


def medoid_plan(n: int, metric: str, backend: str) -> list:
    """Every kernel launch of one find_medoid call (budget 30 per arm);
    none on the ``reference`` backend."""
    if backend == "reference":
        return []
    score = ("dot_pairwise" if backend == "pallas_pairwise" else
             "l1_centrality" if metric == "l1" else "dot_centrality")
    return halving_plan(executed_rounds(n, BUDGET_PER_ARM * n), score,
                        backend == "pallas_fused_topk")


def kmedoids_plan(n: int, k: int, metric: str, backend: str, buckets,
                  executed: int, n_assign: int) -> list:
    """Every kernel launch of one k-medoids call with the KMedoidsConfig
    budgets, from the schedules: BUILD step 0 (find_medoid's program), BUILD
    steps 1..k-1 with a (1, n) distance row after each winner (and one for
    step 0 when k > 1), ``n_assign`` (n, k) assignment caches, the
    refinement's (n_bucket, slots) buckets (masked references), and
    ``executed`` SWAP rounds, each with its (1, n) verification row."""
    cen = "l1_centrality" if metric == "l1" else "dot_centrality"
    pair = "l1_pairwise" if metric == "l1" else "dot_pairwise"
    topk = backend == "pallas_fused_topk"
    rounds = executed_rounds(n, KM_BUILD * n)
    row = [(pair, 1, n, False)]
    plan = halving_plan(rounds, cen, topk) + (row if k > 1 else [])
    for _ in range(1, k):
        plan += halving_plan(rounds, pair, topk) + row
    plan += [(pair, n, k, False)] * n_assign
    for nb, slots in buckets:
        plan += halving_plan(executed_rounds(nb, KM_REFINE * nb), cen, topk,
                             masked=True) * slots
    for _ in range(executed):
        plan += halving_plan(executed_rounds(n, KM_SWAP * n), pair,
                             topk) + row
    return plan


class LMCheck:
    """The LM family phases' (9, 10) checks on one card, their inputs drawn
    from a generator seeded with SEED: the served config's timing, fp32
    copies, decode vs forward and card vs CPU."""

    def __init__(self, dev):
        import torch

        self.dev = dev
        self.gen = torch.Generator(device=dev).manual_seed(SEED)

    @staticmethod
    def forward(params, cfg, batch):
        """The teacher-forced f32 logits (B, S, V)."""
        from repro_torch.models import encdec as ED
        from repro_torch.models import recurrent as R
        from repro_torch.models import transformer as T

        if cfg.family == "audio":
            enc = ED.encode(params, cfg, batch["frames"])
            return ED.decode_train(params, cfg, batch["tokens"], enc)[0]
        if cfg.family == "ssm":
            return R.xlstm_forward(params, cfg, batch["tokens"])[0]
        if cfg.family == "hybrid":
            return R.hybrid_forward(params, cfg, batch["tokens"])[0]
        return T.transformer_forward(params, cfg, batch["tokens"],
                                     image_embed=batch.get("image_embed"))[0]

    def stub(self, cfg, b):
        """Seeded normal image embeddings or frames in the model dtype."""
        import torch
        from repro_torch.models import layers as L

        dt = L.model_dtype(cfg)
        n = {"vlm": cfg.num_image_tokens, "audio": cfg.num_audio_frames}
        if cfg.family not in n:
            return {}
        name = "image_embed" if cfg.family == "vlm" else "frames"
        return {name: torch.randn(b, n[cfg.family], cfg.d_model,
                                  device=self.dev, generator=self.gen).to(dt)}

    @staticmethod
    def copy_as(params, cfg):
        """``params`` as ``cfg``'s weights, every leaf in its dtype (fp32
        or float64): its first layers (or groups) only, where ``cfg`` is
        cut in depth."""
        from repro_torch.models import layers as L
        from repro_torch.models.model import weights_init

        model = weights_init(cfg, None, "meta")
        src, dt = params.state_dict(), L.model_dtype(cfg)
        model.load_state_dict({k: src[k].to(dt)
                               for k in model.state_dict()}, assign=True)
        return model

    @staticmethod
    def lossless(cfg):
        """tests/test_decode_consistency.py's MoE capacity: nothing drops."""
        if cfg.moe is None:
            return cfg
        return cfg.scaled(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))

    def decode_vs_forward(self, cfg, params, what, b=2, s=P9_PROMPT,
                          tol=LM_LOGIT_TOL):
        """Prefill on s tokens and one decode step against the
        teacher-forced logits at positions s - 1 and s, within rtol = atol
        = ``tol`` (None: a reading held to no bound), on seeded tokens and
        stub inputs."""
        import torch
        from repro_torch.models.model import build_model

        m = build_model(cfg)
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1), device=self.dev,
                             generator=self.gen)
        batch = {"tokens": toks, **self.stub(cfg, b)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = self.forward(params, cfg, batch)
        lp, cache = m.prefill(params, dict(batch, tokens=toks[:, :s]), s + 4)
        ld, _ = m.decode_step(params, toks[:, s], cache, s, batch=batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del cache
        e1 = lm_close(f"{what} prefill", lp, full[:, s - 1], tol)
        e2 = lm_close(f"{what} decode", ld, full[:, s], tol)
        bound = "no bound" if tol is None else f"rtol = atol = {tol:.3g}"
        print(f"{what}: decode vs forward (S = {s}, B = {b}): prefill max "
              f"err {e1:.3g}, decode max err {e2:.3g} ({bound}; logits up to "
              f"{float(full[:, s - 1:].abs().max()):.3g}), {secs:.2f} s",
              flush=True)

    def card_vs_cpu(self, cfg, card, what, tols=None):
        """The same fp32 weights on the card and the CPU: prefill and
        LM_CARD_CPU_STEPS greedy decode steps within LM_CARD_CPU_TOL, or
        ``tols``' bound for each quantity (logits, and each cache or
        recurrent state after the prefill and after the last step); greedy
        tokens equal wherever the CPU's top-two gap exceeds twice the
        logits' bound, the routed experts equal wherever the K-th and
        (K+1)-th router probabilities differ by more than twice the
        observed card-vs-CPU difference of the probabilities."""
        import torch
        from repro_torch.launch.serve import prompts
        from repro_torch.models import moe as MOE
        from repro_torch.models.model import (build_model, cache_leaves,
                                              weights_init)

        dev = self.dev
        cpu = weights_init(cfg, None, "meta")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()}, assign=True)
        m = build_model(cfg)
        bg = {"tokens": prompts(1, P9_PROMPT, cfg.vocab_size, dev,
                                seed=9)[0][None], **self.stub(cfg, 1)}
        bc = {k: v.cpu() for k, v in bg.items()}
        n_slots = P9_PROMPT + LM_CARD_CPU_STEPS + 1

        def run(params, batch, feed=None):
            """(logits of the prefill and each step, {when: cache leaves},
            tokens fed, routing records): the greedy tokens of this run,
            or ``feed``'s."""
            dv = batch["tokens"].device
            logits, states, fed = [], {}, []
            with MOE.record_routing() as tape:
                lg, cache = m.prefill(params, batch, n_slots)
                logits.append(lg)
                states["prefill"] = {k: t.clone() for k, t in
                                     cache_leaves(cache)}
                for step in range(LM_CARD_CPU_STEPS):
                    tok = torch.argmax(lg, -1) if feed is None \
                        else feed[step].to(dv)
                    fed.append(tok)
                    lg, cache = m.decode_step(params, tok, cache,
                                              P9_PROMPT + step, batch=batch)
                    logits.append(lg)
            states[f"step {LM_CARD_CPU_STEPS}"] = dict(cache_leaves(cache))
            return logits, states, fed, tape

        t0 = time.perf_counter()
        lgs, sg, fed, rg = run(card, bg)
        lcs, sc, _, rc = run(cpu, bc, fed)
        tol = tols or {k: LM_CARD_CPU_TOL for k in ("logits", *sc["prefill"])}
        _require(set(tol) == {"logits", *sc["prefill"]},
                 f"{what}: bounds for {sorted(tol)}")
        errs = [lm_close(f"{what} {i and f'decode {i - 1}' or 'prefill'} "
                         f"card vs cpu", a, b, tol["logits"])
                for i, (a, b) in enumerate(zip(lgs, lcs))]
        cache_err = {}
        for when, leaves in sc.items():
            for name, t in leaves.items():
                e = lm_close(f"{what} {when} cache {name} card vs cpu",
                             sg[when][name], t, tol[name])
                cache_err[name] = max(cache_err.get(name, 0.0), e)
        tokens = 0
        for step in range(LM_CARD_CPU_STEPS):
            top2 = torch.topk(lcs[step], 2).values[0]
            if float(top2[0] - top2[1]) > 2 * tol["logits"] * (
                    1 + float(top2[0].abs())):
                tokens += 1
                _require(int(torch.argmax(lcs[step], -1)[0]) ==
                         int(fed[step][0]),
                         f"{what} step {step}: greedy token differs")
        decisions = clear = 0
        prob_err = 0.0
        if cfg.moe is not None:
            _require(len(rg) == len(rc) == cfg.num_layers * (
                1 + LM_CARD_CPU_STEPS), f"{what}: {len(rg)} routing records")
            K = cfg.moe.top_k
            prob_err = max(float((a["probs"] - b["probs"].cpu()).abs().max())
                           for a, b in zip(rc, rg))
            for a, b in zip(rc, rg):
                top = torch.sort(a["probs"], dim=-1, descending=True).values
                ok = (top[..., K - 1] - top[..., K]) > 2 * prob_err
                decisions += a["idx"].shape[0] * a["idx"].shape[1]
                clear += int(ok.sum())
                _require(torch.equal(a["idx"][ok], b["idx"].cpu()[ok]),
                         f"{what}: a routed expert differs where the K-th "
                         f"and (K+1)-th probabilities are > 2 x {prob_err:.3g}"
                         f" apart")
        _require(tokens + clear >= 1,
                 f"{what}: no greedy token and no routing decision compared")
        route = (f"; routed experts equal at the {clear} of {decisions} "
                 f"token decisions whose K-th / (K+1)-th gap exceeds 2 x "
                 f"{prob_err:.3g} (the largest card-vs-CPU probability "
                 f"difference)" if cfg.moe is not None else "")
        states = ", ".join(f"{k} {v:.3g}" for k, v in cache_err.items())
        bound = f"rtol = atol = {LM_CARD_CPU_TOL}" if tols is None else (
            "rtol = atol = " + ", ".join(f"{k} {v:g}" for k, v in
                                         tols.items()))
        print(f"{what} card vs cpu, {cfg.num_layers} layers at full width in "
              f"fp32 (TF32 off), prefill of {P9_PROMPT} tokens and "
              f"{LM_CARD_CPU_STEPS} decode steps: logits max err "
              f"{', '.join(f'{e:.3g}' for e in errs)}, caches "
              f"{max(cache_err.values()):.3g} ({states}) ({bound}); greedy "
              f"tokens equal at the {tokens} of {LM_CARD_CPU_STEPS} steps "
              f"whose top-two gap exceeds twice the logits' bound{route}; "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

    def serve(self, arch, what):
        """``Server`` on the full config in bf16 (weights from seed 0 on
        the card): P9_REQUESTS requests of the CLI's prompts through
        P9_SLOTS slots, then one decode step timed and profiled, and for a
        MoE config the served prefills' capacity drops. Returns the
        server."""
        import torch
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import Request, Server, prompts
        from repro_torch.models import moe as MOE
        from repro_torch.models import recurrent as R
        from repro_torch.models import xlstm as XL
        from repro_torch.models.model import cache_leaves

        dev = self.dev
        cfg = get_config(arch)
        V = cfg.vocab_size
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        srv = Server(arch, smoke=False, batch_slots=P9_SLOTS,
                     max_len=P9_MAX_LEN, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params = srv.params
        nparams = sum(p.numel() for p in params.parameters())
        wbytes = sum(p.numel() * p.element_size()
                     for p in params.parameters())
        calls = {"prefill": [0, 0.0], "decode_step": [0, 0.0]}

        def clocked(name, fn):
            def call(*a, **kw):
                t = time.perf_counter()
                logits, cache = fn(*a, **kw)
                torch.cuda.synchronize()
                calls[name][0] += 1
                calls[name][1] += time.perf_counter() - t
                _require(bool(torch.isfinite(logits).all()),
                         f"{what} {name}: non-finite logits")
                return logits, cache
            return call

        m = srv.model
        srv.model = dataclasses.replace(
            m, prefill=clocked("prefill", m.prefill),
            decode_step=clocked("decode_step", m.decode_step))
        srv.run([Request(rid=-1, prompt=p, max_new=3)      # warm-up
                 for p in prompts(1, P9_PROMPT, V, dev, seed=8)])
        for v in calls.values():
            v[:] = [0, 0.0]
        reqs = [Request(rid=i, prompt=p, max_new=P9_NEW)
                for i, p in enumerate(prompts(P9_REQUESTS, P9_PROMPT, V,
                                              dev))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = srv.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want_steps = -(-P9_REQUESTS // P9_SLOTS) * (P9_NEW - 1)
        _require(stats["decode_steps"] == want_steps
                 and stats["tokens"] == P9_REQUESTS * P9_NEW
                 and calls["prefill"][0] == P9_REQUESTS
                 and calls["decode_step"][0] == P9_REQUESTS * (P9_NEW - 1)
                 and all(r.done and len(r.out) == P9_NEW for r in reqs),
                 f"{what} server: {stats}, calls {calls}")
        _require(all(0 <= t < V for r in reqs for t in r.out),
                 f"{what}: a token outside the vocabulary")
        peak = torch.cuda.max_memory_allocated(dev)
        pre_ms = calls["prefill"][1] / calls["prefill"][0] * 1e3
        step_ms = calls["decode_step"][1] / calls["decode_step"][0] * 1e3
        shape = (f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
                 f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab {V}")
        if cfg.moe is not None:
            shape += (f", {cfg.moe.num_experts} experts top-"
                      f"{cfg.moe.top_k}, d_expert {cfg.moe.d_expert}, "
                      f"{cfg.moe.num_shared} shared")
        if cfg.mla is not None:
            shape += (f", MLA r {cfg.mla.kv_lora_rank} / rope "
                      f"{cfg.mla.rope_head_dim}")
        if cfg.cross_attn_every:
            shape += (f", a cross layer every {cfg.cross_attn_every}, "
                      f"{cfg.num_image_tokens} image tokens")
        if cfg.family == "audio":
            shape += (f", {cfg.encoder_layers} encoder layers, "
                      f"{cfg.num_audio_frames} frames")
        if cfg.family == "ssm":
            G, Rm = R._xlstm_layout(cfg)
            shape += (f", {G} groups of {Rm} mLSTM + 1 sLSTM (sLSTM "
                      f"d_inner {XL.slstm_dims(cfg.d_model, cfg.num_heads)[0]}"
                      f")")
        if cfg.family == "hybrid":
            G, E = R._hybrid_layout(cfg)
            shape += (f", {G} groups of {E} Mamba2 blocks (SSD state "
                      f"{cfg.ssm.d_state}, head_dim {cfg.ssm.head_dim}, chunk "
                      f"{cfg.ssm.chunk}) + one shared attention block (head "
                      f"dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff})")
        print(f"{what} server {arch} full config ({shape}) bf16, "
              f"{nparams / 1e9:.2f} B params, {wbytes / 1e9:.3f} GB of "
              f"weights built in {init_s:.2f} s; {P9_REQUESTS} requests of "
              f"{P9_PROMPT} tokens, max_new {P9_NEW}, {P9_SLOTS} slots, "
              f"max_len {P9_MAX_LEN}: {stats['decode_steps']} decode steps, "
              f"{stats['tokens']} tokens, wall {wall:.3f} s, "
              f"{pre_ms:.2f} ms a prefill, {step_ms:.2f} ms a decode step "
              f"(one slot at batch 1), "
              f"{stats['tokens'] / wall:.1f} tokens/s, max_memory_allocated "
              f"{peak / 2 ** 30:.2f} GiB; request 0 generated "
              f"{reqs[0].out[:8]}...", flush=True)

        # one decode step (slot 0's prompt, position P9_PROMPT) timed, then
        # under the profiler
        extra = srv._extra(1)
        lp, pcache = m.prefill(params, {"tokens": reqs[0].prompt[None],
                                        **extra}, P9_MAX_LEN)
        tok = torch.argmax(lp, -1)
        if cfg.family in ("ssm", "hybrid"):
            parts = {}
            for name, t in cache_leaves(pcache):
                key = name.split(".")[0]
                parts[key] = parts.get(key, 0) + t.numel() * t.element_size()
            print(f"{what} a slot's cache at batch 1: "
                  f"{sum(parts.values()) / 1e6:.1f} MB ("
                  + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in
                              parts.items())
                  + (f"; mLSTM C {tuple(pcache['mlstm'].C.shape[2:])} f32 a "
                     f"layer" if cfg.family == "ssm" else "") + ")",
                  flush=True)

        def one_step():
            return m.decode_step(params, tok, pcache, P9_PROMPT, batch=extra)

        one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        print(f"{what} one decode step {step_s * 1e3:.2f} ms; "
              f"{busy_note(profiled(one_step), step_s)}", flush=True)
        del lp, pcache
        if cfg.family == "ssm":       # sLSTM's loop over the prompt
            prefill_note(lambda: m.prefill(params, {
                "tokens": reqs[0].prompt[None], **extra}, P9_MAX_LEN), what)

        if cfg.moe is not None:
            with MOE.record_routing() as tape:
                for r in reqs:
                    m.prefill(params, {"tokens": r.prompt[None]}, P9_MAX_LEN)
            dropped = sum(int((~rec["kept"]).sum()) for rec in tape)
            choices = sum(rec["kept"].numel() for rec in tape)
            hit = sum(int((~rec["kept"]).any(-1).sum()) for rec in tape)
            rows = sum(rec["kept"].shape[0] * rec["kept"].shape[1]
                       for rec in tape)
            print(f"{what} capacity drops of the served prefills (capacity "
                  f"factor {cfg.moe.capacity_factor}, one group of "
                  f"{P9_PROMPT} tokens, {len(tape)} layer-groups): "
                  f"{dropped} of {choices} (token, expert) choices dropped "
                  f"({dropped / choices:.2%}); {hit} of {rows} token-layers "
                  f"lost at least one of their {cfg.moe.top_k} experts",
                  flush=True)
        return srv


def phase9(dev) -> None:
    """Phase 9: the MoE, MLA, VLM and enc-dec serving paths at full width
    (the module docstring's item 9). Its models launch no kernel of the
    port: the launch counts stay empty over the phase."""
    import torch

    from repro_torch.kernels import pairwise_distance as pk

    t9 = time.perf_counter()
    lm = LMCheck(dev)
    pk.reset_launches()

    # 9a: granite-moe, the decode-vs-forward check on a lossless fp32 copy
    srv = lm.serve("granite-moe-3b-a800m", "phase9a")
    cfg32 = lm.lossless(srv.cfg.scaled(dtype="float32"))
    p32 = lm.copy_as(srv.params, cfg32)
    del srv
    torch.cuda.empty_cache()
    lm.decode_vs_forward(cfg32, p32, f"phase9a fp32 copy, full depth, "
                         f"capacity factor {cfg32.moe.capacity_factor:g}")
    del p32
    torch.cuda.empty_cache()

    # 9b: deepseek-v2-lite (MLA + MoE), fp32 copy cut in depth; 9c: two
    # full-width layers at the served capacity, card vs CPU
    srv = lm.serve("deepseek-v2-lite-16b", "phase9b")
    cfg32 = lm.lossless(srv.cfg.scaled(dtype="float32",
                                       num_layers=DEEPSEEK_FP32_LAYERS))
    p32 = lm.copy_as(srv.params, cfg32)
    cfg2 = srv.cfg.scaled(dtype="float32", num_layers=P9_CARD_CPU_LAYERS)
    card2 = lm.copy_as(srv.params, cfg2)
    del srv
    torch.cuda.empty_cache()
    lm.decode_vs_forward(cfg32, p32, f"phase9b fp32 copy cut to "
                         f"{DEEPSEEK_FP32_LAYERS} layers, capacity factor "
                         f"{cfg32.moe.capacity_factor:g}")
    del p32
    torch.cuda.empty_cache()
    lm.card_vs_cpu(cfg2, card2, "phase9c deepseek-v2-lite-16b")
    del card2
    torch.cuda.empty_cache()

    # 9d: llama-3.2-vision served on zeroed images; one full-width group in
    # fp32 with its cross gate at P9_GATE on seeded image embeddings
    srv = lm.serve("llama-3.2-vision-11b", "phase9d")
    cfg1 = srv.cfg.scaled(dtype="float32", num_layers=srv.cfg.cross_attn_every)
    g1 = lm.copy_as(srv.params, cfg1)
    del srv
    torch.cuda.empty_cache()
    for p in g1.groups.cross:
        p.gate.fill_(P9_GATE)
    lm.decode_vs_forward(cfg1, g1, f"phase9d one group fp32, gate {P9_GATE}")
    lm.card_vs_cpu(cfg1, g1, f"phase9d llama-3.2-vision-11b one group, gate "
                   f"{P9_GATE},")
    del g1
    torch.cuda.empty_cache()

    # 9e: whisper served on zeroed frames; full depth in fp32 on seeded
    # frames
    srv = lm.serve("whisper-small", "phase9e")
    cfg32 = srv.cfg.scaled(dtype="float32")
    w32 = lm.copy_as(srv.params, cfg32)
    del srv
    torch.cuda.empty_cache()
    lm.decode_vs_forward(cfg32, w32, "phase9e fp32 copy, full depth")
    lm.card_vs_cpu(cfg32, w32, "phase9e whisper-small")
    del w32
    torch.cuda.empty_cache()

    _require(dict(pk.LAUNCHES) == {}, f"phase9: kernel launches "
                                      f"{dict(pk.LAUNCHES)} on the LM path")
    print(f"phase9: {time.perf_counter() - t9:.1f} s", flush=True)


def phase10(dev):
    """Phase 10 up to 10e: the recurrent families at full width (the module
    docstring's item 10). Its models launch no kernel of the port: the
    launch counts stay empty. Returns zamba2-2.7b's served config and bf16
    weights, for 10e's embedding medoid."""
    import torch

    from repro_torch.kernels import pairwise_distance as pk

    lm = LMCheck(dev)
    pk.reset_launches()

    # 10a: xlstm-1.3b served in bf16, then 10c, decode vs forward at full
    # depth on a P10_PROMPT-token prompt: held to LM_LOGIT_TOL on a float64
    # copy, where rounding cannot hide a fault, and read on an fp32 copy,
    # whose rounding the 48 layers amplify past it; then one group in fp32:
    # decode vs forward (10c) and card vs CPU (10d)
    srv = lm.serve("xlstm-1.3b", "phase10a")
    xcfg, xparams = srv.cfg, srv.params
    del srv
    torch.cuda.empty_cache()
    for dt, tol in (("float64", LM_LOGIT_TOL), ("float32", None)):
        cfgw = xcfg.scaled(dtype=dt)
        xw = lm.copy_as(xparams, cfgw)
        lm.decode_vs_forward(cfgw, xw, f"phase10c xlstm-1.3b {dt} copy, full "
                             f"depth", b=P10_BATCH, s=P10_PROMPT, tol=tol)
        del xw
        torch.cuda.empty_cache()
    per = len(xcfg.block_pattern)
    cfg1 = xcfg.scaled(dtype="float32", num_layers=per)
    g1 = lm.copy_as(xparams, cfg1)
    del xparams
    torch.cuda.empty_cache()
    lm.decode_vs_forward(cfg1, g1, f"phase10c xlstm-1.3b one group ({per} "
                         f"layers)", b=P10_BATCH, s=P10_PROMPT)
    lm.card_vs_cpu(cfg1, g1, f"phase10d xlstm-1.3b one group ({per} of "
                   f"{xcfg.num_layers} layers)", tols=XLSTM_CARD_CPU_TOL)
    del g1
    torch.cuda.empty_cache()

    # 10b: zamba2-2.7b served in bf16; its weights stay for 10e
    srv = lm.serve("zamba2-2.7b", "phase10b")
    zcfg, zparams = srv.cfg, srv.params
    cfg32 = zcfg.scaled(dtype="float32")
    z32 = lm.copy_as(zparams, cfg32)
    del srv
    torch.cuda.empty_cache()
    lm.decode_vs_forward(cfg32, z32, "phase10c zamba2-2.7b fp32 copy, full "
                         "depth", b=P10_BATCH, s=P10_PROMPT)
    del z32
    torch.cuda.empty_cache()
    per = zcfg.shared_attn_every
    cfg1 = cfg32.scaled(num_layers=per)
    g1 = lm.copy_as(zparams, cfg1)
    lm.card_vs_cpu(cfg1, g1, f"phase10d zamba2-2.7b one group ({per} of "
                   f"{cfg32.num_layers} Mamba2 blocks and the shared block)")
    del g1
    torch.cuda.empty_cache()

    _require(dict(pk.LAUNCHES) == {}, f"phase10: kernel launches "
                                      f"{dict(pk.LAUNCHES)} on the LM path")
    return zcfg, zparams


def train_step_ops(cfg, batch: int, seq: int) -> tuple[float, float]:
    """(bf16 tensor-core operations, f32 operations) of one remat train
    step of a dense decoder on batch x seq tokens, counted from the shapes
    the step runs: the layers' products, 2 per weight and token, in two
    forward passes (the first under the checkpoint, the second its
    recomputation) and a backward of twice a forward's (8 P T); the f32
    unembedding of ``fused_xent`` over its zero-padded chunks (the forward,
    its recomputation, and the backward's two products: 4 x 2 T' d V);
    and the f32 attention products over the (q, KV) block pairs the
    causal loops visit, per head 4 bq bkv Dh in a forward (Q K^T, P V),
    twice for the recomputed forward, and 10 bq bkv Dh in the backward
    (S, dV, dP, dQ, dK)."""
    from repro_torch.models.flash import _kv_range

    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    Dh, F = cfg.resolved_head_dim, cfg.d_ff
    P = 2 * d * H * Dh + 2 * d * KV * Dh + (3 if cfg.gated_mlp else 2) * d * F
    T = batch * seq
    bf16 = 8.0 * cfg.num_layers * P * T
    n = seq - 1
    c = min(256, n)
    rows = batch * (-(-n // c)) * c
    unembed = 4 * 2.0 * rows * d * cfg.vocab_size
    bq, bkv = min(512, seq), min(1024, seq)
    nq, nkv = -(-seq // bq), -(-seq // bkv)
    pairs = sum(len(_kv_range(qi, nkv, True, 0, 0, bq, bkv))
                for qi in range(nq))
    attn = 18.0 * cfg.num_layers * batch * H * pairs * bq * bkv * Dh
    return bf16, unembed + attn


def _train_close(what, got: dict, want: dict, tol: float) -> float:
    """Each tensor of ``got`` (on the card) within rtol ``tol`` and atol
    ``tol`` x the largest |value| over all of ``want`` (a gradient that is
    zero in exact arithmetic is rounding noise on both sides), compared in
    float64 on the card; returns the largest |got - want| over that largest
    |value|."""
    import torch

    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        g = got[k].detach().double()
        w = w.detach().to(g.device).double()
        err = (g - w).abs()
        _require(bool(torch.isfinite(g).all()), f"{what} {k}: non-finite")
        _require(bool((err <= tol * top + tol * w.abs()).all()),
                 f"{what} {k}: max err {float(err.max())} beyond rtol {tol}"
                 f" and atol {tol} x {top:.3g}")
        worst = max(worst, float(err.max()) / top)
    return worst


def _update_diff(got: dict, want: dict, before: dict) -> tuple[float,
                                                                 float]:
    """Params after AdamW updates, card (``got``) against CPU: (the largest
    element difference, the difference's norm over the norm of the CPU's
    whole update), in float64 on the card."""
    diff2 = upd2 = worst = 0.0
    for k, g in got.items():
        g = g.detach().double()
        w = want[k].detach().to(g.device).double()
        d = g - w
        worst = max(worst, float(d.abs().max()))
        diff2 += float((d * d).sum())
        upd2 += float(((w - before[k].to(g.device).double()) ** 2).sum())
    return worst, (diff2 / upd2) ** 0.5


def _update_close(what, worst: float, ratio: float, lr_sum: float,
                  tol: float) -> None:
    """Every element within 2 ``lr_sum`` (AdamW's first steps move an
    element by about lr in the sign of its gradient, and a gradient that is
    rounding noise on both sides can take either sign) and the norm ratio
    of :func:`_update_diff` within ``tol``."""
    _require(worst <= 2 * lr_sum, f"{what}: a param moved {worst:.3g} off "
                                  f"the CPU's, beyond 2 sum(lr) = "
                                  f"{2 * lr_sum:.3g}")
    _require(ratio <= tol, f"{what}: params' difference {ratio:.3g} of the "
                           f"update's norm, beyond {tol}")


def _cpu_copy(cfg, params):
    """The weights module ``params`` on the CPU, trainable."""
    from repro_torch.models.model import weights_init

    cpu = weights_init(cfg, None, "meta")
    cpu.load_state_dict({k: v.detach().to("cpu", copy=True) for k, v in
                         params.state_dict().items()}, assign=True)
    return cpu.requires_grad_(True)


def phase11a(dev) -> None:
    """11a: ``repro_torch.launch.train`` on internlm2-1.8b at full width,
    TRAIN_LAYERS deep, then the resume (the module docstring's item 11)."""
    import math
    import shutil

    import torch
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch import train as tl
    from repro_torch.models.model import weights_init
    from repro_torch.train.train_step import TrainCfg

    cfg = get_config(LM_ARCH).scaled(num_layers=TRAIN_LAYERS)
    S = SHAPES["train_4k"].seq_len
    ckdir = ROOT / "build" / "chip_smoke" / "train"
    shutil.rmtree(ckdir, ignore_errors=True)
    tcfg = TrainCfg(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS,
                    num_microbatches=TRAIN_MICRO, remat=True)
    kw = dict(smoke=False, batch_size=TRAIN_BATCH, seq_len=S, tcfg=tcfg,
              log_every=TRAIN_STEPS, device=dev)
    ck = dict(ckpt_dir=str(ckdir), ckpt_every=TRAIN_CKPT_EVERY)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_at(cfg, InputShape("t", S, TRAIN_BATCH, "train"), 0, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0

    # the first run's step TRAIN_PROFILED_STEP runs under the profiler
    make, full = tl.make_train_step, tl.get_config
    busy = []

    def profiling(model, tcfg_):
        step = make(model, tcfg_)

        def run(state, batch):
            if int(state.step) != TRAIN_PROFILED_STEP or busy:
                return step(state, batch)
            out = []
            busy.append(profiled(lambda: out.append(step(state, batch))))
            return out[0]
        return run

    torch.use_deterministic_algorithms(True)
    try:
        tl.get_config = lambda arch: full(arch).scaled(
            num_layers=TRAIN_LAYERS)
        tl.make_train_step = profiling
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        first = tl.train(LM_ARCH, steps=TRAIN_STEPS, **kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        tl.make_train_step = make
        # two checkpoints: the step before the resume, and the resumed end
        t0 = time.perf_counter()
        head = tl.train(LM_ARCH, steps=TRAIN_CKPT_EVERY, **kw, **ck)
        _require(ckpt.all_steps(str(ckdir)) == [TRAIN_CKPT_EVERY],
                 f"phase11a checkpoints {ckpt.all_steps(str(ckdir))}")
        second = tl.train(LM_ARCH, steps=TRAIN_STEPS, **kw, **ck)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        _require(ckpt.all_steps(str(ckdir)) == [TRAIN_CKPT_EVERY,
                                                TRAIN_STEPS],
                 f"phase11a checkpoints {ckpt.all_steps(str(ckdir))}")
    finally:
        tl.make_train_step, tl.get_config = make, full
        torch.use_deterministic_algorithms(False)
    shutil.rmtree(ckdir, ignore_errors=True)

    losses = first["losses"]
    _require(len(losses) == TRAIN_STEPS and all(
        map(math.isfinite, losses + first["grad_norms"])),
             f"phase11a losses {losses}")
    _require(losses[-1] < losses[0],
             f"phase11a: the loss did not fall: {losses}")
    _require(head["losses"] == losses[:TRAIN_CKPT_EVERY]
             and second["start_step"] == TRAIN_CKPT_EVERY
             and second["losses"] == losses[TRAIN_CKPT_EVERY:],
             f"phase11a resume from step {second['start_step']}: losses "
             f"{head['losses']} + {second['losses']} != the first run's "
             f"{losses}")
    secs = first["step_s"]
    steady = sorted(s for i, s in enumerate(secs)
                    if i not in (0, TRAIN_PROFILED_STEP))
    steady_s = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * S
    bf16, f32 = train_step_ops(cfg, TRAIN_BATCH, S)
    nparams = sum(p.numel() for p in
                  weights_init(cfg, None, "meta").parameters())
    # the optimizer's least traffic: read the bf16 weights and the f32
    # gradient, read and write the f32 moments, write the weights
    nbytes = nparams * (2 + 4 + 16 + 2)
    bytes_s, ops_s = _bound_s(nbytes, _ops_s(bf16, True) + _ops_s(f32))
    bound_s = max(bytes_s, ops_s)
    print(f"phase11a {LM_ARCH} training at full width ({cfg.num_layers} "
          f"of {full(LM_ARCH).num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} "
          f"heads, d_ff {cfg.d_ff}, V {cfg.vocab_size}; {nparams / 1e9:.3f} "
          f"B params in bf16, AdamW moments f32), batch {TRAIN_BATCH} x "
          f"{S} tokens (train_4k's 256 cut to {TRAIN_BATCH}) in "
          f"{TRAIN_MICRO} microbatches, remat, {TRAIN_STEPS} steps: losses "
          f"{[round(x, 6) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in first['grad_norms']]}; ms a step: first "
          f"{secs[0] * 1e3:.1f}, steady {steady_s * 1e3:.1f} (median of "
          f"steps 1-{TRAIN_STEPS - 1} but {TRAIN_PROFILED_STEP}), "
          f"{tokens / steady_s:.0f} tokens/s; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; run {first_s:.1f} s (steps "
          f"{sum(secs):.1f} s, the rest data draws and init); one batch's "
          f"draw {draw_s * 1e3:.0f} ms", flush=True)
    print(f"phase11a resume: {TRAIN_CKPT_EVERY} steps to a checkpoint of "
          f"{nparams * 12 / 2 ** 30:.1f} GiB, then resumed from step "
          f"{second['start_step']} to {TRAIN_STEPS} and a second checkpoint: "
          f"losses {[round(x, 6) for x in head['losses'] + second['losses']]}"
          f" bit-equal to the uninterrupted run's "
          f"(torch.use_deterministic_algorithms); {second_s:.1f} s in all",
          flush=True)
    print(f"phase11a bound of a step: {bf16:.4g} bf16 tensor-core ops at "
          f"{BF16_TC_OPS_PER_S:.3g}/s + {f32:.4g} f32 ops (the unembedding "
          f"and attention) at {FP32_OPS_PER_S:.3g}/s = {ops_s * 1e3:.1f} ms;"
          f" the optimizer's {nbytes / 1e9:.1f} GB at {HBM_BYTES_PER_S:.3g} "
          f"B/s = {bytes_s * 1e3:.1f} ms; bound {bound_s * 1e3:.1f} ms "
          f"({bound_s / steady_s:.1%} of the steady step)", flush=True)
    print(f"phase11a step {TRAIN_PROFILED_STEP}: "
          f"{busy_note(busy[0], steady_s)}", flush=True)


def phase11b(dev) -> None:
    """11b: internlm2-1.8b at full width, P11B_LAYERS layers in fp32, one
    train step's loss, gradients and AdamW update, card against CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import batch_at
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, schedule
    from repro_torch.train import train_step as TS

    cfg = get_config(LM_ARCH).scaled(num_layers=P11B_LAYERS, dtype="float32")
    model = build_model(cfg)
    tcfg = TS.TrainCfg(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    card = model.init(SEED, device=dev).requires_grad_(True)
    cpu = _cpu_copy(cfg, card)
    bg = batch_at(cfg, InputShape("t", P11B_SEQ, 1, "train"), 0, device=dev)
    lr = float(schedule.cosine_with_warmup(
        1, peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
        total_steps=tcfg.total_steps))
    out = {}
    for name, params, batch in (("card", card, bg),
                                ("cpu", cpu, {k: v.cpu() for k, v in
                                              bg.items()})):
        t0 = time.perf_counter()
        before = {k: p.detach().clone() for k, p in
                  params.named_parameters()}
        # the train step's two halves: the loss and its gradients, then
        # AdamW at step 1's learning rate
        loss, _, grads = TS._value_and_grad(model, tcfg, params, batch)
        _, _, m = adamw.update(dict(grads), adamw.init(params), params,
                               lr=torch.tensor(lr),
                               weight_decay=tcfg.weight_decay,
                               max_grad_norm=tcfg.max_grad_norm)
        if name == "card":
            torch.cuda.synchronize()
        out[name] = (float(loss), grads, before, float(m["grad_norm"]),
                     time.perf_counter() - t0)
    (lg, gg, _, ng, sg), (lc, gc, bc, nc, sc) = out["card"], out["cpu"]
    tol = TRAIN_CARD_CPU_TOL
    _require(abs(lg - lc) <= tol["loss"] * abs(lc),
             f"phase11b loss {lg!r} card, {lc!r} cpu")
    _require(abs(ng - nc) <= tol["grad"] * abs(nc),
             f"phase11b grad norm {ng!r} card, {nc!r} cpu")
    gerr = _train_close("phase11b gradient", gg, gc, tol["grad"])
    worst, ratio = _update_diff(dict(card.named_parameters()),
                                dict(cpu.named_parameters()), bc)
    _update_close("phase11b params", worst, ratio, lr, tol["update"])
    print(f"phase11b {LM_ARCH} card vs cpu, {P11B_LAYERS} layers at full "
          f"width in fp32 (TF32 off), B 1 x S {P11B_SEQ}: loss {lg:.9g} / "
          f"{lc:.9g} (rtol {tol['loss']}), grad norm {ng:.7g} / {nc:.7g}, "
          f"every gradient within {gerr:.3g} of the largest |gradient| "
          f"(rtol = atol {tol['grad']}), params after one AdamW step (lr "
          f"{lr:g}): largest difference {worst:.3g} (2 lr {2 * lr:g}), "
          f"{ratio:.3g} of the update's norm (bound {tol['update']}); "
          f"{sg:.2f} s card, {sc:.2f} s cpu", flush=True)


def _plain64(q, k, v, causal, window, skv):
    """Softmax attention in float64 on the unpadded keys, the reference's
    masks; head h reads KV head h // rep."""
    import torch

    rep = q.shape[2] // k.shape[2]
    k, v = k[:, :skv].repeat_interleave(rep, 2), \
        v[:, :skv].repeat_interleave(rep, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    qp = torch.arange(q.shape[1], device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones_like(qp >= kp)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    s = s.masked_fill(~mask, -torch.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def phase11c(dev) -> None:
    """11c: FlashTrain at full-width heads against float64 autograd, then
    the memory of its forward and backward against autograd through the
    blockwise loop."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models.flash import flash_attention_trainable

    cfg = get_config(LM_ARCH)
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(SEED)
    rtol, atol = FLASH_F64_TOL
    for what, sq, skv, causal, window in (
            ("causal", P11C_SEQ, P11C_SEQ, True, 0),
            (f"causal, window {P11C_WINDOW}", P11C_SEQ, P11C_SEQ, True,
             P11C_WINDOW),
            ("non-causal, padded queries and keys", P11C_SEQ - 136,
             P11C_SEQ, False, 0)):
        q, k, v, cot = (torch.randn(1, s, h, Dh, device=dev, generator=g)
                        for s, h in ((sq, H), (skv, KV), (skv, KV), (sq, H)))
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = flash_attention_trainable(*ins, causal=causal, window=window)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref = [t.double().requires_grad_(True) for t in (q, k, v)]
        want = _plain64(*ref, causal, window, skv)
        (want * cot.double()).sum().backward()
        errs = []
        for name, a, b in (("out", out, want), ("dq", ins[0].grad,
                                                  ref[0].grad),
                           ("dk", ins[1].grad, ref[1].grad),
                           ("dv", ins[2].grad, ref[2].grad)):
            a, b = a.detach().double(), b.detach()
            top = float(b.abs().max())
            err = (a - b).abs()
            _require(bool((err <= atol * top + rtol * b.abs()).all()),
                     f"phase11c {what} {name}: max err {float(err.max())} "
                     f"beyond rtol {rtol}, atol {atol} x {top:.3g}")
            errs.append(f"{name} {float(err.max()) / top:.3g}")
        print(f"phase11c FlashTrain {what}, B 1, Sq {sq}, Skv {skv}, "
              f"{H}/{KV} heads of {Dh}, blocks 512/1024, against float64 "
              f"autograd of softmax attention: max err over the largest "
              f"|value| {', '.join(errs)} (rtol {rtol}, atol {atol} of the "
              f"largest); forward + backward {ms:.1f} ms (first call)",
              flush=True)
        del q, k, v, cot, ins, ref, out, want

    S = P11C_MEM_SEQ
    peaks = {}
    for name, fn in (
            ("FlashTrain", lambda q, k, v: flash_attention_trainable(q, k, v)),
            ("autograd through the blockwise loop",
             lambda q, k, v: A.flash_attention(q, k, v))):
        q, k, v = (torch.randn(1, S, h, Dh, device=dev, generator=g)
                   .requires_grad_(True) for h in (H, KV, KV))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn(q, k, v).sum().backward()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated(dev) - base
        del q, k, v
        torch.cuda.empty_cache()
    q_bytes = S * H * Dh * 4
    block_bytes = H * 512 * 1024 * 4
    bound = FLASH_MEM_Q * q_bytes + FLASH_MEM_BLOCKS * block_bytes
    _require(peaks["FlashTrain"] <= bound,
             f"phase11c FlashTrain's peak {peaks['FlashTrain']} B beyond "
             f"{bound} B")
    print(f"phase11c memory of forward + backward, B 1, S {S}, "
          f"{H}/{KV} heads of {Dh}, f32, causal: "
          + ", ".join(f"{k} {v / 2 ** 20:.0f} MiB" for k, v in peaks.items())
          + f" (FlashTrain's bound {FLASH_MEM_Q} x q's {q_bytes / 2 ** 20:.0f}"
          f" MiB + {FLASH_MEM_BLOCKS} x a (H, 512, 1024) f32 block's "
          f"{block_bytes / 2 ** 20:.0f} MiB = {bound / 2 ** 20:.0f} MiB: "
          f"O(S Dh))", flush=True)


def phase11d(dev) -> None:
    """11d: one train step of every registered smoke config in fp32, card
    against CPU."""
    import torch
    from repro_torch.configs import ARCH_NAMES, get_smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import batch_at
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as TS

    seq, b = P11D_SHAPE
    tcfg = TS.TrainCfg(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    tol = TRAIN_CARD_CPU_TOL
    lines, read = [], []
    for arch in ARCH_NAMES:
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        model = build_model(cfg)
        card = model.init(SEED, device=dev).requires_grad_(True)
        if cfg.cross_attn_every:
            with torch.no_grad():
                for p in card.groups.cross:
                    p.gate.fill_(P9_GATE)
        cpu = _cpu_copy(cfg, card)
        before = {k: p.detach().cpu().clone()
                  for k, p in cpu.named_parameters()}
        bg = batch_at(cfg, InputShape("t", seq, b, "train"), 0, device=dev)
        step = TS.make_train_step(model, tcfg)
        res = {}
        for name, params, batch in (("card", card, bg),
                                    ("cpu", cpu, {k: v.cpu() for k, v in
                                                  bg.items()})):
            state = TS.TrainState(params=params, opt=adamw.init(params),
                                  ef=None, step=torch.zeros(
                                      (), dtype=torch.int32,
                                      device=batch["tokens"].device))
            res[name] = step(state, batch)[1]
        mg, mc = res["card"], res["cpu"]
        worst, ratio = _update_diff(dict(card.named_parameters()),
                                    dict(cpu.named_parameters()), before)
        read.append((arch, float(mg["loss"]), float(mc["loss"]),
                     float(mg["grad_norm"]), float(mc["grad_norm"]),
                     float(mc["lr"]), worst, ratio))
        lines.append(f"{arch} loss {float(mg['loss']):.7g} / "
                     f"{float(mc['loss']):.7g}, grad norm "
                     f"{float(mg['grad_norm']):.6g} / "
                     f"{float(mc['grad_norm']):.6g}, params {worst:.3g} "
                     f"({ratio:.3g} of the update)")
    print(f"phase11d one train step of each smoke config in fp32 (B {b} x S "
          f"{seq}), card vs cpu (loss rtol {tol['loss']}, grad norm rtol "
          f"{tol['grad']}, params within 2 lr and {tol['update']} of the "
          f"update's norm; xLSTM's {TRAIN_UPDATE_TOL_XLSTM}): "
          + "; ".join(lines), flush=True)
    for arch, lg, lc, ng, nc, lr, worst, ratio in read:
        _require(abs(lg - lc) <= tol["loss"] * abs(lc),
                 f"phase11d {arch} loss: {lg!r} card, {lc!r} cpu")
        _require(abs(ng - nc) <= tol["grad"] * abs(nc),
                 f"phase11d {arch} grad norm: {ng!r} card, {nc!r} cpu")
        _update_close(f"phase11d {arch} params", worst, ratio, lr,
                      TRAIN_UPDATE_TOL_XLSTM if arch.startswith("xlstm")
                      else tol["update"])


def phase11(dev) -> None:
    """Phase 11: training on the card (the module docstring's item 11).
    It launches no kernel of the port: the launch counts stay empty."""
    import torch

    from repro_torch.kernels import pairwise_distance as pk

    t11 = time.perf_counter()
    pk.reset_launches()
    torch.cuda.empty_cache()
    for part in (phase11a, phase11b, phase11c, phase11d):
        t0 = time.perf_counter()
        part(dev)
        torch.cuda.empty_cache()
        print(f"{part.__name__}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    _require(dict(pk.LAUNCHES) == {}, f"phase11: kernel launches "
                                      f"{dict(pk.LAUNCHES)} on the training "
                                      f"path")
    print(f"phase11: {time.perf_counter() - t11:.1f} s", flush=True)


def phase12_dryruns() -> list:
    """12b: one ``python -m repro_torch.launch.dryrun`` a cell, started
    now on the host's CPU at a lower priority (niceness 10), so that the
    card's host-bound phases beside them keep their core; :func:`phase12b`
    collects them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return [(" ".join(cell), time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *cell],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, preexec_fn=lambda: os.nice(10)))
        for cell in P12B_CELLS]


def phase12a(dev) -> None:
    """12a: the sharded trainer at world size 1 on NCCL against the
    unsharded one, and its resume (the module docstring's item 12)."""
    import math
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import get_config
    from repro_torch.launch import train as tl
    from repro_torch.train.train_step import TrainCfg

    cfg = get_config(LM_ARCH).scaled(num_layers=P12_LAYERS)
    ckdir = ROOT / "build" / "chip_smoke" / "train12"
    shutil.rmtree(ckdir, ignore_errors=True)
    ckdir.parent.mkdir(parents=True, exist_ok=True)
    tcfg = TrainCfg(peak_lr=3e-4, warmup_steps=2, total_steps=P12_STEPS,
                    remat=True)
    kw = dict(smoke=False, batch_size=P12_BATCH, seq_len=P12_SEQ, tcfg=tcfg,
              log_every=P12_STEPS, device=dev)
    ck = dict(ckpt_dir=str(ckdir), ckpt_every=P12_CKPT_EVERY)

    def run(steps=P12_STEPS, **extra):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = tl.train(LM_ARCH, steps=steps, **kw, **extra)
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        out["peak"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.empty_cache()
        return out

    get_config_ = tl.get_config
    torch.use_deterministic_algorithms(True)
    try:
        tl.get_config = lambda arch: cfg
        plain = run()
        store = Path(tempfile.mkdtemp(dir=ckdir.parent)) / "store"
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=0, world_size=1)
        try:
            sharded = run()
            # the resume: a checkpoint at P12_CKPT_EVERY, then on to the end
            head = run(P12_CKPT_EVERY, **ck)
            resumed = run(**ck)
            _require(ckpt.all_steps(str(ckdir)) == [P12_CKPT_EVERY,
                                                    P12_STEPS],
                     f"phase12a checkpoints {ckpt.all_steps(str(ckdir))}")
        finally:
            dist.destroy_process_group()
    finally:
        tl.get_config = get_config_
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckdir, ignore_errors=True)

    _require(plain["mesh"] is None and sharded["mesh"] == (1, 1)
             and resumed["mesh"] == (1, 1),
             f"phase12a meshes {plain['mesh']}, {sharded['mesh']}, "
             f"{resumed['mesh']}")
    got, want = sharded["losses"], plain["losses"]
    _require(len(got) == len(want) == P12_STEPS and all(
        map(math.isfinite, got + sharded["grad_norms"])),
             f"phase12a losses {got}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    _require(rel <= P12_LOSS_RTOL, f"phase12a sharded losses {got} vs "
                                   f"unsharded {want}: rel {rel:.3g}")
    _require(head["losses"] == got[:P12_CKPT_EVERY]
             and resumed["start_step"] == P12_CKPT_EVERY
             and resumed["losses"] == got[P12_CKPT_EVERY:],
             f"phase12a resume from step {resumed['start_step']}: losses "
             f"{head['losses']} + {resumed['losses']} != the sharded run's "
             f"{got}")

    def steady(out):
        secs = sorted(out["step_s"][1:])
        return secs[len(secs) // 2]

    sh_s, pl_s = steady(sharded), steady(plain)
    print(f"phase12a {LM_ARCH} at full width cut to {P12_LAYERS} layers "
          f"(d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"d_ff {cfg.d_ff}, V {cfg.vocab_size}), batch {P12_BATCH} x "
          f"{P12_SEQ}, {P12_STEPS} steps: sharded on a (1, 1) mesh over "
          f"one NCCL rank, losses {[round(x, 6) for x in got]}, unsharded "
          f"{[round(x, 6) for x in want]}, largest rel difference "
          f"{rel:.3g} (bound {P12_LOSS_RTOL:g}); ms a step (median of steps "
          f"2-{P12_STEPS}): sharded {sh_s * 1e3:.1f}, unsharded "
          f"{pl_s * 1e3:.1f} (DTensor's host overhead "
          f"{(sh_s - pl_s) * 1e3:.1f} ms, x{sh_s / pl_s:.3f}); first step "
          f"sharded {sharded['step_s'][0] * 1e3:.1f} ms, unsharded "
          f"{plain['step_s'][0] * 1e3:.1f} ms; max_memory_allocated sharded "
          f"{sharded['peak'] / 2 ** 30:.2f} GiB, unsharded "
          f"{plain['peak'] / 2 ** 30:.2f} GiB; runs {plain['run_s']:.1f} s "
          f"unsharded, {sharded['run_s']:.1f} s sharded", flush=True)
    print(f"phase12a resume: {P12_CKPT_EVERY} sharded steps to a checkpoint "
          f"({head['run_s']:.1f} s), resumed from step "
          f"{resumed['start_step']} to {P12_STEPS} onto a new mesh and a "
          f"second checkpoint ({resumed['run_s']:.1f} s): losses "
          f"{[round(x, 6) for x in head['losses'] + resumed['losses']]} "
          f"bit-equal to the uninterrupted sharded run's", flush=True)


def phase12b(procs) -> None:
    """12b: the dry-run rows (the module docstring's item 12)."""
    for cell, t0, proc in procs:
        try:
            out, err = proc.communicate(timeout=P12B_TIMEOUT_S)
        finally:
            proc.kill()
        wall = time.perf_counter() - t0
        _require(proc.returncode == 0,
                 f"phase12b dry run {cell}: exit "
                 f"{proc.returncode}: {err[-2000:]}")
        rows = [json.loads(ln) for ln in out.splitlines()
                if ln.startswith("{")]
        _require(len(rows) == 1 and rows[0]["status"] == "ok"
                 and rows[0]["per_device_bytes"]["total_live"] > 0
                 and rows[0]["flops"] > 0,
                 f"phase12b dry run {cell}: {out[-2000:]}")
        own = rows[0].get("setup_s", 0.0) + rows[0]["run_s"]
        print(f"phase12b dry run {cell} (fake world of "
              f"{rows[0]['chips']} ranks, {rows[0]['mesh']}; {own:.1f} s "
              f"set-up and step, read {wall:.1f} s after its start): "
              f"{json.dumps(rows[0])}", flush=True)


def phase12(dev, procs=None) -> None:
    """Phase 12: the sharded trainer and the dry run (the module
    docstring's item 12), reading 12b's subprocesses ``procs`` (started
    here unless the caller started them earlier, beside phase 11). It
    launches no kernel of the port."""
    import torch

    from repro_torch.kernels import pairwise_distance as pk

    t12 = time.perf_counter()
    pk.reset_launches()
    procs = procs or phase12_dryruns()
    try:
        t0 = time.perf_counter()
        phase12a(dev)
        print(f"phase12a: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        phase12b(procs)
        print(f"phase12b: {time.perf_counter() - t0:.1f} s after 12a",
              flush=True)
    finally:
        for _, _, proc in procs:
            proc.kill()
    torch.cuda.empty_cache()
    _require(dict(pk.LAUNCHES) == {}, f"phase12: kernel launches "
                                      f"{dict(pk.LAUNCHES)} on the sharded "
                                      f"training path")
    print(f"phase12: {time.perf_counter() - t12:.1f} s", flush=True)


def main() -> int:
    import torch

    # cuBLAS's deterministic workspace (phase 11a's resume is held bit for
    # bit under torch.use_deterministic_algorithms), before any CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch.api import find_medoid, kmedoids
    from repro_torch.cluster import (adjusted_rand_index, make_direct_refiner,
                                     pam_exact)
    from repro_torch.convert import data_from_numpy
    from repro_torch.core.bucketing import next_pow2, plan_buckets
    from repro_torch.core.corr_sh import correlated_sequential_halving
    from repro_torch.core.exact import exact_medoid
    from repro_torch.data.medoid_datasets import (CLUSTER_DATASETS, DATASETS,
                                                  planted_medoid)
    from repro_torch.engine import rng
    from repro_torch.engine.schedule import schedule_pulls
    from repro_torch.kernels import build
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise_distance as pk

    script_t0 = time.perf_counter()
    phase_s = {}                   # phase -> seconds, printed at the end
    clock = [script_t0, "1"]

    def phase(name):
        """Stop the running phase's clock and start phase ``name``'s."""
        now = time.perf_counter()
        phase_s[clock[1]] = now - clock[0]
        clock[:] = [now, name]

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    print(f"phase1 card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    bdir = build.build()
    print(f"phase1 build: {time.perf_counter() - t0:.2f} s into "
          f"{bdir.relative_to(ROOT)}", flush=True)
    for src, log in build.build_logs().items():
        lines = log.splitlines()
        regs = sorted({ln.split("Used ")[1] for ln in lines if "Used " in ln})
        spills = any(" 0 bytes spill stores" not in ln
                     for ln in lines if "spill stores" in ln)
        print(f"phase1 ptxas {src}: {' | '.join(regs)}; spills={spills}")
    # the l1 bound's operations a column, from the built tile loop
    l1_ops = l1_ops_from_sass(bdir)
    print(f"phase1 l1 bound: {l1_ops:g} fp32 operations a column", flush=True)

    # ------------------------------------------------------------- data
    t0 = time.perf_counter()
    arrays = {"planted": planted_medoid(SEED, 20000, 784)}
    for cell in CELLS:
        name, ds, n, d = cell[:4]
        if ds not in arrays:
            arrays[ds] = DATASETS[ds][1](SEED, n, d)
    km_labels = {}
    for name, ds, n, d, k, metric, backend in KM_CELLS:
        arrays[ds], km_labels[ds] = CLUSTER_DATASETS[ds][1](SEED, n, d, k)
    data = {ds: data_from_numpy(a, dev) for ds, a in arrays.items()}
    torch.cuda.synchronize()
    print(f"phase1 data: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(data)}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def timed(fn, reps):
        """Device ms per call: ``reps`` calls captured in one CUDA graph and
        timed with CUDA events around its replay. Launching from Python
        costs tens of microseconds a call, more than many of these kernels
        run, so back-to-back eager launches would time the host."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):      # warm-up off the capture stream
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def _tolerance(plain, metric, x, y, w, per_value_refs=None):
        # rtol 1e-5 on each value (fp32 sums in another order), a floor of
        # 1e-5 of the largest value, and for l2 the self-pair allowance: the
        # Gram trick's cancellation at a zero distance leaves ~|x| sqrt(eps)
        # under the sqrt, so 1e-3 * max row norm per valid reference (one
        # per value for a pairwise block).
        tol = RTOL * plain.abs() + RTOL * plain.abs().max()
        if metric == "l2":
            nref = per_value_refs if per_value_refs is not None else (
                float(w.sum()) if w is not None else y.shape[0])
            norm = max(float(x.norm(dim=1).max()), float(y.norm(dim=1).max()))
            tol = tol + 1e-3 * norm * nref
        return tol

    def _agree(got, want, tol, what):
        err = (got - want).abs()
        _require(bool(torch.isfinite(got).all()), f"{what}: non-finite")
        _require(bool((err <= tol).all()),
                 f"{what} disagrees: max err {float(err.max())}, tol "
                 f"{float(tol.min())}")
        return float(err.max())

    def centrality_inputs(metric, x, y):
        if metric == "cosine":
            return ops._unit_rows(x), ops._unit_rows(y), None, None
        return x, y, ops._norms_sq(x), ops._norms_sq(y)

    def check_centrality(metric, x, y, w, reps=0, dtype="float32"):
        """Kernel vs plain on the card (``dtype``: dot_centrality's
        compute_dtype); returns (max_abs_err, ms, plain_ms, bytes, ops_s,
        library_ms) with times only when reps > 0 (ops_s: the operations'
        least time, on the tensor cores for the bf16 tile path)."""
        xk, yk, xn2, yn2 = centrality_inputs(metric, x, y)
        if metric == "l1":
            def kern():
                return pk.l1_centrality(xk, yk, w)

            def plain():
                return pk.l1_centrality_plain(xk, yk, w)
        else:
            def kern(dtype=dtype):
                return pk.dot_centrality(xk, yk, xn2, yn2, w, metric=metric,
                                         compute_dtype=dtype)

            def plain():
                return pk.dot_centrality_plain(xk, yk, xn2, yn2, w,
                                               metric=metric,
                                               compute_dtype=dtype)
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        c, d = x.shape
        r = y.shape[0]
        what = f"{metric} {dtype} centrality at C={c} R={r} d={d}"
        _require(torch.equal(got, again), f"{what}: two launches differ")
        err = _agree(got, want, _tolerance(want, metric, x, y, w), what)
        plan = pk.centrality_plan(c, r, d, sms,
                                  crossover=pk.dot_crossover(dtype))
        if dtype == "bfloat16" and plan[0] == pk.STREAM:
            # the stream path rounds each value once where it is staged,
            # then does the fp32 mode's operations in the same order
            fp32 = pk.launch_dot_centrality(
                xk.bfloat16().float(), yk.bfloat16().float(), xn2, yn2, w,
                plan, metric)
            _require(torch.equal(got, fp32), f"{what}: the stream path "
                     f"differs from the fp32 mode on pre-rounded rows")
        nbytes = 4 * (c * d + r * d + c)
        if metric in ("l2", "sql2"):
            nbytes += 4 * (c + r)
        if w is not None:
            nbytes += 4 * r
        ops_s = _ops_s((l1_ops if metric == "l1" else GRAM_OPS) * c * r * d,
                       dtype == "bfloat16" and plan[0] == pk.TILE)
        if reps == 0:
            return err, 0.0, 0.0, nbytes, ops_s, None
        if dtype == "bfloat16":
            bf16_more[(metric, c, r, d, w is not None)] = (
                timed(lambda: kern("float32"), reps),
                timed(bf16_yardstick(metric, xk, yk, xn2, yn2, w), reps))
        else:
            twocall[(metric, c, r, d, w is not None)] = timed(
                yardstick(metric, xk, yk, w), reps)
        return (err, timed(kern, reps), timed(plain, max(1, reps // 4)),
                nbytes, ops_s, None)

    def bf16_yardstick(metric, xk, yk, xn2, yn2, w):
        """The bf16 mode's two-call yardstick: ``xr @ yr.T`` of the rows
        rounded to bf16 beforehand (TF32 off), then the finish and a row
        sum or ``@ w``."""
        xr, yr = xk.bfloat16().float(), yk.bfloat16().float()

        def block():
            g = xr @ yr.T
            if metric == "cosine":
                return 1.0 - g
            sq = torch.clamp_min(xn2[:, None] + yn2[None, :] - 2.0 * g, 0.0)
            return sq.sqrt() if metric == "l2" else sq
        return lambda: block() @ w if w is not None else block().sum(1)

    def yardstick(metric, xk, yk, w):
        """The two-call yardstick of a centrality kernel on its inputs: the
        (C, R) distance block by one PyTorch call, then a row sum or
        ``@ w``. No single call computes the function, so it stays out of
        library_ms."""
        def block():
            if metric == "cosine":
                return 1.0 - xk @ yk.T         # unit rows; TF32 is off
            dist = torch.cdist(xk, yk, p=1 if metric == "l1" else 2)
            return dist.square() if metric == "sql2" else dist
        return lambda: block() @ w if w is not None else block().sum(1)

    def forced_centrality(metric, xk, yk, xn2, yn2, plan, dtype="float32"):
        """One launch of the centrality kernel for ``metric`` with
        ``plan`` (no weights; ``dtype``: dot_centrality's compute_dtype)."""
        if metric == "l1":
            return pk.launch_l1_centrality(xk, yk, None, plan)
        return pk.launch_dot_centrality(xk, yk, xn2, yn2, None, plan, metric,
                                        dtype)

    def centrality_crossover(cases, ms, dtype="float32"):
        """Both paths of a centrality kernel, each checked against the plain
        version, two launches bit-equal, and timed, at (m, P // m) and
        (P // m, m) for each m of ``ms`` and each (metric, d, P) of
        ``cases``; a crossover of 32 forces the stream path, 0 the tile
        path. Returns the timings and, per m, the cases the stream path
        wins."""
        cross, wins = [], Counter()
        for metric, d, pulls in cases:
            for m in ms:
                for (c, r) in ((m, pulls // m), (pulls // m, m)):
                    x = torch.rand(c, d, device=dev, generator=gen)
                    y = torch.rand(r, d, device=dev, generator=gen)
                    xk, yk, xn2, yn2 = centrality_inputs(metric, x, y)
                    want = (pk.l1_centrality_plain(xk, yk, None)
                            if metric == "l1" else pk.dot_centrality_plain(
                                xk, yk, xn2, yn2, None, metric=metric,
                                compute_dtype=dtype))
                    tol = _tolerance(want, metric, x, y, None)
                    us = []
                    for forced in (32, 0):
                        plan = pk.centrality_plan(c, r, d, sms,
                                                  crossover=forced)
                        what = (f"{metric} {dtype} centrality {plan} at "
                                f"({c}, {r}, {d})")
                        got = forced_centrality(metric, xk, yk, xn2, yn2,
                                                plan, dtype)
                        again = forced_centrality(metric, xk, yk, xn2, yn2,
                                                  plan, dtype)
                        _require(torch.equal(got, again),
                                 f"{what}: two launches differ")
                        _agree(got, want, tol, what)
                        us.append(1e3 * timed(
                            lambda plan=plan: forced_centrality(
                                metric, xk, yk, xn2, yn2, plan, dtype), 10))
                    wins[m] += us[0] < us[1]
                    cross.append(f"{metric} ({c}, {r}, {d}) stream "
                                 f"{us[0]:.2f} / tile {us[1]:.2f} us")
        return "; ".join(cross) + "; stream path wins " + ", ".join(
            f"m={m}: {v} of {2 * len(cases)}" for m, v in sorted(
                wins.items()))

    def check_pairwise_bf16(x, y, reps=0):
        """dot_pairwise's bf16 mode vs its plain version on the card, on
        both forced paths (two launches bit-equal) and the wrapper's plan;
        returns (max_abs_err, ms, plain_ms, bytes, ops_s, None) with times
        (the wrapper's plan) only when reps > 0."""
        c, d = x.shape
        r = y.shape[0]
        want = pk.dot_pairwise_plain(x, y, compute_dtype="bfloat16")
        tol = _tolerance(want, "block", x, y, None)
        err = 0.0
        for forced in (32, 0):
            plan = pk.pairwise_plan(c, r, d, sms, crossover=forced)
            what = f"dot_pairwise bf16 {plan} at C={c} R={r} d={d}"
            got = pk.launch_pairwise("dot_pairwise", x, y, plan, "bfloat16")
            again = pk.launch_pairwise("dot_pairwise", x, y, plan,
                                       "bfloat16")
            _require(torch.equal(got, again), f"{what}: two launches differ")
            err = max(err, _agree(got, want, tol, what))

        def kern():
            return pk.dot_pairwise(x, y, compute_dtype="bfloat16")
        err = max(err, _agree(kern(), want, tol, f"dot_pairwise bf16 at "
                                                 f"C={c} R={r} d={d}"))
        nbytes = 4 * (c * d + r * d + c * r)
        ops_s = _ops_s(2 * c * r * d,
                       pk.pairwise_plan(c, r, d, sms)[0] == pk.TILE)
        if reps == 0:
            return err, 0.0, 0.0, nbytes, ops_s, None
        xr, yr = x.bfloat16().float(), y.bfloat16().float()
        bf16_more[("pairwise", c, r, d, False)] = (
            timed(lambda: pk.dot_pairwise(x, y), reps),
            timed(lambda: xr @ yr.T, reps))
        return (err, timed(kern, reps), timed(
            lambda: pk.dot_pairwise_plain(x, y, compute_dtype="bfloat16"),
            max(1, reps // 4)), nbytes, ops_s, None)

    def check_pairwise(name, x, y, reps=0):
        """The pairwise kernel ``name`` vs its plain version on the card;
        for dot_pairwise also the sql2/l2 blocks built from it (with the
        self-pair allowance). Returns (max_abs_err, ms, plain_ms, bytes,
        ops_s, library_ms) with times only when reps > 0."""
        if name == "dot_pairwise":
            kern, plain = pk.dot_pairwise, pk.dot_pairwise_plain

            def library():
                return x @ y.T                 # TF32 is off (above)
        else:
            kern, plain = pk.l1_pairwise, pk.l1_pairwise_plain

            def library():
                return torch.cdist(x, y, p=1)
        got, again, want = kern(x, y), kern(x, y), plain(x, y)
        torch.cuda.synchronize()
        c, d = x.shape
        r = y.shape[0]
        what = f"{name} at C={c} R={r} d={d}"
        _require(torch.equal(got, again), f"{what}: two launches differ")
        err = _agree(got, want, _tolerance(want, "block", x, y, None), what)
        if name == "dot_pairwise":
            sq = torch.clamp_min(ops._norms_sq(x)[:, None]
                                 + ops._norms_sq(y)[None, :] - 2.0 * want, 0)
            sq_tol = _tolerance(sq, "sql2", x, y, None)
            # l2 is held as far as its square is: a square within e of a
            # moves the root by at most max(sqrt(a + e) - sqrt(a),
            # sqrt(a) - sqrt(a - e)), which is sqrt(e) at a = 0. At a
            # self-pair the two Grams' rounding (~1e-6 of |x|^2 over
            # d = 784, a serial cuBLAS sum against the kernel's grouped
            # one) cancels to a square of ~5e-4 on MNIST rows, whose root
            # exceeds the 1e-3 |x| self-pair allowance alone.
            l2 = torch.sqrt(sq)
            l2_tol = torch.maximum(
                _tolerance(l2, "l2", x, y, None, 1),
                torch.maximum(torch.sqrt(sq + sq_tol) - l2,
                              l2 - torch.sqrt(torch.clamp_min(sq - sq_tol,
                                                              0))))
            for metric, plain_d, tol in (("sql2", sq, sq_tol),
                                         ("l2", l2, l2_tol)):
                got_d = ops.pairwise_kernel(metric)(x, y)
                _agree(got_d, plain_d, tol, f"{metric} from {what}")
        nbytes = 4 * (c * d + r * d + c * r)
        ops_s = _ops_s((GRAM_OPS if name == "dot_pairwise" else l1_ops)
                       * c * r * d)
        if reps == 0:
            return err, 0.0, 0.0, nbytes, ops_s, None
        return (err, timed(lambda: kern(x, y), reps),
                timed(lambda: plain(x, y), max(1, reps // 4)), nbytes, ops_s,
                timed(library, reps))

    def check_topk(keys, theta=None):
        """topk_smallest against argsort(stable=True)[:keep] for keep in
        {1, C // 2, C}, TOPK_KEEPS and SELECT_KEEP_LIMIT, by the wrapper (on
        its plan's path) and by one launch on each path forced (the select
        where keep <= SELECT_KEEP_LIMIT, by the plan's cluster and by one
        block); where C <= TOPK_PLAIN_MAX also
        against the plain version, and the rank-only mode against
        topk_rank_plain. With ``theta``, the float estimates ``keys`` were
        made from, the fp32 mode equals the int32 launch on every path and
        through ops.kernel_topk_smallest. All bit-equal."""
        c = keys.shape[0]
        lib = torch.argsort(keys, stable=True)
        rank = pk.topk_rank_plain(keys) if c <= TOPK_PLAIN_MAX else None
        if rank is not None:
            _require(torch.equal(pk.topk_rank(keys), rank),
                     f"topk_rank disagrees at C={c}")
        sort = (pk.SORT,) + pk.topk_rank_plan(c, sms)
        for keep in sorted({1, max(1, c // 2), c}
                           | {min(k, c) for k in TOPK_KEEPS
                              + (pk.SELECT_KEEP_LIMIT,)}):
            what = f"topk_smallest at C={c} keep={keep}"
            got = pk.topk_smallest(keys, keep)
            _require(torch.equal(got, lib[:keep]),
                     f"{what} differs from a stable argsort")
            if rank is not None:
                _require(torch.equal(got, pk.topk_select_plain(rank, keep)),
                         f"{what} disagrees with its plain version")
            if theta is not None:
                _require(torch.equal(ops.kernel_topk_smallest(
                    theta, keep=keep), got), f"{what}: the fp32 mode differs")
            selects = [pk.select_plan(c), pk.select_plan(c, cluster=1)]
            for plan in [sort] + (selects if keep <= pk.SELECT_KEEP_LIMIT
                                  else []):
                out = pk.launch_topk(keys, keep, plan)[0]
                _require(torch.equal(out, lib[:keep]),
                         f"{what} on {plan} differs from a stable argsort")
                if theta is not None:
                    _require(torch.equal(pk.launch_topk(theta, keep, plan)[0],
                                         out),
                             f"{what} on {plan}: the fp32 mode differs")
        return keys

    def select_time(c, keep):
        """topk_smallest's select path at (C, keep), as the main path
        launches it (ops.kernel_topk_smallest, the fp32 mode), checked on
        random and tie-heavy estimates, timed beside its plain version
        (totalorder_keys, then topk_smallest_plain) and a stable argsort of
        the keys: (err, ms, plain_ms, bytes, ops_s, library_ms)."""
        ck = ("select", c, keep)
        if ck not in cache:
            for theta in (tie_heavy(c),
                          torch.rand(c, device=dev, generator=gen)):
                keys = check_topk(ops.totalorder_keys(theta), theta)
            _require(pk.topk_plan(c, keep, sms)[0] == pk.SELECT,
                     f"C={c} keep={keep} does not take the select path")
            cache[ck] = (
                0.0, timed(lambda: ops.kernel_topk_smallest(theta, keep=keep),
                           10),
                timed(lambda: pk.topk_smallest_plain(
                    ops.totalorder_keys(theta), keep), 3),
                4 * c + 8 * keep, 0,
                timed(lambda: torch.argsort(keys, stable=True), 10))
        return cache[ck]

    def tie_heavy(c):
        """Estimates with ties, -0.0/+0.0, +-inf and NaNs of both signs."""
        theta = torch.randn(c, device=dev, generator=gen)
        theta[::7] = 0.0
        theta[::11] = -0.0
        theta[::13] = float("inf")
        theta[::19] = -float("inf")
        theta[::17] = float("nan")
        theta[::23] = -float("nan")
        theta[::5] = theta[0].clone()
        return theta

    led = Ledger()
    cache = {}
    twocall = {}   # (metric, C, R, d, masked) -> ms of the yardstick
    # (metric or "pairwise", C, R, d, masked) -> (ms of the fp32 mode, ms of
    # the bf16 mode's yardstick) on a bf16 mode's inputs
    bf16_more = {}

    def rows_of(ds, c):
        """c random rows of ``data[ds]``, or all of them and zero rows past
        its end (as a corpus's dead slots are)."""
        src = data[ds]
        n = src.shape[0]
        if c <= n:
            return src[torch.randperm(n, device=dev, generator=gen)[:c]]
        return torch.cat([src, src.new_zeros((c - n, src.shape[1]))])

    def event_ms(fn):
        """Device ms of one call (CUDA events; these calls run for tens of
        milliseconds or more, so the launch cost is noise)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def big_time(kern, ds, c, r, metric, masked, square):
        """Check and time one launch too large to hold against the plain
        version whole: the kernel (two launches bit-equal) against the
        plain version on ~BIG_ROWS rows of x (the first 256, the last 256
        and a stride); then one timed call each of the kernel, the library
        call and the plain version over all of x, in row blocks whose
        outputs are dropped. ``square``: x is y, as in a bootstrap."""
        x = rows_of(ds, c)
        y = x if square else rows_of(ds, r)
        d = x.shape[1]
        idx = torch.unique(torch.cat([
            torch.arange(min(c, 256)), torch.arange(max(0, c - 256), c),
            torch.linspace(0, c - 1, BIG_ROWS).long()])).to(dev)
        what = f"{kern} at C={c} R={r} d={d}"
        if kern in PAIRWISE:
            dot = kern == "dot_pairwise"
            fn = pk.dot_pairwise if dot else pk.l1_pairwise
            plain = pk.dot_pairwise_plain if dot else pk.l1_pairwise_plain
            got = fn(x, y)
            _require(torch.equal(got, fn(x, y)),
                     f"{what}: two launches differ")
            want = plain(x[idx], y)
            err = _agree(got[idx], want,
                         RTOL * want.abs() + RTOL * want.abs().max(), what)
            del got
            ms = event_ms(lambda: fn(x, y))
            lib = event_ms((lambda: x @ y.T) if dot
                           else (lambda: torch.cdist(x, y, p=1)))
            step = max(1, 2 ** 28 // r)        # 1 GiB of output a block

            def plain_all():
                for i in range(0, c, step):
                    plain(x[i:i + step], y)
            pms = event_ms(plain_all)
            torch.cuda.empty_cache()
            return (err, ms, pms, 4 * (c * d + r * d + c * r),
                    _ops_s((GRAM_OPS if dot else l1_ops) * c * r * d), lib)
        w = (torch.rand(r, device=dev, generator=gen) > 0.3).float() \
            if masked else None
        xk, yk, xn2, yn2 = centrality_inputs(metric, x, y)

        def fn(a=xk, an=xn2):
            if metric == "l1":
                return pk.l1_centrality(a, yk, w)
            return pk.dot_centrality(a, yk, an, yn2, w, metric=metric)

        def plain(a, an):
            if metric == "l1":
                return pk.l1_centrality_plain(a, yk, w)
            return pk.dot_centrality_plain(a, yk, an, yn2, w, metric=metric)

        def part(rows):
            return None if xn2 is None else xn2[rows]
        def plain_rows(rows):
            # row blocks of at most 2**31 broadcast elements where the plain
            # l1 centrality materialises the (rows, R, d) difference, else of
            # a 1 GiB (rows, R) block
            step = max(1, 2 ** 31 // (r * d) if metric == "l1"
                       else 2 ** 28 // r)
            return torch.cat([plain(xk[rows[i:i + step]],
                                    part(rows[i:i + step]))
                              for i in range(0, rows.shape[0], step)])
        got = fn()
        _require(torch.equal(got, fn()), f"{what}: two launches differ")
        want = plain_rows(idx)
        err = _agree(got[idx], want, _tolerance(want, metric, x[idx], y, w),
                     what)
        ms = event_ms(fn)
        pms = event_ms(lambda: plain_rows(torch.arange(c, device=dev)))
        nbytes = 4 * (c * d + r * d + c)
        if metric in ("l2", "sql2"):
            nbytes += 4 * (c + r)
        if masked:
            nbytes += 4 * r
        return (err, ms, pms, nbytes,
                _ops_s((l1_ops if metric == "l1" else GRAM_OPS) * c * r * d),
                None)

    def shape_time(kern, ds, c, r=0, metric="", masked=False):
        """Check and time ``kern`` once per shape on rows of dataset ``ds``
        (random rows at the main path's shape; a random 0/1 reference mask
        where the main path masks): the cached (err, ms, plain_ms, bytes,
        ops_s, library_ms). topk_smallest (r its keep) on the select path
        is select_time's; on the sort path it is keyed by C alone, timed at
        the halving's keep = C in the fp32 mode the main path launches, and
        its cache entry also holds the rank-only mode's time and the launch
        floor."""
        if kern == "topk_smallest":
            if pk.topk_plan(c, r, sms)[0] == pk.SELECT:
                return select_time(c, r)
            ck = ("topk", c)
            if ck not in cache:
                th = tie_heavy(c)
                check_topk(ops.totalorder_keys(th), th)
                theta = torch.rand(c, device=dev, generator=gen)
                keys = check_topk(ops.totalorder_keys(theta), theta)
                one = torch.empty(1, device=dev)
                # the bound: its 4 C + 8 keep bytes (keys in, indices out)
                cache[ck] = {
                    "topk_smallest": (
                        0.0, timed(lambda: ops.kernel_topk_smallest(
                            theta, keep=c), 10),
                        timed(lambda: pk.topk_smallest_plain(
                            ops.totalorder_keys(theta), c), 3),
                        12 * c, 0,
                        timed(lambda: torch.argsort(keys, stable=True), 10)),
                    "rank_only_ms": timed(lambda: pk.topk_rank(keys), 10),
                    "floor_ms": timed(lambda: one.zero_(), 10)}
            return cache[ck][kern]
        ck = (kern, ds, c, r, metric, masked)
        if ck not in cache and c * r * data[ds].shape[1] >= BIG_ELEMS:
            cache[ck] = big_time(kern, ds, c, r, metric, masked,
                                 square=kern in PAIRWISE and c == r)
        if ck not in cache:
            n = data[ds].shape[0]
            x = data[ds][torch.randperm(n, device=dev, generator=gen)[:c]]
            y = data[ds][torch.randperm(n, device=dev, generator=gen)[:r]]
            if kern in PAIRWISE:
                cache[ck] = check_pairwise(kern, x, y, reps=10)
            elif kern == "dot_pairwise_bf16":
                cache[ck] = check_pairwise_bf16(x, y, reps=10)
            else:
                w = (torch.rand(r, device=dev, generator=gen) > 0.3).float() \
                    if masked else None
                cache[ck] = check_centrality(
                    metric, x, y, w, reps=10,
                    dtype="bfloat16" if kern.endswith("_bf16") else "float32")
        return cache[ck]

    def ledger_add(plan, ds, metric):
        """Add one ledger entry per launch of ``plan`` (items (kernel, C,
        R, masked)); returns per-kernel (ms, plain_ms, bound_ms, max err)."""
        tot = {}
        for kern, c, r, masked in plan:
            err, ms, pms, nbytes, ops_s, lib = shape_time(kern, ds, c, r,
                                                          metric, masked)
            led.add(kern, ms, pms, nbytes, ops_s, err, library_ms=lib)
            t = tot.setdefault(kern, [0.0, 0.0, 0.0, 0.0])
            t[0] += ms
            t[1] += pms
            t[2] += max(_bound_s(nbytes, ops_s)) * 1e3
            t[3] = max(t[3], err)
        return tot

    def fmt_shapes(plan, ds, metric, kerns):
        """The launches of ``plan`` of the kernels ``kerns`` by shape (times
        from shape_time)."""
        out = []
        for (k, c, r, m), nl in sorted(Counter(
                p for p in plan if p[0] in kerns).items()):
            err, ms, pms, nbytes, ops_s, lib = shape_time(k, ds, c, r, metric,
                                                          m)
            b = max(_bound_s(nbytes, ops_s)) * 1e3
            path = kernel_path(k, c, r, data[ds].shape[1])
            out.append(
                f"{k} ({c}, {r}) {path or ''} x{nl}: kernel {ms * nl:.3f} "
                f"ms, bound "
                f"{b * nl:.4f} ms ({b / ms:.1%} of it), plain {pms * nl:.3f} "
                f"ms" + (f", library {lib * nl:.3f} ms (kernel / library "
                         f"{ms / lib:.2f})" if lib is not None else "")
                + f", max_abs_err {err:.3g}")
        return "; ".join(out)

    def fmt_tot(tot):
        return "; ".join(f"{k} kernel {v[0]:.3f} ms, plain {v[1]:.3f} ms, "
                         f"bound {v[2]:.4f} ms, max_abs_err {v[3]:.3g}"
                         for k, v in sorted(tot.items()))

    def rounds_of(n):
        return executed_rounds(n, BUDGET_PER_ARM * n)

    two_calls = {"l1": "cdist(p=1), row sum", "l2": "cdist, row sum",
                 "sql2": "cdist squared, row sum",
                 "cosine": "1 - x @ y.T, row sum"}

    def centrality_classes(kern, plan, ds, d, metric):
        """The centrality kernel ``kern``'s launches of ``plan`` by shape
        class (times from shape_time): skinny R-short and C-short (stream
        path), middle (tile path), masked refinement (any path); with the
        two-call yardstick, the launches by path, and the share of the
        bound reached by each skinny round with C or R >= 2500."""
        by_class = {}
        big = {}   # skinny rounds with C or R >= 2500: share of the bound
        for k, c, r, masked in plan:
            if k != kern:
                continue
            path = kernel_path(kern, c, r, d)
            cls = ("masked refinement" if masked else
                   "middle" if path == pk.TILE else
                   "skinny C-short" if c <= r else "skinny R-short")
            _, ms, pms, nbytes, ops_s, _ = shape_time(kern, ds, c, r, metric,
                                                      masked)
            b, o = _bound_s(nbytes, ops_s)
            if cls.startswith("skinny") and max(c, r) >= 2500:
                big[(c, r)] = max(b, o) * 1e3 / ms
            v = by_class.setdefault(cls, [0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                          Counter()])
            for i, add in enumerate((1, ms, b * 1e3, o * 1e3, pms,
                                     twocall[(metric, c, r, d, masked)])):
                v[i] += add
            v[6] += max(b, o) * 1e3
            kind = (f"{path} {'C' if c <= r else 'R'}-short"
                    if path == pk.STREAM else path)
            v[7][kind] += 1
            cen_paths[kern][kind] += 1
        return "; ".join(
            f"{cls}: {v[0]} launches, kernel {v[1]:.3f} ms, bound {v[6]:.4f} "
            f"ms ({'bytes' if v[2] >= v[3] else 'operations'}, "
            f"{v[6] / v[1]:.1%} of it), plain {v[4]:.3f} ms, two calls "
            f"({two_calls[metric]}) {v[5]:.3f} ms, kernel / two calls "
            f"{v[1] / v[5]:.2f}, paths {dict(v[7])}"
            for cls, v in sorted(by_class.items())) + (
            f"; skinny shapes with C or R >= 2500: "
            f"{sum(v >= 0.5 for v in big.values())} of {len(big)} at >= 50% "
            f"of their bound, " + ", ".join(
                f"({c}, {r}) {v:.1%}" for (c, r), v in sorted(big.items())))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    paths = Counter()     # (pairwise kernel, path) -> main-path launches
    rank_cs = Counter()   # C -> topk_smallest launches of the main path
    cen_paths = {k: Counter() for k in CENTRALITY}

    def kernel_path(kern, c, r, d):
        """The path the wrapper of kernel ``kern`` (a ``LAUNCHES`` name)
        takes at (c, r, d), or None for a kernel without paths."""
        dtype = "bfloat16" if kern.endswith("_bf16") else "float32"
        fp32 = pk.dot_gemm(dtype)
        if kern.startswith("dot_pairwise"):
            return pk.pairwise_plan(c, r, d, sms, fp32_gram=fp32)[0]
        if kern.startswith("dot_centrality"):
            return pk.centrality_plan(c, r, d, sms,
                                      crossover=pk.dot_crossover(dtype),
                                      fp32_gram=fp32)[0]
        if kern == "l1_pairwise":
            return pk.pairwise_plan(c, r, d, sms)[0]
        if kern == "l1_centrality":
            return pk.centrality_plan(c, r, d, sms)[0]
        if kern == "topk_smallest":     # r is keep
            return pk.topk_plan(c, r, sms)[0]
        return None

    def path_counts(plan, d):
        """The pairwise launches of ``plan`` by the path their wrapper
        gives them."""
        return Counter((kern, kernel_path(kern, c, r, d))
                       for kern, c, r, _ in plan if kern in PAIRWISE)

    def check_launches(cell, counts, plan, d):
        """Hold a main-path run's ``counts`` (a ``Launches``) against
        ``plan``'s launches, by kernel and by the path ``kernel_path`` gives
        each shape at width ``d``, and add them to the ledger."""
        want = dict(Counter(k for k, *_ in plan))
        _require(counts == want, f"{cell}: launches {counts}, expected "
                                 f"{want}")
        want = Counter()
        for k, *shape in plan:
            path = kernel_path(k, *shape[:2], d) if shape else None
            if path is not None:
                want[(k, path)] += 1
        _require(counts.paths == want, f"{cell}: launches by path "
                 f"{dict(counts.paths)}, expected {dict(want)}")
        for k, v in counts.items():
            led.rows[k]["launches"] += v
        for (k, path), v in counts.paths.items():
            led.rows[k]["paths"][path] += v

    def _breakdown(x, key, n, metric, backend, precision="fp32"):
        """Where a steady call's time goes: (host ms of the random draws
        alone — the same splits and permutations, nothing else; the
        profiled call, see ``profiled``)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k = key
        for rd in rounds_of(n):
            k, sub = rng.split(k)
            if rd.num_refs < n:
                rng.permutation(sub, n)
        torch.cuda.synchronize()
        draws_ms = (time.perf_counter() - t0) * 1e3
        return draws_ms, profiled(lambda: find_medoid(
            x, key, metric=metric, backend=backend,
            budget_per_arm=BUDGET_PER_ARM, precision=precision))

    # ------------------------------------------------ phase 2: kernels
    phase("2")
    # ragged shapes (no tile multiple) and random reference masks
    for (c, r, d) in ((1, 1, 1), (77, 131, 300), (130, 65, 257),
                      (333, 1234, 784), (333, 1234, 2048), (97, 1234, 4096),
                      (5, 8000, 4096), (20000, 3, 784)):
        x = torch.randn(c, d, device=dev, generator=gen)
        y = torch.randn(r, d, device=dev, generator=gen)
        for masked in (False, True):
            w = (torch.rand(r, device=dev, generator=gen) > 0.3).float() \
                if masked else None
            for metric in ("l1", "l2", "sql2", "cosine"):
                err = check_centrality(metric, x, y, w)[0]
                led.note_err("l1_centrality" if metric == "l1"
                             else "dot_centrality", err)
                if metric != "l1":
                    led.note_err("dot_centrality_bf16", check_centrality(
                        metric, x, y, w, dtype="bfloat16")[0])
    print("phase2 ragged shapes and masks: l1/l2/sql2/cosine and the bf16 "
          "mode of l2/sql2/cosine agree", flush=True)
    s_cross = pk.PAIRWISE_S
    for (c, r, d) in ((1, 1, 1), (1, 20000, 784), (20000, 1, 784),
                      (20000, 10, 784), (77, 131, 300), (1, 20000, 1024),
                      (20000, 8, 1024), (65, 64, 257), (s_cross, 20000, 784),
                      (s_cross + 1, 5000, 784), (157, 135, 784),
                      (1250, 17, 784), (17, 1250, 784), (3000, 3, 257)):
        x = torch.randn(c, d, device=dev, generator=gen)
        y = torch.randn(r, d, device=dev, generator=gen)
        y[: min(c, r, 3)] = x[: min(c, r, 3)]          # self-pairs
        for name in PAIRWISE:
            led.note_err(name, check_pairwise(name, x, y)[0])
    for (c, r, d) in ((5, 3000, 784), (3000, 5, 784), (157, 135, 784)):
        # a contiguous view 4 bytes past a 16-byte boundary: scalar loads
        buf = torch.randn(c * d + 1, device=dev, generator=gen)
        x = buf[1:].view(c, d)
        _require(x.data_ptr() % 16 != 0, "the view is 16-byte aligned")
        y = torch.randn(r, d, device=dev, generator=gen)
        for name in PAIRWISE:
            led.note_err(name, check_pairwise(name, x, y)[0])
            led.note_err(name, check_pairwise(name, y, x)[0])
    print(f"phase2 ragged, crossover (S = {s_cross}), d % 4 != 0 and "
          "misaligned shapes: dot_pairwise (and sql2/l2 from it) and "
          "l1_pairwise agree, two launches bit-equal", flush=True)
    # both pairwise paths, each checked and timed, on either side of the
    # crossover at round shapes of 16 pulls per arm at n = 20000 (C R ~
    # 21333); a crossover of 32 forces the stream path, 0 the tile path
    t0 = time.perf_counter()
    cross = []
    for d in (784, 1024):
        for m in (8, 12, 16, 20, 24):
            for (c, r) in ((m, 21333 // m), (21333 // m, m)):
                x = torch.randn(c, d, device=dev, generator=gen)
                y = torch.randn(r, d, device=dev, generator=gen)
                for name in PAIRWISE:
                    want = getattr(pk, f"{name}_plain")(x, y)
                    tol = _tolerance(want, "block", x, y, None)
                    us = []
                    for forced in (32, 0):
                        plan = pk.pairwise_plan(c, r, d, sms,
                                                crossover=forced)
                        _agree(pk.launch_pairwise(name, x, y, plan), want,
                               tol, f"{name} {plan} at ({c}, {r}, {d})")
                        us.append(1e3 * timed(
                            lambda plan=plan: pk.launch_pairwise(
                                name, x, y, plan), 10))
                    cross.append(f"{name[:2]} ({c}, {r}, {d}) stream "
                                 f"{us[0]:.2f} / tile {us[1]:.2f} us")
    print(f"phase2 pairwise crossover, both paths checked and timed "
          f"({time.perf_counter() - t0:.1f} s): " + "; ".join(cross),
          flush=True)

    # the Gram kernels' gemm path (fp32), forced: checked against the plain
    # versions on ragged shapes, d % 4 != 0, a view 4 bytes past a 16-byte
    # boundary and several 256-column groups (l2 with self-pairs, sql2 and
    # cosine, with and without a mask), two launches bit-equal; then timed
    # beside the tile path, the plain versions and x @ y.T on both sides of
    # its crossover (GEMM_FILL: squares, short sides 64-256, two widths)
    t0 = time.perf_counter()
    for c, r, d, off in ((300, 257, 784, 0), (1000, 1000, 783, 0),
                         (333, 1234, 784, 1), (129, 130, 4096, 0)):
        x = torch.randn(c * d + off, device=dev, generator=gen)[off:]
        x = x.view(c, d)
        y = torch.randn(r, d, device=dev, generator=gen)
        y[:3] = x[:3]                                  # self-pairs
        plan = pk.gemm_plan(c, r, sms)
        what = f"dot_pairwise {plan} at ({c}, {r}, {d}) offset {off}"
        got = pk.launch_pairwise("dot_pairwise", x, y, plan)
        _require(torch.equal(got, pk.launch_pairwise("dot_pairwise", x, y,
                                                     plan)),
                 f"{what}: two launches differ")
        want = pk.dot_pairwise_plain(x, y)
        led.note_err("dot_pairwise", _agree(
            got, want, _tolerance(want, "block", x, y, None), what))
        for metric in ("l2", "sql2", "cosine"):
            xk, yk, xn2, yn2 = centrality_inputs(metric, x, y)
            for w in (None, (torch.rand(r, device=dev, generator=gen)
                             > 0.3).float()):
                what = (f"{metric} centrality {plan} at ({c}, {r}, {d}) "
                        f"offset {off}, mask {w is not None}")
                got = pk.launch_dot_centrality(xk, yk, xn2, yn2, w, plan,
                                               metric)
                _require(torch.equal(got, pk.launch_dot_centrality(
                    xk, yk, xn2, yn2, w, plan, metric)),
                    f"{what}: two launches differ")
                want = pk.dot_centrality_plain(xk, yk, xn2, yn2, w,
                                               metric=metric)
                led.note_err("dot_centrality", _agree(
                    got, want, _tolerance(want, metric, x, y, w), what))
    cross = []
    for c, r, d in ((128, 128, 784), (512, 512, 784), (896, 896, 784),
                    (1024, 1024, 784), (1536, 1536, 784), (2048, 2048, 784),
                    (160, 4096, 784), (192, 4096, 784), (256, 4096, 784),
                    (4096, 512, 784), (64, 8192, 784), (128, 8192, 784),
                    (128, 32768, 784), (896, 896, 2048), (48, 16384, 2048)):
        x = torch.rand(c, d, device=dev, generator=gen)
        y = torch.rand(r, d, device=dev, generator=gen)
        w = (torch.rand(r, device=dev, generator=gen) > 0.3).float()
        xn2, yn2 = ops._norms_sq(x), ops._norms_sq(y)
        want_p = pk.dot_pairwise_plain(x, y)
        want_c = pk.dot_centrality_plain(x, y, xn2, yn2, w, metric="l2")
        us = []
        for plan in (pk.gemm_plan(c, r, sms),
                     pk.pairwise_plan(c, r, d, sms)):
            what = f"({c}, {r}, {d}) {plan}"
            _agree(pk.launch_pairwise("dot_pairwise", x, y, plan), want_p,
                   _tolerance(want_p, "block", x, y, None),
                   f"dot_pairwise {what}")
            _agree(pk.launch_dot_centrality(x, y, xn2, yn2, w, plan, "l2"),
                   want_c, _tolerance(want_c, "l2", x, y, w),
                   f"l2 centrality {what}")
            us.append(1e3 * timed(lambda plan=plan: pk.launch_pairwise(
                "dot_pairwise", x, y, plan), 10))
            us.append(1e3 * timed(lambda plan=plan: pk.launch_dot_centrality(
                x, y, xn2, yn2, w, plan, "l2"), 10))
        plain_p = 1e3 * timed(lambda: pk.dot_pairwise_plain(x, y), 3)
        plain_c = 1e3 * timed(lambda: pk.dot_centrality_plain(
            x, y, xn2, yn2, w, metric="l2"), 3)
        lib = 1e3 * timed(lambda: x @ y.T, 10)
        pick = pk.pairwise_plan(c, r, d, sms, fp32_gram=True)[0]
        cross.append(
            f"({c}, {r}, {d}) fill {pk.gemm_fill(c, r, sms):.3f} plan "
            f"{pick}: dot_pairwise gemm {us[0]:.2f} / "
            f"tile {us[2]:.2f} / plain {plain_p:.2f} / x @ y.T {lib:.2f} us, "
            f"dot_centrality l2 masked gemm {us[1]:.2f} / tile {us[3]:.2f} / "
            f"plain {plain_c:.2f} us, bound "
            f"{1e6 * _ops_s(2 * c * r * d):.2f} us")
    print(f"phase2 gemm path (GEMM_FILL = {pk.GEMM_FILL}): dot_pairwise "
          f"and dot_centrality (l2 with self-pairs, sql2, cosine; masks) "
          f"agree at ragged shapes, d % 4 != 0, a misaligned view and d = "
          f"4096, two launches bit-equal; both paths checked and timed "
          f"({time.perf_counter() - t0:.1f} s): " + "; ".join(cross),
          flush=True)

    # the Gram kernels' d split (fp32): checked against the plain versions
    # through the wrappers at the embedding rounds of phases 8d (d = V of
    # internlm2) and 10e (zamba2's), at d = 92543 and on a view 4 bytes past
    # a 16-byte boundary; then, at each round of both widths, the unsplit
    # plan and the wrapper's (dot_pairwise, and dot_centrality's l2 with a
    # mask) timed twice in turns, and the wrapper's plan held on the faster
    # side where the two differ by more than the noise: the larger of the
    # two repeats' spread and SPLIT_NOISE of the faster time.
    t0 = time.perf_counter()
    wide = (92544, 32000)                # internlm2-1.8b's V, zamba2-2.7b's
    split_shapes = embed_round_shapes()
    big = torch.rand(max(c for c, _ in split_shapes), max(wide),
                     device=dev, generator=gen)
    for d in wide + (wide[0] - 1,):
        for c, r in split_shapes:
            x = big[:c, :d].contiguous()
            y = torch.rand(r, d, device=dev, generator=gen)
            led.note_err("dot_pairwise", check_pairwise("dot_pairwise", x,
                                                        y)[0])
            for masked in (False, True):
                w = (torch.rand(r, device=dev, generator=gen) > 0.3).float() \
                    if masked else None
                for metric in ("l2", "sql2", "cosine"):
                    led.note_err("dot_centrality",
                                 check_centrality(metric, x, y, w)[0])
    for c, r in ((256, 14), (32, 116), (2048, EMB_K), (4, 930)):
        buf = torch.rand(c * wide[0] + 1, device=dev, generator=gen)
        x = buf[1:].view(c, wide[0])
        _require(x.data_ptr() % 16 != 0, "the view is 16-byte aligned")
        y = torch.rand(r, wide[0], device=dev, generator=gen)
        for a, b in ((x, y), (y, x)):
            led.note_err("dot_pairwise", check_pairwise("dot_pairwise", a,
                                                        b)[0])
            for metric in ("l2", "sql2", "cosine"):
                led.note_err("dot_centrality", check_centrality(
                    metric, a, b, (torch.rand(b.shape[0], device=dev,
                                              generator=gen) > 0.3).float()
                )[0])
    checked_s = time.perf_counter() - t0
    cross, split_paths = [], Counter()
    for d in wide:
        for c, r in split_shapes:
            x = big[:c, :d].contiguous()
            y = torch.rand(r, d, device=dev, generator=gen)
            w = (torch.rand(r, device=dev, generator=gen) > 0.3).float()
            xn2, yn2 = ops._norms_sq(x), ops._norms_sq(y)
            want_c = pk.dot_centrality_plain(x, y, xn2, yn2, w, metric="l2")
            for kern, plan_of, launch in (
                    ("dot_pairwise", pk.pairwise_plan,
                     lambda p: pk.launch_pairwise("dot_pairwise", x, y, p)),
                    ("dot_centrality",
                     lambda *a, **k: pk.centrality_plan(
                         *a, crossover=pk.DOT_CENTRALITY_S, **k),
                     lambda p: pk.launch_dot_centrality(x, y, xn2, yn2, w, p,
                                                        "l2"))):
                unsplit = plan_of(c, r, d, sms)
                plan = plan_of(c, r, d, sms, fp32_gram=True)
                split_paths[(kern, plan[0])] += 1
                if kern == "dot_centrality":
                    _agree(launch(unsplit), want_c,
                           _tolerance(want_c, "l2", x, y, w),
                           f"l2 centrality {unsplit} at ({c}, {r}, {d})")
                if plan == unsplit:
                    continue
                us = {}
                for p in (unsplit, plan, plan, unsplit):
                    us.setdefault(p, []).append(
                        1e3 * timed(lambda p=p: launch(p), 10))
                t_un, t_pl = (sum(us[unsplit]) / 2, sum(us[plan]) / 2)
                noise = max(max(v) - min(v) for v in us.values())
                noise = max(noise, SPLIT_NOISE * min(t_un, t_pl))
                _require(t_pl <= t_un + noise,
                         f"{kern} at ({c}, {r}, {d}): the plan {plan} "
                         f"({us[plan]} us) is slower than {unsplit} "
                         f"({us[unsplit]} us) beyond the noise {noise:.2f}")
                cross.append(f"{'pw' if kern == 'dot_pairwise' else 'cen'} "
                             f"({c}, {r}, {d}) {unsplit[0]} "
                             f"{t_un:.1f} / {plan[0]} x{plan[2]} {t_pl:.1f} "
                             f"us")
    print(f"phase2 d split (SPLIT_MIN_D = {pk.SPLIT_MIN_D}): dot_pairwise "
          f"(and sql2/l2 from it) and dot_centrality (l2, sql2, cosine; "
          f"masks) agree through the wrappers at the {len(split_shapes)} "
          f"embedding round shapes at d = {wide} and {wide[0] - 1} and on a "
          f"misaligned view, two launches bit-equal ({checked_s:.1f} s); "
          f"the plans {dict(split_paths)}; the plan on the faster side "
          f"everywhere (unsplit / plan; {time.perf_counter() - t0:.1f} s): "
          + "; ".join(cross),
          flush=True)
    del big

    rt = pk.RANK_TILE
    t0 = time.perf_counter()
    topk_cs = sorted({1, 2, 3, 64, 129, 513, 1000, 4097, 6424, 20000,
                      rt - 1, rt, rt + 1, 2 * rt + 1, 2 ** 20})
    for c in topk_cs:
        th = tie_heavy(c)
        check_topk(ops.totalorder_keys(th), th)
        check_topk(torch.full((c,), 7, dtype=torch.int32, device=dev))
        check_topk(torch.where(torch.rand(c, device=dev, generator=gen)
                               < 0.5, -2 ** 31, 2 ** 31 - 1).int())
    print(f"phase2 topk_smallest at C = {topk_cs} (keep 1, C // 2, C and "
          f"{TOPK_KEEPS + (pk.SELECT_KEEP_LIMIT,)}; the wrapper, the sort and "
          f"the select path forced, "
          f"the fp32 mode on each) and its rank-only mode on ties, "
          f"-0.0/+0.0, +-inf, +-nan, all-equal and int32 extreme keys: "
          f"bit-equal to argsort(stable=True) and, to C = {TOPK_PLAIN_MAX}, "
          f"the plain version ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    # the tile of the one topk launch: each candidate tile at the large C of
    # the main path (one block below the tile, clusters of tiles above it),
    # at the main path's keep = C
    tiles = []
    for c in (2048, 4096, 6424, 8192, 10000, 20000):
        keys = ops.totalorder_keys(torch.rand(c, device=dev, generator=gen))
        want = torch.argsort(keys, stable=True)
        us = []
        plans = [pk.topk_rank_plan(c, sms, tile=tile)
                 for tile in (512, 1024, 2048)]
        plans += [(t, 8) for t, cl in plans if c > t and cl < 8]
        for plan in plans:
            tile = plan[0]
            plan = (pk.SORT,) + plan
            _require(torch.equal(pk.launch_topk(keys, c, plan)[0], want),
                     f"topk_smallest {plan} disagrees at C={c}")
            us.append(f"{tile} {plan} "
                      f"{1e3 * timed(lambda p=plan: pk.launch_topk(keys, c, p), 10):.2f}")
        tiles.append(f"C={c}: " + ", ".join(us) + " us")
    print("phase2 topk_smallest by tile (tile (tile, cluster) time): "
          + "; ".join(tiles), flush=True)
    # both paths of each centrality kernel, checked and timed on either
    # side of the crossover at round shapes of the main path: 16 pulls per
    # arm at n = 20000 (C R ~ 21333) for the k-medoids BUILD, 30 (~40000)
    # for find_medoid
    t0 = time.perf_counter()
    line = centrality_crossover((("l1", 1024, 21333), ("l1", 4096, 40000)),
                                (8, 12, 16, 20, 24))
    print(f"phase2 l1_centrality crossover (S_c = {pk.CENTRALITY_S}), both "
          f"paths checked and timed ({time.perf_counter() - t0:.1f} s): "
          + line, flush=True)
    t0 = time.perf_counter()
    line = centrality_crossover((("l2", 784, 40000), ("l2", 784, 21333),
                                 ("cosine", 2048, 40000)),
                                (8, 12, 16, 20, 24, 28))
    print(f"phase2 dot_centrality crossover (S_c = {pk.DOT_CENTRALITY_S}), "
          f"both paths checked and timed ({time.perf_counter() - t0:.1f} "
          f"s): " + line, flush=True)
    t0 = time.perf_counter()
    line = centrality_crossover((("l2", 784, 40000), ("sql2", 784, 40000),
                                 ("cosine", 2048, 40000)),
                                (2, 4, 8, 10, 12, 16, 20, 24),
                                dtype="bfloat16")
    print(f"phase2 dot_centrality bf16 mode on both paths around S_c = "
          f"{pk.dot_crossover('bfloat16')}, checked and timed "
          f"({time.perf_counter() - t0:.1f} s): " + line, flush=True)
    # dot_pairwise's bf16 mode at the k-medoids pairwise shapes of the
    # mnist cell (its BUILD and SWAP halving rounds, the (n, k) cache, the
    # (1, n) row), both paths checked at each; no path calls it
    t0 = time.perf_counter()
    km_name, km_ds, km_n, km_d, km_k = KM_CELLS[0][:5]
    pw_shapes = sorted({(rd.survivors, rd.num_refs) for rd in
                        executed_rounds(km_n, KM_BUILD * km_n)}
                       | {(km_n, km_k), (1, km_n)})
    pw_plan = [("dot_pairwise_bf16", c, r, False) for c, r in pw_shapes]
    tot = ledger_add(pw_plan, km_ds, "l2")
    fp32_ms = sum(bf16_more[("pairwise", c, r, km_d, False)][0]
                  for c, r in pw_shapes)
    lib_ms = sum(bf16_more[("pairwise", c, r, km_d, False)][1]
                 for c, r in pw_shapes)
    print(f"phase2 dot_pairwise bf16 mode at the {len(pw_shapes)} pairwise "
          f"shapes of {km_name} (one launch each, both paths checked, "
          f"{time.perf_counter() - t0:.1f} s): {fmt_tot(tot)}; fp32 mode "
          f"{fp32_ms:.3f} ms, yardstick xr @ yr.T of pre-rounded rows "
          f"{lib_ms:.3f} ms; main-path launches 0 (no caller)", flush=True)

    for name, ds, n, d, metric, backend in CELLS:
        plan = medoid_plan(n, metric, backend)
        tot = ledger_add(plan, ds, metric)
        counts = path_counts(plan, d)
        paths.update(counts)
        print(f"phase2 {name}: {len(rounds_of(n))} round shapes: "
              f"{fmt_tot(tot)}" + (f"; pairwise paths {dict(counts)}"
                                   if counts else ""), flush=True)
        for cen in CENTRALITY:
            if cen in tot:
                print(f"phase2 {name} {cen} by shape: "
                      f"{centrality_classes(cen, plan, ds, d, metric)}",
                      flush=True)
        rank_cs.update(c for kern, c, _, _ in plan
                       if kern == "topk_smallest")

    # the widened round shapes of the phase-5 cells that run a kernel (the
    # band's buffer width by t_r): checked and timed here, entered in the
    # ledger by phase 5 for the launches its runs make
    for name, ds, n, d, metric, precision, backend in Q_CELLS:
        plan = widened_plan(n, metric, precision, backend)
        if not plan:
            continue
        kern = plan[0][0]
        # kernel, plain, bound, fp32 mode, yardstick, err, launches; in all
        # and, for the bf16 mode, by path
        sums, shapes = {}, []
        for _, c, r, masked in plan:
            err, ms, pms, nbytes, ops_s, _ = shape_time(kern, ds, c, r,
                                                        metric, masked)
            more = bf16_more.get((metric, c, r, d, masked), (0.0, 0.0))
            path = pk.centrality_plan(
                c, r, d, sms, crossover=pk.dot_crossover("bfloat16"))[0]
            bound = max(_bound_s(nbytes, ops_s)) * 1e3
            shapes.append(f"({c}, {r}) {path} {1e3 * ms:.2f} us, fp32 mode "
                          f"{1e3 * more[0]:.2f} us, {bound / ms:.1%} of the "
                          f"bound")
            for key in ("all", path):
                v = sums.setdefault(key, [0.0] * 7)
                for i, add in enumerate((ms, pms, bound, more[0], more[1])):
                    v[i] += add
                v[5] = max(v[5], err)
                v[6] += 1
        tot = sums["all"]
        if kern == "dot_centrality_bf16":
            extra = (f", fp32 mode {tot[3]:.3f} ms, two calls (xr @ yr.T of "
                     f"pre-rounded rows, finish, row sum) {tot[4]:.3f} ms; by "
                     f"path: " + "; ".join(
                         f"{p} {v[6]:.0f} shapes: kernel {v[0]:.3f} ms, fp32 mode "
                         f"{v[3]:.3f} ms, two calls {v[4]:.3f} ms, bound "
                         f"{v[2]:.4f} ms ({v[2] / v[0]:.1%} of it)"
                         for p, v in sorted(sums.items()) if p != "all")
                     + "; by shape: " + "; ".join(shapes))
        else:
            extra = " (the fp32 kernel on bf16-rounded rows)"
        print(f"phase2 {name}: {len(plan)} widened round shapes "
              f"{[(c, r) for _, c, r, _ in plan]}: {kern} kernel "
              f"{tot[0]:.3f} ms, plain {tot[1]:.3f} ms, bound "
              f"{tot[2]:.4f} ms ({tot[2] / tot[0]:.1%} of it), "
              f"max_abs_err {tot[5]:.3g}{extra}", flush=True)

    # ---------------------------------------------- phase 3: main path
    phase("3")
    for name, ds, n, d, metric, backend in CELLS:
        x = data[ds]
        key = rng.fold_in(rng.key(SEED, dev), 1)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        pk.reset_launches()
        t0 = time.perf_counter()
        res = find_medoid(x, key, metric=metric, backend=backend,
                          budget_per_arm=BUDGET_PER_ARM)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = Launches(pk.LAUNCHES, pk.PATH_LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        nrounds = len(res.rounds)
        check_launches(name, counts, medoid_plan(n, metric, backend), d)

        t0 = time.perf_counter()
        again = find_medoid(x, key, metric=metric, backend=backend,
                            budget_per_arm=BUDGET_PER_ARM)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        _require(again.medoid == res.medoid, f"{name}: rerun differs")
        draws_ms, busy = _breakdown(x, key, n, metric, backend)

        ref = correlated_sequential_halving(x, BUDGET_PER_ARM * n, key,
                                            metric=metric,
                                            backend="reference")
        theta = torch.sort(ref.theta_hat).values
        gap = float(theta[1] - theta[0]) if theta.numel() > 1 else float("inf")
        ref_winner = int(ref.medoid)
        if res.medoid != ref_winner:
            _require(backend != "pallas_pairwise",
                     f"{name}: winner {res.medoid} != reference "
                     f"{ref_winner}")
            _require(gap <= 2 * RTOL * float(theta[0].abs()),
                     f"{name}: winner {res.medoid} != reference "
                     f"{ref_winner} with output-round gap {gap}")
        if metric == "l1":
            small = data_from_numpy(DATASETS[ds][1](SEED, 4096, 512), dev)
            sres = find_medoid(small, key, metric=metric, backend=backend,
                               budget_per_arm=BUDGET_PER_ARM)
            exact = int(exact_medoid(small, metric))
            exact_note = (f"exact(n=4096,d=512)={exact} "
                          f"corr_sh={sres.medoid}")
        else:
            exact = int(exact_medoid(x, metric))
            exact_note = f"exact={exact} agree={exact == res.medoid}"
        if ds == "planted":
            _require(res.medoid == 0 and exact == 0,
                     f"{name}: planted medoid not found ({res.medoid})")
        _require(res.pulls == sum(s * t for s, t in res.rounds),
                 f"{name}: pull accounting")
        print(f"phase3 {name} n={n} d={d} {metric} {backend}: medoid "
              f"{res.medoid} (reference {ref_winner}, output-round gap "
              f"{gap:.6g}), {exact_note}, wall {wall * 1e3:.1f} ms first / "
              f"{steady * 1e3:.1f} ms again, pulls {res.pulls}, rounds "
              f"{nrounds}, launches {counts}, max_memory_allocated "
              f"{peak / 2 ** 20:.1f} MiB = {resident / 2 ** 20:.1f} MiB "
              f"resident before the call + {(peak - resident) / 2 ** 20:.1f} "
              f"MiB of its own", flush=True)
        print(f"phase3 {name} breakdown: random draws alone "
              f"{draws_ms:.1f} ms; {busy_note(busy, steady)}", flush=True)

    # the first cell again with telemetry=True
    from repro_torch.core.corr_sh import _medoid_impl
    from repro_torch.core.hardness import hardness_stats

    name, ds, n, d, metric, backend = CELLS[0]
    x = data[ds]
    key = rng.fold_in(rng.key(SEED, dev), 1)
    kw = dict(metric=metric, backend=backend, budget_per_arm=BUDGET_PER_ARM)
    plain_res = find_medoid(x, key, **kw)
    pk.reset_launches()
    t0 = time.perf_counter()
    tres = find_medoid(x, key, telemetry=True, **kw)
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    counts = dict(pk.LAUNCHES)
    want = dict(Counter(k for k, *_ in medoid_plan(n, metric, backend)))
    _require(counts == want, f"{name} telemetry: launches {counts}, "
                             f"expected {want}")
    tel = tres.telemetry
    _require((tres.medoid, tres.pulls, tres.rounds)
             == (plain_res.medoid, plain_res.pulls, plain_res.rounds),
             f"{name}: telemetry changed the answer")
    _require(int(tel["pulls"].sum()) == tres.pulls
             and len(tel["pulls"]) == len(tres.rounds),
             f"{name}: telemetry pulls {tel['pulls']} vs {tres.pulls}")
    _require(tres.hardness is not None and all(
        np.isfinite(v) for v in tres.hardness.values()),
        f"{name}: hardness {tres.hardness}")
    budget = BUDGET_PER_ARM * n
    b_off = profiled(lambda: _medoid_impl(x, key, budget=budget,
                                          metric=metric, backend=backend))
    b_on = profiled(lambda: _medoid_impl(x, key, budget=budget,
                                         metric=metric, backend=backend,
                                         telemetry=True))
    b_hard = profiled(lambda: hardness_stats(x, metric))
    print(f"phase3 {name} telemetry=True: medoid {tres.medoid} and pulls "
          f"{tres.pulls} as without, {len(tres.rounds)} rows whose pulls sum "
          f"to them, last gap {tel['gap'][-1]!r}, hardness {tres.hardness}; "
          f"wall {twall * 1e3:.1f} ms; launches {counts}; the program's "
          f"device busy {b_on[1]:.2f} ms over {b_on[0]} activities with the "
          f"rows, {b_off[1]:.2f} ms over {b_off[0]} without (+"
          f"{b_on[1] - b_off[1]:.2f} ms, one sort and a few reductions a "
          f"round); hardness_stats (the O(n^2) block) {b_hard[1]:.2f} ms "
          f"over {b_hard[0]} activities", flush=True)

    # ------------------------------------------- phase 4: k-medoids
    phase("4")
    for name, ds, n, d, k, metric, backend in KM_CELLS:
        x = data[ds]
        key = rng.fold_in(rng.key(SEED, dev), 1)
        direct = make_direct_refiner(metric=metric, backend=backend,
                                     budget_per_arm=KM_REFINE,
                                     min_bucket=KM_MIN_BUCKET)
        sizes = []

        def refiner(arrays, rkey):
            sizes.append([a.shape[0] for a in arrays])
            return direct(arrays, rkey)

        def call(backend=backend, refiner=refiner):
            return kmedoids(x, k, key, metric=metric, backend=backend,
                            refiner=refiner)

        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        pk.reset_launches()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = Launches(pk.LAUNCHES, pk.PATH_LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)

        # the counts the schedules and the bucket plan give
        _require(len(sizes) == 1, f"{name}: {len(sizes)} refinement sweeps")
        buckets = [(nb, next_pow2(len(idxs))) for nb, idxs in
                   plan_buckets(sizes[0], KM_MIN_BUCKET).items()]
        per_swap = schedule_pulls(n, KM_SWAP * n) + n
        _require(res.swap_pulls % per_swap == 0,
                 f"{name}: swap pulls {res.swap_pulls}")
        executed = res.swap_pulls // per_swap
        n_assign = 1 + (res.refine_updates > 0)
        plan = kmedoids_plan(n, k, metric, backend, buckets, executed,
                             n_assign)
        check_launches(name, counts, plan, d)

        t0 = time.perf_counter()
        again = call()
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        _require(again.medoids == res.medoids, f"{name}: rerun differs")
        t0 = time.perf_counter()
        busy = profiled(call)
        prof_s = time.perf_counter() - t0

        _require(res.pulls < n * n / 10, f"{name}: pulls {res.pulls}")
        ari = adjusted_rand_index(res.labels, km_labels[ds])
        _require(ari >= 0.95, f"{name}: ARI {ari} against the planted labels")
        t0 = time.perf_counter()
        ref = call(backend="reference", refiner=None)
        ref_s = time.perf_counter() - t0
        same = (ref.medoids == res.medoids
                and np.array_equal(ref.labels, res.labels))
        if not same:
            print(f"phase4 {name}: medoids {res.medoids} cost {res.cost!r} "
                  f"vs reference {ref.medoids} cost {ref.cost!r}", flush=True)
            _require(abs(ref.cost - res.cost) <= RTOL * abs(ref.cost),
                     f"{name}: cost differs from the reference backend's")
        print(f"phase4 {name} n={n} d={d} k={k} {metric} {backend}: "
              f"medoids {res.medoids} (reference backend equal: {same}), "
              f"cost {res.cost:.6g}, ARI {ari:.4f}, swaps {res.swaps} in "
              f"{executed} rounds, refine_updates {res.refine_updates}, "
              f"pulls {res.pulls} (build {res.build_pulls}, assign "
              f"{res.assign_pulls}, refine {res.refine_pulls}, swap "
              f"{res.swap_pulls}; n^2/10 = {n * n // 10}), buckets "
              f"(n_bucket, slots) {buckets}, wall {wall:.3f} s first / "
              f"{steady:.3f} s again, launches {counts}, "
              f"max_memory_allocated {peak / 2 ** 20:.1f} MiB = "
              f"{resident / 2 ** 20:.1f} MiB resident before the call + "
              f"{(peak - resident) / 2 ** 20:.1f} MiB of its own", flush=True)
        print(f"phase4 {name} breakdown: {busy_note(busy, steady)}; "
              f"the profiled call took {prof_s:.1f} s, the reference "
              f"backend's {ref_s:.1f} s", flush=True)
        t0 = time.perf_counter()
        tot = ledger_add(plan, ds, metric)
        print(f"phase4 {name} kernels over the run's {len(plan)} launches "
              f"({time.perf_counter() - t0:.1f} s to check and time them): "
              f"{fmt_tot(tot)}", flush=True)
        # the pairwise kernel's launches by shape class (times from above)
        pair = "l1_pairwise" if metric == "l1" else "dot_pairwise"
        by_class = {}
        for kern, c, r, masked in plan:
            if kern != pair:
                continue
            cls = ("(1, n) rows" if (c, r) == (1, n) else
                   "(n, k) caches" if (c, r) == (n, k) else "halving rounds")
            _, ms, pms, nbytes, ops_s, lib = shape_time(kern, ds, c, r,
                                                        metric, masked)
            b, o = _bound_s(nbytes, ops_s)
            v = by_class.setdefault(cls, [0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
            for i, add in enumerate((1, ms, b * 1e3, o * 1e3, pms, lib)):
                v[i] += add
            v[6] += max(b, o) * 1e3
        print(f"phase4 {name} {pair} by shape: " + "; ".join(
            f"{cls}: {v[0]} launches, kernel {v[1]:.3f} ms, bound {v[6]:.4f} "
            f"ms ({'bytes' if v[2] >= v[3] else 'operations'}, "
            f"{v[6] / v[1]:.1%} of it), plain {v[4]:.3f} ms, library "
            f"{v[5]:.3f} ms, kernel / library {v[1] / v[5]:.2f}"
            for cls, v in by_class.items()), flush=True)
        counts = path_counts(plan, d)
        paths.update(counts)
        print(f"phase4 {name} {pair} by path: {dict(counts)}", flush=True)
        cen = "l1_centrality" if metric == "l1" else "dot_centrality"
        print(f"phase4 {name} {cen} by shape: "
              f"{centrality_classes(cen, plan, ds, d, metric)}", flush=True)
        rank_cs.update(c for kern, c, _, _ in plan
                       if kern == "topk_smallest")

    taken = {p for _, p in paths}
    _require(taken == {pk.STREAM, pk.TILE},
             f"the main path took the pairwise paths {sorted(taken)} only")
    print(f"phase4 pairwise launches by path over the main path: "
          f"{ {f'{k} {p}': v for (k, p), v in sorted(paths.items())} }",
          flush=True)
    for cen, taken in cen_paths.items():
        _require(set(taken) == {f"{pk.STREAM} R-short",
                                f"{pk.STREAM} C-short", pk.TILE},
                 f"{cen} took the paths {dict(taken)} only")
        print(f"phase4 {cen} launches by path over the main path: "
              f"{dict(taken)}", flush=True)
    # topk_smallest at each C of the main path (times from shape_time),
    # beside its rank-only mode and the launch floor: a one-element zero_()
    # under the same graph replay
    slower = []
    one_elem = torch.empty(1, device=dev)
    sums = [0.0, 0.0]   # the main path's launches: fused, rank-only mode
    for c, launches in sorted(rank_cs.items(), reverse=True):
        entry = cache[("topk", c)]
        tk = entry["topk_smallest"]
        sums[0] += launches * tk[1]
        sums[1] += launches * entry["rank_only_ms"]
        us, arg_us = 1e3 * tk[1], 1e3 * tk[5]
        if us > arg_us:
            slower.append(c)
        print(f"phase4 topk_smallest C={c}: {launches} launches, kernel "
              f"{us:.2f} us (rank-only mode {1e3 * entry['rank_only_ms']:.2f} "
              f"us), argsort(stable=True) {arg_us:.2f} us, kernel / argsort "
              f"{us / arg_us:.2f}, bound "
              f"{1e6 * 12 * c / HBM_BYTES_PER_S:.4f} us (bytes), launch floor "
              f"(zero_ of one element) {1e3 * entry['floor_ms']:.2f} us, plan "
              f"{pk.topk_plan(c, c, sms)}", flush=True)
    print(f"phase4 topk_smallest: {len(rank_cs)} distinct C over "
          f"{sum(rank_cs.values())} launches, {sums[0]:.3f} ms (rank-only "
          f"mode {sums[1]:.3f} ms); slower than argsort at C = {slower}",
          flush=True)
    # Med-dit's selections (keep 64 of C = n, the select path) against the
    # sort path, a stable argsort and torch.topk (not tie-stable: it may
    # order equal keys otherwise), then both paths over TOPK_CROSS_C x
    # TOPK_CROSS_KEEP: the crossover topk_plan's SELECT_MIN_C and
    # SELECT_KEEP_SQ_PER_C stand on
    t0 = time.perf_counter()
    floor_us = 1e3 * timed(lambda: one_elem.zero_(), 10)
    for c in sorted({n for _, n, _, _ in P7_CELLS}):
        e = select_time(c, MEDDIT_BATCH)
        theta = torch.rand(c, device=dev, generator=gen)
        keys = ops.totalorder_keys(theta)
        srt = (pk.SORT,) + pk.topk_rank_plan(c, sms)
        sel = pk.topk_plan(c, MEDDIT_BATCH, sms)
        us = {
            "select (fp32 mode)": 1e3 * e[1],
            "select (int32 keys)": 1e3 * timed(
                lambda: pk.launch_topk(keys, MEDDIT_BATCH, sel), 10),
            "sort (fp32 mode)": 1e3 * timed(
                lambda: pk.launch_topk(theta, MEDDIT_BATCH, srt), 10),
            "totalorder_keys (the 4 launches the fp32 mode saves)": 1e3 * timed(
                lambda: ops.totalorder_keys(theta), 10),
            "argsort(stable=True)": 1e3 * e[5],
            "torch.topk(largest=False), not tie-stable": 1e3 * timed(
                lambda: torch.topk(keys, MEDDIT_BATCH, largest=False), 10)}
        _require(us["select (fp32 mode)"] < us["sort (fp32 mode)"],
                 f"topk_smallest at C={c} keep={MEDDIT_BATCH}: the select "
                 f"path is not faster than the sort")
        print(f"phase4 topk_smallest C={c} keep={MEDDIT_BATCH} (Med-dit), plan "
              f"{sel}: " + ", ".join(f"{k} {v:.2f} us" for k, v in us.items())
              + f"; bound {1e6 * e[3] / HBM_BYTES_PER_S:.4f} us (bytes), "
              f"launch floor (zero_ of one element) {floor_us:.2f} us, plain "
              f"{1e3 * e[2]:.1f} us", flush=True)
    cross, right = [], 0
    for c in TOPK_CROSS_C:
        theta = torch.rand(c, device=dev, generator=gen)
        srt = (pk.SORT,) + pk.topk_rank_plan(c, sms)
        reps = 10 if c <= 65536 else 3
        want = torch.argsort(ops.totalorder_keys(theta), stable=True)
        for keep in TOPK_CROSS_KEEP:
            if keep > c:
                continue
            sel_us = sort_us = 0.0
            for plan in (pk.select_plan(c), srt):
                _require(torch.equal(pk.launch_topk(theta, keep, plan)[0],
                                     want[:keep]),
                         f"topk_smallest {plan} at C={c} keep={keep}")
                t = 1e3 * timed(lambda p=plan: pk.launch_topk(theta, keep, p),
                                reps)
                if plan[0] == pk.SELECT:
                    sel_us = t
                else:
                    sort_us = t
            picked = pk.topk_plan(c, keep, sms)[0]
            right += (picked == pk.SELECT) == (sel_us < sort_us)
            one = ""
            if keep == MEDDIT_BATCH and pk.select_plan(c)[2] > 1:
                plan = pk.select_plan(c, cluster=1)
                t1 = 1e3 * timed(lambda: pk.launch_topk(theta, keep, plan),
                                 reps)
                one = f" (one block {plan[1:]} {t1:.2f})"
            cross.append(f"({c}, {keep}) select {pk.select_plan(c)[1:]} "
                         f"{sel_us:.2f}{one} / sort {sort_us:.2f} us, plan "
                         f"{picked}")
    print(f"phase4 topk_smallest select vs sort (fp32 mode; SELECT_MIN_C = "
          f"{pk.SELECT_MIN_C}, keep^2 <= {pk.SELECT_KEEP_SQ_PER_C} C; "
          f"{time.perf_counter() - t0:.1f} s): " + "; ".join(cross)
          + f"; the plan picks the faster path at {right} of {len(cross)}",
          flush=True)

    t0 = time.perf_counter()
    arr, labels = CLUSTER_DATASETS["mnist_like"][1](SEED, 2048, 784, 10)
    small = data_from_numpy(arr, dev)
    res = kmedoids(small, 10, rng.fold_in(rng.key(SEED, dev), 1),
                   metric="l2", backend="pallas_fused")
    pam = pam_exact(small, 10, "l2")
    print(f"phase4 pam_exact mnist_like n=2048 d=784 k=10 l2: bandit "
          f"(pallas_fused) cost {res.cost:.6g} pulls {res.pulls}, PAM cost "
          f"{pam.cost:.6g} pulls {pam.pulls} swaps {pam.swaps}, cost_vs_pam "
          f"{res.cost / pam.cost:.6f}, ARI vs PAM "
          f"{adjusted_rand_index(res.labels, pam.labels):.4f}, ARI vs "
          f"planted: bandit {adjusted_rand_index(res.labels, labels):.4f} / "
          f"PAM {adjusted_rand_index(pam.labels, labels):.4f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # ------------------------------------- phase 5: the quantized path
    phase("5")
    from repro_torch.core.distances import centrality_sums
    from repro_torch.quant import backend_for, verify_pulls

    t5 = time.perf_counter()
    for name, ds, n, d, metric, precision, backend in Q_CELLS:
        x = data[ds]
        key = rng.fold_in(rng.key(SEED, dev), 1)
        kw = dict(metric=metric, budget_per_arm=BUDGET_PER_ARM)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        pk.reset_launches()
        t0 = time.perf_counter()
        res = find_medoid(x, key, backend=backend, precision=precision, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = Launches(pk.LAUNCHES, pk.PATH_LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        fallback = not res.verified
        # one centrality launch per executed round of the widened loop, and
        # the fp32 run's launches again after a fallback
        plan = widened_plan(n, metric, precision, backend)
        if fallback:
            plan += medoid_plan(n, metric, backend)
        check_launches(name, counts, plan, x.shape[1])
        rounds = executed_rounds(n, BUDGET_PER_ARM * n)
        scheduled = sum(rd.pulls for rd in rounds)
        want_pulls = scheduled + verify_pulls(n, rounds) + (
            scheduled if fallback else 0)
        _require(res.pulls == want_pulls,
                 f"{name}: pulls {res.pulls}, expected {want_pulls}")

        t0 = time.perf_counter()
        again = find_medoid(x, key, backend=backend, precision=precision,
                            **kw)
        torch.cuda.synchronize()
        steady = time.perf_counter() - t0
        _require((again.medoid, again.verified) == (res.medoid, res.verified),
                 f"{name}: rerun differs")
        draws_ms, busy = _breakdown(x, key, n, metric, backend, precision)

        # the answer against fp32 corr_sh under the same key: no worse in
        # exact fp32 centrality (two n-vectors)
        f32 = find_medoid(x, key, backend=backend, **kw)
        cen = centrality_sums(x[[res.medoid, f32.medoid]], x, metric)
        _require(float(cen[0]) <= float(cen[1]) * (1 + RTOL),
                 f"{name}: medoid {res.medoid} centrality {float(cen[0])!r} "
                 f"> fp32 corr_sh's {f32.medoid} {float(cen[1])!r}")
        if ds == "planted":
            _require(res.medoid == 0, f"{name}: planted medoid not found "
                                      f"({res.medoid})")
        note = ""
        if backend_for(precision, backend) == "quant_bf16_fused":
            unfused = find_medoid(x, key, backend="reference",
                                  precision=precision, **kw)
            if unfused.medoid == res.medoid:
                note = f"; unfused quant_bf16 answers {unfused.medoid} too"
            else:
                ucen = centrality_sums(x[[unfused.medoid]], x, metric)
                _require(res.verified and unfused.verified
                         and abs(float(ucen[0]) - float(cen[0]))
                         <= RTOL * abs(float(cen[0])),
                         f"{name}: medoid {res.medoid} != unfused quant_bf16's "
                         f"{unfused.medoid}")
                note = (f"; unfused quant_bf16 answers {unfused.medoid}, both "
                        f"verified, exact centralities {float(cen[0])!r} and "
                        f"{float(ucen[0])!r} equal within rtol {RTOL}")
        tot = ledger_add(plan, ds, metric)
        print(f"phase5 {name} n={n} d={d} {metric} {precision} on {backend} "
              f"({backend_for(precision, backend)}): medoid {res.medoid}, "
              f"verified {res.verified}, fp32 fallback ran {fallback}; fp32 "
              f"corr_sh answers {f32.medoid}, exact centralities "
              f"{float(cen[0])!r} vs {float(cen[1])!r}{note}; pulls "
              f"{res.pulls} = {scheduled} scheduled + {verify_pulls(n, rounds)} "
              f"check" + (f" + {scheduled} fp32 re-run" if fallback else "")
              + f"; rounds {len(rounds)}, launches {counts}; wall "
              f"{wall * 1e3:.1f} ms first / {steady * 1e3:.1f} ms again, "
              f"max_memory_allocated {peak / 2 ** 20:.1f} MiB = "
              f"{resident / 2 ** 20:.1f} MiB resident before the call + "
              f"{(peak - resident) / 2 ** 20:.1f} MiB of its own", flush=True)
        print(f"phase5 {name} breakdown: random draws alone {draws_ms:.1f} "
              f"ms; {busy_note(busy, steady)}; kernels: "
              f"{fmt_tot(tot) if tot else 'none (torch Gram)'}", flush=True)

    print(f"phase5: {time.perf_counter() - t5:.1f} s for the "
          f"{len(Q_CELLS)} cells", flush=True)

    # ------------------------------------ phase 6: serving at full width
    phase("6")
    from repro_torch.api import maintain_medoid
    from repro_torch.cluster import (ClusterService, ClusterStream,
                                     kmedoids_via_service)
    from repro_torch.core.bucketing import bucket_n
    from repro_torch.core.distances import pairwise
    from repro_torch.launch.serve_medoid import MedoidServer
    from repro_torch.obs import TraceSession
    from repro_torch.obs import validate as obs_validate
    from repro_torch.serve.stream import (StreamMetrics, check_answer,
                                          exact_budget_per_arm, exact_state)

    t6 = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    files = []        # (trace, exposition) of 6a-6c, validated at the end

    def slot_plan(dispatches, cen, topk):
        """The launches of server dispatches, ``(n_bucket, requests)``
        each: one masked halving per request (the padding slots run
        nothing)."""
        plan = []
        for nb, live_slots in dispatches:
            plan += halving_plan(executed_rounds(nb, SRV_BUDGET * nb), cen,
                                 topk, masked=True) * live_slots
        return plan

    def mem_note(resident, peak):
        return (f"max_memory_allocated {peak / 2 ** 20:.1f} MiB = "
                f"{resident / 2 ** 20:.1f} MiB resident + "
                f"{(peak - resident) / 2 ** 20:.1f} MiB of its own")

    # 6a/6b: the server, FIFO then EDF, on SRV_REQUESTS queries of n
    # log-uniform in SRV_N, seeded row subsets of planted_medoid and
    # mnist_zeros_like (both 20000 x 784); its kernel shapes are timed on
    # rows of a 32768-point planted set (the largest bucket)
    data["mnist20k"] = data_from_numpy(
        DATASETS["mnist_zeros_like"][1](SEED, 20000, 784), dev)
    data["serve32k"] = data_from_numpy(planted_medoid(SEED + 2, 32768, 784),
                                       dev)
    srng = np.random.default_rng(SEED)
    reqs = []
    for i in range(SRV_REQUESTS):
        n_i = int(round(np.exp(srng.uniform(np.log(SRV_N[0]),
                                            np.log(SRV_N[1])))))
        src = data["planted"] if i % 2 == 0 else data["mnist20k"]
        rows = np.sort(srng.choice(src.shape[0], n_i, replace=False))
        reqs.append(src[torch.from_numpy(rows).to(dev)])
    deadlined = set(range(0, SRV_REQUESTS, 3))

    def serve(policy, backend, trace=None, steps=None):
        """A server with every request submitted, drained (or stepped
        ``steps`` times); returns it and the wall of its steps."""
        srv = MedoidServer(metric="l2", backend=backend,
                           budget_per_arm=SRV_BUDGET, max_batch=SRV_BATCH,
                           seed=SEED, policy=policy, trace=trace, device=dev)
        for i, q in enumerate(reqs):
            late = policy == "edf" and i in deadlined
            srv.submit(q, deadline_s=srv.now() + SRV_DEADLINE_S
                       if late else None, priority=1 if late else 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if steps is None:
            srv.drain()
        else:
            for _ in range(steps):
                srv.step()
        torch.cuda.synchronize()
        return srv, time.perf_counter() - t0

    def one_dispatch(policy):
        """(wall s, profile) of a fresh server's first dispatch, unprofiled
        and then profiled on a second fresh server: a whole run under the
        profiler costs ~0.1 ms a device activity, ~700k of them."""
        out = []
        for profile_it in (False, True):
            fresh, _ = serve(policy, SRV_BACKEND, steps=0)
            t0 = time.perf_counter()
            if profile_it:
                out.append(profiled(fresh.step))
            else:
                fresh.step()
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
        return out

    def run_server(cell, policy):
        path = out_dir / cell
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        sess = TraceSession(f"{path}.jsonl", meta={"workload": "chip_smoke",
                                                   "cell": cell})
        pk.reset_launches()
        srv, wall = serve(policy, SRV_BACKEND, trace=sess)
        counts = Launches(pk.LAUNCHES, pk.PATH_LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        sess.close()
        path.with_suffix(".txt").write_text(srv.exposition())
        files.append((f"{path}.jsonl", str(path.with_suffix(".txt"))))
        spans = [e for e in sess.events
                 if e["event"] == "span" and e["name"] == "dispatch"]
        buckets = [int(e["bucket"].split("x")[0]) for e in spans]
        plan = slot_plan([(nb, e["batch"]) for nb, e in zip(buckets, spans)],
                         "dot_centrality", SRV_BACKEND == "pallas_fused_topk")
        check_launches(cell, counts, plan, reqs[0].shape[1])
        walls = [e["dur_s"] for e in spans]
        return (srv, wall, sess.events, buckets, plan, counts, walls,
                mem_note(resident, peak))

    srv, wall, events, buckets, plan, counts, walls, mem = run_server(
        "serve_fifo", "fifo")
    stats = srv.stats()
    _require(stats["answered"] == SRV_REQUESTS, f"serve_fifo: {stats}")
    ref, ref_wall = serve("fifo", "reference")
    last = {}
    for e in events:
        if e["event"] == "round":
            last[e["rid"]] = e
    near = []
    for rid, q in srv.done.items():
        r = ref.done[rid]
        _require(q.pulls == r.pulls, f"serve_fifo rid {rid}: pulls "
                                     f"{q.pulls} != {r.pulls}")
        if q.medoid != r.medoid:
            lr = last[rid]
            _require(lr["gap"] is not None and lr["gap"]
                     <= 2 * RTOL * abs(lr["theta_min"]),
                     f"serve_fifo rid {rid}: medoid {q.medoid} != reference "
                     f"{r.medoid}, last gap {lr['gap']}")
            near.append(rid)
    one_s, busy = one_dispatch("fifo")
    one_nb = bucket_n(reqs[0].shape[0], KM_MIN_BUCKET)
    tot = ledger_add(plan, "serve32k", "l2")
    print(f"phase6a serve_fifo l2 {SRV_BACKEND} d=784: {SRV_REQUESTS} "
          f"requests, n {min(q.shape[0] for q in reqs)}.."
          f"{max(q.shape[0] for q in reqs)}, budget {SRV_BUDGET}/arm, "
          f"max_batch {SRV_BATCH}, collect_gaps on, traced: "
          f"{stats['dispatches']} dispatches at n_bucket {buckets}, "
          f"recompiles {stats['recompiles']}, wall {wall:.3f} s (reference "
          f"backend {ref_wall:.3f} s), dispatch wall p50 "
          f"{np.percentile(walls, 50) * 1e3:.1f} ms / p99 "
          f"{np.percentile(walls, 99) * 1e3:.1f} ms, pulls "
          f"{stats['total_pulls']}; answers and pulls equal the reference "
          f"backend's (same seed) but rids {near} (last gap within 2 rtol "
          f"of theta_min); launches {counts}; one dispatch (n_bucket "
          f"{one_nb}, {SRV_BATCH} slots) {one_s * 1e3:.1f} ms, "
          f"{busy_note(busy, one_s)}; {mem}; "
          f"{time.perf_counter() - t6:.1f} s into phase 6", flush=True)
    print(f"phase6a serve_fifo kernels: {fmt_tot(tot)}",
          flush=True)

    srv, wall, events, buckets, plan, counts, walls, mem = run_server(
        "serve_edf", "edf")
    ledger_add(plan, "serve32k", "l2")
    edf_one_s, edf_busy = one_dispatch("edf")
    stats = srv.stats()
    snap = srv.metrics()

    def total(fam, **labels):
        return sum(s["value"] for s in snap.get(fam, {}).get("series", [])
                   if all(s["labels"].get(k) == v
                          for k, v in labels.items()))
    _require(stats["answered"] + stats["shed"] == SRV_REQUESTS,
             f"serve_edf: {stats}")
    _require(total("medoid_requests_total") == SRV_REQUESTS
             and total("medoid_answered_total") == stats["answered"]
             and total("medoid_shed_total") == stats["shed"]
             and total("medoid_dispatches_total") == stats["dispatches"]
             and total("medoid_deadline_total", outcome="met")
             == stats["deadlines_met"]
             and total("medoid_deadline_total", outcome="missed")
             == stats["deadlines_missed"] + stats["shed"]
             and stats["deadlines_met"] + stats["deadlines_missed"]
             + stats["shed"] == len(deadlined)
             and stats["total_pulls"] == total("medoid_pulls_total"),
             f"serve_edf: the metrics do not reconcile with {stats}")
    print(f"phase6b serve_edf: {len(deadlined)} of {SRV_REQUESTS} requests "
          f"with a {SRV_DEADLINE_S} s deadline (priority 1): answered "
          f"{stats['answered']}, shed {stats['shed']}, deadlines met "
          f"{stats['deadlines_met']} / missed {stats['deadlines_missed']}, "
          f"{stats['dispatches']} dispatches at n_bucket {buckets}, wall "
          f"{wall:.3f} s, dispatch wall p50 "
          f"{np.percentile(walls, 50) * 1e3:.1f} ms / p99 "
          f"{np.percentile(walls, 99) * 1e3:.1f} ms; launches {counts}; the "
          f"metrics reconcile; one dispatch {edf_one_s * 1e3:.1f} ms, "
          f"{busy_note(edf_busy, edf_one_s)}; {mem}; "
          f"{time.perf_counter() - t6:.1f} s into phase 6", flush=True)

    def reference_state(store):
        """The exact state of ``store``'s version by the reference backend's
        distances (``repro_torch.core.distances``, plain PyTorch, none of
        the kernels) over the live rows on the card, in row blocks (the l1
        one materialises its (rows, n, d) difference): (exact slot,
        centralities in live-slot order, summed in float64)."""
        slots = store.live_slots()
        xs = store.buf.index_select(0, torch.from_numpy(slots).to(dev))
        m, d = xs.shape
        pw = pairwise(store.metric)
        step = max(1, 2 ** 31 // (m * d) if store.metric == "l1"
                   else 2 ** 28 // m)
        cent = torch.cat([pw(xs[i:i + step], xs).double().sum(1)
                          for i in range(0, m, step)]).cpu().numpy()
        return int(slots[int(cent.argmin())]), cent

    def reference_check(store, slot, what):
        """``check_answer``'s rule against :func:`reference_state`; returns
        the state."""
        want, cent = reference_state(store)
        lo = float(cent.min())
        got = float(cent[int(np.searchsorted(store.live_slots(), slot))])
        _require(slot == want or got <= lo + 1e-3 * max(1.0, abs(lo)),
                 f"{what}: served slot {slot} (centrality {got}) against the "
                 f"reference's {want} ({lo})")
        return want, cent

    # 6c/6d: a live corpus; served answers checked with check_answer (a
    # from-scratch bootstrap on the card) at every check_every-th version
    # and the last, and against the reference backend's recompute at the
    # steps ``ref_steps``
    def live(cell, ds, n0, metric, backend, steps, check_every, ref_steps,
             pool):
        budget = exact_budget_per_arm(n0 + steps, KM_MIN_BUCKET)
        topk = backend == "pallas_fused_topk"
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        path = out_dir / cell
        sess = TraceSession(f"{path}.jsonl", meta={"workload": "chip_smoke",
                                                   "cell": cell})
        metrics = StreamMetrics()
        mrng = np.random.default_rng(SEED + 6)
        pk.reset_launches()
        t0 = time.perf_counter()
        mm = maintain_medoid(data[ds][:n0], metric=metric, backend=backend,
                             budget_per_arm=budget, seed=SEED, device=dev)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        store = mm.store
        cap = store.capacity
        checked, rerun_ns, nxt, mut_s = [], [n0], 0, 0.0
        ref_checked, ref_s, peak = [], 0.0, 0

        def path_peak():
            # the path's peak so far; the checks' own memory is not its
            nonlocal peak
            torch.cuda.synchronize()
            peak = max(peak, torch.cuda.max_memory_allocated(dev))

        for step in range(steps):
            t0 = time.perf_counter()
            if step == steps // 2:                  # the incumbent goes
                kind, upd = "delete", mm.delete(mm.query()[0])
            elif mrng.random() < 0.7:
                kind, upd = "insert", mm.insert(pool[nxt])
                nxt += 1
            else:
                kind, upd = "delete", mm.delete(
                    int(mrng.choice(store.live_slots())))
            slot, version = mm.query()
            torch.cuda.synchronize()
            mut_s += time.perf_counter() - t0
            if upd.reran:
                rerun_ns.append(store.n)
            metrics.record(kind, upd)
            sess.event("mutation", kind=kind, version=version,
                       reason=upd.reason, reran=upd.reran, n=store.n)
            sess.event("select", winner=slot, pulls=int(upd.pulls),
                       n=store.n, version=version)
            path_peak()
            if (step + 1) % check_every == 0 or step == steps - 1:
                saved = Launches(pk.LAUNCHES, pk.PATH_LAUNCHES)
                _require(check_answer(store, slot),      # not the path
                         f"{cell} version {version}: served slot {slot} "
                         f"fails check_answer")
                pk.reset_launches()
                pk.LAUNCHES.update(saved)
                pk.PATH_LAUNCHES.update(saved.paths)
                checked.append(version)
            if step in ref_steps:
                t0 = time.perf_counter()
                reference_check(store, slot, f"{cell} version {version}")
                ref_s += time.perf_counter() - t0
                ref_checked.append(version)
            torch.cuda.reset_peak_memory_stats(dev)
        path_peak()
        counts = Launches(pk.LAUNCHES, pk.PATH_LAUNCHES)
        inserts, deletes = store.inserts, store.deletes
        metrics.finalize(mm)
        sess.close()
        path.with_suffix(".txt").write_text(metrics.exposition())
        files.append((f"{path}.jsonl", str(path.with_suffix(".txt"))))
        st = mm.stats()
        _require(st["mutations"] == steps and store.capacity == cap,
                 f"{cell}: {st}")
        pair = "l1_pairwise" if metric == "l1" else "dot_pairwise"
        cen = "l1_centrality" if metric == "l1" else "dot_centrality"
        # one (cap, cap) bootstrap, one (1, cap) row per mutation, and each
        # re-run's rounds (the adoption's first) at its bucket
        plan = [(pair, cap, cap, False)] + [(pair, 1, cap, False)] * steps
        for n_run in rerun_ns:
            nb = bucket_n(n_run, KM_MIN_BUCKET)
            plan += halving_plan(executed_rounds(nb, budget * nb), cen, topk,
                                 masked=True)
        check_launches(cell, counts, plan, store.d)
        ex_slot, ex_cent = exact_state(store)
        live_idx = torch.from_numpy(store.live_slots()).to(dev)
        got = store.cent[live_idx].cpu().numpy().astype(np.float64)
        rel = float(np.max(np.abs(got - ex_cent) / np.abs(ex_cent)))
        t0 = time.perf_counter()
        final_slot = mm.query()[0]
        ref_slot, ref_cent = reference_check(store, final_slot,
                                             f"{cell} at the end")
        ref_s += time.perf_counter() - t0
        ref_rel = float(np.max(np.abs(got - ref_cent) / np.abs(ref_cent)))
        _require(ref_rel <= 1e-4, f"{cell}: maintained cent off the "
                                  f"reference's by {ref_rel:.3g} (relative)")
        # the device-busy share of PROFILE_MUTATIONS more inserts (kept
        # ones: one (1, cap) row each), unprofiled and then profiled
        extra = pool[nxt:nxt + 2 * PROFILE_MUTATIONS]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p_row in extra[:PROFILE_MUTATIONS]:
            mm.insert(p_row)
        torch.cuda.synchronize()
        ins_s = time.perf_counter() - t0
        ins_busy = profiled(lambda: [mm.insert(p_row) for p_row
                                     in extra[PROFILE_MUTATIONS:]])
        data[f"{cell}_buf"] = store.buf
        print(f"phase6 {cell} n0={n0} d={store.d} {metric} {backend}, cap "
              f"{cap}, exact-regime budget {budget}/arm: {steps} mutations "
              f"({inserts} inserts, {deletes} deletes, the "
              f"incumbent deleted at step {steps // 2}), kept {st['kept']} "
              f"({st['kept_frac']:.1%}), reruns {st['reruns']} (the "
              f"adoption's included) at n {rerun_ns}, pulls "
              f"{st['total_pulls']} (init {st['init_pulls']}, incremental "
              f"{st['incremental_pulls']}, rerun {st['rerun_pulls']}); "
              f"bootstrap and adoption re-run {boot_s * 1e3:.1f} ms, "
              f"{mut_s / steps * 1e3:.2f} ms per mutation (query and "
              f"re-runs included); versions checked with check_answer: "
              + (f"all {len(checked)}" if check_every == 1 else f"{checked}")
              + "; versions held against the reference backend's recompute "
              f"(plain PyTorch distances, float64 sums) at the end and at "
              + (f"all {len(ref_checked)}" if len(ref_checked) == steps
                 else f"{ref_checked}") + f" ({ref_s:.1f} s)"
              + f"; final served slot {final_slot} (recompute {ex_slot}, "
              f"reference {ref_slot}), maintained cent max rel err against "
              f"the recompute {rel:.3g}, against the reference {ref_rel:.3g}"
              f"; launches {counts}; {mem_note(resident, peak)}; "
              f"{PROFILE_MUTATIONS} more inserts {ins_s * 1e3:.1f} ms, "
              f"{busy_note(ins_busy, ins_s)}; "
              f"{time.perf_counter() - t6:.1f} s into phase 6", flush=True)

        def shapes():
            ledger_add(plan, f"{cell}_buf", metric)
            print(f"phase6 {cell} kernels: "
                  f"{fmt_shapes(plan, f'{cell}_buf', metric, (pair, cen))}",
                  flush=True)
        corpus_shapes.append(shapes)
        return st

    pool = data_from_numpy(planted_medoid(
        SEED + 1, LIVE_L2_STEPS + 2 * PROFILE_MUTATIONS + 1, 784)[1:], dev)
    corpus_shapes = []     # the live cells' launches, checked and timed last
    live("live_l2", "planted", 20000, "l2", "pallas_fused", LIVE_L2_STEPS,
         1, range(LIVE_L2_STEPS), pool)
    pool = data_from_numpy(DATASETS["rnaseq20k_like"][1](
        SEED + 1, LIVE_L1_STEPS + 2 * PROFILE_MUTATIONS, 4096), dev)
    live("live_l1", "rnaseq20k_like", 20000, "l1", "pallas_fused_topk",
         LIVE_L1_STEPS, 10, (LIVE_L1_STEPS // 2,), pool)

    # 6e: k-medoids with the refinement served by a MedoidServer, then a
    # ClusterStream of arrivals and each ClusterService route
    ds, n, d, k = "mnist_like", 20000, 784, 10
    x = data[ds]
    key = rng.fold_in(rng.key(SEED, dev), 1)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    pk.reset_launches()
    t0 = time.perf_counter()
    res, ksrv = kmedoids_via_service(x, k, key, backend="pallas_fused",
                                     device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = Launches(pk.LAUNCHES, pk.PATH_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    ari = adjusted_rand_index(res.labels, km_labels[ds])
    _require(ari >= 0.95, f"kmedoids_via_service: ARI {ari}")
    served = sum(q.pulls for q in ksrv.done.values())
    _require(res.refine_pulls == served, f"kmedoids_via_service: refine "
             f"pulls {res.refine_pulls} != the server's {served}")
    per_swap = schedule_pulls(n, KM_SWAP * n) + n
    executed = res.swap_pulls // per_swap
    kb = [int(s["labels"]["bucket"].split("x")[0])
          for s in ksrv.metrics()["medoid_dispatches_total"]["series"]
          for _ in range(int(s["value"]))]
    # one masked halving per refinement request, at its bucket
    plan = kmedoids_plan(n, k, "l2", "pallas_fused", sorted(Counter(
        bucket_n(q.n, ksrv.min_bucket) for q in ksrv.done.values()).items()),
        executed, 1 + (res.refine_updates > 0))
    check_launches("kmedoids_via_service", counts, plan, d)
    ledger_add(plan, ds, "l2")
    stream_rng = np.random.default_rng(SEED + 7)
    arrivals = x[torch.from_numpy(stream_rng.choice(
        n, SERVICE_ARRIVALS, replace=False)).to(dev)] \
        + 0.01 * torch.randn(SERVICE_ARRIVALS, d, device=dev, generator=gen)
    t0 = time.perf_counter()
    cs = ClusterStream(x, k, key, backend="pallas_fused", device=dev)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    added = cs.add(arrivals)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    more = x[torch.from_numpy(stream_rng.choice(
        n, SERVICE_ARRIVALS, replace=False)).to(dev)] \
        + 0.01 * torch.randn(SERVICE_ARRIVALS, d, device=dev, generator=gen)
    add_busy = profiled(lambda: cs.add(more))
    svc = ClusterService(ksrv, stream=cs)
    routes = {r: svc.handle(r) for r in svc.routes()}
    _require(set(routes) == {"/buckets", "/metrics", "/stats", "/stream"}
             and routes["/stats"]["answered"] == len(ksrv.done)
             and "# TYPE medoid_requests_total counter" in routes["/metrics"]
             and routes["/stream"]["arrivals"] == 2 * SERVICE_ARRIVALS,
             "ClusterService routes")
    print(f"phase6 kmedoids_via_service mnist_like n={n} d={d} k={k} l2 "
          f"pallas_fused: medoids {res.medoids}, ARI {ari:.4f}, pulls "
          f"{res.pulls} (refine {res.refine_pulls} = the server's scheduled "
          f"pulls), server {ksrv.stats()['dispatches']} dispatches at "
          f"n_bucket {kb}, wall {wall:.3f} s, launches {counts}, "
          f"{mem_note(resident, peak)}; ClusterStream fit {fit_s:.3f} s, "
          f"add({SERVICE_ARRIVALS}) {add_s:.3f} s: affected "
          f"{added['affected']}, medoid updates {added['medoid_updates']}, "
          f"pulls {added['pulls']}; a second add profiled: "
          f"{busy_note(add_busy, add_s)}; routes {sorted(routes)}: /buckets "
          f"{routes['/buckets']}; {time.perf_counter() - t6:.1f} s into "
          f"phase 6", flush=True)

    for trace, expo in files:
        tv = obs_validate.validate_trace(trace)
        ev = obs_validate.validate_exposition(expo)
        print(f"phase6 validate {Path(trace).name}: {tv}; "
              f"{Path(expo).name}: {ev}", flush=True)
    print(f"phase6: {time.perf_counter() - t6:.1f} s (serving)", flush=True)
    t0 = time.perf_counter()
    for shapes in corpus_shapes:
        shapes()
    print(f"phase6 corpus shapes (the live cells' launches checked, and "
          f"timed with the plain versions over their full shapes): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # ------------------- phase 7: the paper's baselines and distributed
    phase("7")
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.meddit import CHUNK, clear_graphs, meddit_medoid
    from repro_torch.kernels.threefry import (threefry_draws,
                                              threefry_draws_plain)

    t7 = time.perf_counter()

    def threefry_time(n):
        """One main-path threefry launch (CHUNK steps of MEDDIT_BATCH draws
        over [0, n)) bit-equal to its plain loop on the card, both timed:
        (err, ms, plain_ms, bytes, ops_s, library_ms). The bound: its
        writes, or the chain's CHUNK hashes and the last step's randint
        (two more) on one thread."""
        ck = ("threefry", n)
        if ck not in cache:
            key = rng.fold_in(rng.key(SEED + 9, dev), n)
            subs, nxt, refs = threefry_draws(key, CHUNK, MEDDIT_BATCH, n)
            psubs, pnxt, prefs = threefry_draws_plain(key, CHUNK,
                                                      MEDDIT_BATCH, n)
            _require(torch.equal(refs, prefs) and torch.equal(subs, psubs)
                     and torch.equal(nxt.data, pnxt.data),
                     f"threefry at K={CHUNK} n={n} differs from its plain "
                     f"version")
            cache[ck] = (
                0.0, timed(lambda: threefry_draws(key, CHUNK, MEDDIT_BATCH,
                                                  n), 20),
                event_ms(lambda: threefry_draws_plain(key, CHUNK,
                                                      MEDDIT_BATCH, n)),
                4 * CHUNK * MEDDIT_BATCH + 16 * CHUNK + 32,
                (CHUNK + 2) * HASH_S, None)
        return cache[ck]

    def ledger_many(kern, entry, launches):
        err, ms, pms, nbytes, ops_s, lib = entry
        for _ in range(launches):
            led.add(kern, ms, pms, nbytes, ops_s, err, library_ms=lib)

    def main_path(fn):
        """One run with the counters zeroed just before and read just
        after: (result, wall s, launches, memory note)."""
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        pk.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (res, wall, Launches(pk.LAUNCHES, pk.PATH_LAUNCHES),
                mem_note(resident, torch.cuda.max_memory_allocated(dev)))

    # 7a: the paper's comparison on two of its datasets' lookalikes
    exact7 = {}
    for ds, n, d, metric in P7_CELLS:
        x = data[ds]
        key = rng.fold_in(rng.key(SEED, dev), 1)
        cap = 1000 * n
        # a capped Med-dit run on the graph and kernel path, then the same
        # run eagerly on the plain draws: bit-equal (the first call also
        # captures the chunk graph)
        kw = dict(metric=metric, max_pulls=n + MEDDIT_BATCH * CHUNK
                  * MEDDIT_CAPPED_CHUNKS)
        t0 = time.perf_counter()
        g = meddit_medoid(x, key, graph=True, **kw)
        torch.cuda.synchronize()
        g_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        e = meddit_medoid(x, key, graph=False, **kw)
        torch.cuda.synchronize()
        e_s = time.perf_counter() - t0
        _require(int(g.medoid) == int(e.medoid) and int(g.pulls)
                 == int(e.pulls) and torch.equal(g.means, e.means),
                 f"phase7 {ds}: the capped Med-dit run on the graph differs "
                 f"from the eager run on the plain draws")
        print(f"phase7 {ds} meddit capped at {kw['max_pulls']} pulls: graph "
              f"and kernel draws {g_s:.3f} s (with the capture), eager on "
              f"the plain draws {e_s:.3f} s: medoid {int(g.medoid)}, pulls "
              f"{int(g.pulls)} and all {n} means bit-equal", flush=True)

        lines = {}
        res, wall, counts, mem = main_path(lambda: find_medoid(
            x, key, metric=metric, algo="exact"))
        _require(counts == {} and res.pulls == n * n,
                 f"phase7 {ds} exact: launches {counts}, pulls {res.pulls}")
        exact7[ds] = truth = res.medoid
        lines["exact"] = (res, wall, counts, mem, "")

        plan = medoid_plan(n, metric, "pallas_fused")
        res, wall, counts, mem = main_path(lambda: find_medoid(
            x, key, metric=metric, backend="pallas_fused",
            budget_per_arm=BUDGET_PER_ARM))
        check_launches(f"phase7 {ds} corr_sh", counts, plan, d)
        ledger_add(plan, ds, metric)
        _require(res.pulls == sum(s * t for s, t in res.rounds),
                 f"phase7 {ds} corr_sh: pull accounting")
        lines["corr_sh"] = (res, wall, counts, mem, "")

        for refs in RAND_REFS:
            res, wall, counts, mem = main_path(lambda: find_medoid(
                x, key, metric=metric, algo="rand", budget_per_arm=refs))
            _require(counts == {} and res.pulls == n * refs,
                     f"phase7 {ds} rand {refs}: launches {counts}, pulls "
                     f"{res.pulls} != n * refs")
            lines[f"rand {refs} refs"] = (res, wall, counts, mem, "")

        res, wall, counts, mem = main_path(lambda: find_medoid(
            x, key, metric=metric, algo="meddit"))
        steps, rem = divmod(res.pulls - n, MEDDIT_BATCH)
        chunks = -(-steps // CHUNK)
        _require(rem == 0 and res.pulls < cap + MEDDIT_BATCH,
                 f"phase7 {ds} meddit: pulls {res.pulls} are not n + "
                 f"{MEDDIT_BATCH} a step within the cap {cap}")
        check_launches(f"phase7 {ds} meddit", counts,
                       [("threefry",)] * chunks
                       + [("topk_smallest", n, MEDDIT_BATCH, False)]
                       * (chunks * CHUNK), d)
        ledger_many("threefry", threefry_time(n), chunks)
        ledger_many("topk_smallest", select_time(n, MEDDIT_BATCH),
                    chunks * CHUNK)
        prof_kw = dict(metric=metric, max_pulls=n + MEDDIT_BATCH * CHUNK
                       * MEDDIT_PROFILED_CHUNKS)
        t0 = time.perf_counter()
        meddit_medoid(x, key, **prof_kw)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
        busy = profiled(lambda: meddit_medoid(x, key, **prof_kw))
        per_step = ("not measured" if busy is None else
                    f"{busy[0] / (MEDDIT_PROFILED_CHUNKS * CHUNK):.2f}")
        lines["meddit"] = (res, wall, counts, mem, (
            f", {steps} steps ({'at the cap' if res.pulls >= cap else 'stopped'}"
            f" of {cap} pulls), {chunks} chunks of {CHUNK}, "
            f"{wall / max(steps, 1) * 1e6:.1f} us a step, selections by path "
            f"{dict(counts.paths)}; a run of {MEDDIT_PROFILED_CHUNKS} chunks "
            f"{prof_s * 1e3:.1f} ms, {per_step} device activities a step, "
            f"{busy_note(busy, prof_s)}"))
        for algo, (res, wall, counts, mem, extra) in lines.items():
            print(f"phase7 {ds} n={n} d={d} {metric} {algo}: medoid "
                  f"{res.medoid} (exact {truth}: "
                  f"{'equal' if res.medoid == truth else 'differs'}), pulls "
                  f"{res.pulls} ({res.pulls / n:.1f} per arm), wall "
                  f"{wall:.3f} s, launches {counts}, {mem}{extra}",
                  flush=True)
        e1 = threefry_time(n)
        e2 = select_time(n, MEDDIT_BATCH)
        print(f"phase7 {ds} kernels of Med-dit: threefry (K={CHUNK}, "
              f"B={MEDDIT_BATCH}) {e1[1] * 1e3:.2f} us a launch, bound "
              f"{max(_bound_s(e1[3], e1[4])) * 1e6:.2f} us (the chain), plain "
              f"{e1[2]:.1f} ms; topk_smallest (C={n}, keep={MEDDIT_BATCH}) "
              f"{e2[1] * 1e3:.2f} us, plain {e2[2] * 1e3:.1f} us, "
              f"argsort(stable=True) {e2[5] * 1e3:.2f} us; "
              f"{time.perf_counter() - t7:.1f} s into phase 7", flush=True)
    clear_graphs()

    # 7b: v1 and v2 at world size 1 on NCCL (an in-process group with a
    # file store); the multi-rank behaviour is held on the CPU (gloo tests)
    store = Path(tempfile.mkdtemp(dir=out_dir)) / "store"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,))
        for ds, metric in P7_DIST:
            x = data[ds]
            n = x.shape[0]
            key = rng.fold_in(rng.key(SEED, dev), 1)
            truth = 0 if ds == "planted" else exact7[ds]
            cen = "l1_centrality" if metric == "l1" else "dot_centrality"
            plan = halving_plan(executed_rounds(n, BUDGET_PER_ARM * n), cen,
                                True, half=True)
            for impl in ("v1", "v2"):
                res, wall, counts, mem = main_path(lambda: find_medoid(
                    x, key, mesh=mesh, distributed_impl=impl, metric=metric,
                    backend="pallas_fused", budget_per_arm=BUDGET_PER_ARM))
                check_launches(f"phase7 {ds} {impl}", counts, plan,
                               x.shape[1])
                ledger_add(plan, ds, metric)
                _require(res.medoid == truth and res.algo
                         == f"corr_sh_distributed_{impl}",
                         f"phase7 {ds} {impl}: medoid {res.medoid}, want "
                         f"{truth}")
                print(f"phase7 distributed {impl} x1 (nccl) {ds} n={n} "
                      f"d={x.shape[1]} {metric} pallas_fused: medoid "
                      f"{res.medoid} (= {'planted' if ds == 'planted' else 'exact'}"
                      f" {truth}), pulls {res.pulls}, wall {wall:.3f} s, "
                      f"launches per shard {counts}, {mem}", flush=True)
    finally:
        dist.destroy_process_group()
    print(f"phase7: {time.perf_counter() - t7:.1f} s", flush=True)

    # ------------------- phase 8: the LM serving path at full width
    phase("8")
    from repro_torch.configs import get_config
    from repro_torch.core.bucketing import bucket_n
    from repro_torch.launch.serve import Request, Server, prompts
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model

    sys.path.insert(0, str(ROOT / "examples"))
    import embedding_medoid_torch as emb_ex
    import serve_lm_torch as lm_ex

    t8 = time.perf_counter()

    def decode_vs_forward(cfg, params, s, batch, what):
        """tests/test_decode_consistency.py's invariant: the teacher-forced
        logits at positions S - 1 and S against prefill on S tokens and one
        decode step, within LM_LOGIT_TOL. Returns (prefill err, decode err,
        seconds)."""
        toks = torch.randint(0, cfg.vocab_size, (batch, s + 1), device=dev,
                             generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full, _, _ = T.transformer_forward(params, cfg, toks)
        lp, cache = T.transformer_prefill(params, cfg, toks[:, :s], s + 4)
        ld, _ = T.transformer_decode_step(params, cfg, toks[:, s], cache, s)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        e1 = lm_close(f"{what} prefill", lp, full[:, s - 1], LM_LOGIT_TOL)
        e2 = lm_close(f"{what} decode", ld, full[:, s], LM_LOGIT_TOL)
        return e1, e2, secs

    def fp32_copy(params, cfg32, keep=None):
        """The weights in fp32 on their device (``keep``: the first layers
        only)."""
        sd = {k: v.float() for k, v in params.state_dict().items()
              if keep is None or not k.startswith("layers.")
              or int(k.split(".")[1]) < keep}
        model = T.transformer_init(None, cfg32, "meta")
        model.load_state_dict(sd, assign=True)
        return model

    # 8a: the server, bf16 weights from a seeded generator on the card
    cfg = get_config(LM_ARCH)
    V = cfg.vocab_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    srv = Server(LM_ARCH, smoke=False, batch_slots=LM_SLOTS,
                 max_len=LM_MAX_LEN, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = srv.params
    wbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    calls = {"prefill": [0, 0.0], "decode_step": [0, 0.0]}

    def clocked(name, fn):
        """The model's ``name`` with its host time to a device sync and a
        finiteness check of its logits."""
        def call(*a, **kw):
            t = time.perf_counter()
            logits, cache = fn(*a, **kw)
            torch.cuda.synchronize()
            calls[name][0] += 1
            calls[name][1] += time.perf_counter() - t
            _require(bool(torch.isfinite(logits).all()),
                     f"phase8a {name}: non-finite logits")
            return logits, cache
        return call

    srv.model = dataclasses.replace(
        srv.model, prefill=clocked("prefill", srv.model.prefill),
        decode_step=clocked("decode_step", srv.model.decode_step))
    srv.run([Request(rid=-1, prompt=p, max_new=3)      # warm-up
             for p in prompts(1, LM_PROMPT, V, dev, seed=8)])
    for v in calls.values():
        v[:] = [0, 0.0]
    reqs = [Request(rid=i, prompt=p, max_new=LM_NEW)
            for i, p in enumerate(prompts(LM_REQUESTS, LM_PROMPT, V, dev))]
    pk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = srv.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _require(dict(pk.LAUNCHES) == {}, f"phase8a: kernel launches "
                                      f"{dict(pk.LAUNCHES)} on the LM path")
    want_steps = -(-LM_REQUESTS // LM_SLOTS) * (LM_NEW - 1)
    _require(stats["decode_steps"] == want_steps
             and stats["tokens"] == LM_REQUESTS * LM_NEW
             and calls["prefill"][0] == LM_REQUESTS
             and calls["decode_step"][0] == LM_REQUESTS * (LM_NEW - 1)
             and all(r.done and len(r.out) == LM_NEW for r in reqs),
             f"phase8a server: {stats}, calls {calls}")
    _require(all(0 <= t < V for r in reqs for t in r.out),
             "phase8a: a token outside the vocabulary")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase8a server {LM_ARCH} full config ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {V}) "
          f"bf16, {wbytes / 1e9:.3f} GB of weights built in {init_s:.2f} s; "
          f"{LM_REQUESTS} requests of {LM_PROMPT} tokens, max_new {LM_NEW}, "
          f"{LM_SLOTS} slots, max_len {LM_MAX_LEN}: {stats['decode_steps']} "
          f"decode steps, {stats['tokens']} tokens, wall {wall:.3f} s, "
          f"{calls['prefill'][1] / calls['prefill'][0] * 1e3:.2f} ms a "
          f"prefill, {calls['decode_step'][1] / calls['decode_step'][0] * 1e3:.2f}"
          f" ms a decode step (one slot at batch 1), "
          f"{stats['tokens'] / wall:.1f} tokens/s, max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; request 0 generated {reqs[0].out[:8]}...",
          flush=True)

    # where a decode step's time goes: one step (slot 0's prompt, position
    # LM_PROMPT) timed, then under the profiler
    lp, pcache = T.transformer_prefill(params, cfg, reqs[0].prompt[None],
                                       LM_MAX_LEN)
    tok = torch.argmax(lp, -1)

    def one_step():
        return T.transformer_decode_step(params, cfg, tok, pcache, LM_PROMPT)

    one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    print(f"phase8a one decode step {step_s * 1e3:.2f} ms; "
          f"{busy_note(profiled(one_step), step_s)}", flush=True)
    del lp, pcache

    cfg32 = cfg.scaled(dtype="float32")
    p32 = fp32_copy(params, cfg32)
    e1, e2, secs = decode_vs_forward(cfg32, p32, LM_PROMPT, 2,
                                     "phase8a fp32")
    print(f"phase8a decode vs forward, fp32 copy (S = {LM_PROMPT}, B = 2): "
          f"prefill max err {e1:.3g}, decode max err {e2:.3g} (rtol = atol "
          f"= {LM_LOGIT_TOL}), {secs:.2f} s", flush=True)

    # 8b: two layers at full width, the same weights on the card and the CPU
    cfg2 = cfg32.scaled(num_layers=2)
    card2 = fp32_copy(p32, cfg2, keep=2)
    cpu2 = T.transformer_init(None, cfg2, "meta")
    cpu2.load_state_dict({k: v.cpu() for k, v in card2.state_dict().items()},
                         assign=True)
    del p32
    torch.cuda.empty_cache()
    prompt = prompts(1, LM_PROMPT, V, dev, seed=9)[0][None]
    n_slots = LM_PROMPT + LM_CARD_CPU_STEPS + 1
    lg, cg = T.transformer_prefill(card2, cfg2, prompt, n_slots)
    lc, cc = T.transformer_prefill(cpu2, cfg2, prompt.cpu(), n_slots)
    errs = [lm_close("phase8b prefill card vs cpu", lg, lc, LM_CARD_CPU_TOL)]
    compared = 0
    for step in range(LM_CARD_CPU_STEPS):
        tok = torch.argmax(lg, -1)
        top2 = torch.topk(lc, 2).values[0]
        if float(top2[0] - top2[1]) > 2 * LM_CARD_CPU_TOL * (
                1 + float(top2[0].abs())):
            compared += 1
            _require(int(torch.argmax(lc, -1)[0]) == int(tok[0]),
                     f"phase8b step {step}: greedy token differs")
        pos = LM_PROMPT + step
        lg, cg = T.transformer_decode_step(card2, cfg2, tok, cg, pos)
        lc, cc = T.transformer_decode_step(cpu2, cfg2, tok.cpu(), cc, pos)
        errs.append(lm_close(f"phase8b decode {step} card vs cpu", lg, lc,
                             LM_CARD_CPU_TOL))
    _require(compared >= 1,
             f"phase8b: no decode step had a top-two gap beyond twice "
             f"{LM_CARD_CPU_TOL}, so no greedy token was compared")
    print(f"phase8b card vs cpu, {cfg2.num_layers} layers at {LM_ARCH}'s "
          f"full width in fp32 (TF32 off), prefill of {LM_PROMPT} tokens and "
          f"{LM_CARD_CPU_STEPS} decode steps: max err "
          f"{', '.join(f'{e:.3g}' for e in errs)} (rtol = atol = "
          f"{LM_CARD_CPU_TOL}); greedy tokens equal at the {compared} of "
          f"{LM_CARD_CPU_STEPS} steps whose top-two gap exceeds twice it",
          flush=True)
    del card2, cpu2, cg, cc
    torch.cuda.empty_cache()

    # 8c: gemma3's windows and both thetas at full width, 7 layers, fp32
    gcfg = get_config("gemma3-27b").scaled(num_layers=GEMMA_LAYERS,
                                           dtype="float32")
    _require(set(gcfg.layer_windows()) == {0, 1024}
             and len(set(gcfg.layer_thetas())) == 2,
             f"phase8c: windows {gcfg.layer_windows()}, thetas "
             f"{gcfg.layer_thetas()}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    gparams = build_model(gcfg).init(torch.Generator(device=dev)
                                     .manual_seed(SEED), dev)
    torch.cuda.synchronize()
    ginit_s = time.perf_counter() - t0
    gbytes = sum(p.numel() * p.element_size() for p in gparams.parameters())
    e1, e2, secs = decode_vs_forward(gcfg, gparams, GEMMA_PROMPT, 1,
                                     "phase8c gemma3")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase8c gemma3-27b full width cut to {GEMMA_LAYERS} layers "
          f"(windows {gcfg.layer_windows()}, thetas {gcfg.layer_thetas()}), "
          f"fp32, {gbytes / 1e9:.2f} GB built in {ginit_s:.2f} s; decode vs "
          f"forward on a {GEMMA_PROMPT}-token prompt: prefill max err "
          f"{e1:.3g}, decode max err {e2:.3g} (rtol = atol = "
          f"{LM_LOGIT_TOL}); forward "
          f"+ prefill + decode {secs:.2f} s, max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    del gparams
    torch.cuda.empty_cache()

    # 8d: the embedding medoid on internlm2's bf16 weights of 8a
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs = emb_ex.embed_corpus(cfg, params, EMB_SEQS, EMB_LEN, dev)
    torch.cuda.synchronize()
    emb_s = time.perf_counter() - t0
    _require(embs.shape == (EMB_SEQS, V) and embs.dtype == torch.float32
             and bool(torch.isfinite(embs).all()),
             f"phase8d embeddings {tuple(embs.shape)} {embs.dtype}")
    toks = rng.randint(rng.fold_in(rng.key(1, dev), 0), (32, EMB_LEN), 0, V)
    t0 = time.perf_counter()
    emb_ex.embed_sequences(cfg, params, toks)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    note = busy_note(profiled(
        lambda: emb_ex.embed_sequences(cfg, params, toks)), batch_s)
    print(f"phase8d one batch of the embedding pass (32 x {EMB_LEN} tokens) "
          f"{batch_s * 1e3:.2f} ms; {note}", flush=True)
    del srv, params
    torch.cuda.empty_cache()
    n = EMB_SEQS
    data["lm_embed"] = embs
    t0 = time.perf_counter()
    truth = int(exact_medoid(embs, "l2"))
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    ref = correlated_sequential_halving(embs, EMB_BUDGET * n,
                                        rng.key(2, dev), metric="l2",
                                        backend="reference")
    theta = torch.sort(ref.theta_hat).values
    gap = float(theta[1] - theta[0])
    fm_plan = halving_plan(executed_rounds(n, EMB_BUDGET * n),
                           "dot_centrality", False)
    for backend in ("reference", "pallas_fused"):
        res, wall, counts, mem = main_path(
            lambda: emb_ex.representative(embs, backend))
        plan = fm_plan if backend == "pallas_fused" else []
        check_launches(f"phase8d find_medoid {backend}", counts, plan,
                       embs.shape[1])
        _require(res.medoid == truth or gap <= 2 * RTOL * float(
            theta[0].abs()), f"phase8d {backend}: medoid {res.medoid}, "
                             f"exact {truth}, output-round gap {gap}")
        print(f"phase8d find_medoid {backend} on ({n}, {V}) embeddings "
              f"(key 2, {EMB_BUDGET} per arm, l2): medoid {res.medoid} "
              f"(exact {truth}: {'equal' if res.medoid == truth else 'differs'}"
              f", output-round gap {gap:.6g}), pulls {res.pulls}, wall "
              f"{wall:.3f} s, launches {counts}, {mem}", flush=True)
    tot = ledger_add(fm_plan, "lm_embed", "l2")
    print(f"phase8d 1e ⊂ 1: embedding rounds (C, R, {V}): "
          f"{fmt_shapes(fm_plan, 'lm_embed', 'l2', ('dot_centrality',))}; "
          f"in all {fmt_tot(tot)}", flush=True)
    print(f"phase8d embedding pass: {EMB_SEQS} sequences of {EMB_LEN} tokens "
          f"in batches of 32, {emb_s:.2f} s ({EMB_SEQS * EMB_LEN / emb_s:.0f} "
          f"tokens/s); exact medoid {truth} in {exact_s:.3f} s", flush=True)

    direct = make_direct_refiner(metric="l2", backend="pallas_fused",
                                 budget_per_arm=KM_REFINE,
                                 min_bucket=KM_MIN_BUCKET)
    sizes = []

    def refiner(arrays, rkey):
        sizes.append([a.shape[0] for a in arrays])
        return direct(arrays, rkey)

    res, wall, counts, mem = main_path(lambda: kmedoids(
        embs, EMB_K, rng.key(3, dev), metric="l2", backend="pallas_fused",
        refiner=refiner))
    _require(len(sizes) == 1, f"phase8d kmedoids: {len(sizes)} sweeps")
    per_swap = schedule_pulls(n, KM_SWAP * n) + n
    _require(res.swap_pulls % per_swap == 0,
             f"phase8d kmedoids: swap pulls {res.swap_pulls}")
    km_plan = kmedoids_plan(
        n, EMB_K, "l2", "pallas_fused",
        [(nb, next_pow2(len(idxs))) for nb, idxs in
         plan_buckets(sizes[0], KM_MIN_BUCKET).items()],
        res.swap_pulls // per_swap, 1 + (res.refine_updates > 0))
    check_launches("phase8d kmedoids", counts, km_plan, embs.shape[1])
    km_ref = emb_ex.cluster(embs, EMB_K, "reference")
    same = km_ref.medoids == res.medoids and np.array_equal(
        np.asarray(km_ref.labels), np.asarray(res.labels))
    _require(same or abs(km_ref.cost - res.cost) <= RTOL * abs(km_ref.cost),
             f"phase8d kmedoids: {res.medoids} cost {res.cost!r}, reference "
             f"{km_ref.medoids} cost {km_ref.cost!r}")
    tot = ledger_add(km_plan, "lm_embed", "l2")
    print(f"phase8d kmedoids k={EMB_K} pallas_fused: medoids {res.medoids} "
          f"(reference backend equal: {same}), cost {res.cost:.6g}, swaps "
          f"{res.swaps}, pulls {res.pulls}, wall {wall:.3f} s, launches "
          f"{counts}, {mem}; {fmt_tot(tot)}", flush=True)
    # row 5e: the k-medoids dot_pairwise launches against x @ y.T (the
    # library call) at the same shapes
    pw = [shape_time(k, "lm_embed", c, r, "l2", m)
          for k, c, r, m in km_plan if k == "dot_pairwise"]
    print(f"phase8d 5e ⊂ 5: kmedoids dot_pairwise by shape: "
          f"{fmt_shapes(km_plan, 'lm_embed', 'l2', ('dot_pairwise',))}; in "
          f"all {len(pw)} launches, kernel {sum(e[1] for e in pw):.3f} ms, "
          f"x @ y.T {sum(e[5] for e in pw):.3f} ms (kernel / library "
          f"{sum(e[1] for e in pw) / sum(e[5] for e in pw):.2f})", flush=True)

    shards = emb_ex.shard_bounds(n, EMB_QUERIES)
    (ssrv, rids), wall, counts, mem = main_path(
        lambda: emb_ex.shard_representatives(embs, EMB_QUERIES,
                                             "pallas_fused"))
    sh_plan = slot_plan(sorted(Counter(bucket_n(b - a, KM_MIN_BUCKET)
                                       for a, b in shards).items()),
                        "dot_centrality", False)
    check_launches("phase8d shards", counts, sh_plan, embs.shape[1])
    rsrv, rrids = emb_ex.shard_representatives(embs, EMB_QUERIES,
                                               "reference")
    got = {rids[r]: int(ssrv.done[r].medoid) for r in rids}
    want = {rrids[r]: int(rsrv.done[r].medoid) for r in rrids}
    _require(got == want, f"phase8d shards: {got} != reference {want}")
    tot = ledger_add(sh_plan, "lm_embed", "l2")
    print(f"phase8d {len(shards)} shards {shards} through a MedoidServer "
          f"(pallas_fused, {ssrv.dispatches} dispatches): medoids "
          f"{[a + m for (a, _), m in sorted(got.items())]} (the reference "
          f"backend's), wall {wall:.3f} s, launches {counts}, {mem}; "
          f"{fmt_tot(tot)}", flush=True)
    del embs, data["lm_embed"]
    torch.cuda.empty_cache()

    # 8e: the sidecar, B cosine queries of (512, 64) in one dispatch
    want = lm_ex.serve_medoid_queries(SIDECAR_B, "reference", device=dev)
    out, wall, counts, mem = main_path(
        lambda: lm_ex.serve_medoid_queries(SIDECAR_B, "pallas_fused",
                                           device=dev))
    sc_plan = halving_plan(executed_rounds(SIDECAR_N,
                                           SIDECAR_BUDGET * SIDECAR_N),
                           "dot_centrality", False) * SIDECAR_B
    check_launches("phase8e sidecar", counts, sc_plan, out["d"])
    _require(out["medoids"] == want["medoids"],
             f"phase8e: {out['medoids']} != reference {want['medoids']}")
    key = rng.key(0, dev)
    data["lm_sidecar"] = rng.normal(rng.fold_in(key, 1), (
        SIDECAR_B * SIDECAR_N, out["d"]))
    tot = ledger_add(sc_plan, "lm_sidecar", "cosine")
    print(f"phase8e sidecar: {SIDECAR_B} cosine queries of ({SIDECAR_N}, "
          f"{out['d']}) pallas_fused: medoids {out['medoids']} (the reference "
          f"backend's), wall {wall:.3f} s, launches {counts}, {mem}; "
          f"{fmt_tot(tot)}", flush=True)
    print(f"phase8: {time.perf_counter() - t8:.1f} s", flush=True)

    # ------------- phase 9: the other LM families at full width
    phase("9")
    phase9(dev)

    # ------------- phase 10: the recurrent families at full width
    phase("10")
    t10 = time.perf_counter()
    zcfg, zparams = phase10(dev)

    # 10e: the embedding medoid on zamba2-2.7b's bf16 weights of 10b
    V = zcfg.vocab_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs = emb_ex.embed_corpus(zcfg, zparams, EMB_SEQS, EMB_LEN, dev)
    torch.cuda.synchronize()
    emb_s = time.perf_counter() - t0
    _require(embs.shape == (EMB_SEQS, V) and embs.dtype == torch.float32
             and bool(torch.isfinite(embs).all()),
             f"phase10e embeddings {tuple(embs.shape)} {embs.dtype}")
    _require(dict(pk.LAUNCHES) == {}, f"phase10e embedding pass: kernel "
                                      f"launches {dict(pk.LAUNCHES)}")
    toks = rng.randint(rng.fold_in(rng.key(1, dev), 0), (32, EMB_LEN), 0, V)
    t0 = time.perf_counter()
    emb_ex.embed_sequences(zcfg, zparams, toks)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    note = busy_note(profiled(
        lambda: emb_ex.embed_sequences(zcfg, zparams, toks)), batch_s)
    print(f"phase10e one batch of the embedding pass (32 x {EMB_LEN} tokens) "
          f"{batch_s * 1e3:.2f} ms; {note}", flush=True)
    del zparams
    torch.cuda.empty_cache()
    n = EMB_SEQS
    data["lm_embed_zamba2"] = embs
    t0 = time.perf_counter()
    truth = int(exact_medoid(embs, "l2"))
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    ref = correlated_sequential_halving(embs, EMB_BUDGET * n,
                                        rng.key(2, dev), metric="l2",
                                        backend="reference")
    theta = torch.sort(ref.theta_hat).values
    gap = float(theta[1] - theta[0])
    fm_plan = halving_plan(executed_rounds(n, EMB_BUDGET * n),
                           "dot_centrality", False)
    for backend in ("reference", "pallas_fused"):
        res, wall, counts, mem = main_path(
            lambda: emb_ex.representative(embs, backend))
        plan = fm_plan if backend == "pallas_fused" else []
        check_launches(f"phase10e find_medoid {backend}", counts, plan,
                       embs.shape[1])
        _require(res.medoid == truth or gap <= 2 * RTOL * float(
            theta[0].abs()), f"phase10e {backend}: medoid {res.medoid}, "
                             f"exact {truth}, output-round gap {gap}")
        print(f"phase10e find_medoid {backend} on ({n}, {V}) zamba2-2.7b "
              f"embeddings (key 2, {EMB_BUDGET} per arm, l2): medoid "
              f"{res.medoid} (exact {truth}: "
              f"{'equal' if res.medoid == truth else 'differs'}, "
              f"output-round gap {gap:.6g}), pulls {res.pulls}, wall "
              f"{wall:.3f} s, launches {counts}, {mem}", flush=True)
    tot = ledger_add(fm_plan, "lm_embed_zamba2", "l2")
    print(f"phase10e 1h ⊂ 1: embedding rounds (C, R, {V}): "
          f"{fmt_shapes(fm_plan, 'lm_embed_zamba2', 'l2', ('dot_centrality',))}"
          f"; in all {fmt_tot(tot)}", flush=True)
    print(f"phase10e embedding pass: {EMB_SEQS} sequences of {EMB_LEN} "
          f"tokens in batches of 32, {emb_s:.2f} s "
          f"({EMB_SEQS * EMB_LEN / emb_s:.0f} tokens/s); exact medoid "
          f"{truth} in {exact_s:.3f} s", flush=True)
    del embs, data["lm_embed_zamba2"]
    torch.cuda.empty_cache()
    print(f"phase10: {time.perf_counter() - t10:.1f} s", flush=True)

    # ------------- phase 11: training on the card; 12b's dry runs start
    # now on the host's CPU, beside it
    phase("11")
    dryruns = phase12_dryruns()
    try:
        phase11(dev)
    except BaseException:
        for _, _, proc in dryruns:
            proc.kill()
        raise

    # ------------- phase 12: the sharded trainer and the dry run
    phase("12")
    phase12(dev, dryruns)

    for kern, row in led.rows.items():
        _require(row["launches"] > 0 or kern in UNCALLED,
                 f"{kern} was never launched on the main path")
    phase("end")
    print(f"chip_smoke: {time.perf_counter() - script_t0:.1f} s in all; by "
          f"phase " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()),
          flush=True)
    print(led.line())
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
