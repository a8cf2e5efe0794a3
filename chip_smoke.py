#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs a GPU

Phases, each printing one JSON line and its seconds; any failure raises
and the script exits non-zero:

  1. device       card name, power limit, TF32 off for matmul and cuDNN
  2. build        the CUDA embedding-bag (stacked and ragged-tables),
                  fused-lookup and dot-interaction libraries, from the
                  sources here, one nvcc each, in parallel
  2b. lm_zoo      the ten LM archs at `reduced` (f32, TF32 off), each built
                  on the host from a seeded generator and its state dict
                  copied to the card: card logits against the host's
                  (rtol/atol 1e-4); prefill 4 + decode 4 against the card's
                  teacher forcing (2e-2) for phi4-mini, deepseek-v2-lite,
                  rwkv6, gemma3 and jamba; whisper's cached decode against
                  its full decode; each MoE arch's routing (experts, keep
                  mask) on the card against the host's
  2c. lm_serve    phi4-mini-3.8b at full width and depth: (a) f32, batch
                  2, prompt 64 + 16 greedy steps against teacher forcing
                  over the same 80 tokens (2e-2, greedy tokens agree); (b)
                  bf16, prompt 512 + 64 greedy steps at batch 1 and 8:
                  prefill ms, decode-step p50/p99 (CUDA events), tokens/s,
                  the host's own time a step, the device's busy time and
                  its top ops (torch.profiler), peak memory, each beside
                  its floor (each weight once, the cache, the logits) and
                  `OpCost`'s count on meta tensors; (c) deepseek-v2-lite at
                  full width cut to 4 layers (1 dense + 3 MoE): (a)'s check
                  dropless, (b)'s timing at batch 8 under the published
                  capacity factor, with the tokens capacity drops. Records
                  for `repro_torch.roofline.report` go to build/lm_roofline/
                  and the report's table is printed; no DLRM kernel
                  launches on this path
  2d. spmd_lm_train  the SPMD layer on a one-card mesh ((1, 1) over an
                  NCCL group of one rank, its file:// store under build/,
                  up until spmd_dryrun): phi4-mini-3.8b at full width and
                  depth in bf16 through `launch.steps.make_lm_train_step`
                  (AdamW, remat, vocab_chunk 512), batch 1 x 4096 tokens
                  (train_4k's per-chip share), 5 steps on one batch: the
                  first step's loss against the plain step's (no mesh,
                  plain tensors) within 1e-3 relative, the updated
                  parameters bit for bit, a falling loss, finite parameters;
                  step p50, tokens/s, share of the bf16 peak, peak memory,
                  a sixth step profiled
  3. parity       kernel vs its plain version (ref.embedding_bag_ref) on the
                  card: sum/mean, weights on/off, num_hot 0/>0, f32/bf16,
                  ragged B at every bags-per-block value, vector and scalar
                  D, D=256 (two row passes), L=1, L under the ring depth,
                  L=257, ring depths 2-16, out-of-range indices, one table
                  at the serve shape (R=500K, B=2048, L=150, D=128) and the
                  completion shape (T=1, B=2048, L=150) through its caller
  4. parity_fused the fused kernel vs fused_warm_lookup_plain on the card:
                  sum/mean, weights on/off, hot K 0/>0, all-hit, mixed,
                  PAD and all-miss slot maps, ragged B at every
                  bags-per-block value, D=128, 256 and 33, L=1, 5, 24, 257,
                  T=3 in one launch, a bad slot and a bad row (NaN), bf16;
                  one table at the serve shape with a warm cache; and the
                  law on a small model: tiered pooled output equals the
                  device kernel's bit for bit (hot set, refresh, update)
  4b. interaction the dot-interaction kernel vs dot_interaction_ref on
                  the card (f32 and bf16): the serve shape (B=2048, F=251,
                  D=128) and the benchmark model's (16384, 9, 64), F not a
                  multiple of the 8 x 12 tile, B under the grid and no
                  multiple of 8 samples a block, rows of 132 and 72 bytes
                  and rows not 16-byte aligned, the one-warp path's largest
                  F, six passes at F=600, D=2000; one launch a call; its
                  time, the plain version's and bmm + gather's at the two
                  benchmark shapes beside the bound; the plain backward of
                  the autograd route against autograd
  4c. ragged      the ragged-tables bag kernel vs ref.ragged_tables_bag_ref
                  (f32 and bf16 tables, the scalar path, dlrm-dcnv2's bag
                  sizes), NaN bags for out-of-range ids, the stacked
                  kernel's bits on equal f32 tables; then dlrm-dcnv2 at
                  full width (26 tables, 52.27 GB bf16) through
                  DLRM.forward at batch 8,192: finite logits, one bag
                  launch, the pooled bags against the plain version at
                  the same bound, the kernel's time, the plain version's
                  and F.embedding_bag's beside the byte bound
  4d. towers      the MLP towers of the benchmark's five cells (B = 2048,
                  16,384 and 8,192) under inference_mode: the fused
                  forward (bias and ReLU in each product's epilogue)
                  against `x @ w + b` then relu, whole and layer by layer:
                  device ms, the kernels each launches (no elementwise
                  kernel in a fused layer but an N = 1 one), the gap
                  over the composed output's largest entry, and
                  `MLPTower.epilogue_layers` one a layer where
                  `epilogue_pays` (all but dlrm-production's first top
                  layer)
  5. serve        dlrm_production at full width through ServingSession on
                  the `device` backend: 3 batches of 2048 med_hot queries;
                  the bag and interaction kernels launch once per forward;
                  a 64-query sub-batch's logits match the plain path
  6. kernel_time  kernel, plain version and torch's embedding_bag at the
                  serve shape (CUDA events), the memory bound, the
                  registers and resident blocks per SM of the instantiation
                  launched, and a breakdown of one batch's time
  6b. kernel_diag the bag kernel at the serve shape on four index sets
                  (served, all distinct, L2-resident, one row per table),
                  the completion shape, and the fused kernel's two passes
                  on a slot map made from the served batch
  6c. replay_device  phase serve's model under a flash crowd on a virtual
                  clock: service time measured at max_batch=256, an SLO of
                  4x its median, deadline admission at twice the SLO, the
                  shrink rung down to 32; sheds, levels,
                  batch sizes, one bag launch per forward, a sample
                  batch's logits against the plain path
  6d. spmd_dlrm (serve)  `make_dlrm_serve_step` over serve's tables,
                  wrapped without a copy: batch 0's logits equal serve's
                  bit for bit, one bag launch
  7. serve_tiered the same weights and the first 2 of those batches on the
                  `tiered` backend (hot 50K + warm 50K rows per table on
                  the card, the cold tier on the host, async prefetch); the
                  fused kernel launches once per forward; logits match
                  phase serve's
  8. kernel_time_fused  at the serve shape with the warm state serving
                  left: the fused kernel held to its plain version on all
                  tables (pooled within the bound, miss lists exact); its
                  time (and its pool and list passes apart), the plain
                  version's and a torch embedding_bag's
                  over [hot; cache] (pooled half only); the bound; and a
                  breakdown of one tiered batch
  8b. replay_tiered  the tiered storage under a flash crowd: max_batch=128,
                  an SLO of 2x the median calibration batch, deadline
                  admission at twice the SLO, a spike of 6x base, then
                  base traffic; the shrink rung down to 16, then the
                  degraded rung, and back to level 0; degraded and exact
                  batch times; no
                  completion launch in a degraded batch; every exact
                  answer equal to the device kernel's bit for bit; one
                  degraded batch against the plain degraded pooling and
                  its L2 delta against a recompute
  8c. update      online updates at full width, 8 tables: device, tiered
                  and sharded (2 shards) sessions on one update stream (a
                  full base, two deltas of 2 % of 3 tables' rows); after
                  the run each batch against the plain path over its
                  version's tables, tiered == sharded == device bit for
                  bit, every qid's version
  8c'. train      training on the card. (a) train_dlrm's configuration
                  (16 tables x 48,000 rows, D=128, pooling 20, batch 64)
                  through TrainLoop: the step-0 loss on the kernel path
                  against the plain path's, the table gradient from the
                  kernel's backward against autograd through
                  ref.embedding_bag_ref (summation bound), 60 steps
                  straight through and 40 + a restored 20 under
                  deterministic algorithms (the same losses bit for bit),
                  one bag launch a forward, falling losses. (b)
                  dlrm_production's widths at batch 2048 with 64 tables:
                  10 steps timed with CUDA events, 5 more split into the
                  bag kernel, MLPs, zeroing, scatter, Adagrad and SGD,
                  their byte bounds, peak device memory
  8c''. quickstart the port's quickstart on the card: the planner, then
                  the pinned hot-first lookup (one bag launch) against the
                  plain gather, max|err| < 1e-4
  8f. spmd_dlrm (train)  `make_dlrm_train_step` at the train phase's
                  wide widths (64 tables, batch 2048): one SGD step equal
                  to the same step without a mesh bit for bit (loss and
                  every parameter, deterministic algorithms), as many bag
                  launches as the plain step
  8g. spmd_dryrun `python -m repro_torch.launch.dryrun` for seven cells
                  in parallel processes, no card (started before
                  spmd_lm_train, beside which they run; collected
                  here): on a fake group of 256
                  ranks phi4-mini and deepseek-v2-lite train_4k,
                  dlrm-production serve, phi4-mini prefill_32k and
                  whisper-medium train_4k; on 512 ranks (2x16x16)
                  phi4-mini and rwkv6-7b train_4k. Each `ok` within its
                  300 s, per-device bytes, dominant term, deepseek's
                  expert all-to-all counted, whisper within 80 GB a
                  device, phi4-mini train_4k's flops a device x 512
                  within 10 % of the one-pod cell's x 256, and
                  prefill_32k's x 256 within 10 % of the same prefill
                  counted without a mesh on meta
  8d. serve_sharded  full width, 64 tables: the `device` reference, then
                  the `sharded` backend on 4 shards (serve_tiered's tiers,
                  contiguous placement): 2 batches of 2048, logits ==
                  device's bit for bit, one fused launch per unit a
                  forward; a live migration to a placement that replicates
                  table 0 on two shards, routing updates, the 2 batches
                  again; one batch with the shards in parallel and one
                  serially with each shard's breakdown
  8d'. serve_pool the same tables, batches, tiers and migration on the
                  `pool` backend: 4 worker processes (one shard each, a
                  CUDA context each) over one shared cold segment in
                  /dev/shm (the table count cut to what /dev/shm and the
                  host hold, at most 64); logits == device's bit for bit
                  before and after the migration and after a SIGKILLed
                  worker's respawn; fused and bag launches counted inside
                  the workers; one batch timed directly against
                  serve_sharded's parallel batch; after close() every
                  worker joined and /dev/shm given back
  8e. replay_tenants  two tenants (steady, flash) of 32 tables on one
                  shared sharded backend (2 shards), max_batch 128
                  unpadded, on a virtual clock: `fair` scheduling with the
                  budget arbiter, then `fifo` without; every answer equal
                  to the tenant's bag-kernel pooling, every arbiter round
                  within the budget, each tenant's p99 and shed share, and
                  each tenant's first batch after an arbiter round that
                  resized its tiers timed apart from its other batches
  9. kernels      one line per ported kernel (the PERF.md rows), with
                  registers, blocks per SM and fraction of the bound, and
                  the launches of each phase that drives it

The last line is {"ok": true, "device": {...}}. There is no CPU branch.
`--stop-after PHASE` ends the run after that phase (build, lm_zoo,
lm_serve, spmd_lm_train, parity_fused, interaction, ragged, towers,
kernel_time,
kernel_diag,
replay_device, replay_tiered, quickstart, spmd_dlrm, spmd_dryrun,
serve_sharded, serve_pool, replay_tenants; a short first call for a new
kernel or the LM path); the
result lines are then not printed. The pool phase's workers are spawned
processes that import this file again as `__mp_main__`: its module level
does no work.
`--geometry-sweep` makes kernel_diag also time both kernels at each of
seven launch geometries (bags per block x ring depth).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import resource
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.checkpoint import CheckpointManager, ModelUpdateStream  # noqa: E402
from repro_torch.configs import LM_ARCHS, get_config, reduced  # noqa: E402
from repro_torch.configs.dlrm_production import CONFIG  # noqa: E402
from repro_torch.configs.dlrm_dcnv2 import CONFIG as DCNV2  # noqa: E402
from repro_torch.core.access_patterns import (PAPER_UNIQUE_PCT,  # noqa: E402
                                              make_pattern)
from repro_torch.core.embedding import _pool_rows_core, gather_rows  # noqa: E402
from repro_torch.data import DLRMBatch  # noqa: E402
from repro_torch.examples import quickstart, train_dlrm  # noqa: E402
from repro_torch.kernels.embedding_bag import fused, kernel, ops, ref  # noqa: E402
from repro_torch.kernels.embedding_bag.grad import embedding_bag_backward  # noqa: E402
from repro_torch.kernels.interaction import kernel as interaction  # noqa: E402
from repro_torch.models import (DLRM, abstract_params, build_model,  # noqa: E402
                                build_plan, model_flops)
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.steps import (distribute_inputs,  # noqa: E402
                                      make_dlrm_serve_step,
                                      make_dlrm_train_step,
                                      make_lm_train_step)
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.dlrm import bce_with_logits  # noqa: E402
from repro_torch.models.layers import MLPTower, epilogue_pays  # noqa: E402
from repro_torch.optim import (adamw_lowmem_init,  # noqa: E402
                               adamw_lowmem_update, rowwise_adagrad_update,
                               sgdm_update)
from repro_torch.ps import PSConfig  # noqa: E402
from repro_torch.roofline import report as lm_report  # noqa: E402
from repro_torch.roofline.analyze import OpCost, roofline_terms  # noqa: E402
from repro_torch.roofline.hw import (HBM_BW, PEAK_FLOPS_BF16,  # noqa: E402
                                     PEAK_FLOPS_F32)
from repro_torch.serving import (ArbiterConfig, BatcherConfig,  # noqa: E402
                                 ServingSession, SLOConfig, TenantManager,
                                 TenantSpec, UpdateConfig, configure)
from repro_torch.traffic import (TimedQuery, VirtualClock,  # noqa: E402
                                 make_traffic, replay, replay_tenants)
from repro_torch.utils import read_json, tree_finite  # noqa: E402
from repro_torch.utils import write_json  # noqa: E402

SERVE_BATCHES = 3
# serve_tiered serves the first two of them (a tiered batch of 2048 takes
# about 50 s on the host; the script stays near half its time limit)
SERVE_TIERED_BATCHES = 2
SUB_BATCH = 64
# device bytes kept free beside the tables: a batch's indices, interaction
# and MLP activations, the sub-batch's plain gather, the timing phase's
# flattened indices
HEADROOM_BYTES = 8 * 10**9
# tier sizes of serve_tiered: the repo's convention of rows // 10 per tier
TIER_FRACTION = 10
# host bytes kept free beside what serve_tiered holds per table: a batch's
# slot map, one table's completion rows, the allocator's slack
HOST_HEADROOM_BYTES = 4 * 10**9
# host bytes of one entry of a warm tag store's row -> slot dict
LOC_ENTRY_BYTES = 128
# seed of the trace batch the hot set is planned from: not a served batch
TRACE_SEED = 100
# replay_device: the SLO ladder's shrink rung from 256 down to 32, and a
# flash trace whose spike (24 batch times) outlasts its 8,000 queries, so
# every SLO check after the spike starts falls inside it and the overload
# lasts ~15 batch times (a query's indices are 150 KB: 8,000 queries hold
# 1.2 GB of host memory). The SLO target is 4x the median calibration
# batch (one slow batch of eight does not move it), and the deadline
# admission sheds only past twice the target: a deadline at the target
# caps the wait there, so the windowed p99 sits at the target and the
# ladder can stall on a rung above the floor
REPLAY_DEVICE_BATCH, REPLAY_DEVICE_MIN = 256, 32
REPLAY_DEVICE_QUERIES = 8000
REPLAY_DEVICE_SPIKE = 24            # batch times
REPLAY_DEVICE_TARGET_X = 4          # x the median calibration batch
REPLAY_DEVICE_DEADLINE_FRAC = 2.0   # shed past this x the target
# replay_tiered: 128 down to 16, then the degraded rung; a 64-query SLO
# window, so the windowed p99 forgets the spike within the base traffic
# that follows it. The trace is timed from the calibration batches, which
# ran up to 1.17x the replay's own 128-query batches on the card: with an
# SLO of 3x their p99 and a spike of 4x base, a calibration 1.17x slow
# left the ladder short of the degraded rung. So the SLO is 2x the median
# calibration batch, the spike 6x base (3x the calibrated service rate),
# admission sheds only past twice the SLO (as in replay_device), and 12
# batch times of base traffic follow the spike for the ladder to come
# back down: tests/test_torch_smoke_replay.py rehearses it on a modelled
# service time, reaching the degraded rung and level 0 again for
# calibrations 0.7-2x the replay's batches. 2,752 queries, 413 MB beside
# the 64 GB cold tier
REPLAY_TIERED_BATCH, REPLAY_TIERED_MIN = 128, 16
REPLAY_TIERED_WINDOW = 64
REPLAY_TIERED_SPIKE = 5             # batch times
REPLAY_TIERED_SPIKE_X = 6.0         # x base
REPLAY_TIERED_AFTER = 12            # batch times of base after the spike
REPLAY_TIERED_TARGET_X = 2          # x the median calibration batch
REPLAY_TIERED_DEADLINE_FRAC = 2.0   # shed past this x the target
# base traffic is half a full batch per batch time: one before the
# spike, the spike, then REPLAY_TIERED_AFTER
REPLAY_TIERED_QUERIES = REPLAY_TIERED_BATCH // 2 * (
    1 + int(REPLAY_TIERED_SPIKE_X) * REPLAY_TIERED_SPIKE
    + REPLAY_TIERED_AFTER)
# update: full width with 8 tables (a full base snapshot of all 250 is
# 64 GB on disk), batches of 512, versions published after steps 1, 3, 5
UPDATE_TABLES, UPDATE_BATCH, UPDATE_STEPS = 8, 512, 8
UPDATE_PUBLISH_AFTER = (1, 3, 5)
UPDATE_SHARDS = 2
# serve_sharded: 64 tables (each unit copies its tables beside the
# authoritative copy: host memory, and a tiered batch's host work a table)
# on 4 shards, 2 batches of 2048 before and after a live migration planned
# from a skewed window (table 0 `random`, the next 15 `one_item`). A load
# is the mean distinct rows a query (150 for `random`, 133.7 for med_hot,
# 1 for `one_item`), so the live imbalance of the contiguous split is 1.30
# and a replication factor of 0.085 (a limit of 140 rows) splits table 0
# alone over two shards
SHARDED_TABLES, SHARDED_SHARDS, SHARDED_BATCHES = 64, 4, 2
SKEWED_ONE_ITEM_TABLES = 15
SHARDED_MIGRATE_THRESHOLD = 1.1
SHARDED_REPLICATE = 0.085
# replay_tenants: two tenants of 32 tables on one backend of 2 shards,
# batches of 128 unpadded; steady ~400 queries at 0.5x one batch's service
# rate, flash ~1,200 at 0.25x with a spike 4x its base for 8 batch times
TENANT_TABLES, TENANT_SHARDS, TENANT_BATCH = 32, 2, 128
TENANT_STEADY_QUERIES, TENANT_FLASH_QUERIES = 400, 1200
# train: leg (a) runs train_dlrm's configuration through TrainLoop for 60
# steps, once straight through and once stopped at step 40 and restored
# from its checkpoint by a second incarnation (deterministic algorithms on:
# the two must agree bit for bit); leg (b) trains dlrm_production's widths
# at batch 2048 with the tables cut to serve_sharded's 64 (the dense table
# gradient doubles the table bytes: 16.4 GB of tables and 16.4 GB of
# gradient): 1 warm-up and 10 timed steps on batches sampled before the
# clock starts, then 5 steps split into their parts. train_dlrm's rates
# (SGD 0.01, Adagrad 0.05) diverge at these widths: pooling 150 and 2,080
# interaction features make the logits large (step-0 loss 5.6), and at
# those rates this leg's loss reached NaN by step 5 on an H100. At 1e-4
# and 1e-3 it falls (the phase prints its losses). The rates move no
# byte: the step's time does not depend on them
TRAIN_STEPS, TRAIN_STOP_AT = 60, 40
TRAIN_LOSS_RTOL = 1e-5
TRAIN_WIDE_TABLES, TRAIN_WIDE_BATCH = 64, 2048
TRAIN_WIDE_STEPS, TRAIN_WIDE_SPLIT_STEPS = 10, 5
TRAIN_WIDE_LR_DENSE, TRAIN_WIDE_LR_EMB = 1e-4, 1e-3
# `_split_step`'s parts that make up a step (zeroing alone is timed apart)
STEP_PARTS = ("batch_to_device", "bag_kernel", "mlp_forward_backward",
              "table_backward", "rowwise_adagrad", "sgd_momentum")
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
# serve_pool: serve_sharded's shape on 4 worker processes (one shard each);
# each worker holds torch and a CUDA context (host bytes, a guess kept
# generous); /dev/shm keeps a GiB free beside the segment, and close()
# must give back all but 64 MB of what the phase took from it
POOL_WORKERS = 4
POOL_WORKER_HOST_BYTES = 3 * 10**9
POOL_SHM_HEADROOM_BYTES = 1 << 30
POOL_SHM_SLACK_BYTES = 64 << 20
# lm_zoo: every LM arch at `reduced` (f32, TF32 off), batch 2 x 32 tokens,
# the card against the host; the reference's five decode archs prefill 4
# then decode 4 against the card's teacher forcing
LM_ZOO_BATCH, LM_ZOO_SEQ, LM_ZOO_DECODE_SEQ = 2, 32, 8
LM_DECODE_ARCHS = ("phi4-mini-3.8b", "deepseek-v2-lite-16b", "rwkv6-7b",
                   "gemma3-27b", "jamba-1.5-large-398b")
LM_FORWARD_TOL = {"rtol": 1e-4, "atol": 1e-4}
LM_DECODE_TOL = {"rtol": 2e-2, "atol": 2e-2}     # tests/test_models.py's
# lm_serve: (a)/(c) f32 consistency at batch 2, a 64-token prompt, 16
# greedy steps; (b) bf16 serving, a 512-token prompt, 64 greedy steps at
# batch 1 and 8, 8 of them profiled; deepseek-v2-lite cut to 4 layers (1
# dense + 3 MoE), dropless (factor 64, as `reduced`) for (c), the
# published factor 2.0 at batch 8 for the timing
LM_CONSIST_BATCH, LM_CONSIST_PROMPT, LM_CONSIST_STEPS = 2, 64, 16
LM_SERVE_BATCHES, LM_SERVE_PROMPT, LM_SERVE_STEPS = (1, 8), 512, 64
LM_PROFILED_STEPS, LM_PROFILED_TOP = 8, 10   # steps; ops listed by time
LM_DEEPSEEK_LAYERS, LM_DEEPSEEK_BATCH, LM_DROPLESS_FACTOR = 4, 8, 64.0
LM_ROOFLINE_DIR = os.path.join(ROOT, "build", "lm_roofline")
# spmd phases: a one-card mesh (1, 1) over an NCCL group of one rank whose
# file:// store lives under build/. spmd_lm_train: phi4-mini-3.8b at full
# width and depth in bf16, the per-chip share of train_4k (256 sequences
# over 256 chips: 1 x 4096 tokens), 5 AdamW steps on one repeated batch;
# the first step's loss against the plain step's within the JAX test's
# 1e-3 relative. spmd_dlrm: the serve step over the device serve phase's
# tables (logits bit for bit), one SGD step at the train phase's wide
# widths (bit for bit under deterministic algorithms). spmd_dryrun: seven
# production-mesh cells (arch, shape, mesh) in subprocesses, in parallel
# beside spmd_lm_train (CPU only; the tiered phases' host memory leaves
# no room for them later); the same global work on both meshes and
# without one within SPMD_FLOPS_RTOL
SPMD_STORE = os.path.join(ROOT, "build", "chip_smoke_spmd_store")
SPMD_LM_ARCH, SPMD_LM_SEQ, SPMD_LM_STEPS = "phi4-mini-3.8b", 4096, 5
SPMD_LOSS_RTOL = 1e-3
SPMD_DLRM_LR = 0.01
SPMD_DRYRUN_CELLS = (("phi4-mini-3.8b", "train_4k", "single"),
                     ("deepseek-v2-lite-16b", "train_4k", "single"),
                     ("dlrm-production", "serve", "single"),
                     ("phi4-mini-3.8b", "prefill_32k", "single"),
                     ("whisper-medium", "train_4k", "single"),
                     ("phi4-mini-3.8b", "train_4k", "multi"),
                     ("rwkv6-7b", "train_4k", "multi"))
SPMD_DRYRUN_TIMEOUT_S = 300
SPMD_FLOPS_RTOL = 0.10
SPMD_DRYRUN_DIR = os.path.join(ROOT, "build", "chip_smoke_dryrun")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def expect(failed: list, cond: bool, msg: str) -> None:
    """A check whose failure is collected: the phase prints its line with
    the `failed` list, then main raises."""
    if not cond:
        failed.append(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sample_indices(pattern, batch: int, tables: int, pooling: int,
                   seed: int, workers: int = 8) -> np.ndarray:
    """[batch, tables, pooling] int32 drawn from `pattern`, in `workers`
    chunks on threads (numpy's searchsorted releases the GIL)."""
    rows = batch * tables
    bounds = np.linspace(0, rows, workers + 1).astype(int)
    with ThreadPoolExecutor(workers) as ex:
        parts = list(ex.map(
            lambda k: pattern.sample(int(bounds[k + 1] - bounds[k]), pooling,
                                     seed=seed * workers + k),
            range(workers)))
    return np.concatenate(parts).reshape(batch, tables, pooling)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fused_pass_ms(cache, slots, rows, hot, num_rows, opts,
                  iters: int) -> tuple[float, float]:
    """CUDA-event times of the fused lookup's two kernels apart: the
    gather-and-pool pass (`fused.pool_tables`) and the miss-list pass
    (`fused.list_tables`, on the pool pass's counts and bitmap)."""
    pool = lambda: fused.pool_tables(cache, slots, rows, None, hot,  # noqa: E731
                                     num_rows, opts)
    pool_ms = cuda_ms(pool, iters=iters)
    _, bag_miss, bitmap = pool()
    lists_ms = cuda_ms(lambda: fused.list_tables(slots, rows, bag_miss,
                                                 bitmap, num_rows),
                       iters=iters)
    return pool_ms, lists_ms


def check_geometry(opts, info: dict, dim: int, itemsize: int,
                   weighted: bool, name: str) -> None:
    """Hold the launch geometry's accounting (`kernel.LaunchGeometry`:
    ring depth, bags per block, dynamic shared bytes) to what the library
    reports it launched. The scalar path (row bytes not a multiple of 16)
    has no ring and reports depth 0."""
    vec = dim * itemsize % 16 == 0
    want = {"ring_depth": opts.ring_depth() if vec else 0,
            "bags_per_block": opts.batch_block,
            "dynamic_shared_bytes": opts.shared_bytes(dim, itemsize,
                                                      weighted)}
    got = {k: info[k] for k in want}
    check(got == want, f"{name}: launched {got}, the accounting says {want}")


def compare(got, want, bound, name: str) -> dict:
    """|got - want| <= bound elementwise; NaN only where `want` is NaN."""
    got, want, bound = got.float(), want.float(), bound.float()
    nan = torch.isnan(want)
    check(bool(torch.equal(torch.isnan(got), nan)),
          f"{name}: NaN pattern differs from the plain version")
    err = (got - want).abs().masked_fill(nan, 0)
    excess = (err - bound.masked_fill(nan, 0)).max().item()
    check(excess <= 0, f"{name}: max error {err.max().item():.3e} exceeds "
                       f"its bound by {excess:.3e}")
    return {"case": name, "max_abs_err": err.max().item(),
            "max_err_over_bound": (err / bound.clamp_min(1e-30)).max().item()}


def phase_parity() -> dict:
    """Hold the kernel to its plain version. f32: `ref.summation_bound`
    (2·eps·Σ|w·x|, carried through the mean's division). bf16: the kernel
    accumulates in f32 and rounds once on store, so it is held to the
    plain version on the f32 upcast of the same table, unrounded, with the
    f32 bound plus one bf16 rounding of the result (2^-8·|ref|)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    results = []

    def case(dtype, dim, pooling, mode, weighted, num_hot, batch=13,
             tables=3, rows=1000, pd=8, bb=8, bad_rows=False):
        tab = torch.randn((tables, rows, dim), generator=gen, device=dev)
        tab = tab.to(dtype)
        idx = torch.randint(0, rows, (batch, tables, pooling), generator=gen,
                            device=dev, dtype=torch.int32)
        if bad_rows:
            idx[0, 0, 0], idx[batch - 1, tables - 1, pooling - 1] = -1, rows
        w = (torch.rand((batch, tables, pooling), generator=gen, device=dev)
             if weighted else None)
        opts = kernel.EmbeddingBagOpts(prefetch_distance=pd, batch_block=bb,
                                       num_hot=num_hot, mode=mode)
        got = kernel.embedding_bag_cuda(tab, idx, w, opts)
        name = (f"{str(dtype)[6:]} D={dim} L={pooling} {mode} "
                f"w={int(weighted)} hot={num_hot} pd={pd} bb={bb} B={batch}"
                + (" bad_rows" if bad_rows else ""))
        check_geometry(opts, kernel.last_launch_info(), dim,
                       tab.element_size(), weighted, name)
        torch.cuda.synchronize()
        want, bound = [], []
        for t in range(tables):
            wt = None if w is None else w[:, t]
            safe = idx[:, t].clamp(0, rows - 1)
            want.append(ref.embedding_bag_ref(tab[t].float(), safe, wt, mode))
            bound.append(ref.summation_bound(tab[t].float(), safe, wt, mode))
        want, bound = torch.stack(want, 1), torch.stack(bound, 1)
        if bad_rows:   # an index outside [0, R) poisons its bag with NaN
            want[0, 0] = float("nan")
            want[batch - 1, tables - 1] = float("nan")
        if dtype == torch.bfloat16:   # one rounding of the f32 result
            bound = bound + 2.0 ** -8 * (want.abs() + bound)
        results.append(compare(got, want, bound, name))

    for dtype, dim, pooling in ((torch.float32, 128, 70),
                                (torch.float32, 33, 8),
                                (torch.bfloat16, 128, 150),
                                (torch.bfloat16, 36, 5)):
        for mode in ("sum", "mean"):
            for weighted in (False, True):
                for num_hot in (0, 100):
                    case(dtype, dim, pooling, mode, weighted, num_hot)
    for pd, bb in ((1, 1), (3, 3), (16, 8), (5, 2)):
        case(torch.float32, 128, 40, "mean", True, 50, batch=29, pd=pd, bb=bb)
    case(torch.float32, 128, 20, "sum", False, 0, bad_rows=True)
    case(torch.float32, 33, 20, "mean", True, 10, bad_rows=True)
    # the shared-memory ring's geometry: D=256 (two 512-byte passes), L=1,
    # L shorter than the ring, L=257 (past two 32-lookup windows), ragged
    # B at every bags-per-block value, ring depths 2-16
    for dim, pooling in ((256, 40), (128, 1), (128, 5), (128, 257),
                         (256, 257)):
        case(torch.float32, dim, pooling, "sum", False, 100)
        case(torch.float32, dim, pooling, "mean", True, 100)
    case(torch.float32, 256, 70, "sum", False, 0, bad_rows=True)
    for pd in (2, 4, 16):
        case(torch.float32, 128, 3, "sum", False, 0, pd=pd)
        case(torch.float32, 128, 100, "mean", True, 0, pd=pd)
    for bb in range(1, 9):
        case(torch.float32, 128, 40, "sum", False, 50, batch=29, bb=bb)
    case(torch.bfloat16, 256, 257, "mean", True, 100)

    # the single-table wrappers in ops go through the same kernel
    tab = torch.randn((1000, 128), generator=gen, device=dev)
    idx = torch.randint(0, 1000, (13, 9), generator=gen, device=dev)
    results.append(compare(
        ops.embedding_bag(tab, idx, mode="mean", backend="cuda"),
        ref.embedding_bag_ref(tab, idx, mode="mean"),
        ref.summation_bound(tab, idx, mode="mean"), "ops.embedding_bag"))
    tok = torch.randint(0, 1000, (4, 7), generator=gen, device=dev)
    check(bool(torch.equal(ops.embedding_lookup(tab, tok, backend="cuda"),
                           ref.embedding_lookup_ref(tab, tok))),
          "ops.embedding_lookup differs from the plain gather")

    # one table at the main path's shape, indices from the med_hot pattern
    rows, dim, batch, pooling = 500_000, 128, 2048, 150
    tab = torch.randn((1, rows, dim), generator=gen, device=dev) / dim ** 0.5
    idx_np = make_pattern("med_hot", rows, seed=0).sample(batch, pooling, 7)
    idx = torch.from_numpy(idx_np).to(dev)[:, None]
    got = kernel.embedding_bag_cuda(tab, idx, None, kernel.EmbeddingBagOpts())
    results.append(compare(
        got[:, 0], ref.embedding_bag_ref(tab[0], idx[:, 0]),
        ref.summation_bound(tab[0], idx[:, 0]),
        "serve shape R=500000 B=2048 L=150 D=128 f32 sum"))
    # the completion shape, through its caller: T=1, 2048 bags of 150 rows
    # read once, pooled by fused.pool_bag_rows
    n, pooling, dim = 2048, 150, 128
    bag_rows = torch.randn((n, pooling, dim), generator=gen, device=dev)
    flat = bag_rows.view(n * pooling, dim)
    ar = torch.arange(n * pooling, device=dev).view(n, pooling)
    for mode in ("sum", "mean"):
        results.append(compare(
            fused.pool_bag_rows(bag_rows, mode=mode),
            ref.embedding_bag_ref(flat, ar, mode=mode),
            ref.summation_bound(flat, ar, mode=mode),
            f"completion shape T=1 B={n} L={pooling} D={dim} f32 {mode}"))
    del bag_rows, flat, ar
    f32 = [r for r in results if not r["case"].startswith("bfloat16")]
    return {"cases": len(results),
            "max_abs_err_f32": max(r["max_abs_err"] for r in f32),
            "max_err_over_bound": max(r["max_err_over_bound"]
                                      for r in results),
            "results": results}


def _fused_plain(cache, slots, rows, w, hot, num_rows, mode):
    """The plain version per table (pooled [B, T, D]) and its miss lists."""
    pooled, mrows, mpos = [], [], []
    s_np, r_np = slots.cpu().numpy(), rows.cpu().numpy()
    for t in range(slots.shape[1]):
        pooled.append(fused.fused_warm_lookup_plain(
            cache[t], slots[:, t], rows[:, t],
            None if w is None else w[:, t],
            None if hot is None else hot[t], mode=mode, num_rows=num_rows))
        r, p = fused._miss_list_from_slots(s_np[:, t], r_np[:, t], num_rows)
        mrows.append(r)
        mpos.append(p)
    return torch.stack(pooled, 1), mrows, mpos


def _fused_bound(cache, slots, w, hot, mode):
    """`ref.summation_bound` of each table's bags over the rows they add:
    hot and warm hits; MISS, PAD and bad positions add a zero row."""
    bounds = []
    num_hot = 0 if hot is None else hot.shape[1]
    cache_rows, dim = cache.shape[1], cache.shape[2]
    for t in range(slots.shape[1]):
        parts = ([] if hot is None else [hot[t].float()]) + [
            cache[t].float(), torch.zeros((1, dim), device=cache.device)]
        eff = torch.cat(parts)
        s = slots[:, t].long()
        zero_row = num_hot + cache_rows
        idx = torch.where((s >= 0) & (s < zero_row), s,
                          torch.full_like(s, zero_row))
        bounds.append(ref.summation_bound(
            eff, idx, None if w is None else w[:, t], mode))
    return torch.stack(bounds, 1)


def _check_lists(got_rows, got_pos, want_rows, want_pos, name):
    for t, (gr, gp, wr, wp) in enumerate(zip(got_rows, got_pos, want_rows,
                                             want_pos)):
        check(np.array_equal(gr, wr), f"{name}: table {t} miss_rows differ "
                                      f"({gr.size} vs {wr.size})")
        check(np.array_equal(gp, wp), f"{name}: table {t} miss_pos differ "
                                      f"({gp.size} vs {wp.size})")


def _tiered_twin(model, combine: str, ps_cfg, trace):
    """A tiered model holding `model`'s tables on the host and sharing its
    MLPs, its tiers built from `trace`."""
    emb = dataclasses.replace(model.cfg.embedding, storage="tiered",
                              combine=combine)
    twin = DLRM(dataclasses.replace(model.cfg, embedding=emb),
                device="cuda", tables=model.ebc.tables.cpu())
    twin.bottom, twin.top = model.bottom, model.top
    twin.ebc.storage.build(ps_cfg, trace=trace)
    return twin


def phase_parity_fused() -> dict:
    """Hold the fused kernel to `fused_warm_lookup_plain` on the card.

    Pooled f32: `ref.summation_bound` over the rows each bag adds (zero at
    MISS/PAD), carried through the mean's division. bf16: against the
    plain version on the f32 upcast, plus one bf16 rounding of the stored
    raw sum and, for a mean, one of the epilogue's quotient. miss_rows,
    miss_pos: exactly equal. Then the law: the tiered backend's pooled
    output equals the device kernel's bit for bit (torch.equal), fused and
    per-row paths, sum and mean."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    results = []

    def case(dtype, dim, pooling, mode, weighted, num_hot, mix, batch=13,
             tables=3, rows=1000, cache_rows=200, bad=False, bb=8):
        cache = torch.randn((tables, cache_rows, dim), generator=gen,
                            device=dev).to(dtype)
        hot = (torch.randn((tables, num_hot, dim), generator=gen,
                           device=dev).to(dtype) if num_hot else None)
        ids = torch.randint(0, rows, (batch, tables, pooling), generator=gen,
                            device=dev, dtype=torch.int32)
        hits = torch.randint(0, num_hot + cache_rows, ids.shape,
                             generator=gen, device=dev, dtype=torch.int32)
        draw = torch.rand(ids.shape, generator=gen, device=dev)
        if mix == "hit":
            slots = hits
        elif mix == "miss":
            slots = torch.full_like(ids, fused.MISS)
        elif mix == "pad":   # hits and PAD positions, no miss
            slots = torch.where(draw < 0.5, torch.full_like(ids, fused.PAD),
                                hits)
        else:   # mixed: misses, PAD positions and two all-PAD bags
            slots = torch.where(draw < 0.4, torch.full_like(ids, fused.MISS),
                                hits)
            slots = torch.where(draw > 0.95, torch.full_like(ids, fused.PAD),
                                slots)
            slots[batch - 2:] = fused.PAD
        if bad:   # a slot past the cache, a MISS whose row is out of range
            slots[0, 0, 0] = num_hot + cache_rows
            slots[batch - 1, tables - 1, pooling - 1] = fused.MISS
            ids[batch - 1, tables - 1, pooling - 1] = rows
        slots, ids = slots.contiguous(), ids.contiguous()
        w = (torch.rand(ids.shape, generator=gen, device=dev)
             if weighted else None)
        opts = fused.FusedLookupOpts(batch_block=bb)
        raw, mrow, mpos, counts = fused.launch_tables(cache, slots, ids, w,
                                                      hot, rows, opts)
        name = (f"{str(dtype)[6:]} D={dim} L={pooling} {mode} "
                f"w={int(weighted)} hot={num_hot} {mix} B={batch} T={tables}"
                f" bb={bb}" + (" bad" if bad else ""))
        check_geometry(opts, fused.last_launch_info(), dim,
                       cache.element_size(), weighted, name)
        got = fused.mean_epilogue(raw, w, pooling, mode)
        got_rows, got_pos = fused.lists_to_host(mrow, mpos, counts)
        torch.cuda.synchronize()
        up = (lambda x: x) if dtype == torch.float32 else \
            (lambda x: None if x is None else x.float())
        want, want_rows, want_pos = _fused_plain(
            up(cache), slots, ids, w, up(hot), rows, mode)
        bound = _fused_bound(cache, slots, w, hot, mode)
        if dtype == torch.bfloat16:
            # the raw sum is stored in bf16 (one rounding); a mean's f32
            # epilogue rounds its quotient once more
            roundings = 2 if mode == "mean" else 1
            bound = bound + roundings * 2.0 ** -8 * (
                want.abs().nan_to_num() + bound)
        if bad:
            check(bool(torch.isnan(got[0, 0]).all()
                       and torch.isnan(got[batch - 1, tables - 1]).all()),
                  f"{name}: bad input did not give NaN")
        _check_lists(got_rows, got_pos, want_rows, want_pos, name)
        results.append(compare(got, want, bound, name))

    for dim in (128, 33):
        for mode in ("sum", "mean"):
            for weighted in (False, True):
                for num_hot in (0, 64):
                    for mix in ("hit", "mixed", "miss"):
                        case(torch.float32, dim, 24, mode, weighted,
                             num_hot, mix)
    case(torch.float32, 128, 70, "sum", False, 64, "mixed", bad=True)
    case(torch.float32, 33, 5, "mean", True, 0, "mixed", bad=True)
    case(torch.bfloat16, 128, 40, "mean", True, 64, "mixed")
    case(torch.bfloat16, 36, 9, "sum", False, 0, "mixed")
    # the shared-memory ring's geometry, as in phase parity
    for dim, pooling in ((256, 40), (128, 1), (128, 5), (128, 257)):
        for mix in ("mixed", "pad", "miss"):
            case(torch.float32, dim, pooling, "sum", False, 64, mix)
            case(torch.float32, dim, pooling, "mean", True, 0, mix)
    case(torch.float32, 256, 70, "sum", True, 64, "mixed", bad=True)
    for bb in range(1, 9):
        case(torch.float32, 128, 40, "sum", False, 64, "mixed", batch=29,
             bb=bb)

    # the single-table wrapper, cuda against plain
    cache = torch.randn((300, 64), generator=gen, device=dev)
    sl = torch.randint(-2, 300, (29, 11), generator=gen, device=dev)
    rw = torch.randint(0, 5000, (29, 11), generator=gen, device=dev)
    a = fused.fused_warm_lookup(cache, sl, rw, mode="mean", backend="cuda")
    b = fused.fused_warm_lookup(cache, sl, rw, mode="mean", backend="plain")
    _check_lists([a.miss_rows], [a.miss_pos], [b.miss_rows], [b.miss_pos],
                 "fused_warm_lookup")
    results.append(compare(a.pooled, b.pooled, _fused_bound(
        cache[None], sl[:, None].int(), None, None, "mean")[:, 0],
        "fused_warm_lookup cuda vs plain"))

    # one table at the serve shape: med_hot rows, hot set planned from one
    # batch, the warm cache filled by looking up another
    R, K, B, L, D = 500_000, 50_000, 2048, 150, 128
    pattern = make_pattern("med_hot", R, seed=0)
    table = (torch.randn((1, R, D), generator=gen, device=dev)
             / D ** 0.5).cpu()
    emb = dataclasses.replace(CONFIG.embedding, num_tables=1, rows=R,
                              pooling=L, shard_pad_tables=0,
                              storage="tiered")
    one = DLRM(dataclasses.replace(CONFIG, embedding=emb), device="cuda",
               tables=table)
    one.ebc.storage.build(
        PSConfig(hot_rows=K, warm_slots=K, warm_backing="device",
                 fused_lookup=True),
        trace=pattern.sample(B, L, 11)[:, None])
    ps = one.ebc.storage.ps
    ps.lookup_fused(pattern.sample(B, L, 12)[:, None])
    idx = pattern.sample(B, L, 13)[:, None]
    slots = torch.from_numpy(ps.build_slot_map(idx)).to(dev)
    ids = torch.from_numpy(idx).to(dev)
    hot = ps._hot_dev
    raw, mrow, mpos, counts = fused.launch_tables(
        ps._warm_payload, slots, ids, None, hot, R, fused.FusedLookupOpts())
    got_rows, got_pos = fused.lists_to_host(mrow, mpos, counts)
    want, want_rows, want_pos = _fused_plain(ps._warm_payload, slots, ids,
                                             None, hot, R, "sum")
    name = "serve shape R=500000 K=C=50000 B=2048 L=150 D=128 f32 sum"
    _check_lists(got_rows, got_pos, want_rows, want_pos, name)
    serve_cmp = compare(raw, want,
                        _fused_bound(ps._warm_payload, slots, None, hot,
                                     "sum"), name)
    serve_cmp.update(hit_frac=float((slots >= 0).float().mean()),
                     miss_rows=int(got_rows[0].size),
                     miss_positions=int(got_pos[0].size))
    results.append(serve_cmp)
    one.ebc.storage.close()
    del one, ps, table, hot, slots, ids, raw, mrow, mpos, want

    # the law, on a small model: tiered == device, bit for bit
    law = []
    small = dataclasses.replace(
        CONFIG, embedding=dataclasses.replace(
            CONFIG.embedding, num_tables=3, rows=1000, pooling=20,
            shard_pad_tables=0))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 1000, (37, 3, 20)).astype(np.int32)
               for _ in range(4)]
    upd_rows = np.unique(batches[3][:, 1].ravel())[:40]
    upd_vals = rng.normal(size=(upd_rows.size, 128)).astype(np.float32)
    for combine in ("sum", "mean"):
        for fused_on in (True, False):
            device_model = DLRM(dataclasses.replace(
                small, embedding=dataclasses.replace(small.embedding,
                                                     combine=combine)),
                device="cuda", seed=3)
            twin = _tiered_twin(device_model, combine, PSConfig(
                hot_rows=100, warm_slots=200, warm_backing="device",
                fused_lookup=fused_on), trace=batches[0])
            steps = []
            for step in ("hot set", "warm", "refresh", "update"):
                if step == "refresh":
                    check(twin.ebc.storage.refresh()["replanned"],
                          "refresh did not re-plan")
                if step == "update":
                    for st in (device_model.ebc.storage, twin.ebc.storage):
                        st.begin_update(1)
                        st.apply_update(1, upd_rows, upd_vals)
                        st.commit_update(1)
                idx = batches[3 if step == "update" else 1]
                with torch.no_grad():
                    a = device_model.ebc(torch.from_numpy(idx).cuda())
                    b = twin.ebc(idx)
                check(bool(torch.equal(a, b)),
                      f"tiered != device ({combine}, fused={fused_on}, "
                      f"{step}): max diff {(a - b).abs().max().item():.3e}")
                steps.append(step)
            law.append({"combine": combine, "fused": fused_on,
                        "steps": steps, "equal": True})
            twin.ebc.storage.close()
    f32 = [r for r in results if not r["case"].startswith("bfloat16")]
    return {"cases": len(results),
            "max_abs_err_f32": max(r["max_abs_err"] for r in f32),
            "max_err_over_bound": max(r["max_err_over_bound"]
                                      for r in results),
            "serve_shape": serve_cmp, "law": law, "results": results}


# the dot interaction's parity cases: (name, B, F, D, dtype); the first two
# are the two benchmark models' shapes, timed too
INTERACTION_CASES = (
    ("serve", 2048, 251, 128, torch.float32),
    ("benchmark", 16384, 9, 64, torch.float32),
    ("serve_bf16", 2048, 251, 128, torch.bfloat16),
    ("benchmark_bf16", 16384, 9, 64, torch.bfloat16),
    # F = 37 is no multiple of the 8 x 12 tile, B = 13 is below the grid;
    # D = 100 leaves a last chunk of 36 columns
    ("ragged_tiled", 13, 37, 100, torch.float32),
    # rows of 132 and 72 bytes: loaded element by element
    ("rows_132B", 13, 37, 33, torch.float32),
    ("rows_72B_bf16", 13, 37, 36, torch.bfloat16),
    # the one-warp path: B = 13 is no multiple of its 8 samples a block
    ("small_ragged", 13, 9, 33, torch.float32),
    ("small_largest_f", 29, 32, 16, torch.float32),
    ("tiled_f33", 7, 33, 128, torch.float32),
    # 1,925 tiles: six passes, chunks of 8 columns (two stages of 64 would
    # not fit); and D = 2000 on the tiled path at F = 5
    ("passes", 5, 600, 64, torch.float32),
    ("wide_d", 3, 5, 2000, torch.float32),
)
INTERACTION_GRAD_CASES = ((64, 251, 128), (256, 9, 64), (13, 37, 33))
# ragged: name, table rows, bag sizes, dim, tables' dtype, batch; the
# last case keeps dlrm-dcnv2's bag sizes and dim with its tables cut to
# 100,000 rows at most (the full-width forward follows)
RAGGED_CASES = (
    ("small", (3, 10, 40, 1000, 7), (1, 3, 2, 12, 1), 16, torch.float32,
     13),
    ("small_bf16", (3, 10, 40, 1000, 7), (1, 3, 2, 12, 1), 16,
     torch.bfloat16, 13),
    ("scalar", (50, 70, 9), (5, 33, 1), 99, torch.float32, 9),
    ("dcnv2_bags", tuple(min(r, 100_000) for r in DCNV2.embedding.table_rows),
     DCNV2.embedding.table_pooling, 128, torch.bfloat16, 513),
)
RAGGED_STACKED = (6, 5000, 20, 128, 257)   # T, R, L, D, B: equal tables
RAGGED_BATCH = 8192                        # the benchmark cell's batch
# towers: the benchmark's five cells' MLP towers (name, batch, widths,
# final ReLU): dlrm-production (its three cells), dlrm-benchmark
# (bench/configs/dlrm-benchmark.json: 512 dense inputs, 64 + C(9, 2) =
# 100 interaction features) and dlrm-dcnv2
TOWER_SHAPES = (
    ("production.bottom", 2048, (CONFIG.dense_features, *CONFIG.bottom_mlp),
     True),
    ("production.top", 2048, (CONFIG.interaction_dim(), *CONFIG.top_mlp),
     False),
    ("benchmark.bottom", 16384, (512, 512, 64), True),
    ("benchmark.top", 16384, (100, 1024, 1024, 1024, 1), False),
    ("dcnv2.bottom", 8192, (DCNV2.dense_features, *DCNV2.bottom_mlp), True),
    ("dcnv2.top", 8192, (DCNV2.interaction_dim(), *DCNV2.top_mlp), False),
)
TOWER_ITERS = 20
TOWER_SPIN_CYCLES = 200_000_000     # ~0.1 s at 1,980 MHz: the queue fills
TOWER_GAP_LIMIT = 1e-4      # bench/harness/check.py's logit_gap limit


def _interaction_inputs(batch, features, dim, dtype, seed, offset=0):
    """bottom_out [B, D] and pooled [B, F - 1, D], drawn on the card; with
    `offset` both start that many elements into their buffers."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for shape in ((batch, dim), (batch, features - 1, dim)):
        n = int(np.prod(shape))
        buf = torch.empty(n + offset, device="cuda", dtype=dtype)
        buf[offset:] = torch.randn(n, generator=gen, device="cuda")
        out.append(buf[offset:].view(shape))
    return out


def _gamma(n: int) -> float:
    """Higham's gamma_n for float32: a sum of n products in any order is
    within gamma_n * sum |products| of the exact sum."""
    u = 2.0 ** -24
    return n * u / (1 - n * u)


def phase_interaction() -> dict:
    """Hold the dot-interaction kernel to `dot_interaction_ref` on the card
    (TF32 off), time it at the two benchmark shapes, and check the plain
    backward of its autograd route.

    f32: each side sums the D products of a pair in its own order (the
    kernel along d, cuBLAS in its tiles), and each is within
    gamma_D * sum_d |x_id x_jd| of the exact sum, so the two are within
    twice that. bf16: the kernel rounds an f32 sum once on store, so it is
    held to the plain version on the f32 upcast of the same inputs,
    unrounded, within 2^-8 of its magnitude beside that bound. x_0's
    columns are copied: equal bit for bit. The backward's entries are sums
    of F terms, in one bmm of (S + S^T) against autograd's two: 4 gamma_F
    of the same sum of magnitudes."""
    results, timed, grads = [], {}, []
    failed = []
    for name, batch, features, dim, dtype in INTERACTION_CASES:
        for offset in ((0, 1) if name == "ragged_tiled" else (0,)):
            bottom, pooled = _interaction_inputs(batch, features, dim, dtype,
                                                 seed=len(results),
                                                 offset=offset)
            before = interaction.LAUNCHES
            got = interaction.dot_interaction_cuda(bottom, pooled)
            torch.cuda.synchronize()
            info = interaction.last_launch_info()
            expect(failed, interaction.LAUNCHES == before + 1,
                   f"{name}: {interaction.LAUNCHES - before} launches")
            want = interaction.dot_interaction_ref(bottom.float(),
                                                   pooled.float())
            mag = interaction.dot_interaction_ref(bottom.double().abs(),
                                                  pooled.double().abs())
            bound = 2 * _gamma(dim) * mag[:, dim:]
            if dtype == torch.bfloat16:
                bound = bound * (1 + 2.0 ** -8) + 2.0 ** -8 * \
                    want[:, dim:].double().abs()
            del mag
            expect(failed, torch.equal(got[:, :dim], bottom),
                   f"{name}: x_0 not copied bit for bit")
            case = f"{name} B={batch} F={features} D={dim} {dtype} " \
                f"offset={offset}"
            cmp = compare(got[:, dim:], want[:, dim:], bound, case)
            results.append({**cmp, "path": info["path"],
                            "threads": info["threads"],
                            "chunk": info["chunk"],
                            "passes": info["passes"], "grid": info["grid"]})
            del got, want, bound
            if name in ("serve", "benchmark"):
                timed[name] = _interaction_time(bottom, pooled, info)
            del bottom, pooled
    for batch, features, dim in INTERACTION_GRAD_CASES:
        grads.append(_interaction_grad_case(batch, features, dim))
    torch.cuda.empty_cache()
    return {"cases": len(results), "failed": failed,
            "max_err_over_bound": max(r["max_err_over_bound"]
                                      for r in results),
            "max_abs_err_f32": max(r["max_abs_err"] for r in results
                                   if "float32" in r["case"]),
            "results": results, "grad": grads, "timed": timed}


def _interaction_time(bottom, pooled, info) -> dict:
    """Kernel, plain version and the two library calls that compute the
    pairs (the Gram bmm and the gather) by CUDA events, beside the bound:
    FLOPs 2D - 1 a pair over the f32 FMA peak, or each input row read and
    each output row written once over HBM bandwidth."""
    batch, t, dim = pooled.shape
    f = t + 1
    pairs = f * (f - 1) // 2
    item = bottom.element_size()
    flops = batch * pairs * (2 * dim - 1)
    moved = batch * f * dim * item + batch * (dim + pairs) * item
    ops_ms = flops / PEAK_FLOPS_F32 * 1e3
    bytes_ms = moved / HBM_BW * 1e3
    ms = cuda_ms(lambda: interaction.dot_interaction_cuda(bottom, pooled),
                 iters=100, warmup=20)
    plain_ms = cuda_ms(lambda: interaction.dot_interaction_ref(bottom,
                                                               pooled),
                       iters=5)
    feats = torch.cat([bottom[:, None, :], pooled], dim=1)
    iu, ju = torch.triu_indices(f, f, offset=1, device="cuda")
    library_ms = cuda_ms(lambda: torch.bmm(feats, feats.transpose(1, 2))[
        :, iu, ju], iters=5)
    del feats
    return {"shape": [batch, f, dim], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "torch.bmm + the pair gather",
            "flops": flops, "bytes_moved": moved,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
            "fraction_of_bound": max(ops_ms, bytes_ms) / ms,
            "achieved_tflops": flops / ms / 1e9, **info}


def _interaction_grad_case(batch, features, dim) -> dict:
    """The CUDA route's gradients (kernel forward, plain backward) against
    autograd through `dot_interaction_ref`, both in f32."""
    bottom, pooled = _interaction_inputs(batch, features, dim,
                                         torch.float32, seed=99)
    grad = torch.randn(batch, dim + features * (features - 1) // 2,
                       device="cuda")
    out = []
    for fn in (interaction.dot_interaction, interaction.dot_interaction_ref):
        b = bottom.clone().requires_grad_()
        p = pooled.clone().requires_grad_()
        out.append(torch.autograd.grad(fn(b, p), (b, p), grad))
    # sum over f of |S + S^T|[r, f] |x[f, d]|, in float64
    x = torch.cat([bottom[:, None], pooled], 1).double().abs()
    iu, ju = torch.triu_indices(features, features, 1, device="cuda")
    s = torch.zeros(batch, features, features, device="cuda",
                    dtype=torch.float64)
    s[:, iu, ju] = grad[:, dim:].double().abs()
    mag = torch.bmm(s + s.transpose(1, 2), x)
    u = 2.0 ** -24
    bound = 4 * _gamma(features) * mag
    # bottom_out's gradient adds z's first D columns: one more rounding
    bounds = (bound[:, 0] + 2 * u * (grad[:, :dim].double().abs()
                                     + mag[:, 0]),
              bound[:, 1:])
    cmp = [compare(g, w, bd, f"grad {name} B={batch} F={features} D={dim}")
           for g, w, bd, name in zip(out[0], out[1], bounds,
                                     ("bottom_out", "pooled"))]
    return {"shape": [batch, features, dim],
            "max_abs_err": max(c["max_abs_err"] for c in cmp),
            "max_err_over_bound": max(c["max_err_over_bound"] for c in cmp)}


def _ragged_indices(rows, bags, batch: int, gen) -> torch.Tensor:
    """[batch, sum(bags)] int32 on the card: table t's ids uniform in
    [0, rows[t]) at its own columns."""
    return torch.cat([torch.randint(0, r, (batch, l), generator=gen,
                                    device="cuda", dtype=torch.int32)
                      for r, l in zip(rows, bags)], dim=1)


def _ragged_launch(tables, idx, layout, opts=kernel.LaunchGeometry()):
    dev = tables.device
    return kernel.embedding_bag_ragged_cuda(
        tables, idx,
        torch.tensor(layout.row_offsets(), dtype=torch.int64, device=dev),
        torch.tensor(layout.col_offsets(), dtype=torch.int32, device=dev),
        torch.tensor(layout.table_order(), dtype=torch.int32, device=dev),
        opts)


def phase_ragged() -> dict:
    """Hold the ragged-tables bag kernel (`csrc/ragged_bag.cu`) to its plain
    version `ref.ragged_tables_bag_ref`, and to the stacked kernel bit for
    bit on equal f32 tables; then run dlrm-dcnv2 at full width through
    `DLRM.forward` and time the kernel there.

    Both sides sum the rows widened to f32 exactly, each in its own order,
    so the kernel is held to `2·eps_f32·Σ|x|` an entry. Out-of-range ids
    give NaN bags. The full-width forward: every logit finite, one bag
    launch, the kernel's time beside its byte bound (each distinct row,
    each index and each f32 bag once), the plain version's and
    `F.embedding_bag`'s time on the same ids, and the largest activation
    after each cross layer (the init's check)."""
    failed, results = [], []
    gen = torch.Generator(device="cuda").manual_seed(7)
    eps = float(torch.finfo(torch.float32).eps)
    for name, rows, bags, dim, dtype, batch in RAGGED_CASES:
        layout = kernel.RaggedLayout(rows, bags)
        tables = (torch.randn((sum(rows), dim), generator=gen,
                              device="cuda") * dim ** -0.5).to(dtype)
        idx = _ragged_indices(rows, bags, batch, gen)
        before = kernel.LAUNCHES
        got = _ragged_launch(tables, idx, layout)
        torch.cuda.synchronize()
        info = kernel.ragged_last_launch_info()
        expect(failed, kernel.LAUNCHES == before + 1,
               f"{name}: {kernel.LAUNCHES - before} launches")
        expect(failed, got.dtype == torch.float32,
               f"{name}: pooled in {got.dtype}")
        want = ref.ragged_tables_bag_ref(tables, idx, layout.row_offsets(),
                                         layout.col_offsets())
        bound = 2 * eps * ref.ragged_tables_bag_ref(
            tables.float().abs(), idx, layout.row_offsets(),
            layout.col_offsets())
        results.append({**compare(got, want, bound,
                                  f"{name} B={batch} D={dim} {dtype}"),
                        "ring_depth": info["ring_depth"],
                        "registers": info["registers"],
                        "local_bytes": info["local_bytes"]})
    # ids outside [0, R_t) make their bag NaN, and no other
    rows, bags = (50, 70, 9), (5, 33, 1)
    layout = kernel.RaggedLayout(rows, bags)
    tables = torch.randn((sum(rows), 32), generator=gen, device="cuda")
    idx = _ragged_indices(rows, bags, 4, gen)
    idx[0, 5] = -1            # table 1's first id of sample 0
    idx[2, 38] = 9            # table 2's one id of sample 2, out of 9 rows
    got = _ragged_launch(tables, idx, layout)
    nan = torch.zeros((4, 3), dtype=torch.bool, device="cuda")
    nan[0, 1] = nan[2, 2] = True
    expect(failed, torch.equal(torch.isnan(got).any(dim=2), nan),
           "out-of-range ids: the NaN bags are not exactly the bad ones")
    # equal tables and bag sizes: the stacked kernel's bits
    t_n, r_n, pool, dim, batch = RAGGED_STACKED
    stacked = torch.randn((t_n, r_n, dim), generator=gen, device="cuda")
    idx3 = torch.randint(0, r_n, (batch, t_n, pool), generator=gen,
                         device="cuda", dtype=torch.int32)
    same = torch.equal(
        _ragged_launch(stacked.reshape(t_n * r_n, dim),
                       idx3.reshape(batch, -1),
                       kernel.RaggedLayout((r_n,) * t_n, (pool,) * t_n)),
        kernel.embedding_bag_cuda(stacked, idx3))
    expect(failed, same, "equal f32 tables: not the stacked kernel's bits")
    del tables, idx, got, stacked, idx3
    torch.cuda.empty_cache()
    full = _ragged_full_width(failed)
    return {"cases": len(results), "failed": failed,
            "stacked_bit_for_bit": same,
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "max_err_over_bound": max(r["max_err_over_bound"]
                                      for r in results),
            "results": results, "full_width": full}


def _ragged_abs_sums(tables, idx, layout) -> torch.Tensor:
    """Σ|x| of each ragged bag over its rows widened to f32, [B, T, D]:
    `ref.ragged_tables_bag_ref` on |tables|, one table's rows at a time
    (a whole f32 |tables| of dlrm-dcnv2 would be 104.5 GB)."""
    ro, co = layout.row_offsets(), layout.col_offsets()
    return torch.stack(
        [tables[idx[:, co[t]:co[t + 1]].long() + ro[t]].float().abs().sum(1)
         for t in range(layout.num_tables)], dim=1)


def _ragged_full_width(failed: list) -> dict:
    """dlrm-dcnv2 at its published widths on `DLRM.forward`, uniform ids,
    batch 8,192: the pooled bags held to the plain version at the small
    cases' 2·eps·Σ|x| bound (here row offsets times the row stride pass
    2**31 elements), then timed."""
    cfg = DCNV2
    emb = cfg.embedding
    layout = emb.layout()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DLRM(cfg, device="cuda", seed=0).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(11)
    idx = _ragged_indices(emb.table_rows, emb.table_pooling, RAGGED_BATCH,
                          gen)
    dense = torch.rand((RAGGED_BATCH, cfg.dense_features), generator=gen,
                       device="cuda")
    kernel.LAUNCHES = 0
    with torch.inference_mode():
        logits = model(dense, idx)
        torch.cuda.synchronize()
        launches = kernel.LAUNCHES
        info = kernel.ragged_last_launch_info()
        expect(failed, launches == 1, f"full width: {launches} bag launches")
        expect(failed, logits.shape == (RAGGED_BATCH,)
               and bool(torch.isfinite(logits).all()),
               "full width: logits not finite")
        pooled = model.ebc(idx)
        want = ref.ragged_tables_bag_ref(model.ebc.tables, idx,
                                         layout.row_offsets(),
                                         layout.col_offsets())
        bound = 2 * float(torch.finfo(torch.float32).eps) * _ragged_abs_sums(
            model.ebc.tables, idx, layout)
        err = (pooled - want).abs()
        max_abs_err = float(err.max())
        over = float((err / bound.clamp_min(1e-30)).max())
        expect(failed, bool(torch.isfinite(pooled).all())
               and bool((err <= bound).all()),
               f"full width: pooled bags off the plain version by "
               f"{max_abs_err:.3e}, {over:.3f} of the 2·eps·Σ|x| bound")
        del want, bound, err
        x0 = torch.cat([model.bottom(dense, final_act=True),
                        pooled.reshape(RAGGED_BATCH, -1)], dim=1)
        x, cross_max = x0, []
        for i in range(cfg.dcn_layers):
            y = torch.addmm(model.cross.get_parameter(f"b{i}"),
                            x @ model.cross.get_parameter(f"v{i}"),
                            model.cross.get_parameter(f"w{i}"))
            x = torch.addcmul(x, x0, y)
            cross_max.append(float(x.abs().max()))
        forward_ms = cuda_ms(lambda: model(dense, idx), iters=20, warmup=3)
        ms = cuda_ms(lambda: model.ebc(idx), iters=50, warmup=5)
        flat = (idx.long() + torch.repeat_interleave(
            torch.tensor(layout.row_offsets()[:-1], device="cuda"),
            torch.tensor(layout.pooling, device="cuda"))).reshape(-1)
        plain_ms = cuda_ms(lambda: ref.ragged_tables_bag_ref(
            model.ebc.tables, idx, layout.row_offsets(),
            layout.col_offsets()), iters=3)
        offsets = (torch.arange(RAGGED_BATCH, device="cuda")[:, None]
                   * layout.cols + torch.tensor(
                       layout.col_offsets()[:-1], device="cuda")).reshape(-1)
        library_ms = cuda_ms(lambda: F.embedding_bag(
            flat, model.ebc.tables, offsets, mode="sum"), iters=10)
    distinct = int(torch.unique(flat).numel())
    moved = (distinct * emb.dim * emb.torch_dtype.itemsize
             + idx.numel() * 4 + RAGGED_BATCH * emb.num_tables * emb.dim * 4)
    bound_ms = moved / HBM_BW * 1e3
    out = {"tables": emb.num_tables, "rows": sum(emb.table_rows),
           "table_bytes": emb.table_bytes(),
           "dense_params": sum(p.numel() for p in model.parameters()),
           "build_s": build_s, "batch": RAGGED_BATCH,
           "lookups": idx.numel(), "distinct_rows": distinct,
           "bag_launches": launches, "max_abs_err": max_abs_err,
           "max_err_over_bound": over,
           "logits_abs_max": float(logits.abs().max()),
           "logits_std": float(logits.std()),
           "pooled_abs_max": float(pooled.abs().max()),
           "cross_abs_max": cross_max, "forward_ms": forward_ms,
           "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "F.embedding_bag over the flat ids and offsets",
           "bytes_moved": moved, "bound_ms": bound_ms,
           "fraction_of_bound": bound_ms / ms,
           "peak_bytes": torch.cuda.max_memory_allocated(), **info}
    del model, idx, dense, logits, pooled, x0, x, y, flat, offsets
    gc.collect()
    torch.cuda.empty_cache()
    return out


def queued_device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device ms a call of `fn`, its launches queued behind a spin kernel
    (`torch.cuda._sleep`) so the device runs them back to back: a host
    slower than the kernels (a busy CPU, a heuristic query a call) is not
    timed, unlike `cuda_ms`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(TOWER_SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_kernels(fn, reps: int = 3) -> list:
    """The names of the device kernels a call of `fn` launches, in order
    of first launch (torch.profiler over `reps` calls; a name launched
    fewer than `reps` times is another call's, flushed late), or the
    profiler's error."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except Exception as exc:    # the profiler is untried on that machine
        return [f"profiler failed: {exc!r}"]
    names = collections.Counter(ev.name for ev in prof.events()
                                if "cuda" in str(ev.device_type).lower())
    return [name for name, n in names.items() if n >= reps]


def phase_towers() -> dict:
    """The MLP towers of the benchmark's five cells on the card, under
    `inference_mode`: the fused forward (bias and ReLU in each product's
    epilogue) against the composed one, whole and layer by layer: device
    ms (`queued_device_ms`), the kernels each launches, the gap relative to the
    composed output's largest entry, and `epilogue_layers`' count."""
    failed: list = []
    gen = torch.Generator(device="cuda").manual_seed(28)
    towers = []
    with torch.inference_mode():
        for name, batch, dims, final_act in TOWER_SHAPES:
            tower = MLPTower(dims, torch.float32, generator=gen,
                             device="cuda")
            for i in range(tower.num_layers):      # a bias that matters
                getattr(tower, f"b{i}").normal_(0.0, 0.05, generator=gen)
            x = torch.randn((batch, dims[0]), generator=gen, device="cuda")
            ws = [getattr(tower, f"w{i}") for i in range(tower.num_layers)]
            bs = [getattr(tower, f"b{i}") for i in range(tower.num_layers)]
            fused_fn = lambda: tower(x, final_act=final_act)  # noqa: E731
            composed_fn = lambda: tower.run_layers(  # noqa: E731
                x, ws, bs, final_act, fuse=False)
            tower.epilogue_layers = 0
            got = fused_fn()
            counted = tower.epilogue_layers
            want = composed_fn()
            gap = ((got - want).abs().max() / want.abs().max()).item()
            layers = []
            h = x
            for i, (w, b) in enumerate(zip(ws, bs)):
                relu = i < tower.num_layers - 1 or final_act
                op = torch._addmm_activation if relu else torch.addmm
                one = lambda: op(b, h, w)  # noqa: E731
                two = lambda: (torch.relu(h @ w + b) if relu  # noqa: E731
                               else h @ w + b)
                kernels = _device_kernels(one)
                layers.append({
                    "m_k_n": [batch, w.shape[0], w.shape[1]], "relu": relu,
                    "fused_ms": queued_device_ms(one, TOWER_ITERS),
                    "composed_ms": queued_device_ms(two, TOWER_ITERS),
                    "fused_kernels": kernels,
                    "composed_kernels": _device_kernels(two)})
                extra = [k for k in kernels if "elementwise" in k]
                expect(failed, not extra or w.shape[1] == 1,
                       f"{name} layer {i}: the fused call launched {extra}")
                h = one()
            out = {"name": name, "batch": batch, "dims": list(dims),
                   "final_act": final_act,
                   "fused_ms": queued_device_ms(fused_fn, TOWER_ITERS),
                   "composed_ms": queued_device_ms(composed_fn,
                                                   TOWER_ITERS),
                   "gap": gap, "epilogue_layers": counted,
                   "fused_kernels": _device_kernels(fused_fn),
                   "layers": layers}
            out["speedup"] = out["composed_ms"] / out["fused_ms"]
            pays = sum(epilogue_pays(*w.shape) for w in ws)
            expect(failed, counted == pays,
                   f"{name}: {counted} layers through the epilogue, "
                   f"{pays} wanted")
            expect(failed, gap <= TOWER_GAP_LIMIT,
                   f"{name}: fused against composed {gap:.3e}")
            towers.append(out)
            del tower, x, ws, bs, got, want, h
    torch.cuda.empty_cache()
    return {"towers": towers,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "failed": failed}


def kernel_row(name, source, replaces, launches, max_abs_err, ms, plain_ms,
               bound_ms, bound_by, library_ms, info, **extra) -> dict:
    """One kernel of the final `kernels` line."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "registers": info["registers"],
            "blocks_per_sm": info["blocks_per_sm"],
            "fraction_of_bound": bound_ms / ms, **extra}


def ragged_kernel_row(ragged: dict) -> dict:
    """The ragged bag kernel's row of the `kernels` line, from the
    `ragged` phase: timed at dlrm-dcnv2's full width, its error the
    largest of the small cases and the full-width forward."""
    full = ragged["full_width"]
    return kernel_row(
        "ragged_bag", "src/repro_torch/kernels/embedding_bag/csrc/"
        "ragged_bag.cu", None, full["bag_launches"],
        max(ragged["max_abs_err"], full["max_abs_err"]), full["kernel_ms"],
        full["plain_ms"], full["bound_ms"], "bytes", full["library_ms"],
        full, max_err_over_bound=max(ragged["max_err_over_bound"],
                                     full["max_err_over_bound"]))


def host_available_bytes() -> int:
    """Host memory this process may still take: MemAvailable, or less
    where a cgroup limit is set (a container reports its host's memory in
    /proc/meminfo)."""
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            limit = f.read().strip()
        with open("/sys/fs/cgroup/memory.current") as f:
            used = int(f.read())
        if limit != "max":
            avail = min(avail, int(limit) - used)
    except OSError:
        pass
    return avail


def host_rss_bytes() -> int | None:
    """This process's resident set now (/proc/self/statm), or None where
    the file is missing."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


def host_peak_rss_bytes() -> int:
    """This process's peak resident set (getrusage's ru_maxrss, in KiB on
    Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def tiered_host_bytes_per_table(ps_cfg, batch: int, pooling: int, rows: int,
                                dim: int) -> int:
    """Host bytes a table of the tiered backend holds while serving: the
    cold tier, the plans' two int64 [R] permutations, the warm tag store
    (three int64 [C] arrays and the row -> slot dict), and the staged
    payloads of prefetch_depth future batches plus the one being consumed:
    their distinct cold rows, at most med_hot's share of unique rows per
    batch (20.5 % of B·L)."""
    staged_rows = int(PAPER_UNIQUE_PCT["med_hot"] / 100 * batch * pooling)
    return (rows * dim * 4 + 2 * rows * 8
            + ps_cfg.warm_slots * (3 * 8 + LOC_ENTRY_BYTES)
            + (ps_cfg.prefetch_depth + 1) * staged_rows * dim * 4)


def phase_serve_tiered(model, batches, serve_logits, deadline_s: float):
    """The same weights and batches as phase serve, on the tiered backend.
    Takes `model` apart: its tables go to the host, its MLPs are reused,
    and its device tables are freed before the tiers are built. Returns
    (fields, the session, the tiered model) — the session stays open so
    phase kernel_time_fused finds the warm state serving left."""
    emb = dataclasses.replace(model.cfg.embedding, storage="tiered")
    T, R, L, D = emb.num_tables, emb.rows, emb.pooling, emb.dim
    B = batches[0][1].shape[0]
    ps_cfg = tier_ps_config(R)
    per_table = tiered_host_bytes_per_table(ps_cfg, B, L, R, D)
    avail = host_available_bytes()
    rss = {"start": host_rss_bytes()}
    fit = (avail - HOST_HEADROOM_BYTES) // per_table
    cut = None
    if fit < T:
        cut = {"num_tables": [T, int(fit)],
               "reason": f"{avail} bytes of host memory available, "
                         f"{per_table} needed per table"}
        T = int(fit)
        emb = dataclasses.replace(emb, num_tables=T)
        batches = [(d, i[:, :T].copy()) for d, i in batches]
    t1 = time.perf_counter()
    host_tables = model.ebc.tables[:T].cpu()
    model.ebc.tables = None            # free the device copy (64 GB)
    gc.collect()
    torch.cuda.empty_cache()
    to_host_s = time.perf_counter() - t1
    rss["tables_on_host"] = host_rss_bytes()
    tiered = DLRM(dataclasses.replace(model.cfg, embedding=emb),
                  device="cuda", tables=host_tables, seed=0)
    # the top MLP's input width follows T: after a cut the model keeps its
    # own, and its logits are not phase serve's
    tiered.bottom = model.bottom
    if cut is None:
        tiered.top = model.top
    del host_tables
    pattern = make_pattern("med_hot", R, seed=0)
    trace = sample_indices(pattern, B, T, L, seed=TRACE_SEED)
    t1 = time.perf_counter()
    tiered.ebc.storage.build(ps_cfg, trace=trace)
    build_s = time.perf_counter() - t1
    del trace
    rss["tiers_built"] = host_rss_bytes()
    torch.cuda.reset_peak_memory_stats()
    scores = []
    fused.LAUNCHES = 0
    kernel.LAUNCHES = 0
    t1 = time.perf_counter()
    sess = ServingSession(tiered, batcher=BatcherConfig(max_batch=B,
                                                        max_wait_s=0.0))
    warmup_s = time.perf_counter() - t1
    sess.server.on_batch = lambda batch, s: scores.append(s.copy())
    for dense, idx in batches:
        sess.submit_batch(dense, idx)
    rss["warmed_up"] = host_rss_bytes()
    sess.drain(timeout_s=deadline_s)
    rss["served"] = host_rss_bytes()
    fused_launches, bag_launches = fused.LAUNCHES, kernel.LAUNCHES
    lat = np.asarray(sess.stats.batch_latencies_s) * 1e3
    forwards = 1 + len(lat)                       # warmup + served batches
    check(len(lat) == len(batches) and sess.stats.served == B * len(lat),
          f"served {sess.stats.served} queries in {len(lat)} batches")
    check(fused_launches == forwards,
          f"fused kernel launched {fused_launches} times over {forwards} "
          f"forwards")
    logits = np.concatenate(scores)
    check(bool(np.isfinite(logits).all()), "non-finite logits")
    max_diff = sub_batch = None
    if cut is None:
        max_diff = float(np.abs(logits - serve_logits).max())
        check(bool(np.allclose(logits, serve_logits, rtol=1e-4, atol=1e-4)),
              f"tiered logits differ from phase serve's by {max_diff:.3e}")
    else:
        # a sub-batch's pooled output against the plain pooling of the same
        # rows of the host tables
        idx64 = batches[0][1][:SUB_BATCH]
        rows = torch.from_numpy(tiered.ebc.storage.ps.cold.tables[
            np.arange(T)[None, :, None], idx64])          # [64, T, L, D]
        with torch.no_grad():
            got = tiered.ebc(idx64).cpu()
        sub_batch = compare(got, _pool_rows_core(rows, None, emb.combine),
                            2 * ref.F32_EPS * rows.abs().sum(dim=2),
                            "tiered sub-batch pooled (after a cut)")
        del rows
    st = sess.stats.storage_stats
    keys = ("total_accesses", "hot_hits", "warm_hits", "cold_misses",
            "hot_hit_rate", "warm_hit_rate", "cold_miss_rate",
            "cache_hit_rate", "cold_gathered_rows", "evictions",
            "insertions", "warm_occupancy", "staged_rows", "prefetch_hits",
            "prefetch_misses", "queue_depth", "max_queue_depth",
            "off_critical_frac", "consume_ready", "consume_waited",
            "consume_wait_s", "consume_overlap_frac")
    fields = dict(
        config="dlrm_production", backend="tiered", tables=T, rows=R,
        dim=D, pooling=L, batch=B, cut=cut, ps_config=dataclasses.asdict(
            ps_cfg), batches=len(lat), batch_ms=lat.tolist(),
        p50_batch_ms=float(np.percentile(lat, 50)),
        p99_batch_ms=float(np.percentile(lat, 99)),
        fused_launches=fused_launches, bag_kernel_launches=bag_launches,
        forwards=forwards, logits_max_abs_diff_vs_serve=max_diff,
        logits_tolerance="rtol=1e-4 atol=1e-4", sub_batch_after_cut=sub_batch,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        device_tier_bytes=ps_cfg.device_bytes(T, D),
        host_available_bytes=avail, host_bytes_estimate=per_table * T,
        host_bytes_per_table_estimate=per_table,
        host_peak_rss_bytes=host_peak_rss_bytes(), host_rss_bytes=rss,
        host_peak_growth_bytes=(host_peak_rss_bytes() - rss["start"]
                                if rss["start"] is not None else None),
        tables_to_host_s=to_host_s,
        build_s=build_s, warmup_s=warmup_s,
        stats={k: st[k] for k in keys if k in st})
    return fields, sess, tiered, batches


def phase_kernel_time_fused(sess, tiered, batches) -> dict:
    """Fused kernel at the serve shape with the warm state serving left:
    the kernel held to its plain version on every table (pooled within
    the summation bound, miss lists exactly equal); CUDA-event times of
    the kernel, its plain version and a torch embedding_bag over
    [hot; cache] (pooled half only); the bound; and a breakdown of one
    tiered batch."""
    ps = sess.storage.ps
    dense_np, idx_np = batches[0]
    B, T, L = idx_np.shape
    D, R = ps.cold.dim, ps.cold.num_rows
    K, C = ps.num_hot, ps.cfg.warm_slots
    dev = torch.device("cuda")
    slots = torch.from_numpy(ps.build_slot_map(idx_np)).to(dev)
    ids = torch.from_numpy(idx_np).to(dev)
    hot = ps._hot_dev
    cache = ps._warm_payload
    opts = fused.FusedLookupOpts()
    run = lambda: fused.launch_tables(cache, slots, ids, None, hot, R,  # noqa: E731
                                      opts)
    ms = cuda_ms(run, iters=10, warmup=2)
    pool_ms, lists_ms_dev = fused_pass_ms(cache, slots, ids, hot, R, opts,
                                          iters=5)
    raw, mrow, mpos, counts = run()
    info = fused.last_launch_info()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    miss_rows, miss_pos = fused.lists_to_host(mrow, mpos, counts)
    lists_ms = (time.perf_counter() - t1) * 1e3
    n_distinct = sum(int(r.size) for r in miss_rows)
    n_occ = sum(int(p.size) for p in miss_pos)

    def plain():
        out = []
        for t in range(T):
            out.append(fused.fused_warm_lookup_plain(
                cache[t], slots[:, t], ids[:, t], None, hot[t], num_rows=R))
            s, r = slots[:, t].reshape(-1), ids[:, t].reshape(-1)
            miss = torch.nonzero(s == fused.MISS).flatten()
            torch.unique(r[miss])
        return torch.stack(out, 1)
    plain_ms = cuda_ms(plain, iters=1)
    name = (f"serve shape, served warm state: B={B} T={T} L={L} D={D} "
            f"K=C={K} f32 sum")
    held = compare(raw, plain(), _fused_bound(cache, slots, None, hot, "sum"),
                   name)
    slots_np = slots.cpu().numpy()
    want = [fused._miss_list_from_slots(slots_np[:, t], idx_np[:, t], R)
            for t in range(T)]
    _check_lists(miss_rows, miss_pos, [w[0] for w in want],
                 [w[1] for w in want], name)
    del slots_np, want

    # the library yardstick: F.embedding_bag over [hot; cache] per table,
    # the slot map as indices and 0/1 weights — the pooled half only
    both = torch.cat([hot, cache], dim=1).view(-1, D)       # [T(K+C), D]
    flat = (slots.long().clamp_min(0)
            + torch.arange(T, device=dev)[None, :, None] * (K + C)).reshape(-1)
    psw = (slots >= 0).float().reshape(-1)
    offsets = torch.arange(0, flat.numel(), L, device=dev)
    library = lambda: F.embedding_bag(flat, both, offsets, mode="sum",  # noqa: E731
                                      per_sample_weights=psw)
    library_ms = cuda_ms(library, iters=3)
    library_err = (library().view(B, T, D) - raw).abs().max().item()
    del both, flat, psw, offsets

    # bytes the function must move: each distinct hit row once, the slot
    # map, the row ids at MISS positions, the output, the bitmap pass and
    # the miss lists; operations: a multiply-add per hit element
    hit_rows = 0
    for t in range(T):
        s = slots[:, t]
        hit_rows += int(torch.unique(s[s >= 0]).numel())
    words = -(-R // 32)
    moved = (hit_rows * D * 4 + slots.numel() * 4 + n_occ * 4
             + raw.numel() * 4 + T * words * 4 + (n_distinct + n_occ) * 4
             + counts.numel() * 4)
    hits = int((slots >= 0).sum())
    bytes_ms = moved / HBM_BW * 1e3
    ops_ms = hits * D * 2 / PEAK_FLOPS_F32 * 1e3

    # one tiered batch, step by step (device synchronised at each step)
    ps.breakdown = {}
    t1 = time.perf_counter()
    with torch.no_grad():
        pooled = tiered.ebc(idx_np)
    torch.cuda.synchronize()
    lookup_s = time.perf_counter() - t1
    breakdown = {k: v * 1e3 for k, v in ps.breakdown.items()}
    ps.breakdown = None
    with torch.inference_mode():
        dense = torch.from_numpy(dense_np).cuda()
        breakdown["mlps_and_interaction"] = cuda_ms(
            lambda: tiered.forward_from_pooled(dense, pooled), iters=5)
    breakdown["lookup_total_host_clock"] = lookup_s * 1e3
    return dict(
        shape=[B, T, L, D], hot_rows=K, warm_slots=C, ms=ms,
        pool_pass_ms=pool_ms, list_pass_ms=lists_ms_dev, plain_ms=plain_ms,
        plain_max_abs_err=held["max_abs_err"],
        plain_max_err_over_bound=held["max_err_over_bound"],
        miss_lists_equal=True,
        library_ms=library_ms,
        library="torch.nn.functional.embedding_bag over [hot; cache] with "
                "0/1 per_sample_weights: the pooled half only",
        library_max_abs_diff=library_err, miss_list_copy_ms=lists_ms,
        hit_positions=hits, distinct_hit_rows=hit_rows,
        miss_positions=n_occ, distinct_miss_rows=n_distinct,
        bytes_moved=moved, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
        fraction_of_bound=max(bytes_ms, ops_ms) / ms, **info,
        launches_per_forward=1, breakdown_ms=breakdown)


def _bag_bound_ms(distinct_rows: int, lookups: int, outputs: int,
                  dim: int) -> float:
    """Bytes bound of an f32 bag launch: each distinct row once, the int32
    indices, the output."""
    moved = distinct_rows * dim * 4 + lookups * 4 + outputs * dim * 4
    return moved / HBM_BW * 1e3


def phase_kernel_diag(tables, idx_served, pattern, opts,
                      geometry_sweep: bool) -> dict:
    """Where the bag kernel's time goes, at the serve shape [B, T, L] ->
    [B, T, D] f32 (CUDA events), on three index sets made from the seed:
    (a) the served med_hot batch 0; (b) distinct: each table's B·L lookups
    all different rows, a seeded permutation prefix of R, so every row
    comes from device memory; (c) resident: every lookup from 2,048 rows
    per table (1 MB a table), which L2 holds; (d) one row per table, which
    L1 holds: the loop's own cost. Beside each time, the
    registers per thread and the resident blocks per SM of the
    instantiation launched. Then the completion shape (T=1, B=2048 bags of
    L=150 rows read once, as `fused.pool_bag_rows` launches it), and the
    fused kernel at the serve shape on a slot map made from batch 0 (ranks
    below K+C hit, the rest MISS; hot and cache are views of the tables),
    with its pool and list passes timed apart. With `geometry_sweep`, both
    kernels again at each of seven launch geometries."""
    B, T, L = idx_served.shape
    R, D = tables.shape[1], tables.shape[2]
    dev = tables.device
    gen = torch.Generator(device=dev).manual_seed(13)
    resident_rows = 2048
    idx_distinct = torch.empty_like(idx_served)
    idx_resident = torch.empty_like(idx_served)
    idx_one = torch.empty_like(idx_served)
    resident_distinct = 0
    for t in range(T):
        perm = torch.randperm(R, generator=gen, device=dev)[:B * L].int()
        idx_distinct[:, t] = perm.view(B, L)
        pick = torch.randint(0, resident_rows, (B, L), generator=gen,
                             device=dev)
        idx_resident[:, t] = perm[pick]
        idx_one[:, t] = perm[0]
        resident_distinct += int(torch.unique(idx_resident[:, t]).numel())
    served_distinct = sum(int(torch.unique(idx_served[:, t]).numel())
                          for t in range(T))
    all_lookups_ms = B * T * L * D * 4 / HBM_BW * 1e3
    sets = {}
    for name, idx, distinct in (
            ("a_served", idx_served, served_distinct),
            ("b_distinct", idx_distinct, B * T * L),
            ("c_resident", idx_resident, resident_distinct),
            ("d_one_row", idx_one, T)):
        ms = cuda_ms(lambda: kernel.embedding_bag_cuda(tables, idx, None,
                                                       opts),
                     iters=5, warmup=1)
        bound = _bag_bound_ms(distinct, B * T * L, B * T, D)
        sets[name] = dict(ms=ms, distinct_rows=distinct, bound_ms=bound,
                          fraction_of_bound=bound / ms,
                          lookup_bytes_per_s=B * T * L * D * 4 / ms * 1e3,
                          **kernel.last_launch_info())
    del idx_distinct, idx_resident, idx_one

    # the completion shape: [1, B·L, D] rows read once, indices arange
    n = 2048
    rows = torch.randn((1, n * L, D), generator=gen, device=dev)
    ar = torch.arange(n * L, dtype=torch.int32, device=dev).view(n, 1, L)
    copts = fused.COMPLETION_OPTS
    ms = cuda_ms(lambda: kernel.embedding_bag_cuda(rows, ar, None, copts),
                 iters=20, warmup=2)
    bound = _bag_bound_ms(n * L, n * L, n, D)
    completion = dict(shape=[n, 1, L, D], ms=ms, bound_ms=bound,
                      fraction_of_bound=bound / ms,
                      **kernel.last_launch_info())

    # the fused kernel at the serve shape on a slot map from batch 0
    K = C = R // TIER_FRACTION
    rank = np.empty(R, np.int64)
    rank[pattern.rank_to_row()] = np.arange(R)
    rank_dev = torch.from_numpy(rank).to(dev)
    slots = rank_dev[idx_served.long()]
    slots = torch.where(slots < K + C, slots,
                        torch.full_like(slots, fused.MISS)).int()
    del rank_dev
    hot, cache = tables[:, :K], tables[:, K:K + C]

    fopts = fused.FusedLookupOpts()
    ms = cuda_ms(lambda: fused.launch_tables(cache, slots, idx_served, None,
                                             hot, R, fopts),
                 iters=5, warmup=1)
    pool_ms, lists_ms = fused_pass_ms(cache, slots, idx_served, hot, R,
                                      fopts, iters=5)
    hit_rows = 0
    for t in range(T):
        s = slots[:, t]
        hit_rows += int(torch.unique(s[s >= 0]).numel())
    fused_diag = dict(ms=ms, pool_pass_ms=pool_ms, list_pass_ms=lists_ms,
                      hit_frac=float((slots >= 0).float().mean()),
                      distinct_hit_rows=hit_rows, **fused.last_launch_info())

    # with geometry_sweep, both kernels at each launch geometry: the bag
    # kernel on (a), the fused kernel's pool pass on its slot map, the
    # completion shape
    geometries = (((8, 2), (8, 4), (8, 8), (8, 16), (4, 4), (4, 8), (2, 8))
                  if geometry_sweep else ())
    sweep = []
    for bb, pd in geometries:
        geo = dict(batch_block=bb, prefetch_distance=pd)
        o = dataclasses.replace(opts, **geo)
        bag_ms = cuda_ms(lambda: kernel.embedding_bag_cuda(
            tables, idx_served, None, o), iters=3, warmup=1)
        info = kernel.last_launch_info()
        co = dataclasses.replace(copts, **geo)
        comp_ms = cuda_ms(lambda: kernel.embedding_bag_cuda(
            rows, ar, None, co), iters=20, warmup=2)
        fused_pool_ms = cuda_ms(lambda: fused.pool_tables(
            cache, slots, idx_served, None, hot, R,
            fused.FusedLookupOpts(**geo)), iters=3)
        sweep.append(dict(geo, ring_depth=info["ring_depth"],
                          registers=info["registers"],
                          blocks_per_sm=info["blocks_per_sm"],
                          bag_served_ms=bag_ms, completion_ms=comp_ms,
                          fused_pool_pass_ms=fused_pool_ms,
                          fused_registers=fused.last_launch_info()[
                              "registers"]))
    del slots, hot, cache, rows, ar
    return dict(shape=[B, T, L, D], resident_rows_per_table=resident_rows,
                all_lookups_ms_at_peak=all_lookups_ms, sets=sets,
                sweep=sweep, completion=completion,
                fused_synthetic=fused_diag)


# -- replay, SLO ladder and online updates -----------------------------------

class LookupTap:
    """Wraps a storage backend's `lookup` to record, per forward, the rows
    looked up (the batch, padded or not), the queries in it (from the
    server's `hint_valid`), whether the backend was degraded, and the bag-
    and fused-kernel launches the lookup made; keeps the last lookup's
    indices and pooled output for a check after the batch (outside its
    timed service)."""

    def __init__(self, storage):
        self.storage = storage
        self.records = []
        self.last = None
        self._lookup = storage.lookup
        self._hint_valid = storage.hint_valid
        self._queries = None
        storage.lookup = self
        storage.hint_valid = self.hint_valid

    def hint_valid(self, n: int) -> None:
        self._queries = n
        self._hint_valid(n)

    def __call__(self, indices, weights=None, **kw):
        degraded = self.storage.degraded()
        bag0, fused0 = kernel.LAUNCHES, fused.LAUNCHES
        out = self._lookup(indices, weights, **kw)
        self.records.append({"rows": int(indices.shape[0]),
                             "queries": self._queries,
                             "degraded": degraded,
                             "bag": kernel.LAUNCHES - bag0,
                             "fused": fused.LAUNCHES - fused0})
        self.last = (indices, out)
        return out

    def remove(self) -> None:
        del self.storage.lookup, self.storage.hint_valid


def flash_trace(n: int, t_b: float, batch: int, emb, dense_features: int,
                pattern, seed: int, spike_len_batches: float,
                spike_x: float = 4.0):
    """`n` queries on a `flash` profile: base 0.5x the measured service
    rate (batch / t_b), a spike of `spike_x` x base from one batch time in,
    lasting `spike_len_batches` batch times. Arrivals are the flash
    generator's; indices come from the phase's med_hot `pattern` (one
    rank -> row map for every table, as served batches are made), since
    the tiered tiers were planned from it."""
    base = 0.5 * batch / t_b
    gen = make_traffic("flash", base_qps=base, spike_qps=spike_x * base,
                       spike_start_s=t_b, spike_len_s=spike_len_batches * t_b,
                       num_tables=emb.num_tables, rows=emb.rows,
                       pooling=emb.pooling, dense_features=dense_features,
                       seed=seed)
    return (timed_queries(gen, n, emb, dense_features, pattern, seed),
            gen.profile)


def timed_queries(gen, n: int, emb, dense_features: int, pattern,
                  seed: int) -> list:
    """`n` queries with `gen`'s arrival times and indices from `pattern`."""
    arrivals = gen.arrival_times(n)
    idx = sample_indices(pattern, n, emb.num_tables, emb.pooling, seed=seed)
    dense = np.random.default_rng(seed).normal(
        size=(n, dense_features)).astype(np.float32)
    return [TimedQuery(qid=i, arrival_s=float(arrivals[i]),
                       dense=dense[i], indices=idx[i]) for i in range(n)]


def calibrate_service(model, batch: int, dense, idx) -> np.ndarray:
    """Real service seconds of len(dense) // batch full batches through a
    session without controllers. Only its server is closed: the storage
    serves the replay next."""
    sess = ServingSession(model, batcher=BatcherConfig(max_batch=batch,
                                                       max_wait_s=0.0))
    sess.submit_batch(dense, idx)
    sess.drain(timeout_s=600.0)
    sess.server.close()
    return np.asarray(sess.stats.batch_latencies_s)


def replay_summary(sess, rep, tap, profile, target_ms: float) -> dict:
    """What a replay did: sheds by reason, SLO levels and actions, the
    batch sizes served, the SLO checks that fell inside the spike, and
    batch service times split by degraded and not."""
    tl = rep.timeline
    every = sess.slo.cfg.check_every_batches
    spike_end = profile.spike_start_s + profile.spike_len_s
    checks_in_spike = sum(1 for i, s in enumerate(tl)
                          if (i + 1) % every == 0
                          and profile.spike_start_s <= s.t_s < spike_end)
    lat = np.asarray(sess.stats.batch_latencies_s) * 1e3
    check(len(lat) == len(tap.records) == len(tl),
          f"{len(lat)} batches, {len(tap.records)} lookups, "
          f"{len(tl)} snapshots")
    deg = np.array([r["degraded"] for r in tap.records], bool)
    queries = np.array([r["queries"] for r in tap.records])
    check(int(queries.sum()) == rep.served, "lookups missed queries")

    def split(mask):
        if not mask.any():
            return None
        return {"batches": int(mask.sum()),
                "queries": int(queries[mask].sum()),
                "mean_batch_ms": float(lat[mask].mean()),
                "p50_batch_ms": float(np.percentile(lat[mask], 50)),
                "ms_per_query": float(lat[mask].sum()
                                      / queries[mask].sum())}
    sizes = collections.Counter(r["rows"] for r in tap.records)
    timeline = [[round(s.t_s, 4), s.served, s.shed, s.queue_len,
                 None if s.windowed_p99_ms is None
                 else round(s.windowed_p99_ms, 2), s.slo_level,
                 int(s.degraded), int(q), round(float(ms), 2)]
                for s, q, ms in zip(tl, queries, lat)]
    return dict(
        submitted=rep.submitted, admitted=rep.admitted, served=rep.served,
        shed=rep.shed, shed_frac=rep.shed_frac,
        shed_reasons=dict(sess.stats.shed_reasons),
        slo_target_p99_ms=target_ms,
        final_windowed_p99_ms=rep.final_windowed_p99_ms(),
        max_slo_level=max(s.slo_level for s in tl),
        final_slo_level=tl[-1].slo_level,
        slo_actions=[(e["action"], e["batch"]) for e in sess.slo.events],
        slo_checks_in_spike=checks_in_spike,
        spike_s=[profile.spike_start_s, spike_end],
        trace_end_s=tl[-1].t_s,
        batch_sizes_served=dict(sorted(sizes.items())),
        batches=len(lat), non_degraded=split(~deg), degraded=split(deg),
        bag_launches=sum(r["bag"] for r in tap.records),
        fused_launches=sum(r["fused"] for r in tap.records),
        bag_launches_in_degraded=sum(r["bag"] for r, d in
                                     zip(tap.records, deg) if d),
        percentiles={k: v for k, v in rep.percentiles.items()
                     if k.startswith(("p50", "p99", "slo_", "degraded_",
                                      "served", "shed"))},
        timeline_columns=["t_s", "served", "shed", "queue", "wp99_ms",
                          "level", "degraded", "queries", "service_ms"],
        timeline=timeline)


def phase_replay_device(model, pattern, src) -> dict:
    """dlrm_production on `device` under a flash crowd: service time
    measured at max_batch=256, an SLO of 4x its median with the shrink rung
    down to 32 and the deadline admission at twice the SLO, a flash trace
    (base 0.5x the service rate, spike 4x base) that ends inside its spike,
    so at least 4 SLO checks fall in it. A sample batch's answers are held
    to the plain path on the card."""
    emb, F = model.cfg.embedding, model.cfg.dense_features
    dense, idx = src
    lat = calibrate_service(model, REPLAY_DEVICE_BATCH,
                            dense[:8 * REPLAY_DEVICE_BATCH],
                            idx[:8 * REPLAY_DEVICE_BATCH])
    p99_s, t_b = float(np.percentile(lat, 99)), float(lat.mean())
    median_s = float(np.median(lat))
    t1 = time.perf_counter()
    queries, profile = flash_trace(REPLAY_DEVICE_QUERIES, t_b,
                                   REPLAY_DEVICE_BATCH, emb, F, pattern,
                                   seed=21,
                                   spike_len_batches=REPLAY_DEVICE_SPIKE)
    trace_s = time.perf_counter() - t1
    rss_trace = host_rss_bytes()
    target_ms = REPLAY_DEVICE_TARGET_X * median_s * 1e3
    sess = ServingSession(
        model, batcher=BatcherConfig(max_batch=REPLAY_DEVICE_BATCH,
                                     max_wait_s=0.002),
        slo=SLOConfig(target_p99_ms=target_ms,
                      min_batch=REPLAY_DEVICE_MIN, check_every_batches=2,
                      shed_deadline_frac=REPLAY_DEVICE_DEADLINE_FRAC),
        clock=VirtualClock())
    tap = LookupTap(sess.storage)
    served = []
    sess.server.on_batch = lambda batch, s: served.append(
        ([q.qid for q in batch], s.copy()))
    kernel.LAUNCHES = 0
    t1 = time.perf_counter()
    rep = replay(sess, queries)
    replay_s = time.perf_counter() - t1
    launches = kernel.LAUNCHES
    tap.remove()
    sess.close()
    out = replay_summary(sess, rep, tap, profile, target_ms)
    failed = []
    expect(failed, launches == out["batches"] > 0,
           f"bag kernel launched {launches} times over {out['batches']} "
           f"forwards")
    expect(failed, out["slo_checks_in_spike"] >= 4,
           f"{out['slo_checks_in_spike']} SLO checks inside the spike")
    expect(failed, out["max_slo_level"] == 2,
           f"device replay reached SLO level {out['max_slo_level']}, not "
           f"the shrink rung (2)")
    expect(failed, set(out["batch_sizes_served"]) == {256, 128, 64, 32},
           f"batch sizes {out['batch_sizes_served']}")
    # a sample batch (the last full one at the shrink floor) against the
    # plain path
    full = [b for b in served if len(b[0]) == REPLAY_DEVICE_MIN]
    qids, scores = (full or served)[-1]
    d64 = torch.from_numpy(np.stack([queries[q].dense for q in qids])).cuda()
    i64 = torch.from_numpy(np.stack([queries[q].indices
                                     for q in qids])).cuda()
    with torch.inference_mode():
        rows = gather_rows(model.ebc.tables, i64)
        plain = model.forward_from_pooled(
            d64, _pool_rows_core(rows, None, emb.combine))
        del rows
    plain = plain.cpu().numpy()
    diff = float(np.abs(plain - scores).max())
    expect(failed, bool(np.isfinite(scores).all()), "non-finite logits")
    expect(failed, bool(np.allclose(scores, plain, rtol=1e-4, atol=1e-4)),
           f"replayed logits differ from the plain path by {diff:.3e}")
    return dict(
        config="dlrm_production", backend="device", tables=emb.num_tables,
        max_batch=REPLAY_DEVICE_BATCH, min_batch=REPLAY_DEVICE_MIN,
        calibration_batch_ms=(lat * 1e3).tolist(),
        service_p99_ms=p99_s * 1e3, service_median_ms=median_s * 1e3,
        service_rate_qps=REPLAY_DEVICE_BATCH / t_b,
        deadline_ms=target_ms * REPLAY_DEVICE_DEADLINE_FRAC,
        trace={"kind": "flash", "queries": len(queries),
               "base_qps": profile.base_qps, "spike_qps": profile.spike_qps,
               "seconds_to_make": trace_s},
        **out, sample_batch={"queries": len(qids),
                             "logits_max_abs_diff_vs_plain": diff,
                             "tolerance": "rtol=1e-4 atol=1e-4"},
        replay_s=replay_s, host_rss_bytes_after_trace=rss_trace,
        host_peak_rss_bytes=host_peak_rss_bytes(), failed=failed)


def compact_bag_pooled(host_tables, idx: np.ndarray, opts) -> torch.Tensor:
    """The `device` backend's answer for `idx` [B, T, L] without the
    device tables: each table's distinct rows copied to the card as a
    compact table, indices remapped into it, and the bag kernel launched
    over all tables, as phase serve launched it. A bag's rows and their
    order are the same, so the pooled sums are the same bits."""
    B, T, L = idx.shape
    uniq = [np.unique(idx[:, t]) for t in range(T)]
    U = max(u.size for u in uniq)
    D = host_tables.shape[2]
    compact = torch.zeros((T, U, D), dtype=torch.float32)
    remapped = np.empty_like(idx)
    for t, u in enumerate(uniq):
        compact[t, :u.size] = torch.from_numpy(host_tables[t]).index_select(
            0, torch.from_numpy(u.astype(np.int64)))
        remapped[:, t] = np.searchsorted(u, idx[:, t])
    launches = kernel.LAUNCHES
    out = kernel.embedding_bag_cuda(
        compact.cuda(), torch.from_numpy(remapped).cuda(), None, opts)
    kernel.LAUNCHES = launches          # a check, not the main path
    return out


def replay_tiered_scenario(model, pattern, lat: np.ndarray):
    """The session and flash trace replay_tiered replays on `model`, from
    the service seconds `lat` of its calibration batches: returns
    (session, queries, trace profile, SLO target in ms)."""
    emb, F = model.cfg.embedding, model.cfg.dense_features
    queries, profile = flash_trace(REPLAY_TIERED_QUERIES, float(lat.mean()),
                                   REPLAY_TIERED_BATCH, emb, F, pattern,
                                   seed=22,
                                   spike_len_batches=REPLAY_TIERED_SPIKE,
                                   spike_x=REPLAY_TIERED_SPIKE_X)
    target_ms = REPLAY_TIERED_TARGET_X * float(np.median(lat)) * 1e3
    sess = ServingSession(
        model, batcher=BatcherConfig(max_batch=REPLAY_TIERED_BATCH,
                                     max_wait_s=0.002, pad_to_max=False),
        slo=SLOConfig(target_p99_ms=target_ms, min_batch=REPLAY_TIERED_MIN,
                      check_every_batches=2,
                      window_queries=REPLAY_TIERED_WINDOW,
                      shed_deadline_frac=REPLAY_TIERED_DEADLINE_FRAC),
        clock=VirtualClock())
    return sess, queries, profile, target_ms


def phase_replay_tiered(tiered, pattern, device_opts, src) -> dict:
    """The tiered storage serve_tiered built, under a flash crowd: service
    time measured at max_batch=128, an SLO of 2x its median with the shrink
    rung down to 16 and the degraded rung above it, the deadline admission
    at twice the SLO, and a spike of 6x base followed by 12 batch times of
    base traffic. Batches are not padded
    (a padded row costs a host gather on `tiered`). Every answer that is
    not degraded is held to the `device` kernel's bit for bit (the law);
    one degraded batch is held to the plain degraded pooling (misses as
    zeros), and its L2 delta to a recompute from the cold rows."""
    emb = tiered.cfg.embedding
    storage = tiered.ebc.storage
    cold = storage.ps.cold.tables
    dense, idx = src
    n_cal = 3 * REPLAY_TIERED_BATCH
    lat = calibrate_service(tiered, REPLAY_TIERED_BATCH, dense[:n_cal],
                            idx[:n_cal])
    p99_s, t_b = float(np.percentile(lat, 99)), float(lat.mean())
    median_s = float(np.median(lat))
    sess, queries, profile, target_ms = replay_tiered_scenario(
        tiered, pattern, lat)
    rss = {"trace": host_rss_bytes()}
    tap = LookupTap(storage)
    law = {"batches": 0, "queries": 0, "seconds": 0.0}
    failed = []

    def hold_to_device(batch, scores):
        indices, pooled = tap.last
        if tap.records[-1]["degraded"]:
            return
        t1 = time.perf_counter()
        want = compact_bag_pooled(cold, indices, device_opts)
        expect(failed, bool(torch.equal(pooled, want)),
               f"tiered != device on a replayed batch of {len(batch)}: "
               f"max diff {(pooled - want).abs().max().item():.3e}")
        law["batches"] += 1
        law["queries"] += len(batch)
        law["seconds"] += time.perf_counter() - t1
    sess.server.on_batch = hold_to_device
    kernel.LAUNCHES = fused.LAUNCHES = 0
    t1 = time.perf_counter()
    rep = replay(sess, queries, window_queries=REPLAY_TIERED_WINDOW)
    replay_s = time.perf_counter() - t1
    bag_launches, fused_launches = kernel.LAUNCHES, fused.LAUNCHES
    rss["replayed"] = host_rss_bytes()
    tap.remove()
    out = replay_summary(sess, rep, tap, profile, target_ms)
    expect(failed, fused_launches == out["batches"] > 0,
           f"fused kernel launched {fused_launches} times over "
           f"{out['batches']} forwards")
    expect(failed, bag_launches == out["bag_launches"] > 0,
           f"{bag_launches} completion launches, {out['bag_launches']} in "
           f"the lookups")
    expect(failed, out["max_slo_level"] == 3, f"tiered replay reached SLO "
           f"level {out['max_slo_level']}, not the degraded rung (3)")
    expect(failed, out["final_slo_level"] == 0,
           f"tiered replay ended at SLO level {out['final_slo_level']}")
    expect(failed, out["degraded"] is not None
           and out["non_degraded"] is not None,
           "no degraded or no exact batches")
    expect(failed, out["bag_launches_in_degraded"] == 0,
           f"{out['bag_launches_in_degraded']} completion launches in "
           f"degraded batches")
    expect(failed, out["non_degraded"] is not None
           and law["batches"] == out["non_degraded"]["batches"],
           f"law checked on {law['batches']} exact batches")

    # one degraded batch by hand: 16 fresh queries, the slot map read
    # before (no counter moves), then the lookup under degraded mode
    idx16 = sample_indices(pattern, 16, emb.num_tables, emb.pooling,
                           seed=23)
    storage.set_degraded(True)
    slot_map = storage.ps.build_slot_map(idx16)
    before = storage.stats()
    bag0 = kernel.LAUNCHES
    with torch.no_grad():
        got = tiered.ebc(idx16)
    torch.cuda.synchronize()
    bag_in_check = kernel.LAUNCHES - bag0
    after = storage.stats()
    storage.set_degraded(False)
    sess.close()
    miss = slot_map == fused.MISS                              # [16, T, L]
    rows = cold[np.arange(emb.num_tables)[None, :, None], idx16]
    rows[miss] = 0.0
    rows_t = torch.from_numpy(rows).cuda()
    plain = _pool_rows_core(rows_t, None, emb.combine)
    degraded_cmp = compare(got, plain,
                           2 * ref.F32_EPS * rows_t.abs().sum(dim=2),
                           "degraded batch pooled (misses as zeros)")
    del rows, rows_t
    miss_rows = cold[np.nonzero(miss)[1], idx16[miss]].astype(np.float64)
    l2_want = float(np.sqrt((miss_rows ** 2).sum()))
    l2_got = float(np.sqrt(after["degraded_l2_sq"]
                           - before["degraded_l2_sq"]))
    expect(failed, bag_in_check == 0, f"{bag_in_check} completion launches "
           f"in the degraded check batch")
    expect(failed, after["degraded_rows"] - before["degraded_rows"]
           == int(miss.sum()),
           "degraded_rows does not count the batch's misses")
    expect(failed, abs(l2_got - l2_want) <= 1e-6 * l2_want,
           f"degraded_l2_delta {l2_got} vs recompute {l2_want}")
    return dict(
        config="dlrm_production", backend="tiered", tables=emb.num_tables,
        max_batch=REPLAY_TIERED_BATCH, min_batch=REPLAY_TIERED_MIN,
        window_queries=REPLAY_TIERED_WINDOW, pad_to_max=False,
        calibration_batch_ms=(lat * 1e3).tolist(),
        service_p99_ms=p99_s * 1e3, service_median_ms=median_s * 1e3,
        service_rate_qps=REPLAY_TIERED_BATCH / t_b,
        deadline_ms=target_ms * REPLAY_TIERED_DEADLINE_FRAC,
        trace={"kind": "flash", "queries": len(queries),
               "base_qps": profile.base_qps, "spike_qps": profile.spike_qps},
        **out, law={**law, "equal": True},
        degraded_check={"queries": 16, "misses": int(miss.sum()),
                        "max_abs_err": degraded_cmp["max_abs_err"],
                        "max_err_over_bound":
                            degraded_cmp["max_err_over_bound"],
                        "l2_delta": l2_got, "l2_delta_recomputed": l2_want,
                        "completion_launches": bag_in_check},
        replay_s=replay_s, host_rss_bytes=rss,
        host_peak_rss_bytes=host_peak_rss_bytes(), failed=failed)


def phase_update(cfg, pattern) -> dict:
    """Online updates at full width with the table count cut: `device`,
    `tiered` and `sharded` (2 shards) sessions over the same weights and
    one update stream (one full base, then two deltas touching 2 % of the
    rows of 3 tables), batches served between versions. After the run,
    every batch is held to the plain path over `load_version` tables of
    its pinned version, tiered and sharded to device bit for bit, and
    every qid's version to the schedule."""
    emb = dataclasses.replace(cfg.embedding, num_tables=UPDATE_TABLES)
    T, R, L, D = emb.num_tables, emb.rows, emb.pooling, emb.dim
    B = UPDATE_BATCH
    dev_model = DLRM(dataclasses.replace(cfg, embedding=emb),
                     device="cuda", seed=3)
    v0 = dev_model.ebc.tables[:T].to("cpu", copy=True)
    tiered = DLRM(dataclasses.replace(cfg, embedding=dataclasses.replace(
        emb, storage="tiered")), device="cuda", tables=v0.clone(), seed=3)
    tiered.bottom, tiered.top = dev_model.bottom, dev_model.top
    sharded = DLRM(dataclasses.replace(cfg, embedding=dataclasses.replace(
        emb, storage="sharded")), device="cuda", tables=v0.clone(), seed=3)
    sharded.bottom, sharded.top = dev_model.bottom, dev_model.top
    trace = sample_indices(pattern, B, T, L, seed=TRACE_SEED)
    tiered.ebc.storage.build(tier_ps_config(R), trace=trace)
    sharded.ebc.storage.build(tier_ps_config(R), trace=trace,
                              num_shards=UPDATE_SHARDS)
    sharded_units = len(sharded.ebc.storage._units)
    root = os.path.join(ROOT, "build", "chip_smoke_updates")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    disk = shutil.disk_usage(root)
    # consumers attach before the base is published, so the base lands
    # through the update path too
    sessions = {}
    for name, model in (("device", dev_model), ("tiered", tiered),
                        ("sharded", sharded)):
        sessions[name] = ServingSession(
            model, batcher=BatcherConfig(max_batch=B, max_wait_s=0.0),
            controllers=configure(updates=UpdateConfig(
                ModelUpdateStream(root), poll_every_batches=1)))
    pub = ModelUpdateStream(root)
    taps = {name: LookupTap(sess.storage) for name, sess in sessions.items()}
    served = {name: [] for name in sessions}
    traffic = {}                        # qid -> (dense, indices)
    for name, sess in sessions.items():
        sess.server.on_batch = lambda batch, s, out=served[name]: out.append(
            ([q.qid for q in batch], s.copy()))
    rng = np.random.default_rng(4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    std = float(dev_model.ebc.tables[:T].std())
    published = []
    failed = []
    kernel.LAUNCHES = fused.LAUNCHES = 0
    t_serve = time.perf_counter()
    for step in range(UPDATE_STEPS):
        dense = rng.normal(size=(B, cfg.dense_features)).astype(np.float32)
        idx = sample_indices(pattern, B, T, L, seed=40 + step)
        traffic.update((step * B + i, (dense[i], idx[i])) for i in range(B))
        for sess in sessions.values():
            sess.submit_batch(dense, idx, qid0=step * B)
            while sess.poll(force=True):
                pass
        if step in UPDATE_PUBLISH_AFTER:
            t1 = time.perf_counter()
            if not published:
                v = pub.publish_full(torch.randn(
                    (T, R, D), generator=gen, device="cuda") * std)
            else:
                changed = {}
                for t in rng.choice(T, size=3, replace=False):
                    rows = rng.choice(R, size=R // 50, replace=False)
                    changed[int(t)] = (rows, (rng.normal(
                        size=(rows.size, D)) * std).astype(np.float32))
                v = pub.publish_delta(changed)
            published.append({"version": v, "after_step": step,
                              "publish_s": time.perf_counter() - t1})
    for sess in sessions.values():
        sess.drain(timeout_s=600.0)
    serve_s = time.perf_counter() - t_serve
    launches = {name: {"forwards": len(tap.records),
                       "bag": sum(r["bag"] for r in tap.records),
                       "fused": sum(r["fused"] for r in tap.records)}
                for name, tap in taps.items()}
    for tap in taps.values():
        tap.remove()
    dev_n, tier_n = launches["device"], launches["tiered"]
    shard_n = launches["sharded"]
    expect(failed, kernel.LAUNCHES == dev_n["bag"] + tier_n["bag"]
           + shard_n["bag"] and fused.LAUNCHES == tier_n["fused"]
           + shard_n["fused"],
           f"launches outside the lookups: {kernel.LAUNCHES} bag, "
           f"{fused.LAUNCHES} fused")
    expect(failed, dev_n["bag"] == dev_n["forwards"] == UPDATE_STEPS
           and tier_n["fused"] == tier_n["forwards"] == UPDATE_STEPS
           and tier_n["bag"] > 0 and shard_n["forwards"] == UPDATE_STEPS
           and shard_n["fused"] == sharded_units * UPDATE_STEPS
           and shard_n["bag"] > 0, f"launches in the update run: {launches}")
    pct = {name: sess.percentiles() for name, sess in sessions.items()}
    disk_used = sum(os.path.getsize(os.path.join(d, f))
                    for d, _, files in os.walk(root) for f in files)
    for name, p in pct.items():
        got = (p["model_version"], p["updates_applied"], p["updates_full"],
               p["updates_delta"])
        expect(failed, got == (3, 3, 1, 2),
               f"{name}: (version, applied, full, delta) = {got}")

    # every batch single-version, the same version in every session, and
    # tiered == sharded == device bit for bit
    dev_batches = served["device"]
    by_version = collections.defaultdict(list)
    for other in ("tiered", "sharded"):
        expect(failed, [b[0] for b in dev_batches]
               == [b[0] for b in served[other]],
               f"device and {other} served other batches")
        for (qids, d_scores), (_, o_scores) in zip(dev_batches,
                                                   served[other]):
            vs = {sessions["device"].version_of(q) for q in qids}
            vo = {sessions[other].version_of(q) for q in qids}
            expect(failed, len(vs) == 1 and vs == vo,
                   f"batch versions: device {vs}, {other} {vo}")
            expect(failed, bool(np.array_equal(d_scores, o_scores)),
                   f"{other} != device after an update: max diff "
                   f"{np.abs(d_scores - o_scores).max():.3e}")
    for qids, d_scores in dev_batches:
        v = sessions["device"].version_of(qids[0])
        by_version[v].append((qids, d_scores))
    # the schedule: a version published after step s is applied after the
    # first batch of step s + 1, so step s + 2 is the first served by it
    for step in range(UPDATE_STEPS):
        want = sum(1 for p in published if p["after_step"] + 2 <= step)
        for q in (step * B, (step + 1) * B - 1):
            got = sessions["device"].version_of(q)
            expect(failed, got == want,
                   f"qid {q} (step {step}) pinned to v{got}, not v{want}")
    expect(failed, sorted(by_version) == [0, 1, 2, 3],
           f"versions served: {sorted(by_version)}")

    # each version's batches against the plain path over its tables
    mgr = CheckpointManager(root)
    plain_diff = {}
    for v, batches_v in sorted(by_version.items()):
        tables_v = v0.numpy() if v == 0 else mgr.load_version(v)
        worst = 0.0
        for qids, scores in batches_v:
            d = torch.from_numpy(np.stack([traffic[q][0]
                                           for q in qids])).cuda()
            i = np.stack([traffic[q][1] for q in qids])
            rows = torch.from_numpy(
                tables_v[np.arange(T)[None, :, None], i]).cuda()
            with torch.inference_mode():
                logits = dev_model.forward_from_pooled(
                    d, _pool_rows_core(rows, None, emb.combine)).cpu().numpy()
            del rows
            diff = float(np.abs(logits - scores).max())
            worst = max(worst, diff)
            expect(failed, bool(np.allclose(scores, logits, rtol=1e-4,
                                            atol=1e-4)),
                   f"v{v}: logits differ from the plain path over its "
                   f"tables by {diff:.3e}")
        plain_diff[f"v{v}"] = {"batches": len(batches_v),
                               "logits_max_abs_diff": worst}
        del tables_v
    for sess in sessions.values():
        sess.close()
    shutil.rmtree(root, ignore_errors=True)
    keep = ("model_version", "updates_applied", "updates_full",
            "updates_delta", "updates_rolled_back", "update_stall_s",
            "p50_ms", "p99_ms", "mean_batch_ms", "served")
    return dict(
        config="dlrm_production", tables=T, rows=R, dim=D, pooling=L,
        batch=B, steps=UPDATE_STEPS,
        cut={"num_tables": [cfg.embedding.num_tables, T],
             "reason": "a full base snapshot of 250 tables is 64 GB on "
                       "disk and in host memory"},
        published=published, launches=launches,
        sessions={name: {k: p[k] for k in keep if k in p}
                  for name, p in pct.items()},
        plain=plain_diff, tiered_equals_device=True,
        sharded_equals_device=True, sharded_shards=UPDATE_SHARDS,
        sharded_units=sharded_units,
        logits_tolerance="rtol=1e-4 atol=1e-4",
        disk={"free_bytes": disk.free, "total_bytes": disk.total,
              "stream_bytes": disk_used},
        serve_s=serve_s, host_peak_rss_bytes=host_peak_rss_bytes(),
        failed=failed)


@contextlib.contextmanager
def deterministic_algorithms():
    """`torch.use_deterministic_algorithms(True)` for the block: an op
    without a deterministic implementation raises instead of running."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def _train_step_zero_checks(failed: list) -> dict:
    """train_dlrm's model at step 0 on its first batch: the pooled bags
    and the loss on the kernel path against the plain path's (the bags
    within the summation bound), and the kernel path's table
    gradient (the Function's backward, `embedding_bag_backward`) against
    `torch.autograd.grad` through `ref.embedding_bag_ref` for the same
    pooled gradient, within the summation bound 2·eps·Σ|g|."""
    cfg = train_dlrm.CONFIG
    emb = cfg.embedding
    model = DLRM(cfg, device="cuda", seed=train_dlrm.SEED)
    dense, idx, labels = train_dlrm.batch_tensors(
        train_dlrm.make_stream().next_batch(), "cuda")
    tables = model.ebc.tables.requires_grad_(True)
    pooled_k = model.ebc(idx)
    loss_k = bce_with_logits(model.forward_from_pooled(dense, pooled_k),
                             labels)
    grad_k, grad_pooled = torch.autograd.grad(loss_k, [tables, pooled_k])
    with torch.no_grad():
        pooled_p = _pool_rows_core(gather_rows(tables, idx), None,
                                   emb.combine)
        loss_p = bce_with_logits(model.forward_from_pooled(dense, pooled_p),
                                 labels)
    pooled_bound = torch.stack([ref.summation_bound(
        tables[t].detach(), idx[:, t], None, emb.combine)
        for t in range(emb.num_tables)], dim=1)
    pooled_cmp = compare(pooled_k.detach(), pooled_p, pooled_bound,
                         "train pooled")
    leaf = tables.detach().clone().requires_grad_(True)
    pooled_r = torch.stack([ref.embedding_bag_ref(leaf[t], idx[:, t], None,
                                                  emb.combine)
                            for t in range(emb.num_tables)], dim=1)
    grad_r, = torch.autograd.grad(pooled_r, leaf, grad_outputs=grad_pooled)
    shape = tuple(tables.shape)
    bound = 2 * ref.F32_EPS * embedding_bag_backward(
        grad_pooled.abs(), idx, None, emb.combine, shape)
    grad_cmp = compare(grad_k, grad_r, bound, "train table gradient")
    # the scatter's bits on a second run, deterministic algorithms off
    again = embedding_bag_backward(grad_pooled, idx, None, emb.combine,
                                   shape)
    repeat_equal = bool(torch.equal(again, grad_k))
    expect(failed, repeat_equal,
           "the table gradient differs between two runs of the backward")
    loss_k, loss_p = float(loss_k.detach()), float(loss_p)
    expect(failed, abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p),
           f"step-0 loss {loss_k!r} on the kernel path, {loss_p!r} plain")
    return {"loss_kernel": loss_k, "loss_plain": loss_p,
            "loss_rtol": TRAIN_LOSS_RTOL,
            "pooled_max_abs_err": pooled_cmp["max_abs_err"],
            "pooled_max_err_over_bound": pooled_cmp["max_err_over_bound"],
            "grad_max_abs_err": grad_cmp["max_abs_err"],
            "grad_max_err_over_bound": grad_cmp["max_err_over_bound"],
            "grad_equal_bits": bool(torch.equal(grad_k, grad_r)),
            "grad_rows_touched": int((grad_k.abs().sum(-1) > 0).sum()),
            "backward_repeat_equal_bits": repeat_equal,
            "grad_tolerance": "2*eps_f32*sum|g| (summation bound)"}


def _train_runs(failed: list) -> dict:
    """train_dlrm's `main` three times under deterministic algorithms: 60
    steps straight through; 40 steps (a completion checkpoint at 40); and
    a second incarnation over the same directory that restores step 40
    and runs 40-59. Launches are counted per run; each must equal its
    forwards."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    runs, launches, seconds = {}, {}, {}
    legs = (("full", TRAIN_STEPS, "full"), ("stopped", TRAIN_STOP_AT, "restart"),
            ("resumed", TRAIN_STEPS, "restart"))
    with deterministic_algorithms():
        for name, steps, ckpt in legs:
            t0 = time.perf_counter()
            kernel.LAUNCHES = 0
            runs[name] = train_dlrm.main(
                ["--steps", str(steps), "--device", "cuda",
                 "--ckpt", os.path.join(TRAIN_DIR, ckpt)])
            launches[name] = kernel.LAUNCHES
            seconds[name] = time.perf_counter() - t0
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    losses = {k: [h.loss for h in r.history] for k, r in runs.items()}
    steps = {k: [h.step for h in r.history] for k, r in runs.items()}
    for name, _, _ in legs:
        expect(failed, launches[name] == len(steps[name]),
               f"train {name}: {launches[name]} bag launches over "
               f"{len(steps[name])} forwards")
    full = losses["full"]
    first, last = float(np.mean(full[:10])), float(np.mean(full[-10:]))
    expect(failed, bool(np.isfinite(full).all()), "non-finite train loss")
    expect(failed, last < first,
           f"train loss did not fall: first 10 {first}, last 10 {last}")
    expect(failed, steps["resumed"] == list(range(TRAIN_STOP_AT,
                                                  TRAIN_STEPS)),
           f"the restored run took steps {steps['resumed']}")
    restart_equal = (losses["resumed"] == full[TRAIN_STOP_AT:]
                     and losses["stopped"] == full[:TRAIN_STOP_AT])
    expect(failed, restart_equal,
           "losses after the restore differ from the uninterrupted run's")
    return {"losses": full, "first10_mean": first, "last10_mean": last,
            "launches": launches, "forwards": {k: len(v)
                                               for k, v in steps.items()},
            "restart_equal_bits": restart_equal,
            "resumed_losses": losses["resumed"],
            "stragglers": sum(h.straggler for h in runs["full"].history),
            "step_wall_ms_p50": float(np.median(
                [h.wall_s for h in runs["full"].history]) * 1e3),
            "deterministic_algorithms": True, "run_seconds": seconds}


def _split_step(model, state, batch) -> dict:
    """One train step in its parts, each between two CUDA events: the batch
    to the card, the bag kernel, the MLPs forward and backward (with the
    pooled gradient), the table backward (`embedding_bag_backward`: zero
    the gradient, scatter into it), row-wise Adagrad, SGD momentum. The
    same arithmetic as `train_dlrm.make_train_step` at the wide leg's
    rates. Zeroing a gradient is also timed alone, before the step's
    parts: `scatter` is the table backward less that."""
    parts = ("zero_table_grad", "batch_to_device", "bag_kernel",
             "mlp_forward_backward", "table_backward", "rowwise_adagrad",
             "sgd_momentum")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    params = state["params"]
    names = [(t, k) for t in ("bottom", "top") for k in params[t]]
    tables = params["embedding"]["tables"]
    emb = model.cfg.embedding
    events[0].record()
    torch.zeros_like(tables)
    events[1].record()
    dense, idx, labels = train_dlrm.batch_tensors(batch, "cuda")
    events[2].record()
    with torch.no_grad():
        pooled = model.ebc(idx)
    events[3].record()
    pooled.requires_grad_(True)
    loss = bce_with_logits(model.forward_from_pooled(dense, pooled), labels)
    grads = torch.autograd.grad(loss, [params[t][k] for t, k in names]
                                + [pooled])
    events[4].record()
    grad = embedding_bag_backward(grads[-1], model.ebc.remap_indices(idx),
                                  None, emb.combine, tuple(tables.shape))
    events[5].record()
    rowwise_adagrad_update(params["embedding"], {"tables": grad},
                           state["opt_emb"], lr=TRAIN_WIDE_LR_EMB)
    events[6].record()
    g_dense = {"bottom": {}, "top": {}}
    for (t, k), g in zip(names, grads):
        g_dense[t][k] = g
    sgdm_update({"bottom": params["bottom"], "top": params["top"]}, g_dense,
                state["opt_dense"], lr=TRAIN_WIDE_LR_DENSE)
    events[7].record()
    torch.cuda.synchronize()
    ms = {p: events[i].elapsed_time(events[i + 1])
          for i, p in enumerate(parts)}
    ms["scatter"] = ms["table_backward"] - ms["zero_table_grad"]
    return ms


def _train_wide(cfg, pattern, failed: list) -> dict:
    """dlrm_production's widths at batch 2048, tables cut to 64: the
    train step timed with CUDA events, split into its parts, the bounds of
    the parts that move the dense table gradient, and peak memory."""
    gc.collect()                # what the earlier phases hold on the card
    torch.cuda.empty_cache()
    emb = dataclasses.replace(cfg.embedding, num_tables=TRAIN_WIDE_TABLES)
    B, L, D, R = TRAIN_WIDE_BATCH, emb.pooling, emb.dim, emb.rows
    reduced = [{"num_tables": [cfg.embedding.num_tables, TRAIN_WIDE_TABLES],
                "reason": "the dense table gradient doubles the table "
                          "bytes; serve_sharded's table count"}]
    free, _ = torch.cuda.mem_get_info()
    # a table, its gradient and Adagrad's squared gradient, plus the
    # scatter's values for its lookups
    per_table = (3 * R + B * L) * D * emb.torch_dtype.itemsize
    fit = int((free - HEADROOM_BYTES) // per_table)
    if fit < TRAIN_WIDE_TABLES:
        reduced.append({"num_tables": [TRAIN_WIDE_TABLES, fit],
                        "reason": f"{free} bytes free on the card"})
        emb = dataclasses.replace(emb, num_tables=fit)
    T = emb.num_tables
    cfg_w = dataclasses.replace(cfg, embedding=emb)
    t1 = time.perf_counter()
    rng = np.random.default_rng(8)
    batches = [DLRMBatch(
        dense=rng.standard_normal((B, cfg.dense_features), dtype=np.float32),
        indices=sample_indices(pattern, B, T, L, seed=80 + s),
        labels=(rng.random(B) < 0.2).astype(np.float32))
        for s in range(1 + TRAIN_WIDE_STEPS)]
    sample_s = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    model = DLRM(cfg_w, device="cuda", seed=7)
    state = train_dlrm.train_state(model)
    step = train_dlrm.make_train_step(model, lr_dense=TRAIN_WIDE_LR_DENSE,
                                      lr_emb=TRAIN_WIDE_LR_EMB)
    kernel.LAUNCHES = 0
    state, loss = step(state, batches[0])            # warm-up
    losses, step_ms = [float(loss)], []
    for batch in batches[1:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    launches = kernel.LAUNCHES
    expect(failed, launches == len(batches),
           f"train wide: {launches} bag launches over {len(batches)} steps")
    expect(failed, bool(np.isfinite(losses).all()), "non-finite wide loss")
    splits = [_split_step(model, state, batches[1 + i % TRAIN_WIDE_STEPS])
              for i in range(TRAIN_WIDE_SPLIT_STEPS)]
    split_p50 = {k: float(np.median([s[k] for s in splits]))
                 for k in splits[0]}
    peak = torch.cuda.max_memory_allocated()
    # bounds from this run's inputs: each input read once, each output
    # written once (distinct rows: what the bag kernel and a sparse
    # scatter must move)
    idx = torch.from_numpy(batches[1].indices).cuda()
    distinct = sum(int(torch.unique(idx[:, t]).numel()) for t in range(T))
    del idx
    table_bytes = T * R * D * 4
    row_bytes = D * 4
    moved = {
        "bag_kernel": distinct * row_bytes + B * T * L * 4 + B * T * D * 4,
        "zero_table_grad": table_bytes,
        "scatter": B * T * D * 4 + B * T * L * 4 + distinct * row_bytes,
        # read the gradient and the tables, write the tables; read and
        # write one accumulator a row
        "rowwise_adagrad": 3 * table_bytes + 2 * T * R * 4,
    }
    bound_ms = {k: v / HBM_BW * 1e3 for k, v in moved.items()}
    del model, state, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": "dlrm_production", "tables": T, "rows": R, "dim": D,
            "pooling": L, "batch": B, "reduced": reduced,
            "steps": TRAIN_WIDE_STEPS, "warmup_steps": 1,
            "step_ms": step_ms, "step_p50_ms": float(np.median(step_ms)),
            "split_steps": TRAIN_WIDE_SPLIT_STEPS,
            "split_p50_ms": split_p50,
            "split_sum_ms": float(sum(split_p50[p] for p in STEP_PARTS)),
            "splits_ms": splits, "bytes_moved": moved,
            "bound_ms": bound_ms, "distinct_rows": distinct,
            "table_bytes": table_bytes, "peak_memory_bytes": peak,
            "launches": launches, "forwards": len(losses), "losses": losses,
            "lr_dense": TRAIN_WIDE_LR_DENSE, "lr_emb": TRAIN_WIDE_LR_EMB,
            "sample_s": sample_s}


def phase_train(cfg, pattern) -> dict:
    """Training on the card: leg (a), train_dlrm through TrainLoop with
    its step-0 checks and the restart; leg (b), dlrm_production's widths
    at batch 2048 (`_train_wide`)."""
    gc.collect()
    torch.cuda.empty_cache()
    failed = []
    t0 = time.perf_counter()
    checks = _train_step_zero_checks(failed)
    runs = _train_runs(failed)
    first, plain = runs["losses"][0], checks["loss_plain"]
    expect(failed, abs(first - plain) <= TRAIN_LOSS_RTOL * abs(plain),
           f"TrainLoop's first loss {first!r}, the plain path's {plain!r}")
    runs["first_loss_equals_step0_kernel_bits"] = (
        first == checks["loss_kernel"])
    small_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide = _train_wide(cfg, pattern, failed)
    emb = train_dlrm.CONFIG.embedding
    return {"small": {"config": "train_dlrm", "tables": emb.num_tables,
                      "rows": emb.rows, "dim": emb.dim,
                      "pooling": emb.pooling, "batch": train_dlrm.BATCH,
                      "steps": TRAIN_STEPS, "stop_at": TRAIN_STOP_AT,
                      **checks, **runs, "seconds": small_s},
            "wide": {**wide, "seconds": time.perf_counter() - t0},
            "failed": failed}


def phase_quickstart() -> dict:
    """The port's quickstart on the card: the planner, then the pinned,
    hot-first collection (the bag kernel with its hot operand) against the
    plain gather; one launch."""
    kernel.LAUNCHES = 0
    out = quickstart.main(["--device", "cuda"])
    launches = kernel.LAUNCHES
    check(launches == 1, f"quickstart: {launches} bag launches, not 1")
    check(out["max_abs_err"] < quickstart.MAX_ERR,
          f"quickstart: max|err| {out['max_abs_err']}")
    return {"planner": dataclasses.asdict(out["report"]),
            "max_abs_err": out["max_abs_err"], "tolerance": quickstart.MAX_ERR,
            "launches": launches}


def tier_ps_config(rows: int) -> PSConfig:
    """serve_tiered's tiers: rows // 10 hot and warm rows a table on the
    card, the fused kernel, async staging two batches deep."""
    return PSConfig(hot_rows=rows // TIER_FRACTION,
                    warm_slots=rows // TIER_FRACTION, warm_backing="device",
                    fused_lookup=True, async_prefetch=True, prefetch_depth=2)


def skewed_indices(batch: int, tables: int, pooling: int, rows: int,
                   seed: int) -> np.ndarray:
    """[batch, tables, pooling] with the `sharded_migration` bench's
    patterns on the first tables — table 0 `random`, tables 1-15
    `one_item` — and med_hot on the rest: a live window whose loads leave
    the contiguous placement lopsided and table 0 heavy enough to be
    replicated."""
    idx = sample_indices(make_pattern("med_hot", rows, seed=0), batch,
                         tables, pooling, seed=seed)
    for t in range(min(tables, 1 + SKEWED_ONE_ITEM_TABLES)):
        kind = "random" if t == 0 else "one_item"
        idx[:, t] = make_pattern(kind, rows, seed=t).sample(
            batch, pooling, seed=seed * 1000 + t)
    return idx


def shard_breakdown(storage) -> dict:
    """Each shard's `ParameterServer.breakdown` (its units summed), ms."""
    out = {}
    for u in storage._units:
        for step, s in (u.ps.breakdown or {}).items():
            key = f"shard{u.shard}"
            out.setdefault(key, {})
            out[key][step] = out[key].get(step, 0.0) + s * 1e3
    return out


def phase_serve_sharded(cfg, pattern) -> dict:
    """dlrm_production at full width with the table count cut, on the
    `sharded` backend: the `device` reference first (the bag kernel), then
    4 shards of serve_tiered's tiers on a contiguous placement, the same 2
    batches through a session (logits equal `device`'s bit for bit, one
    fused launch per unit a forward), a live migration to a placement
    that replicates table 0 on two shards (`plan_migration` on a skewed
    window, `install_migration`, routing observations folded by
    `update_routing`), and the 2 batches again. Then one batch timed with
    the shards in parallel and one serially, the latter with each shard's
    `ParameterServer.breakdown`."""
    gc.collect()                # earlier phases' collections and storages
    emb = dataclasses.replace(cfg.embedding, num_tables=SHARDED_TABLES)
    R, L, D = emb.rows, emb.pooling, emb.dim
    B = 2048
    ps_cfg = tier_ps_config(R)
    # the tiered backend's host bytes a table, plus the authoritative copy
    # the units are copied from, plus the second unit copy a migration
    # builds before it tears the first down
    per_table = tiered_host_bytes_per_table(ps_cfg, B, L, R, D) \
        + 2 * R * D * 4
    avail = host_available_bytes()
    rss = {"start": host_rss_bytes()}
    T = min(SHARDED_TABLES, int((avail - HOST_HEADROOM_BYTES) // per_table))
    reduced = [{"num_tables": [cfg.embedding.num_tables, SHARDED_TABLES],
                "reason": "each unit copies its tables beside the "
                          "authoritative copy: host memory (about 880 MB "
                          "a table with a migration in flight) and the "
                          "host work of a tiered batch per table"}]
    if T < SHARDED_TABLES:
        reduced.append({"num_tables": [SHARDED_TABLES, T],
                        "reason": f"{avail} bytes of host memory "
                                  f"available, {per_table} needed a table"})
    emb = dataclasses.replace(emb, num_tables=T)
    cfg_t = dataclasses.replace(cfg, embedding=emb)
    rng = np.random.default_rng(6)
    batches = [(rng.normal(size=(B, cfg.dense_features)).astype(np.float32),
                sample_indices(pattern, B, T, L, seed=60 + s))
               for s in range(SHARDED_BATCHES)]
    failed = []
    torch.cuda.reset_peak_memory_stats()

    def serve(model, name):
        scores = []
        sess = ServingSession(model, batcher=BatcherConfig(max_batch=B,
                                                           max_wait_s=0.0))
        sess.server.on_batch = lambda batch, s: scores.append(s.copy())
        for dense, idx in batches:
            sess.submit_batch(dense, idx)
        sess.drain(timeout_s=600.0)
        lat = np.asarray(sess.stats.batch_latencies_s) * 1e3
        expect(failed, len(lat) == len(batches),
               f"{name}: {len(lat)} batches served")
        return sess, np.concatenate(scores), lat

    # the `device` reference: the same tables on the card, the bag kernel
    dev = DLRM(cfg_t, device="cuda", seed=5)
    kernel.LAUNCHES = 0
    sess, dev_logits, dev_lat = serve(dev, "device")
    sess.close()
    dev_launches = kernel.LAUNCHES
    expect(failed, dev_launches == 1 + len(batches),
           f"device: {dev_launches} bag launches in {1 + len(batches)} "
           f"forwards")
    expect(failed, bool(np.isfinite(dev_logits).all()),
           "device: non-finite logits")
    t1 = time.perf_counter()
    host_tables = dev.ebc.tables.cpu()
    dev.ebc.tables = None
    gc.collect()
    torch.cuda.empty_cache()
    to_host_s = time.perf_counter() - t1
    sharded = DLRM(dataclasses.replace(cfg_t, embedding=dataclasses.replace(
        emb, storage="sharded")), device="cuda", tables=host_tables, seed=5)
    sharded.bottom, sharded.top = dev.bottom, dev.top
    del dev, host_tables
    st = sharded.ebc.storage
    trace = sample_indices(pattern, B, T, L, seed=TRACE_SEED)
    t1 = time.perf_counter()
    st.build(ps_cfg, trace=trace, num_shards=SHARDED_SHARDS,
             placement="contiguous", replicate_factor=SHARDED_REPLICATE)
    build_s = time.perf_counter() - t1
    del trace
    rss["built"] = host_rss_bytes()
    units_before = len(st._units)
    expect(failed, units_before == SHARDED_SHARDS,
           f"{units_before} units on {SHARDED_SHARDS} shards")

    tap = LookupTap(st)
    kernel.LAUNCHES = fused.LAUNCHES = 0
    sess, logits, lat = serve(sharded, "sharded")
    rss["served"] = host_rss_bytes()
    before = {"batch_ms": lat.tolist(),
              "fused_launches": fused.LAUNCHES,
              "bag_launches": kernel.LAUNCHES,
              "fused_per_forward": [r["fused"] for r in tap.records],
              "units": units_before}
    expect(failed, all(r["fused"] == units_before for r in tap.records)
           and len(tap.records) == 1 + len(batches),
           f"fused launches per forward {before['fused_per_forward']}, "
           f"{units_before} units")
    equal = bool(np.array_equal(logits, dev_logits))
    expect(failed, equal, f"sharded != device: max diff "
           f"{np.abs(logits - dev_logits).max():.3e}")
    stats = st.stats()
    expect(failed, stats["hot_hits"] + stats["warm_hits"]
           + stats["cold_misses"] == stats["total_accesses"] > 0,
           "merged stats break hot + warm + cold == total")
    keys = ("total_accesses", "hot_hits", "warm_hits", "cold_misses",
            "cache_hit_rate", "cold_gathered_rows", "prefetch_hits",
            "prefetch_misses", "off_critical_frac", "max_queue_depth")
    before.update(logits_equal_device=equal,
                  stats={k: stats[k] for k in keys if k in stats})

    # live migration, planned from a skewed window (med_hot's equal loads
    # give no plan), installed between batches while the session serves
    window = skewed_indices(B, T, L, R, seed=70)
    t1 = time.perf_counter()
    plan = st.plan_migration({"traffic": [window]},
                             threshold=SHARDED_MIGRATE_THRESHOLD)
    plan_s = time.perf_counter() - t1
    del window
    check(plan is not None, "serve_sharded: the skewed window gave no "
                            "migration plan")
    mig = plan["migration"]
    t1 = time.perf_counter()
    res = st.install_migration(plan)
    install_s = time.perf_counter() - t1
    rss["migrated"] = host_rss_bytes()
    replicated = {int(t): list(mig.new.replicas[t])
                  for t in mig.new.replicated_tables}
    expect(failed, res["migrated"] and 0 in replicated
           and len(replicated[0]) == 2,
           f"migration {res}, replicated {replicated}")
    units_after = len(st._units)
    tap.records.clear()
    kernel.LAUNCHES = fused.LAUNCHES = 0
    scores = []
    sess.server.on_batch = lambda batch, s: scores.append(s.copy())
    routing = []
    for dense, idx in batches:
        sess.submit_batch(dense, idx)
        sess.drain(timeout_s=600.0)
        routing.append(st.update_routing())
    lat2 = np.asarray(sess.stats.batch_latencies_s[-len(batches):]) * 1e3
    logits2 = np.concatenate(scores)
    equal2 = bool(np.array_equal(logits2, dev_logits))
    expect(failed, equal2, f"sharded after migration != device: max diff "
           f"{np.abs(logits2 - dev_logits).max():.3e}")
    expect(failed, len(tap.records) == len(batches)
           and all(r["fused"] == units_after for r in tap.records),
           f"after migration: fused launches per forward "
           f"{[r['fused'] for r in tap.records]}, {units_after} units")
    expect(failed, routing[0] is not None and 0 in routing[0]["fractions"],
           f"routing: {routing}")
    stats = st.stats()
    expect(failed, stats["hot_hits"] + stats["warm_hits"]
           + stats["cold_misses"] == stats["total_accesses"],
           "merged stats break hot + warm + cold == total after migration")
    after = {"batch_ms": lat2.tolist(), "fused_launches": fused.LAUNCHES,
             "bag_launches": kernel.LAUNCHES,
             "fused_per_forward": [r["fused"] for r in tap.records],
             "units": units_after, "logits_equal_device": equal2,
             "routing": routing}
    tap.remove()
    sess.server.close()

    # one batch with the shards in parallel, one serially with each
    # shard's breakdown (the device synchronised at each step)
    idx = batches[0][1]
    timing = {}
    for mode in ("parallel", "serial"):
        pool = st._pool
        if mode == "serial":
            st._pool = None
            for u in st._units:
                u.ps.breakdown = {}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            pooled = sharded.ebc(idx)
        torch.cuda.synchronize()
        timing[f"{mode}_ms"] = (time.perf_counter() - t1) * 1e3
        st._pool = pool
    timing["breakdown_ms"] = shard_breakdown(st)
    for u in st._units:
        u.ps.breakdown = None
    want = compact_bag_pooled(st._tables, idx, emb.kernel_opts())
    expect(failed, bool(torch.equal(pooled, want)),
           "serial fan-out != the bag kernel's pooling")
    del pooled, want
    peak = torch.cuda.max_memory_allocated()
    rss["timed"] = host_rss_bytes()
    sess.close()
    # the collection and its storage point at each other: gc frees them
    del sess, sharded, st, tap
    gc.collect()
    torch.cuda.empty_cache()
    return dict(
        config="dlrm_production", backend="sharded", tables=T, rows=R,
        dim=D, pooling=L, batch=B, shards=SHARDED_SHARDS,
        placement="contiguous", reduced=reduced,
        ps_config=dataclasses.asdict(ps_cfg),
        device={"batch_ms": dev_lat.tolist(), "bag_launches": dev_launches},
        before_migration=before,
        migration={"window": "table 0 random, tables 1-15 one_item (the "
                             "sharded_migration bench's patterns), the rest "
                             "med_hot: med_hot's equal loads give no plan",
                   "threshold": SHARDED_MIGRATE_THRESHOLD,
                   "replicate_factor": SHARDED_REPLICATE,
                   "describe": mig.describe(), "replicated": replicated,
                   "moved_tables": len(mig.moved_tables),
                   "imbalance_before": res.get("imbalance_before"),
                   "imbalance_after": res.get("imbalance_after"),
                   "plan_s": plan_s, "install_s": install_s},
        after_migration=after, timing=timing,
        peak_memory_bytes=peak, host_rss_bytes=rss,
        host_available_bytes=avail, host_bytes_estimate=per_table * T,
        tables_to_host_s=to_host_s, build_s=build_s, failed=failed)


def shm_free_bytes() -> int:
    """Free bytes of /dev/shm, where the pool's shared cold segment lives
    (a tmpfs: its pages are host memory too)."""
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def proc_rss_bytes(pid: int) -> int | None:
    """Resident set of process `pid` (/proc/<pid>/status VmRSS), or None
    where it is gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            return next(int(line.split()[1]) * 1024 for line in f
                        if line.startswith("VmRSS:"))
    except (OSError, StopIteration):
        return None


def phase_serve_pool(cfg, pattern, sharded: dict) -> dict:
    """serve_sharded's shape on the `pool` backend: the same tables (seed
    5), batches and tiers, 4 worker processes (one shard each, each with
    its own CUDA context) over one shared host cold segment in /dev/shm.
    The `device` reference first; then 2 batches through a session, the
    same live migration (6 units), 2 batches, a SIGKILLed worker and a
    batch that respawns it. Logits equal `device`'s bit for bit
    throughout; the kernels' launches are counted inside the workers
    (fused: once a unit a forward); one batch timed directly, as
    serve_sharded timed its parallel batch, gives the ratio to it. After
    `close()` every worker is joined and /dev/shm has its bytes back."""
    gc.collect()
    emb = dataclasses.replace(cfg.embedding, num_tables=SHARDED_TABLES)
    R, L, D = emb.rows, emb.pooling, emb.dim
    B = 2048
    ps_cfg = tier_ps_config(R)
    table_bytes = R * D * 4
    shm_start = shm_free_bytes()
    machine = {"nproc": os.cpu_count(),
               "affinity": len(os.sched_getaffinity(0)),
               "shm_free_bytes": shm_start,
               "shm_total_bytes": shutil.disk_usage("/dev/shm").total,
               "host_available_bytes": host_available_bytes()}
    # host bytes a table: the tiered backend's (its cold tier is the
    # segment), the collection's authoritative copy, and the hot plans the
    # pool ships (two int64 [R] arrays, held on both sides); each worker
    # process adds a fixed cost (torch, its CUDA context)
    per_table = tiered_host_bytes_per_table(ps_cfg, B, L, R, D) \
        + table_bytes + 4 * R * 8
    fixed = POOL_WORKERS * POOL_WORKER_HOST_BYTES
    t_host = int((machine["host_available_bytes"] - HOST_HEADROOM_BYTES
                  - fixed) // per_table)
    t_shm = int((shm_start - POOL_SHM_HEADROOM_BYTES) // table_bytes)
    T = min(SHARDED_TABLES, t_host, t_shm)
    reduced = [{"num_tables": [cfg.embedding.num_tables, SHARDED_TABLES],
                "reason": "serve_sharded's cut, kept so the two are "
                          "compared on the same tables"}]
    if T < SHARDED_TABLES:
        reduced.append({"num_tables": [SHARDED_TABLES, T],
                        "reason": f"/dev/shm {shm_start} bytes free "
                                  f"({t_shm} tables), host "
                                  f"{machine['host_available_bytes']} "
                                  f"bytes available ({t_host} tables)"})
    check(T >= POOL_WORKERS, f"serve_pool: room for {T} tables only")
    emb = dataclasses.replace(emb, num_tables=T)
    cfg_t = dataclasses.replace(cfg, embedding=emb)
    rng = np.random.default_rng(6)
    batches = [(rng.normal(size=(B, cfg.dense_features)).astype(np.float32),
                sample_indices(pattern, B, T, L, seed=60 + s))
               for s in range(SHARDED_BATCHES)]
    failed = []

    # the `device` reference: serve_sharded's tables, on the card
    dev = DLRM(cfg_t, device="cuda", seed=5)
    sess = ServingSession(dev, batcher=BatcherConfig(max_batch=B,
                                                     max_wait_s=0.0))
    scores = []
    sess.server.on_batch = lambda batch, s: scores.append(s.copy())
    for dense, idx in batches:
        sess.submit_batch(dense, idx)
    sess.drain(timeout_s=600.0)
    sess.close()
    dev_logits = np.concatenate(scores)
    expect(failed, bool(np.isfinite(dev_logits).all())
           and dev_logits.shape == (B * len(batches),),
           "device: non-finite logits or a wrong shape")
    host_tables = dev.ebc.tables.cpu()
    dev.ebc.tables = None
    gc.collect()
    torch.cuda.empty_cache()
    model = DLRM(dataclasses.replace(cfg_t, embedding=dataclasses.replace(
        emb, storage="pool")), device="cuda", tables=host_tables, seed=5)
    model.bottom, model.top = dev.bottom, dev.top
    del dev, host_tables
    st = storage = model.ebc.storage
    try:
        trace = sample_indices(pattern, B, T, L, seed=TRACE_SEED)
        # build's parts: the hot plans, the segment's creation and fill,
        # each worker's boot (spawn to constructed units, in parallel)
        parts = {"boot_s": {}}
        plan_hot, fill, boot = st._plan_hot, st._fill_segment, st._boot

        def timed(fn, key):
            def run(*a):
                t0 = time.perf_counter()
                out = fn(*a)
                parts[key] = time.perf_counter() - t0
                return out
            return run

        def timed_boot(t, *a):
            t0 = time.perf_counter()
            boot(t, *a)
            parts["boot_s"][t.worker] = time.perf_counter() - t0
        st._plan_hot = timed(plan_hot, "plan_hot_s")
        st._fill_segment = timed(fill, "segment_s")
        st._boot = timed_boot
        t1 = time.perf_counter()
        st.build(ps_cfg, trace=trace, num_workers=POOL_WORKERS,
                 placement="contiguous", replicate_factor=SHARDED_REPLICATE)
        build_s = time.perf_counter() - t1
        del st._plan_hot, st._fill_segment, st._boot
        del trace
        segment_bytes, threads = int(st._segment.size), st._threads
        procs = [t.proc for t in st._transports]
        pids = [p.pid for p in procs]
        expect(failed, len(st._units) == POOL_WORKERS,
               f"{len(st._units)} units on {POOL_WORKERS} workers")

        # each worker's lookup: the parent's round trip and the worker's own
        # seconds (the difference is the frames' travel)
        rpc = {w: {"round_trip_s": 0.0, "worker_s": 0.0, "calls": 0}
               for w in range(POOL_WORKERS)}
        call = st._call

        def timed_call(w, verb, payload=None):
            t0 = time.perf_counter()
            out = call(w, verb, payload)
            if verb == "lookup":
                rpc[w]["round_trip_s"] += time.perf_counter() - t0
                rpc[w]["worker_s"] += out["seconds"]
                rpc[w]["calls"] += 1
            return out
        st._call = timed_call
        respawn_s = []
        respawn = st._respawn_worker

        def timed_respawn(w):
            t0 = time.perf_counter()
            respawn(w)
            respawn_s.append(time.perf_counter() - t0)
        st._respawn_worker = timed_respawn

        def launches(forwards: int, units: int, name: str) -> dict:
            got = st.take_worker_launches()
            expect(failed, got["fused"] == forwards * units > 0,
                   f"{name}: {got['fused']} fused launches in the workers, "
                   f"{forwards} forwards x {units} units")
            return got

        def serve_batches(name: str) -> tuple[np.ndarray, list, dict]:
            """The batches through the session one at a time, the workers'
            launches taken after each."""
            out, lat, bag, fused_n = [], [], 0, 0
            units = len(st._units)
            for dense, idx in batches:
                scores.clear()
                sess.submit_batch(dense, idx)
                sess.drain(timeout_s=600.0)
                lat.append(sess.stats.batch_latencies_s[-1] * 1e3)
                out.append(np.concatenate(scores))
                got = launches(1, units, name)
                bag += got["bag"]
                fused_n += got["fused"]
            logits = np.concatenate(out)
            equal = bool(np.array_equal(logits, dev_logits))
            expect(failed, equal, f"{name}: pool != device, max diff "
                   f"{np.abs(logits - dev_logits).max():.3e}")
            return logits, lat, {"fused": fused_n, "bag": bag, "units": units,
                                 "logits_equal_device": equal}

        st.take_worker_launches()
        t1 = time.perf_counter()
        sess = ServingSession(model, batcher=BatcherConfig(max_batch=B,
                                                           max_wait_s=0.0))
        warmup_s = time.perf_counter() - t1
        sess.server.on_batch = lambda batch, s: scores.append(s.copy())
        warm = launches(1, len(st._units), "warmup")
        for v in rpc.values():
            v.update(round_trip_s=0.0, worker_s=0.0, calls=0)
        _, lat, before = serve_batches("before migration")
        before.update(batch_ms=lat, warmup_fused=warm["fused"],
                      warmup_bag=warm["bag"])
        stats = st.stats()
        expect(failed, stats["hot_hits"] + stats["warm_hits"]
               + stats["cold_misses"] == stats["total_accesses"] > 0,
               "merged stats break hot + warm + cold == total")
        expect(failed, stats["cold_misses"] == 0 or before["bag"] > 0,
               f"{stats['cold_misses']} cold misses, no bag launch")
        before["stats"] = {k: stats[k] for k in (
            "total_accesses", "hot_hits", "warm_hits", "cold_misses",
            "cache_hit_rate", "cold_gathered_rows")}
        before["rpc"] = {w: dict(v) for w, v in rpc.items()}
        before["cold_tier"] = stats["pool"]

        window = skewed_indices(B, T, L, R, seed=70)
        t1 = time.perf_counter()
        plan = st.plan_migration({"traffic": [window]},
                                 threshold=SHARDED_MIGRATE_THRESHOLD)
        plan_s = time.perf_counter() - t1
        del window
        check(plan is not None, "serve_pool: the skewed window gave no "
                                "migration plan")
        t1 = time.perf_counter()
        res = st.install_migration(plan)
        install_s = time.perf_counter() - t1
        mig = plan["migration"]
        replicated = {int(t): list(mig.new.replicas[t])
                      for t in mig.new.replicated_tables}
        expect(failed, res["migrated"] and 0 in replicated
               and len(replicated[0]) == 2,
               f"migration {res}, replicated {replicated}")
        for v in rpc.values():
            v.update(round_trip_s=0.0, worker_s=0.0, calls=0)
        _, lat2, after = serve_batches("after migration")
        after.update(batch_ms=lat2, routing=st.update_routing())
        after["rpc"] = {w: dict(v) for w, v in rpc.items()}
        # units whose tables are no longer one contiguous run copy them
        after["cold_tier"] = st.stats()["pool"]

        # a worker SIGKILLed between batches: the next batch respawns it
        killed = POOL_WORKERS - 1
        old_pid = st._transports[killed].pid
        st._transports[killed].kill()
        dense, idx = batches[0]
        scores.clear()
        sess.submit_batch(dense, idx)
        sess.drain(timeout_s=600.0)
        kill_ms = sess.stats.batch_latencies_s[-1] * 1e3
        equal_k = bool(np.array_equal(np.concatenate(scores), dev_logits[:B]))
        expect(failed, equal_k, "after the respawn: pool != device")
        expect(failed, len(respawn_s) == 1
               and st._transports[killed].pid != old_pid,
               f"respawns {respawn_s}")
        respawned = {"worker": killed, "respawn_s": respawn_s,
                     "batch_ms": kill_ms, "logits_equal_device": equal_k,
                     "launches": launches(1, len(st._units), "respawn")}
        pids[killed] = st._transports[killed].pid
        sess.server.close()

        # one batch timed directly, as serve_sharded timed its parallel one
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            pooled = model.ebc(idx)
        torch.cuda.synchronize()
        direct_ms = (time.perf_counter() - t1) * 1e3
        st.take_worker_launches()
        want = compact_bag_pooled(st._tables, idx, emb.kernel_opts())
        expect(failed, bool(torch.equal(pooled, want)),
               "the pool's direct batch != the bag kernel's pooling")
        del pooled, want
        status = st.worker_status()
        rss = {"parent": host_rss_bytes(),
               "workers": [proc_rss_bytes(p) for p in pids]}
        worker_peak = [w.get("max_memory_allocated") for w in status]
        shm_served = shm_free_bytes()
        procs += [t.proc for t in st._transports]
        st._call, st._respawn_worker = call, respawn
        t1 = time.perf_counter()
        sess.close()                    # closes the storage: joins workers
        close_s = time.perf_counter() - t1
        joined = all(not p.is_alive() for p in procs) and not st._transports
        expect(failed, joined, "a worker outlived close()")
        del sess, model, st
        gc.collect()
        torch.cuda.empty_cache()
        shm_end = shm_free_bytes()
        expect(failed, abs(shm_start - shm_end) <= POOL_SHM_SLACK_BYTES,
               f"/dev/shm free {shm_start} at the start, {shm_end} after "
               f"close()")
        par = sharded["timing"]["parallel_ms"]
        sharded_mean = float(np.mean(sharded["before_migration"]["batch_ms"]))
        return dict(
            config="dlrm_production", backend="pool", tables=T, rows=R, dim=D,
            pooling=L, batch=B, workers=POOL_WORKERS, shards=POOL_WORKERS,
            placement="contiguous", reduced=reduced, machine=machine,
            ps_config=dataclasses.asdict(ps_cfg), threads_a_worker=threads,
            device={"logits": "serve_sharded's tables and batches (seed 5)"},
            before_migration=before, after_migration=after,
            migration={"describe": mig.describe(), "replicated": replicated,
                       "plan_s": plan_s, "install_s": install_s,
                       "imbalance_before": res.get("imbalance_before"),
                       "imbalance_after": res.get("imbalance_after")},
            respawned=respawned, direct_batch_ms=direct_ms,
            sharded_parallel_ms=par,
            ratio_to_sharded_parallel=direct_ms / par,
            ratio_session_batches=float(np.mean(lat)) / sharded_mean,
            build_s=build_s, build_parts=parts, warmup_s=warmup_s,
            close_s=close_s,
            segment_bytes=segment_bytes,
            worker_peak_device_bytes=worker_peak,
            worker_peak_device_bytes_sum=sum(b or 0 for b in worker_peak),
            host_rss_bytes=rss,
            shm_free_bytes={"start": shm_start, "served": shm_served,
                            "end": shm_end},
            failed=failed)
    finally:
        # idempotent: a failure anywhere above must not leave the workers
        # running or the segment in /dev/shm
        storage.close()


def phase_replay_tenants(cfg, pattern) -> dict:
    """Two tenants, `steady` and `flash`, 32 tables each at full width,
    over ONE shared sharded backend (2 shards, tiers of rows // 10), on a
    virtual clock with max_batch 128 and unpadded batches, twice: `fair`
    scheduling with the budget arbiter, `fifo` without. Traffic is set in
    multiples of one tenant batch's service time measured here. Every
    answer is held to the tenant's own bag-kernel pooling bit for bit;
    every arbiter round to the shared budget; every tenant forward to one
    fused launch per unit of that tenant."""
    gc.collect()
    R, L, D = cfg.embedding.rows, cfg.embedding.pooling, cfg.embedding.dim
    B = TENANT_BATCH
    ps_cfg = tier_ps_config(R)
    names = ("steady", "flash")
    # per table: the tiered host bytes, the tenant model's host tables and
    # the union stack the units are copied from
    per_table = tiered_host_bytes_per_table(ps_cfg, 2048, L, R, D) \
        + 2 * R * D * 4
    avail = host_available_bytes()
    T = min(TENANT_TABLES, int((avail - HOST_HEADROOM_BYTES) // per_table
                               // len(names)))
    reduced = [{"num_tables": [cfg.embedding.num_tables, TENANT_TABLES],
                "per": "tenant",
                "reason": "host memory (the tenant tables, the union stack "
                          "and the units' copies) and the host work of a "
                          "tiered batch per table"}]
    if T < TENANT_TABLES:
        reduced.append({"num_tables": [TENANT_TABLES, T], "per": "tenant",
                        "reason": f"{avail} bytes of host memory "
                                  f"available, {per_table} needed a table"})
    emb = dataclasses.replace(cfg.embedding, num_tables=T,
                              storage="sharded")
    models = {n: DLRM(dataclasses.replace(cfg, embedding=emb),
                      device="cuda", seed=7 + i)
              for i, n in enumerate(names)}
    own_storage = {n: m.ebc.storage for n, m in models.items()}
    rss = {"models": host_rss_bytes()}
    trace = sample_indices(pattern, 2048, len(names) * T, L,
                           seed=TRACE_SEED)
    failed = []

    def manager(scheduling, arbiter):
        return TenantManager(
            [TenantSpec(n, m) for n, m in models.items()],
            backend="sharded",
            batcher=BatcherConfig(max_batch=B, max_wait_s=0.002,
                                  pad_to_max=False),
            controllers=configure(arbiter=arbiter), scheduling=scheduling,
            clock=VirtualClock(), ps_cfg=ps_cfg, trace=trace,
            num_shards=TENANT_SHARDS)

    built = ps_cfg.device_bytes(len(names) * T, D)

    def streams(t_b: float):
        svc_qps = B / t_b
        spec = {
            "steady": dict(kind="steady", n=TENANT_STEADY_QUERIES,
                           base_qps=0.5 * svc_qps),
            "flash": dict(kind="flash", n=TENANT_FLASH_QUERIES,
                          base_qps=0.25 * svc_qps, spike_qps=svc_qps,
                          spike_start_s=t_b, spike_len_s=8.0 * t_b)}
        out = {}
        for i, (name, s) in enumerate(spec.items()):
            gen = make_traffic(
                s["kind"], base_qps=s["base_qps"],
                spike_qps=s.get("spike_qps"),
                spike_start_s=s.get("spike_start_s", 1.0),
                spike_len_s=s.get("spike_len_s", 1.0),
                num_tables=T, rows=R, pooling=L,
                dense_features=cfg.dense_features, seed=90 + i)
            out[name] = timed_queries(gen, s["n"], emb, cfg.dense_features,
                                      pattern, seed=90 + i)
        return spec, out

    calib = {}

    def run_leg(leg: str, scheduling: str) -> dict:
        """One leg on a manager of its own; everything that views the
        leg's union stack is local here, so it is freed on return."""
        arbiter = (ArbiterConfig(every_batches=8, budget_fallback_bytes=built)
                   if scheduling == "fair" else None)
        t1 = time.perf_counter()
        mgr = manager(scheduling, arbiter)
        leg_build_s = time.perf_counter() - t1
        if arbiter is not None:
            # the budget the arbiter splits: the bytes the tiers were built
            # with (a round reads the card's free memory x the fraction)
            free, _ = torch.cuda.mem_get_info()
            arbiter = dataclasses.replace(arbiter,
                                          budget_fraction=built / free)
            mgr.arbiter.cfg = arbiter
        rss[f"{leg}_built"] = host_rss_bytes()
        shared = mgr.shared
        if not calib:
            # one tenant batch's service time, on the first leg's backend;
            # the probe batches are not traffic
            view = mgr.views["steady"]
            probe = sample_indices(pattern, 3 * B, T, L, seed=80)
            dense = np.zeros((B, cfg.dense_features), np.float32)
            cal = []
            for k in range(3):
                t1 = time.perf_counter()
                mgr.session("steady")._forward(
                    dense, probe[k * B:(k + 1) * B]).cpu()
                cal.append(time.perf_counter() - t1)
            view.flush()
            view.reset_stats()
            calib.update(cal=cal, t_b=float(np.mean(cal[1:])))
        taps, law = {}, {n: {"batches": 0, "queries": 0} for n in names}
        # which batches of a tenant are the first after an arbiter round
        # that resized its tiers (a resize rebuilds the warm caches empty):
        # they are timed apart from the others
        resized = {n: False for n in names}
        tiers = {n: (ps_cfg.hot_rows, ps_cfg.warm_slots) for n in names}
        after_resize = {n: [] for n in names}
        for name in names:
            view = mgr.views[name]

            def retune(budget, name=name, inner=view.retune_capacities):
                res = inner(budget)
                if res is not None and \
                        (res["hot_rows"], res["warm_slots"]) != tiers[name]:
                    tiers[name] = (res["hot_rows"], res["warm_slots"])
                    resized[name] = True
                return res
            view.retune_capacities = retune
        for name in names:
            tap = taps[name] = LookupTap(mgr.views[name])
            ns = shared.tenants[name]

            def hold(batch, scores, tap=tap,
                     tables=shared._tables[ns.start:ns.stop], name=name):
                after_resize[name].append(resized[name])
                resized[name] = False
                indices, pooled = tap.last
                want = compact_bag_pooled(tables, indices,
                                          emb.kernel_opts())
                expect(failed, bool(torch.equal(pooled, want)),
                       f"{leg}: tenant {name} != its bag-kernel pooling "
                       f"on a batch of {len(batch)}")
                law[name]["batches"] += 1
                law[name]["queries"] += len(batch)
            mgr.session(name).server.on_batch = hold
        units = {n: len(shared._tenant_units(n)) for n in names}
        calib["spec"], qs = streams(calib["t_b"])
        kernel.LAUNCHES = fused.LAUNCHES = 0
        t1 = time.perf_counter()
        reports = replay_tenants(mgr, qs, window_queries=64)
        replay_s = time.perf_counter() - t1
        pct = mgr.percentiles()
        out = {"build_s": leg_build_s, "replay_s": replay_s,
               "units": units, "tenants": {}}
        for name in names:
            rep, tp, tap = reports[name], pct["tenants"][name], taps[name]
            expect(failed, all(r["fused"] == units[name]
                               for r in tap.records) and tap.records,
                   f"{leg}: tenant {name} fused launches per forward "
                   f"{sorted({r['fused'] for r in tap.records})}, "
                   f"{units[name]} units")
            expect(failed, law[name]["queries"] == rep.served,
                   f"{leg}: law held on {law[name]['queries']} of "
                   f"{rep.served} answers of {name}")
            lat = np.asarray(mgr.session(name).stats.batch_latencies_s)
            first = np.asarray(after_resize[name], bool)
            split = ({"first_after_resize_ms": (lat[first] * 1e3).tolist(),
                      "other_mean_ms": float(lat[~first].mean() * 1e3)
                      if (~first).any() else None}
                     if first.size == lat.size else
                     {"unsplit": f"{first.size} flags, {lat.size} batches"})
            out["tenants"][name] = {
                "submitted": rep.submitted, "admitted": rep.admitted,
                "served": rep.served, "shed": rep.shed,
                "shed_frac": rep.shed_frac, "p50_ms": tp["p50_ms"],
                "p99_ms": tp["p99_ms"], "batches": len(lat),
                "mean_batch_ms": float(lat.mean() * 1e3),
                "fused_per_forward": units[name],
                "bag_launches": sum(r["bag"] for r in tap.records),
                "resize_split": split,
                "law": {**law[name], "equal": True}}
            tap.remove()
            del mgr.views[name].retune_capacities
        if mgr.arbiter is not None:
            ev = mgr.arbiter.events
            conserved = all(sum(e["budgets"].values()) <= e["budget_bytes"]
                            for e in ev)
            splits = [(sum(e["budgets"].values()), e["budget_bytes"])
                      for e in ev]
            expect(failed, conserved and ev,
                   f"{leg}: arbiter rounds (split, budget) {splits}")
            out["arbiter"] = {
                "budget_target_bytes": built,
                "budget_fraction": arbiter.budget_fraction,
                "rounds": len(ev), "conserved": conserved,
                "budget_bytes": [e["budget_bytes"] for e in ev],
                "last_shares": mgr.arbiter.last_shares,
                "depths": [e["depths"] for e in ev]}
        out["fused_launches"] = fused.LAUNCHES
        out["bag_launches"] = kernel.LAUNCHES
        out["device_bytes"] = mgr.stats()["shared"]["device_bytes"]
        rss[leg] = host_rss_bytes()
        mgr.close()
        # the manager bound each tenant model to a view of its backend:
        # unbind them, or the closed backend's union stack stays alive
        for name, model in models.items():
            model.ebc.storage = own_storage[name]
        return out

    legs = {}
    for leg, scheduling in (("fair_arbiter", "fair"), ("fifo", "fifo")):
        t_leg = time.perf_counter()
        legs[leg] = run_leg(leg, scheduling)
        # the collections and their storages point at each other: gc
        # frees the leg's union stack and units before the next leg
        gc.collect()
        torch.cuda.empty_cache()
        rss[f"{leg}_freed"] = host_rss_bytes()
        legs[leg]["seconds"] = time.perf_counter() - t_leg
    del models
    gc.collect()
    fair = legs["fair_arbiter"]["tenants"]["steady"]["p99_ms"]
    fifo = legs["fifo"]["tenants"]["steady"]["p99_ms"]
    return dict(
        config="dlrm_production", backend="sharded (shared)",
        tenants={n: T for n in names}, rows=R, dim=D,
        pooling=L, shards=TENANT_SHARDS, max_batch=B, pad_to_max=False,
        reduced=reduced, ps_config=dataclasses.asdict(ps_cfg),
        calibration_batch_ms=[c * 1e3 for c in calib["cal"]],
        service_rate_qps=B / calib["t_b"], traffic=calib["spec"],
        legs=legs, steady_p99_fair_under_half_fifo=fair < 0.5 * fifo,
        steady_p99_ms={"fair_arbiter": fair, "fifo": fifo},
        host_rss_bytes=rss, host_available_bytes=avail, failed=failed)


def _lm_inputs(cfg, batch: int, seq: int, seed: int) -> dict:
    """Seeded inputs on the host: tokens, and qwen2-vl's patch prefix or
    whisper's frames."""
    rng = np.random.default_rng(seed)
    out = {"toks": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int64))}
    if cfg.vision_prefix_tokens:
        out["ve"] = torch.from_numpy(rng.normal(size=(
            batch, cfg.vision_prefix_tokens, cfg.d_model)).astype(np.float32))
    if cfg.is_encoder_decoder:
        out["frames"] = torch.from_numpy(rng.normal(size=(
            batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
    return out


def _lm_logits(model, cfg, x: dict, device) -> torch.Tensor:
    """Teacher-forced logits of `x` on `device`."""
    x = {k: v.to(device) for k, v in x.items()}
    with torch.inference_mode():
        if cfg.is_encoder_decoder:
            return model.decode(x["toks"], model.encode(x["frames"]))[0]
        return model(x["toks"], vision_embeds=x.get("ve"))


@contextlib.contextmanager
def moe_tap():
    """Record every MoE call's routing (router probabilities, top experts)
    and its capacity's keep mask, by wrapping `moe._route` and
    `moe._dispatch_local` (which `moe_ffn_local` calls) for the block."""
    calls = []
    route, dispatch = lm_moe._route, lm_moe._dispatch_local

    def route_tap(router_w, x, top_k):
        w, e = route(router_w, x, top_k)
        calls.append({"probs": torch.softmax(x.float() @ router_w, -1),
                      "top_e": e})
        return w, e

    def dispatch_tap(x, top_w, top_e, num_experts, capacity):
        buf, info = dispatch(x, top_w, top_e, num_experts, capacity)
        calls[-1]["keep"] = info[4]
        calls[-1]["capacity"] = capacity
        return buf, info
    lm_moe._route, lm_moe._dispatch_local = route_tap, dispatch_tap
    try:
        yield calls
    finally:
        lm_moe._route, lm_moe._dispatch_local = route, dispatch


def _routing_diff(cpu_calls, card_calls, top_k: int) -> dict:
    """Tokens whose experts or keep mask differ between the two runs, and
    the largest gap between a differing token's k-th and (k+1)-th router
    probability on the host (a near-tie flips on rounding)."""
    differ, gap = 0, None
    for a, b in zip(cpu_calls, card_calls, strict=True):
        rows = ((a["top_e"] != b["top_e"].cpu()).any(-1)
                | (a["keep"] != b["keep"].cpu()).reshape(
                    a["top_e"].shape).any(-1))
        differ += int(rows.sum())
        if rows.any():
            p = torch.sort(a["probs"][rows], dim=-1, descending=True).values
            g = float((p[:, top_k - 1] - p[:, top_k]).max())
            gap = g if gap is None else max(gap, g)
    return {"calls": len(cpu_calls), "tokens_differing": differ,
            "max_prob_gap_among_differing": gap}


def phase_lm_zoo() -> dict:
    """All ten LM archs at `reduced` (f32, TF32 off): each built on the
    host from a seeded generator and its state dict copied to the card;
    the card's forward against the host's; prefill 4 + decode 4 against
    the card's own teacher forcing for the reference's five decode archs;
    whisper's cached decode against its full decode; MoE routing on the
    card against the host's."""
    dev = torch.device("cuda")
    failed, archs = [], {}
    for arch in LM_ARCHS:
        t0 = time.perf_counter()
        cfg = reduced(get_config(arch))
        cpu = build_model(cfg, device="cpu", seed=0)
        card = build_model(cfg, device=dev, seed=1)
        card.load_state_dict(cpu.state_dict(), strict=True)
        x = _lm_inputs(cfg, LM_ZOO_BATCH, LM_ZOO_SEQ, seed=0)
        with moe_tap() as cpu_calls:
            want = _lm_logits(cpu, cfg, x, "cpu")
        with moe_tap() as card_calls:
            got = _lm_logits(card, cfg, x, dev).cpu()
        err = (got - want).abs().max().item()
        expect(failed, bool(torch.isfinite(got).all()),
               f"{arch}: non-finite logits on the card")
        expect(failed, torch.allclose(got, want, **LM_FORWARD_TOL),
               f"{arch}: card logits differ from the host's by {err:.3e}")
        rec = {"logits_shape": list(got.shape), "max_abs_err": err}
        if cfg.moe_num_experts:
            rec["routing"] = _routing_diff(cpu_calls, card_calls,
                                           cfg.moe_top_k)
            expect(failed, rec["routing"]["calls"] > 0,
                   f"{arch}: no MoE call seen")
        if arch in LM_DECODE_ARCHS:
            rec["decode_vs_teacher"] = _decode_vs_teacher(
                card, cfg, x["toks"][:1, :LM_ZOO_DECODE_SEQ].to(dev),
                prompt=LM_ZOO_DECODE_SEQ // 2, failed=failed, name=arch)
        if cfg.is_encoder_decoder:
            rec["cached_vs_full"] = _whisper_cached_vs_full(card, cfg, dev,
                                                           failed)
        rec["seconds"] = time.perf_counter() - t0
        archs[arch] = rec
        del cpu, card, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"archs": archs, "forward_tolerance": LM_FORWARD_TOL,
            "decode_tolerance": LM_DECODE_TOL, "failed": failed}


def _decode_vs_teacher(model, cfg, toks, *, prompt: int, failed: list,
                       name: str) -> dict:
    """prefill `prompt` tokens of `toks` [B, S], then decode the rest one
    at a time (teacher tokens): each step's logits against the model's
    own teacher-forced forward over `toks`."""
    b, s = toks.shape
    with torch.inference_mode():
        full = model(toks)
        cache = model.init_cache(b, s, dtype=torch.float32)
        logits, cache = model.prefill(toks[:, :prompt], cache)
        errs = [(logits[:, -1] - full[:, prompt - 1]).abs().max().item()]
        ok = torch.allclose(logits[:, -1], full[:, prompt - 1],
                            **LM_DECODE_TOL)
        for t in range(prompt, s):
            logits, cache = model.decode_step(toks[:, t:t + 1], cache, t)
            errs.append((logits[:, 0] - full[:, t]).abs().max().item())
            ok &= torch.allclose(logits[:, 0], full[:, t], **LM_DECODE_TOL)
    expect(failed, ok, f"{name}: decode differs from teacher forcing by "
                       f"{max(errs):.3e}")
    return {"prompt": prompt, "steps": s - prompt, "max_abs_err": max(errs)}


def _whisper_cached_vs_full(model, cfg, dev, failed: list) -> dict:
    x = _lm_inputs(cfg, 1, 8, seed=2)
    toks = x["toks"].to(dev)
    errs, ok = [], True
    with torch.inference_mode():
        enc = model.encode(x["frames"].to(dev))
        full, _ = model.decode(toks, enc)
        cache = model.init_cache(1, 8, dtype=torch.float32)
        for t in range(4):
            step, cache = model.decode(toks[:, t:t + 1], enc, cache=cache,
                                       cache_pos=t)
            errs.append((step[:, 0] - full[:, t]).abs().max().item())
            ok &= torch.allclose(step[:, 0], full[:, t], **LM_DECODE_TOL)
    expect(failed, ok, f"whisper: cached decode differs from the full by "
                       f"{max(errs):.3e}")
    return {"steps": 4, "max_abs_err": max(errs)}


def _lm_consistency(cfg, failed: list, name: str) -> dict:
    """lm_serve (a)/(c): f32 at full width, batch 2, a 64-token prompt,
    then 16 greedy decode steps; each step's logits against the
    teacher-forced forward over the same 80 tokens, and the greedy tokens
    against that forward's argmax (a disagreement must be a near-tie:
    top-2 gap under the tolerance)."""
    dev = torch.device("cuda")
    b, p, n = LM_CONSIST_BATCH, LM_CONSIST_PROMPT, LM_CONSIST_STEPS
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab_size, (b, p), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    with torch.inference_mode():
        cache = model.init_cache(b, p + n, dtype=torch.float32)
        logits, cache = model.prefill(toks, cache)
        steps = [logits[:, -1]]
        gen = [steps[-1].argmax(-1)]
        for t in range(p, p + n):
            logits, cache = model.decode_step(gen[-1][:, None], cache, t)
            steps.append(logits[:, 0])
            gen.append(steps[-1].argmax(-1))
        seq = torch.cat([toks, torch.stack(gen[:-1], 1)], dim=1)  # 80 tokens
        full = model(seq)[:, p - 1:]                    # positions 63..79
        steps = torch.stack(steps, 1)
        err = (steps - full).abs().max().item()
        ok = torch.allclose(steps, full, **LM_DECODE_TOL)
        top2 = full.topk(2, dim=-1).values
        agree = full.argmax(-1) == torch.stack(gen, 1)
        near_tie = (top2[..., 0] - top2[..., 1]) < LM_DECODE_TOL["atol"]
    expect(failed, bool(torch.isfinite(steps).all()),
           f"{name}: non-finite decode logits")
    expect(failed, ok, f"{name}: decode differs from teacher forcing by "
                       f"{err:.3e}")
    expect(failed, bool((agree | near_tie).all()),
           f"{name}: greedy tokens differ from teacher forcing away from a "
           f"near-tie")
    out = {"batch": b, "prompt": p, "steps": n, "dtype": cfg.dtype,
           "params": sum(q.numel() for q in model.parameters()),
           "init_s": init_s, "max_abs_err": err,
           "greedy_agree": int(agree.sum()), "greedy_total": agree.numel(),
           "near_ties": int((~agree & near_tie).sum()),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del model, cache, full, steps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _lm_floor(cfg, params: dict, batch: int, tokens: int, kv_len: int,
              logits: int, expert_frac: float = 1.0) -> int:
    """The least bytes a call must move: each weight it needs once (an
    untied input embedding: the rows gathered; routed experts: the share
    `expert_frac` that this run's tokens reached), the KV cache it reads
    (`kv_len` positions) or writes, the logits it writes."""
    weights = 0.0
    for name, p in params.items():
        n = p.numel() * p.element_size()
        if name == "embed" and not cfg.tie_embeddings:
            n = batch * tokens * cfg.d_model * p.element_size()
        elif p.dim() == 3 and name.rsplit(".", 1)[-1] in ("wi", "wg", "wo"):
            n *= expert_frac
        weights += n
    specs = build_plan(cfg).layers()
    per_pos = sum(
        2 * cfg.num_kv_heads * cfg.hd if s.mixer in ("attn", "attn_local")
        else cfg.kv_lora_rank + cfg.qk_rope_dim if s.mixer == "mla" else 0
        for s in specs) * cfg.torch_dtype.itemsize
    return int(weights + batch * max(kv_len, tokens) * per_pos
               + batch * logits * cfg.vocab_size * cfg.torch_dtype.itemsize)


def _lm_opcost(cfg, batch: int, prompt: int, s_max: int) -> dict:
    """`OpCost` of a prefill and of one decode step (at the middle of the
    decode) at these shapes, on meta tensors."""
    model, params = abstract_params(cfg)
    meta = torch.device("meta")
    cache = model.init_cache(batch, s_max)
    out = {}
    with OpCost() as cost:
        model.prefill(torch.zeros((batch, prompt), dtype=torch.long,
                                  device=meta), cache)
    out["prefill"] = cost.total()
    with OpCost() as cost:
        model.decode_step(torch.zeros((batch, 1), dtype=torch.long,
                                      device=meta), cache,
                          prompt + LM_SERVE_STEPS // 2)
    out["decode"] = cost.total()
    return out, params


def _lm_time(model, cfg, batch: int, failed: list, name: str,
             smi: str) -> dict:
    """lm_serve (b): a 512-token prompt and 64 greedy decode steps at
    `batch`, bf16. Prefill: CUDA events, median of 3. Decode: an event
    before each step (no host sync inside the loop: each step's token
    stays on the card), the host clock around each call (its enqueue);
    one profiled window of 8 steps for the device's busy time and the ops
    that take it."""
    dev = torch.device("cuda")
    p, n = LM_SERVE_PROMPT, LM_SERVE_STEPS
    prompt = torch.randint(0, cfg.vocab_size, (batch, p), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(4))
    cache = model.init_cache(batch, p + n)

    def decode(first, steps, events=None, enqueue=None):
        toks = [first]
        for t in range(p, p + steps):
            if events is not None:
                events[t - p].record()
            h0 = time.perf_counter()
            logits, _ = model.decode_step(toks[-1], cache, t)
            toks.append(logits[:, -1:].argmax(-1))
            if enqueue is not None:
                enqueue.append((time.perf_counter() - h0) * 1e3)
        if events is not None:
            events[steps].record()
        return toks

    with torch.inference_mode():
        logits, _ = model.prefill(prompt, cache)            # warm-up
        decode(logits[:, -1:].argmax(-1), 4)
        prefill_ms = []
        for _ in range(3):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            e0.record()
            logits, _ = model.prefill(prompt, cache)
            e1.record()
            torch.cuda.synchronize()
            prefill_ms.append(e0.elapsed_time(e1))
        events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        enqueue = []
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        toks = decode(logits[:, -1:].argmax(-1), n, events, enqueue)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - w0
        step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(n)]
        ids = torch.cat(toks, 1)
        # the host's own time a step: from an idle card, so no launch
        # waits on a full queue (in the loop above the host is held back
        # to the card's pace once the queue fills)
        host_ms = []
        for t in range(p, p + 3):
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            model.decode_step(toks[-1], cache, t)
            host_ms.append((time.perf_counter() - h0) * 1e3)
        torch.cuda.synchronize()
        busy = _profiled_busy_ms(decode, toks[0])
    expect(failed, bool(((ids >= 0) & (ids < cfg.vocab_size)).all()),
           f"{name}: greedy ids out of the vocabulary")
    p50 = float(np.percentile(step_ms, 50))
    out = {"batch": batch, "prompt": p, "steps": n,
           "prefill_ms": float(np.median(prefill_ms)),
           "prefill_ms_runs": prefill_ms,
           "decode_step_ms_p50": p50,
           "decode_step_ms_p99": float(np.percentile(step_ms, 99)),
           "decode_wall_s": wall_s,
           "decode_tokens_per_s": batch * n / wall_s,
           "enqueue_ms_p50": float(np.percentile(enqueue, 50)),
           "host_ms_per_step": float(np.median(host_ms)),
           "host_share_of_step": float(np.median(host_ms)) / p50,
           "profiled": busy,
           "greedy_ids_row0": ids[0, 1:].tolist(),
           "device": smi}
    if busy.get("busy_ms_per_step") is not None:
        out["device_idle_share"] = 1.0 - busy["busy_ms_per_step"] / p50
    return out


def _profiled_busy_ms(decode, first, steps: int = LM_PROFILED_STEPS) -> dict:
    """The device's busy time a decode step: the sum of its kernels' own
    device time over `steps` profiled steps (torch.profiler), or why not."""
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode(first, steps)
            torch.cuda.synchronize()
        # the device's own entries (kernels, copies) give the busy time;
        # the host ops' self device time attributes it to aten ops
        us, by_op = 0.0, {}
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
            if "CUDA" in str(ev.device_type):
                us += t
            elif t > 0:
                by_op[ev.key] = t
    except Exception as exc:    # the profiler is untried on that machine
        return {"busy_ms_per_step": None, "error": repr(exc)}
    if us <= 0:
        return {"busy_ms_per_step": None,
                "error": "key_averages() shows no device time"}
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:LM_PROFILED_TOP]
    return {"busy_ms_per_step": us / 1e3 / steps, "steps": steps,
            "ops_ms_per_step": sum(by_op.values()) / 1e3 / steps,
            "top_ops_ms_per_step": {k: v / 1e3 / steps for k, v in top}}


def _lm_records(arch: str, cfg, batch: int, timed: dict, cost: dict,
                params: dict, peak: int, smi: str,
                expert_frac: dict | None = None) -> dict:
    """One record a measured call (the prefill and a decode step) for
    `repro_torch.roofline.report`, written under build/lm_roofline/, and
    the bounds beside the times."""
    p, n = LM_SERVE_PROMPT, LM_SERVE_STEPS
    out = {}
    for shape, tokens, kv_len, logits, ms in (
            ("prefill", p, p, 1, timed["prefill_ms"]),
            ("decode", 1, p + n // 2, 1, timed["decode_step_ms_p50"])):
        floor_bytes = _lm_floor(cfg, params, batch, tokens, kv_len, logits,
                                (expert_frac or {}).get(shape, 1.0))
        c = cost[shape]
        floor_ms = max(floor_bytes / HBM_BW, c["flops"] / PEAK_FLOPS_BF16) \
            * 1e3
        terms = roofline_terms(c, num_chips=1)
        rec = {"arch": arch, "shape": f"{shape}_b{batch}", "mesh": "single",
               "cell": f"{arch}__{shape}_b{batch}__single", "status": "ok",
               "roofline": terms, "memory": {"per_device_total": peak},
               "model_flops_global": model_flops(cfg, batch * tokens,
                                                 "decode"),
               "floor_bytes": floor_bytes, "floor_ms": floor_ms,
               "measured_ms": ms, "device": smi}
        write_json(os.path.join(LM_ROOFLINE_DIR, rec["cell"] + ".json"), rec)
        out[shape] = {"ms": ms, "floor_bytes": floor_bytes,
                      "floor_ms": floor_ms,
                      "floor_by": ("bytes" if floor_bytes / HBM_BW
                                   >= c["flops"] / PEAK_FLOPS_BF16
                                   else "operations"),
                      "share_of_floor": floor_ms / ms,
                      "opcost_bytes": c["bytes"], "opcost_flops": c["flops"],
                      "opcost_memory_ms": terms["memory_s"] * 1e3,
                      "opcost_compute_ms": terms["compute_s"] * 1e3,
                      "share_of_opcost_bound": max(
                          terms["memory_s"], terms["compute_s"]) * 1e3 / ms}
    return out


def phase_lm_serve(smi: str) -> dict:
    """phi4-mini-3.8b at full width and depth: (a) f32 consistency, (b)
    bf16 serving at batch 1 and 8; deepseek-v2-lite at full width, depth 4:
    (c) f32 consistency (dropless), bf16 serving at batch 8 under the
    published capacity factor, with the tokens capacity drops."""
    dev = torch.device("cuda")
    failed = []
    shutil.rmtree(LM_ROOFLINE_DIR, ignore_errors=True)
    bag0, fused0 = kernel.LAUNCHES, fused.LAUNCHES
    phi = get_config("phi4-mini-3.8b")
    ds = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                             num_layers=LM_DEEPSEEK_LAYERS)
    out = {"phi4_consistency": _lm_consistency(
        dataclasses.replace(phi, dtype="float32"), failed, "phi4 f32")}

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(phi, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    serve = {"init_s": init_s, "dtype": phi.dtype,
             "params": sum(q.numel() for q in model.parameters()),
             "weight_bytes": sum(q.numel() * q.element_size()
                                 for q in model.parameters())}
    for batch in LM_SERVE_BATCHES:
        timed = _lm_time(model, phi, batch, failed, f"phi4 b{batch}", smi)
        cost, params = _lm_opcost(phi, batch, LM_SERVE_PROMPT,
                                  LM_SERVE_PROMPT + LM_SERVE_STEPS)
        peak = torch.cuda.max_memory_allocated()
        timed["bounds"] = _lm_records("phi4-mini-3.8b", phi, batch, timed,
                                      cost, params, peak, smi)
        timed["peak_memory_bytes"] = peak
        serve[f"b{batch}"] = timed
    out["phi4_serve"] = serve
    del model
    gc.collect()
    torch.cuda.empty_cache()

    out["deepseek_consistency"] = _lm_consistency(
        dataclasses.replace(ds, dtype="float32",
                            moe_capacity_factor=LM_DROPLESS_FACTOR),
        failed, "deepseek f32")
    torch.cuda.reset_peak_memory_stats()
    model = build_model(ds, device=dev, seed=0)
    batch = LM_DEEPSEEK_BATCH
    timed = _lm_time(model, ds, batch, failed, f"deepseek b{batch}", smi)
    with moe_tap() as calls, torch.inference_mode():
        # the drops of one prefill and its 64 decode steps, untimed
        cache = model.init_cache(batch, LM_SERVE_PROMPT + LM_SERVE_STEPS)
        toks = torch.randint(0, ds.vocab_size, (batch, LM_SERVE_PROMPT),
                             device=dev, generator=torch.Generator(
                                 device=dev).manual_seed(4))
        logits, _ = model.prefill(toks, cache)
        n_prefill = len(calls)
        tok = logits[:, -1:].argmax(-1)
        for t in range(LM_SERVE_PROMPT, LM_SERVE_PROMPT + LM_SERVE_STEPS):
            logits, _ = model.decode_step(tok, cache, t)
            tok = logits[:, -1:].argmax(-1)
    drops, expert_frac = {}, {}
    for leg, legs in (("prefill", calls[:n_prefill]),
                      ("decode", calls[n_prefill:])):
        kept = sum(int(c["keep"].sum()) for c in legs)
        total = sum(c["keep"].numel() for c in legs)
        # experts that computed a kept token, a call (the floor's share)
        reached = [int(torch.unique(c["top_e"].reshape(-1)[c["keep"]])
                       .numel()) for c in legs]
        expert_frac[leg] = float(np.mean(reached)) / ds.moe_num_experts
        drops[leg] = {"moe_calls": len(legs), "assignments": total,
                      "dropped": total - kept,
                      "capacity": sorted({c["capacity"] for c in legs}),
                      "experts_reached_mean": float(np.mean(reached))}
    expect(failed, drops["decode"]["capacity"] == [1],
           f"deepseek decode capacity {drops['decode']['capacity']}, not 1")
    cost, params = _lm_opcost(ds, batch, LM_SERVE_PROMPT,
                              LM_SERVE_PROMPT + LM_SERVE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    timed["bounds"] = _lm_records("deepseek-v2-lite-16b-4l", ds, batch,
                                  timed, cost, params, peak, smi,
                                  expert_frac)
    timed["peak_memory_bytes"] = peak
    timed["moe_drops"] = drops
    out["deepseek_serve"] = {"layers": ds.num_layers,
                             "capacity_factor": ds.moe_capacity_factor,
                             f"b{batch}": timed}
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()

    out["kernel_launches"] = {"embedding_bag": kernel.LAUNCHES - bag0,
                              "fused_warm_lookup": fused.LAUNCHES - fused0}
    expect(failed, out["kernel_launches"] == {"embedding_bag": 0,
                                              "fused_warm_lookup": 0},
           "the LM path launched a DLRM kernel")
    out["roofline_dir"] = os.path.relpath(LM_ROOFLINE_DIR, ROOT)
    out["failed"] = failed
    return out


# ---------------------------------------------------------------------------
# The SPMD layer on a one-card mesh
# ---------------------------------------------------------------------------

def spmd_group():
    """The default NCCL process group of one rank over a file:// store
    under build/, and the (1, 1) debug mesh on it, on the card."""
    import torch.distributed as dist
    os.makedirs(os.path.dirname(SPMD_STORE), exist_ok=True)
    if os.path.exists(SPMD_STORE):
        os.remove(SPMD_STORE)
    dist.init_process_group("nccl", init_method=f"file://{SPMD_STORE}",
                            world_size=1, rank=0)
    return make_debug_mesh((1, 1), device_type="cuda")


def end_spmd_group() -> None:
    """Destroy the spmd phases' process group, if one is up."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _lm_batch(cfg, seq: int, dev) -> tuple:
    g = torch.Generator().manual_seed(20)
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1), generator=g)
    return toks[:, :-1].to(dev), toks[:, 1:].to(dev)


def _plain_lm_step(cfg, dev, tokens, labels) -> tuple:
    """The train step without a mesh: `TransformerLM.loss` (remat,
    vocab_chunk 512, as `make_lm_train_step`'s) + autograd +
    `adamw_lowmem_update`, on plain tensors. Returns (the first step's
    loss, the parameters it updated, on the host, and the seconds of a
    second step)."""
    model = build_model(cfg, device=dev, seed=0)
    params = {n: q for n, q in model.named_parameters() if q.requires_grad}
    opt = adamw_lowmem_init(params)

    def step():
        loss = model.loss(tokens, labels, remat=True, vocab_chunk=512)
        grads = torch.autograd.grad(loss, list(params.values()))
        adamw_lowmem_update(params, dict(zip(params, grads)), opt, lr=1e-4)
        return float(loss)
    first = step()
    host = {n: q.detach().to("cpu", copy=True) for n, q in params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    return first, host, time.perf_counter() - t0


def _max_abs_diff(model, host: dict) -> float:
    """max |d| of `model`'s parameters (DTensors) against host copies;
    bitwise-equal tensors (the expected case) skip the f32 arithmetic."""
    diff = 0.0
    for n, q in model.named_parameters():
        if n not in host:
            continue
        got = q.to_local().detach().cpu()
        if not torch.equal(got, host[n]):
            diff = max(diff, float((got.float() - host[n].float())
                                   .abs().max()))
    return diff


def phase_spmd_lm_train(mesh, smi: str) -> dict:
    """`make_lm_train_step` on the one-card mesh: phi4-mini at full width
    and depth in bf16, batch 1 x SPMD_LM_SEQ tokens, SPMD_LM_STEPS steps
    on one batch; the first against the plain step (deterministic
    algorithms): the loss within SPMD_LOSS_RTOL, the updated parameters
    bit for bit (the same aten ops on one card)."""
    dev = torch.device("cuda")
    cfg, seq, steps = get_config(SPMD_LM_ARCH), SPMD_LM_SEQ, SPMD_LM_STEPS
    failed: list = []
    tokens, labels = _lm_batch(cfg, seq, dev)
    shape = ShapeConfig("train_4k_per_chip", seq, 1, "train")
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
           "batch": 1, "seq": seq, "steps": steps, "nvidia_smi": smi,
           "loss_tolerance": f"rtol {SPMD_LOSS_RTOL}"}
    with deterministic_algorithms():
        t0 = time.perf_counter()
        plain_loss, plain_params, plain_s = _plain_lm_step(cfg, dev, tokens,
                                                           labels)
        out["plain_phase_s"] = time.perf_counter() - t0
        out["plain_step_ms"] = plain_s * 1e3
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev, seed=0)
        bundle = make_lm_train_step(cfg, shape, mesh, model=model)
        batch = distribute_inputs({"tokens": tokens, "labels": labels},
                                  bundle.in_shardings[2], mesh)
        _, opt, _ = bundle.inputs
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        out["parallel_mode"] = bundle.meta["parallel_mode"]
        losses, step_s = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            loss, model, opt = bundle.fn(model, opt, batch)
            losses.append(float(loss.full_tensor()))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if i == 0:
                diff = _max_abs_diff(model, plain_params)
                del plain_params
        out["profiled_step"] = _profiled_busy_ms(   # one more, apart
            lambda _first, n: [bundle.fn(model, opt, batch)
                               for _ in range(n)], None, steps=1)
    rel = abs(losses[0] - plain_loss) / max(abs(plain_loss), 1e-9)
    p50 = float(np.median(step_s[1:])) if steps > 1 else step_s[0]
    flops = model_flops(cfg, seq, "train")
    finite = tree_finite(dict(model.named_parameters()))
    out.update(
        losses=losses, plain_first_loss=plain_loss,
        first_loss_rel_diff=rel, first_step_params_max_abs_diff=diff,
        step_s=step_s, step_p50_ms=p50 * 1e3, tokens_per_s=seq / p50,
        model_flops=flops, mfu_bf16=flops / p50 / PEAK_FLOPS_BF16,
        params_finite=finite,
        peak_memory_bytes=torch.cuda.max_memory_allocated())
    expect(failed, rel <= SPMD_LOSS_RTOL,
           f"first loss {losses[0]} vs plain {plain_loss} (rel {rel})")
    expect(failed, diff == 0.0,
           f"first step's parameters differ from the plain step's: max "
           f"|d| {diff}")
    expect(failed, losses[-1] < losses[0], f"loss did not fall: {losses}")
    expect(failed, finite, "a parameter is not finite")
    out["failed"] = failed
    del model, opt, bundle, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_spmd_dlrm_serve(mesh, model, dense, idx, want_logits) -> dict:
    """`make_dlrm_serve_step` over `model`'s own tables, wrapped without a
    copy (a twin module shares them; `model` stays plain): the logits
    against the serve phase's for the same batch, bit for bit, and one bag
    launch a forward."""
    failed: list = []
    twin = DLRM(model.cfg, device=model.device, tables=model.ebc.tables)
    twin.bottom.load_state_dict(model.bottom.state_dict())
    twin.top.load_state_dict(model.top.state_dict())
    table_ptr = model.ebc.tables.data_ptr()
    bundle = make_dlrm_serve_step(model.cfg, mesh, batch=dense.shape[0],
                                  model=twin)
    wrapped = twin.ebc.tables.to_local().data_ptr() == table_ptr
    batch = distribute_inputs(
        {"dense": torch.from_numpy(dense).to(model.device),
         "indices": torch.from_numpy(idx).to(model.device)},
        bundle.in_shardings[1], mesh)
    launches0 = kernel.LAUNCHES
    t0 = time.perf_counter()
    logits = bundle.fn(twin, batch).full_tensor()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = kernel.LAUNCHES - launches0
    got = logits.cpu().numpy()
    equal = bool(np.array_equal(got, want_logits))
    expect(failed, wrapped, "the tables were copied, not wrapped")
    expect(failed, equal, "spmd logits differ from the serve phase's: max "
           f"|d| {float(np.abs(got - want_logits).max())}")
    expect(failed, launches == 1, f"{launches} bag launches in one forward")
    del twin, bundle, batch
    return {"batch": int(dense.shape[0]), "tables_wrapped": wrapped,
            "logits_equal": equal, "max_abs_diff": float(
                np.abs(got - want_logits).max()),
            "bag_launches": launches, "forward_ms_first": ms,
            "failed": failed}


def phase_spmd_dlrm_train(mesh, cfg, pattern, *, tables: int =
                          TRAIN_WIDE_TABLES, batch: int = TRAIN_WIDE_BATCH
                          ) -> dict:
    """`make_dlrm_train_step` at the train phase's wide widths, one SGD
    step, against the same step without a mesh (deterministic algorithms):
    the loss and every updated parameter bit for bit."""
    dev = torch.device("cuda")
    failed: list = []
    gc.collect()
    torch.cuda.empty_cache()
    emb = dataclasses.replace(cfg.embedding, num_tables=tables,
                              shard_pad_tables=0)
    cfg_w = dataclasses.replace(cfg, embedding=emb)
    rng = np.random.default_rng(9)
    dense = torch.from_numpy(rng.standard_normal(
        (batch, cfg.dense_features), dtype=np.float32)).to(dev)
    idx = torch.from_numpy(sample_indices(pattern, batch, tables,
                                          emb.pooling, seed=90)).to(dev)
    labels = torch.from_numpy((rng.random(batch) < 0.2).astype(
        np.float32)).to(dev)
    with deterministic_algorithms():
        plain = DLRM(cfg_w, device=dev, seed=7)
        plain.ebc.tables.requires_grad_(True)
        named = dict(plain.named_parameters())
        named["ebc.tables"] = plain.ebc.tables
        launches0 = kernel.LAUNCHES
        loss_p = plain.loss(dense, idx, labels)
        grads = torch.autograd.grad(loss_p, list(named.values()))
        with torch.no_grad():
            for q, g in zip(named.values(), grads):
                q.sub_(SPMD_DLRM_LR * g)
        del grads
        plain_launches = kernel.LAUNCHES - launches0
        spmd = DLRM(cfg_w, device=dev, seed=7)
        bundle = make_dlrm_train_step(cfg_w, mesh, batch=batch, model=spmd,
                                      lr=SPMD_DLRM_LR)
        inputs = distribute_inputs(
            {"dense": dense, "indices": idx, "labels": labels},
            bundle.in_shardings[1], mesh)
        launches0 = kernel.LAUNCHES
        t0 = time.perf_counter()
        loss_s, spmd = bundle.fn(spmd, inputs)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = kernel.LAUNCHES - launches0
    got = dict(spmd.named_parameters())
    got["ebc.tables"] = spmd.ebc.tables
    unequal = [n for n, q in named.items()
               if not torch.equal(got[n].to_local().detach(), q.detach())]
    loss_equal = float(loss_s.full_tensor()) == float(loss_p)
    expect(failed, loss_equal,
           f"loss {float(loss_s.full_tensor())} vs plain {float(loss_p)}")
    expect(failed, not unequal, f"parameters differ: {unequal}")
    expect(failed, launches == plain_launches >= 1,
           f"{launches} bag launches in the spmd step, {plain_launches} in "
           "the plain one")
    out = {"tables": tables, "batch": batch, "loss": float(loss_p),
           "loss_equal": loss_equal, "params_unequal": unequal,
           "bag_launches": launches, "plain_bag_launches": plain_launches,
           "step_ms_first": step_ms, "failed": failed}
    del plain, spmd, bundle, inputs, named, got
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the no-mesh count of `spmd_dryrun`'s prefill cell, a process of its own
_PREFILL_NO_MESH = """
import sys
from repro_torch.configs import get_config
from repro_torch.launch.steps import lm_inputs
from repro_torch.models import build_model
from repro_torch.models.config import SHAPES
from repro_torch.roofline.analyze import OpCost
cfg = get_config(sys.argv[1])
model = build_model(cfg, device="meta")
x = lm_inputs(cfg, SHAPES[sys.argv[2]], model)
with OpCost() as cost:
    model.prefill(x["tokens"], x["cache"])
print("FLOPS", cost.total()["flops"])
"""
_DRYRUN_PROCS: list = []


def start_spmd_dryrun() -> None:
    """Start the production-mesh dry-run of seven cells, each in its own
    process (a fake group of 256 or 512 ranks, meta tensors, no card),
    and the count of the prefill cell without a mesh: CPU work that runs
    beside the card's phases until `phase_spmd_dryrun` collects it."""
    shutil.rmtree(SPMD_DRYRUN_DIR, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")

    def start(argv):
        return subprocess.Popen([sys.executable, *argv], env=env, cwd=ROOT,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    _DRYRUN_PROCS[:] = [(time.perf_counter(), "prefill_no_mesh", start(
        ["-c", _PREFILL_NO_MESH, "phi4-mini-3.8b", "prefill_32k"]))] + [
        (time.perf_counter(), (arch, shape, mesh), start(
            ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--mesh", mesh, "--out", SPMD_DRYRUN_DIR]))
        for arch, shape, mesh in SPMD_DRYRUN_CELLS]


def stop_spmd_dryrun() -> None:
    """Kill what `start_spmd_dryrun` started and is still running."""
    for _, _, proc in _DRYRUN_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    _DRYRUN_PROCS.clear()


def _collect(started: float, proc) -> str:
    try:
        log, _ = proc.communicate(timeout=max(
            1.0, SPMD_DRYRUN_TIMEOUT_S - (time.perf_counter() - started)))
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
    return log


def phase_spmd_dryrun() -> dict:
    """Collect `start_spmd_dryrun`'s processes (each within 300 s of its
    start) and hold their records to the checks."""
    failed: list = []
    (t_pre, _, pre), *procs = _DRYRUN_PROCS
    log = _collect(t_pre, pre)
    plain_prefill = (float(log.split("FLOPS")[1].split()[0])
                     if pre.returncode == 0 else float("nan"))
    expect(failed, pre.returncode == 0,
           f"prefill without a mesh: rc {pre.returncode}: {log[-500:]}")
    cells = {}
    for started, (arch, shape, mesh), proc in procs:
        log = _collect(started, proc)
        tag = f"{arch}__{shape}__{mesh}"
        path = os.path.join(SPMD_DRYRUN_DIR, tag + ".json")
        rec = read_json(path) if os.path.exists(path) else {}
        status = rec.get("status", "missing")
        cell = {"status": status, "rc": proc.returncode}
        if status == "ok":
            r, m = rec["roofline"], rec["memory"]
            cell.update(per_device_bytes=m["per_device_total"],
                        fits_80GB_HBM=m["fits_80GB_HBM"],
                        dominant=r["dominant"],
                        per_device_flops=r["per_device_flops"],
                        compute_s=r["compute_s"], memory_s=r["memory_s"],
                        collective_s=r["collective_s"],
                        collective_breakdown=r["collective_breakdown"],
                        num_chips=rec["num_chips"], torch=rec["torch"],
                        seconds=rec["lower_s"] + rec["compile_s"])
        else:
            cell["log_tail"] = log[-1500:]
        cells[tag] = cell
        expect(failed, status == "ok", f"dryrun {tag}: {status}")
    _DRYRUN_PROCS.clear()
    ds = cells.get("deepseek-v2-lite-16b__train_4k__single", {})
    expect(failed, "all_to_all_single" in ds.get("collective_breakdown", {}),
           "deepseek's expert all-to-all is not counted")
    wh = cells.get("whisper-medium__train_4k__single", {})
    expect(failed, wh.get("fits_80GB_HBM") is True,
           f"whisper train_4k: {wh.get('per_device_bytes')} B a device")

    def global_flops(tag):
        c = cells.get(tag, {})
        return c.get("per_device_flops", float("nan")) * c.get("num_chips", 0)
    train = {m: global_flops(f"phi4-mini-3.8b__train_4k__{m}")
             for m in ("single", "multi")}
    prefill = global_flops("phi4-mini-3.8b__prefill_32k__single")
    ratios = {"train_multi_over_single": train["multi"] / train["single"]
              if train["single"] else float("nan"),
              "prefill_over_no_mesh": prefill / plain_prefill}
    for name, ratio in ratios.items():
        expect(failed, abs(ratio - 1.0) <= SPMD_FLOPS_RTOL,
               f"phi4-mini {name} {ratio}")
    return {"cells": cells, "global_flops_ratios": ratios,
            "prefill_flops_no_mesh": plain_prefill, "failed": failed}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--stop-after", default=None,
                        help="end the run after this phase")
    parser.add_argument("--geometry-sweep", action="store_true",
                        help="kernel_diag also times both kernels at each "
                             "of seven launch geometries")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2

    # cuBLAS's deterministic workspace, read when the train phase turns
    # deterministic algorithms on; set before the first matmul
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_all = time.perf_counter()
    # 1. device
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         seconds=time.perf_counter() - t0)

    def stop(phase: str) -> bool:
        if args.stop_after == phase:
            end_spmd_group()
            stop_spmd_dryrun()
            emit("stopped", after=phase,
                 seconds=time.perf_counter() - t_all)
        return args.stop_after == phase

    # 2. build: one nvcc per library, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as ex:
        infos = list(ex.map(lambda build: build(),
                            (kernel.build, fused.build, interaction.build)))
    libs = {}
    for lib, info in zip(("embedding_bag", "fused_lookup",
                          "dot_interaction"), infos):
        libs[lib] = {
            "path": os.path.relpath(info["path"], ROOT),
            "nvcc_seconds": info["seconds"], "cached": info["cached"],
            "ptxas": [ln.strip() for ln in info["log"].splitlines()
                      if "registers" in ln or "spill" in ln]}
    emit("build", libraries=libs, seconds=time.perf_counter() - t0)
    if stop("build"):
        return 0

    # 2b. lm_zoo: the ten LM archs at `reduced`, card against host
    t0 = time.perf_counter()
    zoo = phase_lm_zoo()
    emit("lm_zoo", **zoo, seconds=time.perf_counter() - t0)
    check(not zoo["failed"], f"lm_zoo: {zoo['failed']}")
    if stop("lm_zoo"):
        return 0

    # 2c. lm_serve: phi4-mini at full width and depth, deepseek at depth 4
    t0 = time.perf_counter()
    lm = phase_lm_serve(smi)
    emit("lm_serve", **lm, seconds=time.perf_counter() - t0)
    lm_report.main(["--dir", LM_ROOFLINE_DIR])
    check(not lm["failed"], f"lm_serve: {lm['failed']}")
    if stop("lm_serve"):
        return 0

    # 2d. spmd_lm_train: the LM train step on the one-card mesh; the
    # dry-run's processes (8g, CPU only) start here and run beside it
    start_spmd_dryrun()
    t0 = time.perf_counter()
    mesh = spmd_group()
    spmd_lm = phase_spmd_lm_train(mesh, smi)
    emit("spmd_lm_train", **spmd_lm, seconds=time.perf_counter() - t0)
    check(not spmd_lm["failed"], f"spmd_lm_train: {spmd_lm['failed']}")
    if stop("spmd_lm_train"):
        return 0

    # 3. parity
    t0 = time.perf_counter()
    parity = phase_parity()
    emit("parity", **parity, seconds=time.perf_counter() - t0)

    # 4. parity_fused
    t0 = time.perf_counter()
    parity_fused = phase_parity_fused()
    emit("parity_fused", **parity_fused, seconds=time.perf_counter() - t0)
    if stop("parity_fused"):
        return 0

    # 4b. interaction: the dot-interaction kernel against its plain version
    t0 = time.perf_counter()
    inter = phase_interaction()
    emit("interaction", **inter, seconds=time.perf_counter() - t0)
    check(not inter["failed"], f"interaction: {inter['failed']}")
    if stop("interaction"):
        return 0

    # 4c. ragged: the ragged-tables bag kernel, and dlrm-dcnv2 at full width
    t0 = time.perf_counter()
    ragged = phase_ragged()
    emit("ragged", **ragged, seconds=time.perf_counter() - t0)
    check(not ragged["failed"], f"ragged: {ragged['failed']}")
    if stop("ragged"):
        return 0

    # 4d. towers: the MLP towers' fused epilogue against the composed form
    t0 = time.perf_counter()
    towers = phase_towers()
    emit("towers", **towers, seconds=time.perf_counter() - t0)
    check(not towers["failed"], f"towers: {towers['failed']}")
    if stop("towers"):
        return 0

    # 5. serve
    t0 = time.perf_counter()
    # shard_pad_tables pads 250 -> 256 tables for a 256-device slice; one
    # card holds whole tables, so no padding here
    emb = dataclasses.replace(CONFIG.embedding, shard_pad_tables=0)
    free, _total = torch.cuda.mem_get_info()
    per_table = emb.rows * emb.dim * emb.torch_dtype.itemsize
    fit = (free - HEADROOM_BYTES) // per_table
    cut = None
    if fit < emb.num_tables:
        cut = {"num_tables": [emb.num_tables, int(fit)],
               "reason": f"{free} bytes free on the card"}
        emb = dataclasses.replace(emb, num_tables=int(fit))
    cfg = dataclasses.replace(CONFIG, embedding=emb)
    T, R, L, D = emb.num_tables, emb.rows, emb.pooling, emb.dim
    B = 2048
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    model = DLRM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    pattern = make_pattern("med_hot", R, seed=0)
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(B, cfg.dense_features)).astype(np.float32),
                sample_indices(pattern, B, T, L, seed=s))
               for s in range(SERVE_BATCHES)]
    sample_s = time.perf_counter() - t1

    scores = []
    kernel.LAUNCHES = interaction.LAUNCHES = 0
    sess = ServingSession(model, batcher=BatcherConfig(max_batch=B,
                                                       max_wait_s=0.0))
    sess.server.on_batch = lambda batch, s: scores.append(s.copy())
    for dense, idx in batches:
        sess.submit_batch(dense, idx)
    sess.drain(timeout_s=600.0)
    launches = kernel.LAUNCHES
    interaction_launches = interaction.LAUNCHES
    lat = np.asarray(sess.stats.batch_latencies_s) * 1e3
    forwards = 1 + len(lat)                       # warmup + served batches
    sess.close()
    check(len(lat) == SERVE_BATCHES and sess.stats.served == B * len(lat),
          f"served {sess.stats.served} queries in {len(lat)} batches")
    check(launches == forwards,
          f"kernel launched {launches} times over {forwards} forwards")
    check(interaction_launches == forwards,
          f"interaction kernel launched {interaction_launches} times over "
          f"{forwards} forwards")
    logits = np.concatenate(scores)
    check(logits.shape == (B * SERVE_BATCHES,), f"logits {logits.shape}")
    check(bool(np.isfinite(logits).all()), "non-finite logits")

    # one 64-query sub-batch: kernel path vs the plain path on the card
    dense64 = torch.from_numpy(batches[0][0][:SUB_BATCH]).cuda()
    idx64 = torch.from_numpy(batches[0][1][:SUB_BATCH]).cuda()
    with torch.inference_mode():
        logits_k = model(dense64, idx64)
        pooled_k = model.ebc(idx64)
        rows = gather_rows(model.ebc.tables, idx64)       # [64, T, L, D]
        pooled_p = _pool_rows_core(rows, None, emb.combine)
        bound = 2 * ref.F32_EPS * rows.abs().sum(dim=2)
        del rows
        logits_p = model.forward_from_pooled(dense64, pooled_p)
    pooled_cmp = compare(pooled_k, pooled_p, bound,
                         "serve sub-batch pooled")
    torch.testing.assert_close(logits_k, logits_p, rtol=1e-4, atol=1e-4)
    check(bool(np.allclose(logits_k.cpu().numpy(), scores[0][:SUB_BATCH],
                           rtol=1e-4, atol=1e-4)),
          "session logits differ from a direct forward")
    emit("serve", config="dlrm_production", tables=T, rows=R, dim=D,
         pooling=L, batch=B, dtype=emb.dtype, cut=cut,
         batches=len(lat), batch_ms=lat.tolist(),
         p50_batch_ms=float(np.percentile(lat, 50)),
         p99_batch_ms=float(np.percentile(lat, 99)),
         kernel_launches=launches,
         interaction_launches=interaction_launches, forwards=forwards,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         table_bytes=emb.table_bytes(), init_s=init_s, sample_s=sample_s,
         logits_mean=float(logits.mean()), logits_std=float(logits.std()),
         sub_batch_pooled_max_abs_err=pooled_cmp["max_abs_err"],
         sub_batch_logits_max_abs_diff=(logits_k - logits_p).abs().max()
         .item(), logits_tolerance="rtol=1e-4 atol=1e-4",
         seconds=time.perf_counter() - t0)

    # 6. kernel time at the serve shape
    t0 = time.perf_counter()
    tables = model.ebc.tables
    idx_np = batches[0][1]
    t1 = time.perf_counter()
    idx = torch.from_numpy(idx_np).to("cuda")
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t1) * 1e3
    opts = emb.kernel_opts()
    run_kernel = lambda: kernel.embedding_bag_cuda(tables, idx, None, opts)
    ms = cuda_ms(run_kernel, iters=10, warmup=2)
    out_k = run_kernel()
    bag_info = kernel.last_launch_info()
    plain = lambda: torch.stack([ref.embedding_bag_ref(tables[t], idx[:, t])
                                 for t in range(T)], 1)
    plain_ms = cuda_ms(plain, iters=3)
    plain_err = (plain() - out_k).abs().max().item()
    flat = (idx.long() + torch.arange(T, device="cuda")[None, :, None] * R
            ).reshape(-1)
    offsets = torch.arange(0, flat.numel(), L, device="cuda")
    library = lambda: F.embedding_bag(flat, tables.view(-1, D), offsets,
                                      mode=emb.combine)
    library_ms = cuda_ms(library, iters=3)
    library_err = (library().view(B, T, D) - out_k).abs().max().item()
    del flat, offsets
    with torch.inference_mode():
        dense = torch.from_numpy(batches[0][0]).cuda()
        rest_ms = cuda_ms(lambda: model.forward_from_pooled(
            dense, out_k), iters=5)
    distinct = sum(int(torch.unique(idx[:, t]).numel()) for t in range(T))
    moved = distinct * D * 4 + idx.numel() * 4 + out_k.numel() * 4
    ops_count = B * T * L * D
    bytes_ms = moved / HBM_BW * 1e3
    ops_ms = ops_count / PEAK_FLOPS_F32 * 1e3
    all_lookups = B * T * L * D * 4
    emit("kernel_time", shape=[B, T, L, D], ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, library="torch.nn.functional.embedding_bag",
         plain_max_abs_diff=plain_err, library_max_abs_diff=library_err,
         distinct_rows=distinct, bytes_moved=moved,
         bound_ms=max(bytes_ms, ops_ms),
         bound_by="bytes" if bytes_ms >= ops_ms else "operations",
         bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
         all_lookups_bytes=all_lookups,
         all_lookups_ms_at_peak=all_lookups / HBM_BW * 1e3,
         fraction_of_bound=max(bytes_ms, ops_ms) / ms, **bag_info,
         breakdown_ms={"indices_to_device": h2d_ms, "embedding_kernel": ms,
                       "mlps_and_interaction": rest_ms,
                       "served_batch_p50": float(np.percentile(lat, 50))},
         seconds=time.perf_counter() - t0)

    del out_k, run_kernel, plain, library, dense
    if stop("kernel_time"):
        return 0

    # 6b. kernel_diag: the bag kernel on served, distinct and resident rows
    t0 = time.perf_counter()
    diag = phase_kernel_diag(tables, idx, pattern, opts, args.geometry_sweep)
    emit("kernel_diag", **diag, seconds=time.perf_counter() - t0)
    del tables, idx
    if stop("kernel_diag"):
        return 0

    # 6c. replay_device: the flash crowd and the SLO ladder on `device`
    t0 = time.perf_counter()
    replay_dev = phase_replay_device(model, pattern, batches[0])
    emit("replay_device", **replay_dev, seconds=time.perf_counter() - t0)
    check(not replay_dev["failed"], f"replay_device: {replay_dev['failed']}")
    if stop("replay_device"):
        return 0

    # 6d. spmd_dlrm (serve): the DLRM serve step over serve's tables
    t0 = time.perf_counter()
    spmd_serve = phase_spmd_dlrm_serve(mesh, model, batches[0][0],
                                       batches[0][1], logits[:B])
    emit("spmd_dlrm", part="serve", **spmd_serve,
         seconds=time.perf_counter() - t0)
    check(not spmd_serve["failed"], f"spmd_dlrm: {spmd_serve['failed']}")

    # 7. serve_tiered: the same weights and batches on the tiered backend
    t0 = time.perf_counter()
    n_tiered = SERVE_TIERED_BATCHES
    fields, sess, tiered, tiered_batches = phase_serve_tiered(
        model, batches[:n_tiered], logits[:B * n_tiered], deadline_s=600.0)
    del model
    emit("serve_tiered", **fields, seconds=time.perf_counter() - t0)

    # 8. kernel_time_fused, with the warm state serving left
    t0 = time.perf_counter()
    timed = phase_kernel_time_fused(sess, tiered, tiered_batches)
    sess.server.close()             # the storage serves replay_tiered next
    emit("kernel_time_fused", **timed, seconds=time.perf_counter() - t0)

    # 8b. replay_tiered: the ladder down to the degraded rung and back
    t0 = time.perf_counter()
    replay_tier = phase_replay_tiered(tiered, pattern, opts,
                                      tiered_batches[0])
    del sess, tiered, tiered_batches
    gc.collect()
    torch.cuda.empty_cache()
    emit("replay_tiered", **replay_tier, seconds=time.perf_counter() - t0)
    check(not replay_tier["failed"],
          f"replay_tiered: {replay_tier['failed']}")
    if stop("replay_tiered"):
        return 0

    # 8c. update: online model updates on `device`, `tiered` and `sharded`
    t0 = time.perf_counter()
    update = phase_update(cfg, pattern)
    emit("update", **update, seconds=time.perf_counter() - t0)
    check(not update["failed"], f"update: {update['failed']}")

    # 8c'. train: train_dlrm with a restart, then dlrm_production's widths
    t0 = time.perf_counter()
    train = phase_train(cfg, pattern)
    emit("train", **train, seconds=time.perf_counter() - t0)
    check(not train["failed"], f"train: {train['failed']}")

    # 8c''. quickstart: the planner and the pinned hot-first lookup
    t0 = time.perf_counter()
    quick = phase_quickstart()
    emit("quickstart", **quick, seconds=time.perf_counter() - t0)
    if stop("quickstart"):
        return 0

    # 8f. spmd_dlrm (train): one SGD step at the wide widths
    t0 = time.perf_counter()
    spmd_train = phase_spmd_dlrm_train(mesh, cfg, pattern)
    emit("spmd_dlrm", part="train", **spmd_train,
         seconds=time.perf_counter() - t0)
    check(not spmd_train["failed"], f"spmd_dlrm: {spmd_train['failed']}")
    if stop("spmd_dlrm"):
        return 0

    # 8g. spmd_dryrun: seven production-mesh cells, no card
    t0 = time.perf_counter()
    dry = phase_spmd_dryrun()
    end_spmd_group()
    emit("spmd_dryrun", **dry, seconds=time.perf_counter() - t0)
    check(not dry["failed"], f"spmd_dryrun: {dry['failed']}")
    if stop("spmd_dryrun"):
        return 0

    # 8d. serve_sharded: 4 shards, the law, a live migration
    t0 = time.perf_counter()
    sharded = phase_serve_sharded(cfg, pattern)
    emit("serve_sharded", **sharded, seconds=time.perf_counter() - t0)
    check(not sharded["failed"], f"serve_sharded: {sharded['failed']}")
    if stop("serve_sharded"):
        return 0

    # 8d'. serve_pool: serve_sharded's shape on 4 worker processes
    t0 = time.perf_counter()
    pool = phase_serve_pool(cfg, pattern, sharded)
    emit("serve_pool", **pool, seconds=time.perf_counter() - t0)
    check(not pool["failed"], f"serve_pool: {pool['failed']}")
    if stop("serve_pool"):
        return 0

    # 8e. replay_tenants: two tenants on one shared sharded backend
    t0 = time.perf_counter()
    tenants = phase_replay_tenants(cfg, pattern)
    emit("replay_tenants", **tenants, seconds=time.perf_counter() - t0)
    check(not tenants["failed"], f"replay_tenants: {tenants['failed']}")
    if stop("replay_tenants"):
        return 0

    # 9. kernels
    row = kernel_row
    csrc = "src/repro_torch/kernels/embedding_bag/csrc/"
    print(json.dumps({"kernels": [
        row("embedding_bag", csrc + "embedding_bag.cu",
            "src/repro/kernels/embedding_bag/kernel.py:194", launches,
            max(parity["max_abs_err_f32"], pooled_cmp["max_abs_err"]), ms,
            plain_ms, max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", library_ms,
            bag_info,
            launches_tiered=fields["bag_kernel_launches"],
            launches_replay_device=replay_dev["bag_launches"],
            launches_replay_tiered=replay_tier["bag_launches"],
            launches_replay_tiered_degraded=replay_tier[
                "bag_launches_in_degraded"],
            launches_update_device=update["launches"]["device"]["bag"],
            launches_update_tiered=update["launches"]["tiered"]["bag"],
            launches_update_sharded=update["launches"]["sharded"]["bag"],
            launches_train=train["small"]["launches"],
            launches_train_wide=train["wide"]["launches"],
            launches_quickstart=quick["launches"],
            launches_spmd_serve=spmd_serve["bag_launches"],
            launches_spmd_train=spmd_train["bag_launches"],
            launches_sharded=sharded["before_migration"]["bag_launches"],
            launches_sharded_migrated=sharded["after_migration"][
                "bag_launches"],
            launches_pool=pool["before_migration"]["bag"],
            launches_pool_migrated=pool["after_migration"]["bag"],
            launches_tenants={leg: out["bag_launches"] for leg, out in
                              tenants["legs"].items()}),
        row("fused_warm_lookup", csrc + "fused_lookup.cu",
            "src/repro/kernels/embedding_bag/fused.py:266",
            fields["fused_launches"],
            max(parity_fused["max_abs_err_f32"], timed["plain_max_abs_err"]),
            timed["ms"], timed["plain_ms"], timed["bound_ms"],
            timed["bound_by"], timed["library_ms"], timed,
            pool_pass_ms=timed["pool_pass_ms"],
            list_pass_ms=timed["list_pass_ms"],
            launches_replay_tiered=replay_tier["fused_launches"],
            launches_update=update["launches"]["tiered"]["fused"],
            launches_update_sharded=update["launches"]["sharded"]["fused"],
            launches_sharded=sharded["before_migration"]["fused_launches"],
            launches_sharded_migrated=sharded["after_migration"][
                "fused_launches"],
            launches_pool=pool["before_migration"]["fused"],
            launches_pool_migrated=pool["after_migration"]["fused"],
            launches_tenants={leg: out["fused_launches"] for leg, out in
                              tenants["legs"].items()}),
        row("dot_interaction",
            "src/repro_torch/kernels/interaction/csrc/dot_interaction.cu",
            None, interaction_launches, inter["max_abs_err_f32"],
            inter["timed"]["serve"]["ms"],
            inter["timed"]["serve"]["plain_ms"],
            inter["timed"]["serve"]["bound_ms"],
            inter["timed"]["serve"]["bound_by"],
            inter["timed"]["serve"]["library_ms"], inter["timed"]["serve"],
            benchmark_shape=inter["timed"]["benchmark"]),
        ragged_kernel_row(ragged)]}),
          flush=True)
    emit("done", seconds=time.perf_counter() - t_all)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_spmd_dryrun()          # a failed phase leaves none running
