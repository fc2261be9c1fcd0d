#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (nasrec_tpu_torch).

    python3 chip_smoke.py            # one CUDA card; exits non-zero without one

Phases, each printing JSON lines; any failure exits non-zero:
  1. device   nvidia-smi name and power limit, torch/CUDA versions, and the
              build of every kernel from csrc/ (one nvcc per source, in
              parallel), with ptxas's registers and shared memory.
  2. kernels  each hand-written kernel against its plain PyTorch version on
              the same CUDA inputs at the main paths' shapes, batch 32768:
              the dot-product at n = 46, 17 (autoctr) and 40, 9 (xlarge), and
              33 (avazu/autoctr, phase 11), on the operands the node holds
              (x [B, 16], yt [B, 16, n - 1]), with equal bits from two runs;
              the transformer body at S = 64, 48 and 16 (S = 16: the xlarge
              archs of avazu and kdd, phase 11) (eval forward, training
              forward with o and the softmax statistic, backward with dx and
              the twelve parameter gradients, equal bits from two backward
              runs, and equal bits from x as the slot projection leaves it,
              [B, 16, S] transposed, and from a contiguous x);
              the attention core at the same S; the transformer
              node's fused form against its unfused form; the full-vocab
              table update with uniform and zipf(1.05) indices, and on the
              table's two halves by row_offset (phase 10c); the table update
              over avazu's 9,459,467 rows and kdd's 50,666,853 (753,664 and
              327,680 uniform positions, among them every slot's last row),
              bit for bit over the whole table; the segment-sum over the same
              three tables' slots at batch 32768 (rows and run ends equal to
              the plain version's, zeros off the run ends, each run within
              2^-20 of its sum of |g| from float64 sums, equal bits from two
              runs; the plain version, the PyTorch composite it replaced, as
              the library call too); the dense parameters' global-norm clip
              and Adagrad update as one launch each over the whole list, on
              one xlarge sparse step's own lists (86 gradients and the
              table's summed gradient; the scale within 2 ulps of the plain
              version's, parameters and accumulators bit for bit given it,
              equal bits from two launches; torch._foreach_* as the library
              call).  With errors
              and CUDA-event times of kernel, plain version and the one
              PyTorch call that computes the same function; for the
              dot-product and the table update also the kernel's time with
              the L2 cache overwritten before each launch (cold_ms).  Then the
              supernet's shapes, in rows named "_b512" and "_b4096": the body
              at S = 64 (training forward and backward at batch 512, eval
              forward at 4096), the dot-product at n = 46 (both at 512, the
              forward at 4096) and the segment-sum and the table update over
              the search-capped table (3,069,317 rows) at batch 512, each
              with cold_ms; and the search's shapes: a group's folded
              launches, the body's eval
              forward at S = 64 and the dot-product forward at n = 46 for 8 x
              512 and 8 x 1024 rows (a group step and an eval chunk), the
              dot-product backward at 8 x 512; one candidate's eval chunk
              (1024); the K-candidate body (8 candidates, each with its own
              parameters: training forward and backward at 512 rows a
              candidate, eval forward at 1024), bit-equal to 8 one-candidate
              launches and held against its K-candidate plain version
              (parameter gradients 1e-5 of their largest magnitude), with vmap
              of nn.TransformerEncoderLayer over the stacked weights as its
              library call, and the same in bf16 (held and timed on a line of
              its own: no search runs it, the evaluator being float32 as the
              JAX package's is); on that line too, the attention core's
              K-candidate form, vmap of tiny_head_attention over 8 candidates
              of 512 rows at S = 64, forward and backward (one launch each
              for the group, bit-equal to 8 one-candidate launches, held
              against vmap of the plain version, vmap of SDPA its library
              call); the segment-sum over 8 candidates' rows of every slot
              ([512, 208]) and the table update over 8 stacked search-capped
              tables (24,554,536 rows).  And in bf16 (rows
              "_bf16"), at batch 32768: the
              body and the attention core at S = 64, 48 and 16, the
              dot-product at n = 40, 9, 46, 17 and 33, each against its plain
              version in bf16 (one bf16 ulp, f32 parameter gradients within
              1e-3), with cold_ms and the library call in bf16.
  3. main     sparse-embedding train steps at full Criteo vocab (33,762,601
              rows) and batch 32768 through the kernels, counted, then the
              same steps from the same weights through the plain versions:
              10 steps and one eval forward of criteo-kaggle/xlarge (whose
              blocks 0 and 6 run transformer nodes), 2 more steps of it
              with the nodes in their unfused form (the attention kernel),
              then 4 steps of criteo-kaggle/autoctr.  A torch.profiler window
              over 3 more kernel-path steps prints where the device time
              goes (one "profile" line per arch).
  3d. amp     phase 3's steps with compute_dtype bfloat16 (the AMP leg of the
              JAX bench): 10 xlarge and 4 autoctr steps at full vocab, batch
              32768, through the kernels, counted a step (body and dot-product
              in bf16, the segment-sum and the table update in f32), each
              against the plain versions from the kernel path's state before
              it; an eval forward; 2 xlarge steps unfused (the attention kernel
              in bf16); step ms against phase 3's f32 step, peak memory, a
              profile line.
  3e. dcnv2   DLRM-DCNv2's sparse step (models/dcn.py, configs/dcnv2.py) at
              batch 16384 with MLPerf's 26 multi-hot bags (214 lookups a row)
              and widths (128-wide rows, 3 cross layers of rank 512), each
              slot's table its 4-way row share capped at DCN_VOCAB_CAP rows:
              DCN_STEPS steps through the kernels (one 128-wide segment-sum
              and table update a step, counted) and the same through the
              plain versions from the same weights and batches (losses,
              logits, parameters; the table and its accumulator against
              their own change); then the two 128-wide kernels alone at the
              step's shapes (the segment-sum held to float64, the update to
              its plain version bit for bit), timed beside their bounds and
              plain versions (rows segment_sum128, table_update128 of the
              "dcnv2" line).
  3a. data    criteo-shaped TSV shards written from a seed (4 shards, 300,000
              training and 80,000 test rows; empty, negative and short
              fields): the C++ parser (built with g++; a failed build fails)
              against the NumPy transform on the same lines, equal bits; the
              parser's rows/s by thread count, the stream's at batch 32768,
              the binary cache's build and read rates and its rows against the
              stream's; nasrec_tpu_torch.cli.main_train --arch
              criteo-kaggle/xlarge --root_dir on them (8 steps, one test pass
              whose last batch of each shard is short), counted; two TSV
              batches through the kernels and the plain versions; the TSV-fed
              step against the synthetic step, with the host's wait for each
              batch and the busy share under the profiler.
  3b. dense   the dense-gradient step of criteo-kaggle/xlarge at full vocab
              and batch 32768, for Adam, SGD and Adagrad with wd 1e-6: 3 steps
              through the kernels, counted (no segment-sum, no table update),
              and 3 through the plain versions from the same weights and
              batches; step ms, peak memory, and Adam's sign-edge elements
              counted.
  3c. micro   the sparse step with 2 micro-batches against 1 at batch 32768
              (one segment-sum and one table update a step), then batch 65536
              with 2 and with 1: step ms and peak memory.
  4. supernet one-shot supernet training, criteo-kaggle space xlarge, 7
              blocks with LayerNorm, 3,069,317 rows, batch 512: 12 masked train
              steps (masks from the port's ChoiceSampler through the device
              mask buffer: the full path and subnets with a transformer or a
              dot-product gate of 0) and one eval forward at batch 4096 through
              the kernels, with the launches of every step counted (7 body
              forward and 7 backward at S = 64, 7 dot-product forward and 7
              backward at n = 46, 1 segment-sum, 1 table update), then the
              same steps through the plain versions, and a profile line; then
              the same 12 steps in bf16, each against the plain versions from
              the same state.
  5. cli      nasrec_tpu_torch.cli.main_train on synthetic data, once per
              arch; 40 steps must lower the test loss, lift the AUROC above
              0.6 and launch every kernel of the path (counted as in phase 3).
              main_train --compute_dtype bfloat16 on xlarge, held to the same.
              Then nasrec_tpu_torch.cli.train_supernet at 7 blocks and batch
              512 with a logging dir, resumed from its checkpoint; the resumed
              checkpoint reloads into a fresh model with equal eval logits;
              and 3 steps of it with --compute_dtype bfloat16.
  6. search   the weight-shared search at the canonical search configuration
              of the JAX CLI (nasrec_tpu/cli/eval_subnet_from_supernet.py:3-10):
              the phase-4 supernet (space xlarge, 7 blocks, LayerNorm, 3,069,317
              capped rows, the same seed-0 weights), fine-tune batch 512, test
              batch 8192 in eval chunks of 1024, groups of 8, final-only, each
              group one program (its kernels launch once for the group, at 8 x
              512 rows a step and 8 x 1024 an eval chunk).  The launches of
              single group steps (7 eval body forwards and 7 dot-product
              forwards, nothing else), their times and busy share, a profile
              line; a short regularized EA (16 initial candidates, 2 generations
              of 8 children, sample 8, top 2; 20 fine-tune steps and 2 test
              batches a candidate, where the canonical run takes 500 and 150:
              only the step counts are cut), counted; its first group scored
              again through the plain versions and one candidate at a time
              (test losses and fine-tuned finals within 1e-4); then one group
              of 8 in the whole-net mode for 3 steps as one K-candidate step
              (each step 7 K-candidate body training forwards and backwards,
              7 dot-product forwards and backwards at 8 x 512 rows, one table
              update over the 8 stacked tables), against plain (test losses
              within 1e-4, every candidate's parameters too, but where
              relu_edge_leaves shows a ReLU input within rounding of zero
              taking one side in each route: it replays both routes, finds
              the first step at which the parameters part, the batch rows
              whose ReLU input changes sign between the two states before it,
              and requires the gradients to differ there and to agree within
              1e-4 of their largest magnitude without those rows), and one
              candidate at a time (each step phase 4's 7/7/7/7/1 launches),
              against plain:
              seconds, step ms, launches, peak memory of each, the forms'
              test losses within 2e-4 of each other; the LayerNorm-calibrate
              mode as one K-candidate step for 3 steps (no segment-sum, no
              table update), against plain.
  7. search_rank  the JAX-trained supernet of experiments/search_quality_proxy
              re-scores the 24 initial candidates of its all_results.pickle with
              the proxy's protocol (experiments/search_quality_proxy.py: fine-tune
              stream seed 303, test stream seed 1, 200 steps at batch 512, 24 test
              batches of 4096, lr 0.04, groups of 8); the Spearman correlation
              with the losses recorded on the TPU must be 0.7 or more.
  8. search_cli  nasrec_tpu_torch.cli.eval_subnet_from_supernet: --method random
              on phase 5's checkpoint (8 candidates, 5 steps), --method cached on
              the first 8 records of the proxy's results.pickle; then
              nasrec_tpu_torch.cli.eval_subnet_from_scratch with 2 xlarge
              subnets at batch 512.  Every loss finite, every file written.
  9. profiling  profiling.calibrate_chip() at its defaults (bf16 4096^2
              products and an f32 copy of 512 MiB): TFLOP/s and GB/s, and each
              as a share of 989 TFLOP/s and of the card's HBM rate; the
              criteo-kaggle/xlarge best arch's forward at batch 512 over the
              search-capped table (3,069,317 rows): measure_latency through
              the kernels and through the plain versions, dot_flops of both
              (must be equal), the cost model's estimate; the search CLI with
              --criterion test_loss_penalty_lat --beta 0.5 and that kernel
              latency as --target_latency on phase 5's checkpoint (its
              synthetic tables, 1000 rows a slot), once per latency estimator:
              a regularized EA of 8 initial candidates and one generation of 8
              children, 5 fine-tune steps and 1 test batch a candidate; each
              candidate's cost-model estimate, measured latency and loss, and
              the Spearman correlation of the two latencies (a finding, not a
              gate); the launches inside measure_latency in the measured mode
              (the dot-product and body forward kernels must be among them),
              none in the cost-model mode; the evaluator's launches as phase
              8 counts them; tools.body_device_check and
              tools.sweep_device_check (each must print its OK line); then
              main_train --report_flops 1 --profile_dir for 3 xlarge steps at
              batch 512 (a FLOPS line and a trace file).  Launches at a batch-512
              shape without a row get one: its kernel checked against the
              plain version at that shape and timed.

  10. multi-device  10a, the host-RAM table: criteo-kaggle/xlarge at full vocab
              (33,762,601 rows) and batch 32768, the table and its Adagrad
              accumulator in host RAM (parallel/host_embedding.py), 1 warm-up
              step and 3 more, against the one-device sparse step from the
              same weights and batches (loss and dense parameters within
              1e-4; the touched rows of the table and the accumulator within
              1e-3 of the reference's largest movement of each), the step's
              time split into host lookup, copy to the card, forward and
              backward, copy back, host segment-sum and update; the body and
              dot-product kernels counted.  10b, the mesh at world size 1: an
              NCCL group of one rank, --mesh_model 1, the same cell and steps
              through the sparse mesh step, held to the one-device step as
              phase 3 holds its steps, every kernel of a step counted, its
              step time beside phase 3's.  10c (in phase 2): the table update
              launched on the two halves of the full-vocab table with
              row_offset 0 and rows/2 gives the whole-table launch's bits.
              10d, the search fan-out: the search CLI (phase 8's configuration,
              16 candidates in two groups of 8) on phase 5's checkpoint in two
              processes on the one card against one process; results.pickle
              and all_results.pickle the same choices in order, metrics within
              1e-6 relative; seconds a candidate for each, of the processes'
              wall time and of the search's own time (its "evaluated ...
              candidates in ...s" lines); clean_exit: no process printed
              an abort or an undestroyed process group.  10e: the supernet CLI at phase 5's
              configuration with --ckpt_backend orbax (2 steps) writes
              arrays/ and sidecar.json, which reload into the run's weights bit
              for bit, and a run resumes from the directory at its step.
  11. datasets  the published best archs of the other two datasets,
              avazu/xlarge, avazu/autoctr, kdd/xlarge and kdd/autoctr, each as
              phase 3 runs criteo-kaggle's: 7 blocks, the dataset's full vocab
              (9,459,467 and 50,666,853 rows), batch 32768, uniform indices, 4
              steps through the kernels against the plain versions from the
              same weights, an eval forward, 2 steps unfused for the xlarge
              archs, a profile line; then as phase 3d in bf16.  avazu/xlarge
              and kdd/xlarge fed from TSV shards of their datasets' columns
              (2 shards of 33,000 rows) through the C++ parser and
              device_prefetch: two batches through kernels and plain, then
              the TSV-fed step against the synthetic one.  Then each avazu and
              kdd launcher of nasrec_tpu_torch/scripts/ (eval_best_model x 2,
              train_supernet, run_ea) through its CLI's main, its flags read
              from the file with synthetic data, 3 steps and the run's own
              directories appended (the EA: 4 candidates on the checkpoint of
              the dataset's supernet run): finite losses, the model's kernels
              launched, the CLI's files written; each run's launches go
              into rows of the shapes it launched at its batches (256 and 512
              for eval_best_model, 512 and 4096 for train_supernet, 512 and
              eval chunks of 1024 for run_ea), a shape without a row getting
              one, checked against its plain version and timed; the table
              update's rows for these runs hold the synthetic tables
              (1,000 rows a slot) that the runs train.

Then one {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 32768
STEPS = {"criteo-kaggle/xlarge": 10, "criteo-kaggle/autoctr": 4}
UNFUSED_STEPS = 2
CLI_STEPS = 40
DEVICE = "cuda"
VOCAB_CAP = None         # full Criteo vocab
F32_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores (data sheet)
# Exponentials a second: 16 a cycle on each of 132 multiprocessors at the
# 1.98 GHz boost clock that the f32 rate above is stated at.
EXP_RATE = 132 * 16 * 1.98e9
# Tolerances (f32).  Kernel vs plain: the kernels sum in another order than
# cuBLAS, so errors are held to 1e-5 of the output's largest magnitude; the
# table update rounds step by step like the plain version and must match
# exactly.  The transformer body's and the attention core's gradients sum over
# the slots, and the body's parameter gradients over all 2 M positions of a
# batch, so they are held to 1e-4 of the gradient's largest magnitude (or of
# 1, where that is smaller).  Train steps: losses within 1e-4, logits within
# 1e-3 and parameters within 1e-4 (absolute).
KERNEL_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-4
# The K-candidate body's parameter gradients (K = 8 candidates of 512 rows,
# 32,768 positions a candidate) against its plain version: 1e-5 of their
# largest magnitude (or of 1).  Against one-candidate launches: equal bits.
K_PARAM_GRAD_TOL = 1e-5
# The whole-net mode's two forms (one K-candidate step, one candidate at a
# time) against each other: test losses within what the JAX package's own
# two forms are held to (tests/test_search.py, 2e-4 relative).
WHOLE_FORMS_REL_TOL = 2e-4
RELU_MARGIN = 1e-5   # |ReLU input| below this: the side taken is a matter of rounding
LOSS_TOL, LOGIT_TOL, PARAM_TOL = 1e-4, 1e-3, 1e-4
# Tolerances (bf16 compute: activations in bf16, f32 inside the kernels).
# Kernel vs plain: both sides round one f32 value to bf16 per output, so an
# output is held to one bf16 unit in the last place (ulp) elementwise, or to
# BF16_FLOOR of the largest element where an f32 sum cancelled far below its
# terms (the two sums then differ by their own rounding, several ulps of so
# small a value); the body's f32 parameter gradients to 1e-3 of the largest
# element, and its f32 residuals o and the statistic as in f32.  A library
# call that rounds to bf16 after each op is a yardstick where it agrees with
# the plain version to BF16_LIB_TOL of the largest output.  Train steps in
# bf16 are compared step by step, each plain step from the kernel path's
# state before it (a bf16 rounding that lands the other way in one step moves
# the next step's inputs by an ulp, and a run of steps would compare that
# drift, not the step): losses within BF16_LOSS_TOL of the loss; logits
# within BF16_LOGIT_TOL of the largest logit, four bf16 ulps of a value at
# the foot of its binade (a logit is the bf16 output of the final linear,
# seven blocks of bf16 ops after an output that one path rounded the other
# way; 2 ulps at xlarge on the H100);
# parameters within PARAM_TOL; Adagrad accumulators within BF16_SLOT_TOL of
# their largest element (or of 1): a bf16 linear's weight and bias gradients
# are rounded to bf16 before their cast to f32, and a gradient that rounds to
# the neighbouring bf16 value moves its square by 2^-7 of itself (4.6e-4 at
# xlarge on the H100, where the largest element is below 1).
BF16_FLOOR = 1e-6
BF16_PARAM_GRAD_TOL = 1e-3
BF16_LIB_TOL = 5e-2
BF16_LOSS_TOL, BF16_LOGIT_TOL, BF16_SLOT_TOL = 1e-3, 2 ** -5, 2 ** -6
# The shapes each published best arch puts on the kernels: the dot-product's n
# and the transformer body's S in its live blocks.  Blocks whose outputs
# nothing reads are skipped (models/fixed.py :: live_blocks): 3 to 5 of the
# two xlarge archs of criteo-kaggle and avazu, 5 of kdd/xlarge.
ARCH_SHAPES = {
    "criteo-kaggle/xlarge": ((40, 9), (64, 48)),
    "criteo-kaggle/autoctr": ((46, 17), ()),
    "avazu/xlarge": ((9, 40), (48, 16)),
    "avazu/autoctr": ((33, 40), ()),
    "kdd/xlarge": ((17,), (48, 64, 16)),
    "kdd/autoctr": ((17, 9, 40, 46), ()),
}
XL, AC = "criteo-kaggle/xlarge", "criteo-kaggle/autoctr"
# The S of every body a main path runs, held and timed in phase 2.
BODY_SLOTS = (64, 48, 16)
# Every kernel launch of one train step: the dot-product forward and backward
# at each n, the body's training forward and backward at each S, the
# segment-sum and the table update, and the dense parameters' global-norm
# clip and Adagrad update, each one launch over the whole list of tensors
# (csrc/dense_adagrad.cu; once a step, whatever its micro-batches).
TABLE_KERNELS = {"segment_sum", "table_update"}
LIST_KERNELS = {"clip_scale", "adagrad"}
TRAIN_STEP_KERNELS = {
    arch: ({f"dot_scores_tril_{k}_n{n}" for k in ("fwd", "bwd") for n in dots}
           | {f"transformer_body_{k}_s{s}" for k in ("fwd_train", "bwd") for s in bodies}
           | TABLE_KERNELS | LIST_KERNELS)
    for arch, (dots, bodies) in ARCH_SHAPES.items()}
# An eval forward (under no_grad) launches the forward kernels only.
EVAL_KERNELS = {
    arch: ({f"dot_scores_tril_fwd_n{n}" for n in dots}
           | {f"transformer_body_fwd_s{s}" for s in bodies})
    for arch, (dots, bodies) in ARCH_SHAPES.items()}
# With the transformer nodes unfused, the attention core's kernel takes the
# body kernels' place.
UNFUSED_STEP_KERNELS = {
    arch: ({k for k in TRAIN_STEP_KERNELS[arch] if not k.startswith("transformer_body")}
           | {f"tiny_head_attention_{k}_s{s}" for k in ("fwd", "bwd") for s in bodies})
    for arch, (_, bodies) in ARCH_SHAPES.items()}
# Phase 3d (amp): the steps of phase 3 with compute_dtype bfloat16, the AMP leg
# of the JAX package's bench.py (:197-205); the unfused run's losses against
# the fused run's first steps within AMP_UNFUSED_LOSS_TOL of the loss (the
# unfused form rounds to bf16 after every op, the fused one once).
AMP_STEPS = {"criteo-kaggle/xlarge": 10, "criteo-kaggle/autoctr": 4}
AMP_UNFUSED_STEPS = 2
AMP_UNFUSED_LOSS_TOL = 2e-2
# Phase 3a (data): criteo-shaped TSV shards made from a seed, 4 shards of
# 75,000 training rows (2 batches of 32768 each; the short rest is dropped)
# and 20,000 test rows (a batch of 16368 and a short one of 3,632 each).
TSV_SHARDS = 4
TSV_TRAIN_ROWS, TSV_TEST_ROWS = TSV_SHARDS * 75_000, TSV_SHARDS * 20_000
TSV_TEST_BATCH = 16368
TSV_TRAIN_BATCHES = TSV_SHARDS * (75_000 // BATCH)
TSV_TEST_BATCHES = TSV_SHARDS * 2
TSV_CHECK_LINES = 20_000          # lines parsed by both parsers and compared
TSV_TIMED_STEPS = 16
# Phase 3b (dense): the dense-gradient step of criteo-kaggle/xlarge at full
# vocab, batch 32768, per (optimizer, wd, constant lr); 3 steps through the
# kernels and 3 through the plain versions.  A step launches the kernels of a
# sparse step but the segment-sum, the table update and the list clip: the
# optimizer updates the whole table, and the dense step clips with the
# table's norm summed over the mesh's shards.  Adagrad's update is the list
# kernel's (DENSE_LIST_UPDATE); SGD and Adam loop.
DENSE_STEPS = 3
DENSE_SETTINGS = (("adam", 0.0, 1e-3), ("sgd", 0.0, 0.01), ("adagrad", 1e-6, 0.01))
DENSE_STEP_KERNELS = TRAIN_STEP_KERNELS[XL] - TABLE_KERNELS - LIST_KERNELS
DENSE_LIST_UPDATE = {"adagrad": {"adagrad"}, "sgd": set(), "adam": set()}
# Phase 3c (micro): the sparse step with 2 micro-batches against 1 at batch
# 32768 (2 steps), then batch 65536 with 2 and with 1.
MICRO_STEPS = 2

# Phase 3e (dcnv2): DLRM-DCNv2 at MLPerf's bags and widths, batch 16384, each
# slot's 4-way row share capped at DCN_VOCAB_CAP rows (two copies of table and
# accumulator, 5.6 GB).  The plain step sums a row's lookups with index_add_
# (the card's atomics, in no fixed order) and the kernel in a fixed order, so
# the two differ by rounding: held to LOSS_TOL, LOGIT_TOL and PARAM_TOL.  The
# steps take Adagrad's eps at DCN_EPS, not the preset's 1e-8: at 1e-8 the
# first update moves an element by about lr times its gradient's sign, and an
# element whose gradient cancels to within rounding of zero moves by up to lr
# on either route (1.2e-3 in one call), which compares the rounding, not the
# kernels.  A table row moves by about 5e-6 a step at DCN_EPS, far below
# PARAM_TOL, so the table and its accumulator are also held on their own:
# the same rows move on both routes, and the routes' largest difference is
# within DCN_TABLE_REL_TOL of the table's largest change over the steps (of
# the accumulator's largest value).  The 128-wide segment-sum alone is held
# to float64 as tests/test_torch_cuda.py holds it: each run's sum within
# 2^-20 sqrt(max(n/16, 1)) of its sum of |g|, exact +0.0 off the run ends.
DCN_BATCH = 16384
DCN_VOCAB_CAP = 500_000
DCN_STEPS = 3
DCN_EPS = 1e-2
DCN_TABLE_REL_TOL = 1e-3
MICRO_BIG_BATCH = 2 * BATCH
# The supernet (phase 5): criteo-kaggle at the search cap of 500,000 rows a
# slot (config.SEARCH_MAX_NUM_EMBEDDINGS: 3,069,317 rows in all), space
# xlarge, 7 blocks with LayerNorm, batch 512, eval batch 4096.  Masks from the
# port's ChoiceSampler (default strategy, binomial-0.5 fan-in, seed 0, full-path
# warmup over 4 steps) through the device mask buffer.
SN_VOCAB_CAP = 500_000
SN_ROWS = 3_069_317
SN_BLOCKS = 7
SN_BATCH = 512
SN_EVAL_BATCH = 4096
SN_STEPS = 12
SN_WARMUP = 4
SN_CLI_STEPS, SN_RESUME_STEPS = 6, 3
SN_BF16_CLI_STEPS = 3
# Every block runs every node, whatever its gate: a transformer body at S = 64
# (its slots projected to 64) and a dot-product at n = 46 (45 projected slots
# and the dense row).  Launches of one train step, and of one eval forward:
SN_STEP_LAUNCHES = {"transformer_body_fwd_train_s64": SN_BLOCKS,
                    "transformer_body_bwd_s64": SN_BLOCKS,
                    "dot_scores_tril_fwd_n46": SN_BLOCKS, "dot_scores_tril_bwd_n46": SN_BLOCKS,
                    "segment_sum": 1, "table_update": 1, "clip_scale": 1, "adagrad": 1}
SN_EVAL_LAUNCHES = {"transformer_body_fwd_s64": SN_BLOCKS,
                    "dot_scores_tril_fwd_n46": SN_BLOCKS}
# The search (phase 6) at the canonical search configuration: the phase-4
# supernet, groups of 8 final-only candidates, fine-tune batch 512, test batch
# 8192 in eval chunks of 1024.  Cut: the step counts only (20 fine-tune steps
# and 2 test batches a candidate; the canonical run takes 500 and 150).  A
# group runs as one program: its kernels launch at 8 x 512 rows a step and
# 8 x 1024 an eval chunk.
SEARCH_GROUP = 8
SEARCH_STEPS, SEARCH_EVAL_STEPS = 20, 2
SEARCH_TEST_BATCH, SEARCH_CHUNK = 8192, 1024
SEARCH_TRAIN_BATCHES = 8          # distinct fine-tune batches, looped
SEARCH_EA = dict(init_population=16, n_generations=2, n_childs=8, sample_size=8, top_k=2)
SEARCH_CANONICAL_STEPS = (500, 150)
SEARCH_STEP_ROWS, SEARCH_CHUNK_ROWS = SEARCH_GROUP * SN_BATCH, SEARCH_GROUP * SEARCH_CHUNK
SEARCH_WHOLE_CANDIDATES, SEARCH_WHOLE_STEPS = SEARCH_GROUP, 3
# The whole-net group against the plain versions: every candidate's test
# loss within LOSS_TOL and every parameter within PARAM_TOL, but where a ReLU
# edge is shown to part the two routes (relu_edge_leaves): a ReLU input
# within rounding of zero takes one side in one route and the other side in
# the other, so a gradient differs by a whole term and Adagrad carries it on.
# A final-only group step runs the frozen body once for the group under
# no_grad: the eval body forward and the dot-product forward in every block,
# nothing else; an eval chunk launches the same.
SEARCH_STEP_LAUNCHES = {"transformer_body_fwd_s64": SN_BLOCKS,
                        "dot_scores_tril_fwd_n46": SN_BLOCKS}
# A whole-net group step (batch_candidates, the default): the K-candidate
# body's training forward and backward and the dot-product at 8 x 512 rows
# in every block, one segment-sum over the 8 candidates' rows of every slot
# ([512, 8 x 26]) and one table update over the 8 stacked tables; its eval
# chunk the K-candidate eval forward and the dot-product forward.
WHOLE_STEP_LAUNCHES = {f"transformer_body_fwd_train_s64_k{SEARCH_GROUP}": SN_BLOCKS,
                       f"transformer_body_bwd_s64_k{SEARCH_GROUP}": SN_BLOCKS,
                       "dot_scores_tril_fwd_n46": SN_BLOCKS, "dot_scores_tril_bwd_n46": SN_BLOCKS,
                       "segment_sum": 1, "table_update": 1}
WHOLE_EVAL_LAUNCHES = {f"transformer_body_fwd_s64_k{SEARCH_GROUP}": SN_BLOCKS,
                       "dot_scores_tril_fwd_n46": SN_BLOCKS}
# LayerNorm-calibrate: the same but the segment-sum and the table update (the
# table is frozen); the body's two LayerNorms train, so each candidate has its
# own parameters.
LN_STEP_LAUNCHES = {k: v for k, v in WHOLE_STEP_LAUNCHES.items() if k not in TABLE_KERNELS}
# The search-quality proxy (phase 7; experiments/search_quality_proxy.py:57-58,
# :138-144, :202-210): its JAX-trained supernet and the protocol of its EA.
PROXY_DIR = ROOT / "experiments" / "search_quality_proxy"
RANK_CANDIDATES = 24              # the EA's initial population, records 0-23
RANK_STEPS, RANK_EVAL_STEPS = 200, 24
RANK_MIN_SPEARMAN = 0.7
# Phase 9 (profiling): the latency-aware search CLI at the canonical search
# configuration on phase 5's checkpoint, once per latency estimator: a
# regularized EA cut to 8 initial candidates and one generation of 8 children,
# 5 fine-tune steps and 1 test batch a candidate, beta 0.5, the latency batch
# 512; then 3 xlarge steps of main_train with --report_flops and --profile_dir.
PROF_EA = dict(init_population=8, n_generations=1, n_childs=8, sample_size=4, ea_top_k=2)
PROF_CANDIDATES = PROF_EA["init_population"] + PROF_EA["n_generations"] * PROF_EA["n_childs"]
PROF_STEPS, PROF_BETA, PROF_TRAIN_STEPS = 5, 0.5, 3
BF16_PEAK = 989e12       # H100 SXM dense bf16 (data sheet)
# Phase 10 (multi-device): the host-RAM table and the mesh at world size 1,
# criteo-kaggle/xlarge at full vocab and batch 32768, 1 warm-up step and 3
# more, each against the one-device sparse step from the same weights and
# batches.  The offload step sums duplicate rows with NumPy in another order
# than the card's segment-sum, so its loss and dense parameters are held to
# 1e-4.  In the warm-up schedule's first steps the touched rows move little
# (lr <= 4.8e-4, Adagrad's eps 1e-2), so the touched rows of the table and the
# accumulator are held to 1e-3 of the reference's largest movement of each
# from its starting value: a host update that left out the accumulator or
# squared duplicates before summing them is off by about all of it.  The mesh
# step runs the same kernels in the same order and is held as phase 3 holds
# its steps.
MD_STEPS = 4
OFFLOAD_TOL = 1e-4
OFFLOAD_REL = 1e-3
# The search fan-out: phase 8's search configuration on phase 5's checkpoint
# with two groups of 8 (one for each process); metrics within 1e-6 relative.
FANOUT_CANDIDATES = 2 * SEARCH_GROUP
FANOUT_TOL = 1e-6
ORBAX_STEPS = 2         # the directory checkpoint's run; its resume takes 1 more
# Phase 11 (datasets): the published best archs of avazu and kdd at full
# width (7 blocks, each dataset's full vocab: 9,459,467 and 50,666,853 rows,
# batch 32768), each as phase 3 runs criteo-kaggle's and in bf16 as phase 3d
# does, with DS_STEPS steps; avazu/xlarge and kdd/xlarge fed from TSV shards
# of their datasets' columns (DS_TSV_SHARDS shards of one batch each); then
# each dataset's launchers through their CLIs' main, the launcher's flags
# followed by overrides (argparse keeps a flag's last value): synthetic data,
# LAUNCH_STEPS train steps, 1 eval batch, and for the search
# LAUNCH_CANDIDATES initial candidates (a sample of half of them, which the
# EA needs below the population) and no generation, on the checkpoint of the
# dataset's own supernet run.
DS_DATASETS = ("avazu", "kdd")
DS_ARCHS = tuple(f"{d}/{s}" for d in DS_DATASETS for s in ("xlarge", "autoctr"))
DS_STEPS = 4
DS_TSV_SHARDS = 2
DS_TSV_ROWS = DS_TSV_SHARDS * 33_000
DS_TSV_TIMED_STEPS = 4
DS_LAUNCHERS = ("eval_best_model/{}_xlarge.sh", "eval_best_model/{}_autoctr.sh",
                "train_supernet/{}_xlarge.sh", "run_ea/{}_xlarge.sh")
LAUNCH_STEPS, LAUNCH_CANDIDATES = 3, 4
# What each CLI writes into its logging dir (as phases 5 and 8 hold the
# criteo-kaggle runs of the same CLIs to).
LAUNCH_FILES = {
    "main_train": {"configs_args.json", "metrics.jsonl", "checkpoint.pkl",
                   "train_test_logs.json", "train_test_logs.pickle"},
    "train_supernet": {"configs_args.json", "metrics.jsonl", "supernet_checkpoint.pkl",
                       "train_test_logs.json", "train_test_logs.pickle"},
    "eval_subnet_from_supernet": {"results.pickle", "all_results.pickle"},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def hbm_bytes_per_s(name: str) -> float:
    # H100 data sheet: SXM 3.35 TB/s, PCIe 2.0 TB/s.
    return 2.0e12 if "PCIe" in name else 3.35e12


def cuda_ms(fn, groups: int = 5, per_group: int = 5, warmup: int = 3) -> float:
    """Median over `groups` of the mean CUDA-event time of `per_group`
    back-to-back calls, in ms."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_group)
    return float(np.median(times))


L2_FLUSH_BYTES = 256 * 1024 * 1024   # several times the H100's 50 MB L2
_l2_scratch = []


def cuda_cold_ms(fn, launches: int = 9) -> float:
    """Median CUDA-event time of single calls, in ms, each after a pass over a
    scratch buffer larger than the L2, so the call finds none of its operands
    cached; the pass lies outside the call's pair of events."""
    import numpy as np
    import torch

    if not _l2_scratch:
        _l2_scratch.append(torch.zeros(L2_FLUSH_BYTES // 4, device=DEVICE))
    fn()
    times = []
    for _ in range(launches):
        _l2_scratch[0].add_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(a, b) -> tuple:
    d = (a.float() - b.float()).abs().max().item()
    scale = b.float().abs().max().item()
    return d, d / max(scale, 1e-30), scale


def ordered_bits(t):
    """bf16 values as integers in their order: neighbours differ by one."""
    import torch

    bits = t.contiguous().view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def within_ulp(got, want) -> tuple:
    """(max abs error, max ulps, ok) of bf16 outputs: ok where every element
    is within one ulp, or within BF16_FLOOR of the largest |want|.  The ulps
    are the largest among the elements beyond that floor (below it, a value
    near zero may be thousands of ulps from a neighbour of the other sign)."""
    diff = (got.float() - want.float()).abs()
    ulps = (ordered_bits(got) - ordered_bits(want)).abs()
    picked = ulps[diff > BF16_FLOOR * want.float().abs().max().item()]
    max_ulps = int(picked.max().item()) if picked.numel() else 0
    return diff.max().item(), max_ulps, max_ulps <= 1


def agree(got, want, rel_tol) -> tuple:
    """(max abs error, ok) of a kernel output against the plain version's:
    `within` for f32, `within_ulp` for bf16 (rel_tol is then not used)."""
    import torch

    if want.dtype == torch.bfloat16:
        err, _, ok = within_ulp(got, want)
        return err, ok
    return within(got, want, rel_tol)


def dtype_of(name: str):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def bf16_named(names):
    """Launch keys of a bf16 run: every kernel but the segment-sum, the
    table update and the list clip and update (f32 under bf16 compute) has
    "_bf16" added.  A set or a dict of counts."""
    def rename(k):
        return k if k in TABLE_KERNELS | LIST_KERNELS else k + "_bf16"

    if isinstance(names, dict):
        return {rename(k): v for k, v in names.items()}
    return {rename(k) for k in names}


def kernel_modules():
    """(name prefix of a kernel's rows and launch counts, its wrapper module)."""
    from nasrec_tpu_torch.ops.kernels import (
        attention,
        dense_adagrad,
        dotprod,
        segment_sum,
        table_update,
        transformer_body,
    )

    return (("dot_scores_tril_", dotprod), ("transformer_body_", transformer_body),
            ("tiny_head_attention_", attention), ("", table_update), ("", segment_sum),
            ("", dense_adagrad))


def reset_launches() -> None:
    for _, mod in kernel_modules():
        mod.LAUNCHES.clear()


def read_launches() -> dict:
    return {prefix + k: v for prefix, mod in kernel_modules() for k, v in mod.LAUNCHES.items()}


def kernel_row(name, source, replaces, err, kern, plain, lib, nbytes, flops, hbm,
               heavy=False, exps=0, cold=False) -> dict:
    """One entry of the "kernels" line.  bound_ms is the larger of `nbytes`
    over the card's memory rate and the operations' time: `flops` over the
    card's f32 rate or, where that is longer, `exps` exponentials over the rate
    of the unit that computes them, which runs beside the f32 pipes.  `heavy`
    times a slow plain version or library call with fewer repeats.  `ms` is
    taken from back-to-back launches on the same tensors; `cold` adds cold_ms,
    taken with the L2 overwritten before each launch (else null)."""
    t_bytes, t_ops = nbytes / hbm, max(flops / F32_FLOPS, exps / EXP_RATE)
    reps = dict(groups=3, per_group=3, warmup=1) if heavy else {}
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, **reps),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if lib is None else cuda_ms(lib, **reps),
            "cold_ms": cuda_cold_ms(kern) if cold else None}


def draw_indices(rng, batch, vocab, kind):
    """[batch, S] int32; slot s uniform (or zipf(1.05), clipped) over its table
    (the synthetic index draw of the JAX package's bench.py)."""
    import numpy as np

    cols = []
    for v in vocab:
        if kind == "uniform":
            cols.append(rng.randint(0, v, size=batch))
        else:
            cols.append(np.minimum(rng.zipf(1.05, size=batch) - 1, v - 1))
    return np.stack(cols, axis=1).astype(np.int32)


def phase_device(kernel_build):
    import torch

    smi = nvidia_smi()
    t0 = time.perf_counter()
    report = kernel_build.build_all()
    ptxas = {name: [l.strip() for l in r["log"].splitlines()
                    if "registers" in l or "Compiling entry" in l or "spill" in l]
             for name, r in report.items()}
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0,
          "nvcc_s": {k: r["seconds"] for k, r in report.items()}, "ptxas": ptxas})
    return smi


BODY_SOURCE = "nasrec_tpu_torch/csrc/transformer_body.cu"
BODY_REPLACES = "nasrec_tpu/ops/kernels/transformer_body_pallas.py:414"
ATTN_SOURCE = "nasrec_tpu_torch/csrc/attention.cu"
ATTN_REPLACES = "nasrec_tpu/ops/kernels/attention_pallas.py:166"


def attention_flops(slots: int) -> tuple:
    """(forward, backward) operations of the attention core for one position:
    8 heads x S keys.  The products q.k and p.v are `attention.matmul_flops`
    of one batch row over its S positions (2 a multiply-add, 8 a (query, key)
    pair of a head: the count that profiling.dot_flops reports for the
    kernel).  Beside them, forward:
    subtract the max, exp, row sum (3 a pair).  Backward from the saved
    statistics: the products of the plain version's gradients (twice the
    forward's), the scores recomputed (half the forward's products), and
    subtract, exp, times 1/sum, ds 2 (5 a pair).  An exp counts as one
    operation here, and also in the bound's own term for exponentials: 8 * S
    of them a position each way (`kernel_row`)."""
    from nasrec_tpu_torch.ops.kernels import attention

    mm = attention.matmul_flops(1, slots) // slots
    return mm + 8 * slots * 3, 2 * mm + mm // 2 + 8 * slots * 5


def body_flops(slots: int) -> tuple:
    """(forward, backward) operations of the transformer body for one position.
    Forward: the four feature linears (`transformer_body.matmul_flops` less
    the attention core's products: 2*16*(48+16+16+16)), the attention core,
    two LayerNorms and residuals (about 230).  Backward: the linears again,
    their transposes and their weight gradients (3x), the attention backward,
    and both LayerNorms forward and backward (about 500)."""
    from nasrec_tpu_torch.ops.kernels import attention, transformer_body

    lin = (transformer_body.matmul_flops(1, slots) - attention.matmul_flops(1, slots)) // slots
    fwd, bwd = attention_flops(slots)
    return lin + fwd + 230, 3 * lin + bwd + 500


def within(got, want, rel_tol) -> tuple:
    """(max abs error, ok): the error against rel_tol * max(1, largest |want|)."""
    err, _, scale = max_err(got, want)
    return err, err <= rel_tol * max(scale, 1.0)


def relu_edge_rows(x, params):
    """The one discontinuity of the body: where an input of the FFN's ReLU lies
    within rounding of zero, a kernel and the plain version may take different
    sides, and their gradients then differ by a whole term.  Returns the mask
    of batch rows of x [B, S, 16] that hold such an input (a few in 32768);
    the checks give them a zero output gradient, so they count in no backward."""
    import torch
    import torch.nn.functional as F

    from nasrec_tpu_torch.ops.common import LN_EPS
    from nasrec_tpu_torch.ops.kernels.attention import tiny_head_attention_plain

    with torch.no_grad():
        o = tiny_head_attention_plain(F.linear(x, params[0], params[1]))
        x4 = F.layer_norm(F.linear(o, params[2], params[3]) + x, (16,), params[4],
                          params[5], LN_EPS)
        return (F.linear(x4, params[6], params[7]).abs() < RELU_MARGIN).flatten(1).any(1)


def check_transformer_body(slots, hbm, gen, rows_out, batch=BATCH, suffix="",
                           kinds=("fwd", "fwd_train", "bwd"), cold=False,
                           dtype="float32") -> None:
    """The body kernels at [batch, slots, 16] against the plain version: the
    eval forward, the training forward (out, o, statistic), the backward (dx
    and each of the twelve parameter gradients), equal bits from two backward
    runs and from both layouts of x, and the times of the rows in `kinds`,
    named with `suffix`.  x is laid out as the main path gives it: the
    transposed view of a contiguous [batch, 16, slots].  dtype "bfloat16":
    x, dout, out and dx in bf16 (o, the statistic and the parameters f32),
    rows named "_bf16", outputs held to a bf16 ulp (the tolerances above)."""
    import torch
    import torch.nn.functional as F

    from nasrec_tpu_torch.ops.kernels import transformer_body as tb
    from nasrec_tpu_torch.ops.kernels.attention import softmax_lse2, tiny_head_attention_plain

    dev = torch.device(DEVICE)
    dt = dtype_of(dtype)
    bf16 = dt == torch.bfloat16
    if bf16:
        suffix += "_bf16"
    x = torch.randn(batch, 16, slots, device=dev, generator=gen).to(dt).transpose(1, 2)
    dout = torch.randn(batch, slots, 16, device=dev, generator=gen).to(dt)
    params = []
    for name, shape in zip(tb.PARAM_NAMES, tb.PARAM_SHAPES):
        p = 0.3 * torch.randn(shape, device=dev, generator=gen)
        params.append(p + 0.17 if name in ("attn_ln_w", "fc_ln_w") else p)
    flat = tb.flatten_params(params)

    unsure = relu_edge_rows(x.float(), params)
    dout[unsure] = 0.0
    with torch.no_grad():        # the plain attention output and statistics (f32)
        qkv = F.linear(x.float(), params[0], params[1])
        o_p = tiny_head_attention_plain(qkv)
        stats_p = softmax_lse2(qkv)
        del qkv

    out_e, _, _ = tb.transformer_body_fwd_kernel(x, flat, save=False)
    out_t, o_k, stats_k = tb.transformer_body_fwd_kernel(x, flat, save=True)
    dx_k, dflat_k = tb.transformer_body_bwd_kernel(x, dout, o_k, stats_k, flat)
    dx_2, dflat_2 = tb.transformer_body_bwd_kernel(x, dout, o_k, stats_k, flat)
    torch.cuda.synchronize()
    same_bits = (torch.equal(out_e, out_t) and torch.equal(dx_k, dx_2)
                 and torch.equal(dflat_k, dflat_2))
    # The same values as a contiguous [batch, slots, 16]: the other layout the
    # kernels read in place.  dx comes back in the layout x had.
    xc = x.contiguous()
    out_c, o_c, stats_c = tb.transformer_body_fwd_kernel(xc, flat, save=True)
    dx_c, dflat_c = tb.transformer_body_bwd_kernel(xc, dout, o_c, stats_c, flat)
    torch.cuda.synchronize()
    same_layouts = (dx_c.is_contiguous() and dx_k.transpose(1, 2).is_contiguous()
                    and torch.equal(out_c, out_t) and torch.equal(o_c, o_k)
                    and torch.equal(stats_c, stats_k) and torch.equal(dx_c, dx_k)
                    and torch.equal(dflat_c, dflat_k))
    del xc, out_c, o_c, stats_c, dx_c, dflat_c

    xg = x.clone().requires_grad_(True)
    pg = [p.clone().requires_grad_(True) for p in params]
    out_g = tb.transformer_body_plain(xg, pg)
    grads_p = torch.autograd.grad(out_g, [xg] + pg, dout, retain_graph=True)
    errs, scales, ok = {}, {}, same_bits and same_layouts
    param_tol = BF16_PARAM_GRAD_TOL if bf16 else GRAD_REL_TOL
    for key, got, want, tol in (
            [("out", out_e, out_g.detach(), KERNEL_REL_TOL), ("o", o_k, o_p, KERNEL_REL_TOL),
             ("stats", stats_k, stats_p, KERNEL_REL_TOL), ("dx", dx_k, grads_p[0], GRAD_REL_TOL)]
            + [(f"d_{n}", g.reshape(w.shape), w, param_tol)
               for n, g, w in zip(tb.PARAM_NAMES, dflat_k.split(tb.PARAM_SIZES), grads_p[1:])]):
        errs[key], good = agree(got, want, tol)
        scales[key] = want.abs().max().item()
        ok = ok and good
    ulps = ({"out": within_ulp(out_e, out_g.detach())[1], "dx": within_ulp(dx_k, grads_p[0])[1]}
            if bf16 else None)
    emit({"phase": "kernels", "kernel": "transformer_body", "dtype": dtype, "slots": slots,
          "batch": batch, "max_abs_err": errs, "max_ulps": ulps, "grad_scale": scales,
          "equal_bits_twice": same_bits, "equal_bits_both_layouts": same_layouts,
          "rows_at_a_relu_edge": int(unsure.sum()), "ok": ok})
    if not ok:
        raise SystemExit(f"transformer_body S={slots} ({dtype}) disagrees with its plain "
                         "version")
    del o_p, stats_p

    # The one library module that computes the same function, timed only.
    lib = torch.nn.TransformerEncoderLayer(16, 8, dim_feedforward=16, dropout=0.0,
                                           batch_first=True, norm_first=False, device=dev,
                                           dtype=dt)
    with torch.no_grad():
        for dst, src in zip((lib.self_attn.in_proj_weight, lib.self_attn.in_proj_bias,
                             lib.self_attn.out_proj.weight, lib.self_attn.out_proj.bias,
                             lib.norm1.weight, lib.norm1.bias, lib.linear1.weight,
                             lib.linear1.bias, lib.linear2.weight, lib.linear2.bias,
                             lib.norm2.weight, lib.norm2.bias), params):
            dst.copy_(src)
    lib.eval()        # no dropout either way; eval lets no_grad calls take its fused path
    lib_params = list(lib.parameters())
    xl = x.clone().requires_grad_(True)

    def lib_eval():
        with torch.no_grad():
            return lib(x)

    # A yardstick only: where the library refuses the shape or disagrees with
    # the plain version, the rows carry no library time.
    lib_tol = BF16_LIB_TOL if bf16 else 10 * KERNEL_REL_TOL
    try:
        out_l = lib(xl)
        lib_err, lib_ok = within(out_l.detach(), out_g.detach(), lib_tol)
        lib_err = max(lib_err, within(lib_eval(), out_g.detach(), lib_tol)[0])
        lib_ok = lib_ok and lib_err <= lib_tol * max(1.0, out_g.float().abs().max().item())
        note = None
    except RuntimeError as exc:
        out_l, lib_err, lib_ok, note = None, None, False, str(exc)[:200]
    emit({"phase": "kernels", "library": "nn.TransformerEncoderLayer", "dtype": dtype,
          "slots": slots, "batch": batch,
          "max_abs_err_vs_plain": lib_err, "agrees": lib_ok, "error": note})

    pos = batch * slots
    f_fwd, f_bwd = body_flops(slots)
    act, f32 = pos * 16 * x.element_size(), pos * 16 * 4
    # Bytes moved: x and out; with o and the statistic [B, S, 8], both f32;
    # x, dout, o, the statistic and dx.
    for kind, kern, plain, lib_fn, nbytes, flops, err in (
        ("fwd",
         lambda: tb.transformer_body_fwd_kernel(x, flat, save=False),
         lambda: no_grad_call(tb.transformer_body_plain, x, params), lib_eval,
         2 * act, f_fwd, errs["out"]),
        ("fwd_train",
         lambda: tb.transformer_body_fwd_kernel(x, flat, save=True),
         lambda: tb.transformer_body_plain(xg, pg), lambda: lib(xl),
         2 * act + 1.5 * f32, f_fwd, max(errs["out"], errs["o"], errs["stats"])),
        ("bwd",
         lambda: tb.transformer_body_bwd_kernel(x, dout, o_k, stats_k, flat),
         lambda: torch.autograd.grad(out_g, [xg] + pg, dout, retain_graph=True),
         lambda: torch.autograd.grad(out_l, [xl] + lib_params, dout, retain_graph=True),
         3 * act + 1.5 * f32, f_bwd, max(v for k, v in errs.items() if k.startswith("d"))),
    ):
        if kind not in kinds:
            continue
        name = f"transformer_body_{kind}_s{slots}{suffix}"
        rows_out[name] = kernel_row(name, BODY_SOURCE, BODY_REPLACES, err, kern, plain,
                                    lib_fn if lib_ok else None,
                                    nbytes + 2 * flat.numel() * 4,
                                    flops * pos, hbm, heavy=True, exps=8 * slots * pos,
                                    cold=cold or bf16)
    del out_g, out_l, grads_p, xg, xl
    torch.cuda.empty_cache()


LIB_BODY_NAMES = ("self_attn.in_proj_weight", "self_attn.in_proj_bias", "self_attn.out_proj.weight",
                  "self_attn.out_proj.bias", "norm1.weight", "norm1.bias", "linear1.weight",
                  "linear1.bias", "linear2.weight", "linear2.bias", "norm2.weight", "norm2.bias")


def check_transformer_body_k(hbm, gen, rows_out, batch, kinds, dtype="float32",
                             k=SEARCH_GROUP, slots=64) -> None:
    """The K-candidate body kernels (the whole-net group's form) at k
    candidates of `batch` rows, [k * batch, slots, 16] as the slot projection
    leaves it, each candidate with its own parameters [k, ...]: every output
    and gradient bit-equal to k one-candidate launches on the candidates'
    rows, and held against the K-candidate plain version (the one-candidate
    kernels' tolerances, the parameter gradients to K_PARAM_GRAD_TOL of their
    largest magnitude in f32); rows "transformer_body_<kind>_s<S>_k<k>[_bf16]
    _b<batch>" for `kinds`, with cold_ms.  The library yardstick is
    torch.func.vmap of nn.TransformerEncoderLayer over the stacked weights
    (functional_call)."""
    import torch
    import torch.nn.functional as F

    from nasrec_tpu_torch.ops.kernels import transformer_body as tb
    from nasrec_tpu_torch.ops.kernels.attention import softmax_lse2, tiny_head_attention_plain

    dev = torch.device(DEVICE)
    dt = dtype_of(dtype)
    bf16 = dt == torch.bfloat16
    suffix = f"_k{k}" + ("_bf16" if bf16 else "") + f"_b{batch}"
    n = k * batch
    x = torch.randn(n, 16, slots, device=dev, generator=gen).to(dt).transpose(1, 2)
    dout = torch.randn(n, slots, 16, device=dev, generator=gen).to(dt)
    params = []
    for name, shape in zip(tb.PARAM_NAMES, tb.PARAM_SHAPES):
        p = 0.3 * torch.randn((k,) + shape, device=dev, generator=gen)
        params.append(p + 0.17 if name in ("attn_ln_w", "fc_ln_w") else p)
    flat = tb.flatten_params(params)
    runs = [slice(i * batch, (i + 1) * batch) for i in range(k)]
    unsure = torch.cat([relu_edge_rows(x[r].float(), [p[i] for p in params])
                        for i, r in enumerate(runs)])
    dout[unsure] = 0.0

    out_e, _, _ = tb.transformer_body_fwd_kernel(x, flat, save=False)
    out_t, o_k, stats_k = tb.transformer_body_fwd_kernel(x, flat, save=True)
    dx_k, dflat_k = tb.transformer_body_bwd_kernel(x, dout, o_k, stats_k, flat)
    same_singles = True
    for i, r in enumerate(runs):
        oe, _, _ = tb.transformer_body_fwd_kernel(x[r], flat[i], save=False)
        ot, oi, si = tb.transformer_body_fwd_kernel(x[r], flat[i], save=True)
        dxi, dfi = tb.transformer_body_bwd_kernel(x[r], dout[r].contiguous(), oi, si, flat[i])
        same_singles = (same_singles and torch.equal(out_e[r], oe) and torch.equal(out_t[r], ot)
                        and torch.equal(o_k[r], oi) and torch.equal(stats_k[r], si)
                        and torch.equal(dx_k[r], dxi) and torch.equal(dflat_k[i], dfi))
    torch.cuda.synchronize()
    with torch.no_grad():
        qkv = torch.func.vmap(F.linear)(x.float().reshape(k, batch, slots, 16), params[0],
                                        params[1]).reshape(n, slots, 48)
        o_p, stats_p = tiny_head_attention_plain(qkv), softmax_lse2(qkv)
        del qkv
    xg = x.clone().requires_grad_(True)
    pg = [p.clone().requires_grad_(True) for p in params]
    out_g = tb.transformer_body_k_plain(xg, pg)
    grads_p = torch.autograd.grad(out_g, [xg] + pg, dout, retain_graph=True)
    param_tol = BF16_PARAM_GRAD_TOL if bf16 else K_PARAM_GRAD_TOL
    errs, ok = {}, same_singles
    for key, got, want, tol in (
            [("out", out_e, out_g.detach(), KERNEL_REL_TOL), ("o", o_k, o_p, KERNEL_REL_TOL),
             ("stats", stats_k, stats_p, KERNEL_REL_TOL), ("dx", dx_k, grads_p[0], GRAD_REL_TOL)]
            + [(f"d_{nm}", g.reshape(w.shape), w, param_tol)
               for nm, g, w in zip(tb.PARAM_NAMES, dflat_k.split(tb.PARAM_SIZES, dim=1),
                                   grads_p[1:])]):
        errs[key], good = agree(got, want, tol)
        ok = ok and good
    emit({"phase": "kernels", "kernel": "transformer_body", "form": f"{k} candidates",
          "dtype": dtype, "slots": slots, "batch_per_candidate": batch, "max_abs_err": errs,
          "equal_bits_to_one_candidate_launches": same_singles,
          "rows_at_a_relu_edge": int(unsure.sum()), "ok": ok})
    if not ok:
        raise SystemExit(f"the {k}-candidate transformer_body S={slots} ({dtype}) disagrees "
                         "with its plain version or with one-candidate launches")
    del o_p, stats_p

    lib = torch.nn.TransformerEncoderLayer(16, 8, dim_feedforward=16, dropout=0.0,
                                           batch_first=True, norm_first=False, device=dev,
                                           dtype=dt)
    stacked = {nm: p.detach().to(dt) for nm, p in zip(LIB_BODY_NAMES, params)}
    stacked_g = {nm: p.clone().requires_grad_(True) for nm, p in stacked.items()}
    xk = x.reshape(k, batch, slots, 16)
    xl = xk.clone().requires_grad_(True)

    def lib_call(ps, xx):
        return torch.func.vmap(lambda p, xi: torch.func.functional_call(lib, p, (xi,)))(ps, xx)

    def lib_eval():
        with torch.no_grad():
            return lib_call(stacked, xk)

    lib_tol = BF16_LIB_TOL if bf16 else 10 * KERNEL_REL_TOL
    try:
        out_l = lib_call(stacked_g, xl)
        lib_err, lib_ok = within(out_l.detach().reshape(n, slots, 16), out_g.detach(), lib_tol)
        note = None
    except RuntimeError as exc:
        out_l, lib_err, lib_ok, note = None, None, False, str(exc)[:200]
    emit({"phase": "kernels", "library": "vmap(nn.TransformerEncoderLayer)", "dtype": dtype,
          "form": f"{k} candidates", "slots": slots, "batch_per_candidate": batch,
          "max_abs_err_vs_plain": lib_err, "agrees": lib_ok, "error": note})
    dout_l = dout.reshape(k, batch, slots, 16)

    pos = n * slots
    f_fwd, f_bwd = body_flops(slots)
    act, f32 = pos * 16 * x.element_size(), pos * 16 * 4
    for kind, kern, plain, lib_fn, nbytes, flops, err in (
        ("fwd",
         lambda: tb.transformer_body_fwd_kernel(x, flat, save=False),
         lambda: no_grad_call(tb.transformer_body_k_plain, x, params), lib_eval,
         2 * act, f_fwd, errs["out"]),
        ("fwd_train",
         lambda: tb.transformer_body_fwd_kernel(x, flat, save=True),
         lambda: tb.transformer_body_k_plain(xg, pg), lambda: lib_call(stacked_g, xl),
         2 * act + 1.5 * f32, f_fwd, max(errs["out"], errs["o"], errs["stats"])),
        ("bwd",
         lambda: tb.transformer_body_bwd_kernel(x, dout, o_k, stats_k, flat),
         lambda: torch.autograd.grad(out_g, [xg] + pg, dout, retain_graph=True),
         lambda: torch.autograd.grad(out_l, [xl, *stacked_g.values()], dout_l,
                                     retain_graph=True),
         3 * act + 1.5 * f32, f_bwd, max(v for key, v in errs.items() if key.startswith("d"))),
    ):
        if kind not in kinds:
            continue
        name = f"transformer_body_{kind}_s{slots}{suffix}"
        rows_out[name] = kernel_row(name, BODY_SOURCE, BODY_REPLACES, err, kern, plain,
                                    lib_fn if lib_ok else None, nbytes + 2 * flat.numel() * 4,
                                    flops * pos, hbm, heavy=True, exps=8 * slots * pos,
                                    cold=True)
    del out_g, out_l, grads_p, xg, xl, stacked_g
    torch.cuda.empty_cache()


def no_grad_call(fn, *args):
    import torch

    with torch.no_grad():
        return fn(*args)


def check_attention(slots, hbm, gen, rows_out, dtype="float32") -> None:
    """The attention kernel at [BATCH, slots, 48], forward and backward,
    against the plain version; F.scaled_dot_product_attention as the library.
    dtype "bfloat16": qkv, do, o and dqkv in bf16, rows named "_bf16"."""
    import torch
    import torch.nn.functional as F

    from nasrec_tpu_torch.ops.kernels import attention as at

    dev = torch.device(DEVICE)
    dt = dtype_of(dtype)
    bf16 = dt == torch.bfloat16
    sfx = "_bf16" if bf16 else ""
    qkv = torch.randn(BATCH, slots, 48, device=dev, generator=gen).to(dt)
    do = torch.randn(BATCH, slots, 16, device=dev, generator=gen).to(dt)
    o_k = at.tiny_head_attention_fwd_kernel(qkv)
    dqkv_k = at.tiny_head_attention_bwd_kernel(qkv, do)
    qg = qkv.clone().requires_grad_(True)
    o_g = at.tiny_head_attention_plain(qg)
    (dqkv_p,) = torch.autograd.grad(o_g, qg, do, retain_graph=True)
    torch.cuda.synchronize()
    fe, f_ok = agree(o_k, o_g.detach(), KERNEL_REL_TOL)
    be, b_ok = agree(dqkv_k, dqkv_p, GRAD_REL_TOL)
    ulps = ({"o": within_ulp(o_k, o_g.detach())[1], "dqkv": within_ulp(dqkv_k, dqkv_p)[1]}
            if bf16 else None)
    emit({"phase": "kernels", "kernel": "tiny_head_attention", "dtype": dtype, "slots": slots,
          "batch": BATCH, "o_max_abs_err": fe, "dqkv_max_abs_err": be, "max_ulps": ulps,
          "ok": f_ok and b_ok})
    if not (f_ok and b_ok):
        raise SystemExit(f"tiny_head_attention S={slots} ({dtype}) disagrees with its plain "
                         "version")

    ql = qkv.clone().requires_grad_(True)

    def sdpa(t):
        q, k, v = (u.reshape(BATCH, slots, 8, 2).transpose(1, 2) for u in t.split(16, dim=-1))
        return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(BATCH, slots, 16)

    o_l = sdpa(ql)
    lib_err, lib_ok = within(o_l.detach(), o_g.detach(),
                             BF16_LIB_TOL if bf16 else 10 * KERNEL_REL_TOL)
    emit({"phase": "kernels", "library": "F.scaled_dot_product_attention", "dtype": dtype,
          "slots": slots, "max_abs_err_vs_plain": lib_err, "agrees": lib_ok})
    pos = BATCH * slots
    f_fwd, f_bwd = attention_flops(slots)
    for name, kern, plain, lib_fn, nfloats, flops, exps, err in (
        (f"tiny_head_attention_fwd_s{slots}{sfx}",
         lambda: at.tiny_head_attention_fwd_kernel(qkv),
         lambda: no_grad_call(at.tiny_head_attention_plain, qkv),
         lambda: no_grad_call(sdpa, qkv), 48 + 16, f_fwd, 8 * slots, fe),
        # Nothing is saved, so the backward first needs the forward's work too.
        (f"tiny_head_attention_bwd_s{slots}{sfx}",
         lambda: at.tiny_head_attention_bwd_kernel(qkv, do),
         lambda: torch.autograd.grad(o_g, qg, do, retain_graph=True),
         lambda: torch.autograd.grad(o_l, ql, do, retain_graph=True),
         48 + 16 + 48, f_fwd + f_bwd, 16 * slots, be),
    ):
        rows_out[name] = kernel_row(name, ATTN_SOURCE, ATTN_REPLACES, err, kern, plain,
                                    lib_fn if lib_ok else None,
                                    nfloats * qkv.element_size() * pos,
                                    flops * pos, hbm, heavy=True, exps=exps * pos, cold=bf16)
    del o_g, o_l, qg, ql
    torch.cuda.empty_cache()


def check_attention_k(hbm, gen, rows_out, batch, k=SEARCH_GROUP, slots=64) -> None:
    """The attention core's K-candidate form: torch.func.vmap of
    attention.tiny_head_attention over k candidates of `batch` rows, [k,
    batch, slots, 48], forward and backward in f32.  Its vmap rule
    (ops/kernels/candidates.py) must launch each kernel once for the group,
    at k * batch rows; o and dqkv bit-equal to k one-candidate launches and
    within the one-candidate tolerances of vmap of the plain version.  Rows
    "tiny_head_attention_<fwd|bwd>_s<S>_k<k>_b<batch>" time that launch on
    the folded tensors, beside vmap of the plain version and of
    F.scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from nasrec_tpu_torch.ops.kernels import attention as at

    dev = torch.device(DEVICE)
    qkv = torch.randn(k, batch, slots, 48, device=dev, generator=gen)
    do = torch.randn(k, batch, slots, 16, device=dev, generator=gen)
    before = dict(at.LAUNCHES)
    qv = qkv.clone().requires_grad_(True)
    o_v = torch.func.vmap(at.tiny_head_attention)(qv)
    (dq_v,) = torch.autograd.grad(o_v, qv, do)
    torch.cuda.synchronize()
    group_launches = {key: n - before.get(key, 0) for key, n in at.LAUNCHES.items()
                      if n != before.get(key, 0)}
    one_launch = group_launches == {f"fwd_s{slots}": 1, f"bwd_s{slots}": 1}
    same_singles = all(
        torch.equal(o_v[i], at.tiny_head_attention_fwd_kernel(qkv[i]))
        and torch.equal(dq_v[i], at.tiny_head_attention_bwd_kernel(qkv[i], do[i]))
        for i in range(k))
    qg = qkv.clone().requires_grad_(True)
    o_g = torch.func.vmap(at.tiny_head_attention_plain)(qg)
    (dq_p,) = torch.autograd.grad(o_g, qg, do, retain_graph=True)
    fe, f_ok = agree(o_v, o_g.detach(), KERNEL_REL_TOL)
    be, b_ok = agree(dq_v, dq_p, GRAD_REL_TOL)
    ok = one_launch and same_singles and f_ok and b_ok
    emit({"phase": "kernels", "kernel": "tiny_head_attention", "form": f"{k} candidates",
          "dtype": "float32", "slots": slots, "batch_per_candidate": batch,
          "launches_of_the_vmap_rule": group_launches,
          "equal_bits_to_one_candidate_launches": same_singles,
          "o_max_abs_err": fe, "dqkv_max_abs_err": be, "ok": ok})
    if not ok:
        raise SystemExit(f"the {k}-candidate tiny_head_attention S={slots} did not launch "
                         "once a group, or disagrees with one-candidate launches or with "
                         "its plain version")
    del o_v, dq_v, qv

    def sdpa(t):
        q, kk, v = (u.reshape(batch, slots, 8, 2).transpose(1, 2) for u in t.split(16, dim=-1))
        return F.scaled_dot_product_attention(q, kk, v).transpose(1, 2).reshape(batch, slots, 16)

    ql = qkv.clone().requires_grad_(True)
    try:
        o_l = torch.func.vmap(sdpa)(ql)
        lib_err, lib_ok = within(o_l.detach(), o_g.detach(), 10 * KERNEL_REL_TOL)
        note = None
    except RuntimeError as exc:
        o_l, lib_err, lib_ok, note = None, None, False, str(exc)[:200]
    emit({"phase": "kernels", "library": "vmap(F.scaled_dot_product_attention)",
          "dtype": "float32", "form": f"{k} candidates", "slots": slots,
          "batch_per_candidate": batch, "max_abs_err_vs_plain": lib_err, "agrees": lib_ok,
          "error": note})
    qf, dof = qkv.reshape(k * batch, slots, 48), do.reshape(k * batch, slots, 16)
    pos = k * batch * slots
    f_fwd, f_bwd = attention_flops(slots)
    for kind, kern, plain, lib_fn, nfloats, flops, exps, err in (
        ("fwd", lambda: at.tiny_head_attention_fwd_kernel(qf),
         lambda: no_grad_call(torch.func.vmap(at.tiny_head_attention_plain), qkv),
         lambda: no_grad_call(torch.func.vmap(sdpa), qkv), 48 + 16, f_fwd, 8 * slots, fe),
        ("bwd", lambda: at.tiny_head_attention_bwd_kernel(qf, dof),
         lambda: torch.autograd.grad(o_g, qg, do, retain_graph=True),
         lambda: torch.autograd.grad(o_l, ql, do, retain_graph=True),
         48 + 16 + 48, f_fwd + f_bwd, 16 * slots, be),
    ):
        name = f"tiny_head_attention_{kind}_s{slots}_k{k}_b{batch}"
        rows_out[name] = kernel_row(name, ATTN_SOURCE, ATTN_REPLACES, err, kern, plain,
                                    lib_fn if lib_ok else None, nfloats * 4 * pos,
                                    flops * pos, hbm, heavy=True, exps=exps * pos)
    del o_g, o_l, qg, ql
    torch.cuda.empty_cache()


def check_fused_against_unfused(gen) -> None:
    """The transformer node of the xlarge plan's block 0 (26 -> 64 slots):
    its fused form (the body kernels) against its unfused form (PyTorch ops
    around the attention kernel), output and input gradient."""
    import torch

    from nasrec_tpu_torch.ops.attention import Transformer

    dev = torch.device(DEVICE)
    node = Transformer(26, 64, 16, False, gen, dev)
    sparse = torch.randn(BATCH, 26 * 16, device=dev, generator=gen)
    co = torch.randn(BATCH, 64 * 16, device=dev, generator=gen)
    with torch.no_grad():
        x = node.proj(sparse.reshape(BATCH, 26, 16).transpose(1, 2)).transpose(1, 2)
    unsure = relu_edge_rows(x, node.body_params())
    co[unsure] = 0.0
    res = []
    for fused in (True, False):
        node.fused = fused
        xs = sparse.clone().requires_grad_(True)
        out = node(xs, 16)
        res.append((out.detach(), torch.autograd.grad(out, xs, co)[0]))
    fe, f_ok = within(res[0][0], res[1][0], KERNEL_REL_TOL)
    be, b_ok = within(res[0][1], res[1][1], GRAD_REL_TOL)
    emit({"phase": "kernels", "check": "fused form against unfused form", "slots": 64,
          "batch": BATCH, "out_max_abs_err": fe, "dx_max_abs_err": be,
          "rows_at_a_relu_edge": int(unsure.sum()), "ok": f_ok and b_ok})
    if not (f_ok and b_ok):
        raise SystemExit("the transformer node's fused and unfused forms disagree")



def check_dot_scores(n, hbm, gen, rows_out, batch=BATCH, suffix="",
                     kinds=("fwd", "bwd"), dtype="float32") -> None:
    """The dot-product kernels at batch rows against the plain version, on the
    operands as the DotProduct node holds them: the projected dense row
    x [B, 16] and the projected slots yt [B, 16, n - 1]; equal bits from two
    runs; the times of the rows in `kinds`, named with `suffix`.  dtype
    "bfloat16": every operand and result in bf16, rows named "_bf16"."""
    import torch

    from nasrec_tpu_torch.ops.kernels import dotprod

    dev = torch.device(DEVICE)
    dt = dtype_of(dtype)
    bf16 = dt == torch.bfloat16
    if bf16:
        suffix += "_bf16"
    P = dotprod.tril_size(n)
    x = torch.randn(batch, 16, device=dev, generator=gen).to(dt)
    yt = torch.randn(batch, 16, n - 1, device=dev, generator=gen).to(dt)
    dz = torch.randn(batch, P, device=dev, generator=gen).to(dt)
    idx = dotprod._tril_flat_index(n, dev)
    idx_t = (idx % n) * n + idx // n

    z_k = dotprod.dot_scores_tril_fwd_kernel(x, yt)
    dx_k, dy_k = dotprod.dot_scores_tril_bwd_kernel(x, yt, dz)
    z_2 = dotprod.dot_scores_tril_fwd_kernel(x, yt)
    dx_2, dy_2 = dotprod.dot_scores_tril_bwd_kernel(x, yt, dz)
    xg, yg = x.clone().requires_grad_(True), yt.clone().requires_grad_(True)
    z_g = dotprod.dot_scores_tril_plain(xg, yg)
    dx_p, dy_p = torch.autograd.grad(z_g, [xg, yg], dz, retain_graph=True)
    torch.cuda.synchronize()
    same_bits = (torch.equal(z_k, z_2) and torch.equal(dx_k, dx_2)
                 and torch.equal(dy_k, dy_2))
    fe, fr, fs = max_err(z_k, z_g.detach())
    xe, xr, xs = max_err(dx_k, dx_p)
    ye, yr, ys = max_err(dy_k, dy_p)
    pairs = ((z_k, z_g.detach()), (dx_k, dx_p), (dy_k, dy_p))
    ok = same_bits and all(agree(got, want, KERNEL_REL_TOL)[1] for got, want in pairs)
    ulps = [within_ulp(got, want)[1] for got, want in pairs] if bf16 else None
    emit({"phase": "kernels", "kernel": "dot_scores_tril", "dtype": dtype, "n": n,
          "batch": batch, "z_max_abs_err": fe, "z_max_rel_err": fr, "dx_max_abs_err": xe,
          "dx_max_rel_err": xr, "dyt_max_abs_err": ye, "dyt_max_rel_err": yr,
          "max_ulps_z_dx_dyt": ulps,
          "equal_bits_twice": same_bits, "fwd_launch": list(dotprod.fwd_config(n)),
          "bwd_launch": list(dotprod.bwd_config(n)), "ok": ok})
    if not ok:
        raise SystemExit(f"dot_scores_tril n={n} batch={batch} ({dtype}) disagrees with its "
                         "plain version")

    # The library calls work on t [B, n, 16], which only they need.
    t = torch.cat([x[:, None, :], yt.transpose(1, 2)], dim=1).contiguous()

    def lib_fwd():
        return torch.bmm(t, t.transpose(1, 2)).reshape(batch, n * n)[:, idx]

    def lib_bwd():
        full = torch.zeros(batch, n * n, device=dev, dtype=dt)
        full[:, idx] = dz
        full[:, idx_t] = dz
        return torch.bmm(full.reshape(batch, n, n), t)

    t_bytes, z_bytes = batch * n * 16 * x.element_size(), batch * P * x.element_size()
    for kind, kern, plain, lib, nbytes, flops, err in (
        ("fwd",
         lambda: dotprod.dot_scores_tril_fwd_kernel(x, yt),
         lambda: no_grad_call(dotprod.dot_scores_tril_plain, x, yt), lib_fwd,
         t_bytes + z_bytes, 2 * 16 * P * batch, fe),
        ("bwd",
         lambda: dotprod.dot_scores_tril_bwd_kernel(x, yt, dz),
         lambda: torch.autograd.grad(z_g, [xg, yg], dz, retain_graph=True), lib_bwd,
         2 * t_bytes + z_bytes, 2 * 16 * n * (n - 1) * batch, max(xe, ye)),
    ):
        if kind not in kinds:
            continue
        name = f"dot_scores_tril_{kind}_n{n}{suffix}"
        rows_out[name] = kernel_row(
            name, "nasrec_tpu_torch/csrc/dotprod.cu",
            "nasrec_tpu/ops/kernels/dotprod_pallas.py:160", err, kern, plain, lib,
            nbytes, flops, hbm, cold=True)
    del x, yt, t, dz, z_k, z_2, dx_k, dy_k, dx_2, dy_2, xg, yg, z_g, dx_p, dy_p
    torch.cuda.empty_cache()


def check_table_update(vocab, hbm, gen, rows_out, batch=BATCH, name="table_update",
                       kinds=("uniform", "zipf"), top_rows=False) -> None:
    """The table update over the fused table of `vocab` against the plain
    version, with the touched rows of a batch of uniform (and of zipf(1.05))
    indices; the row `name` times the uniform case.  top_rows: the batch's
    first example takes the last row of every slot, so the update reaches
    the table's highest rows (the last slot's last row is the table's)."""
    import numpy as np
    import torch

    from nasrec_tpu_torch.models.embedding import table_offsets
    from nasrec_tpu_torch.ops.kernels import table_update
    from nasrec_tpu_torch.train.sparse_embedding import rowwise_segment_sum_slotwise

    dev = torch.device(DEVICE)
    total = int(sum(vocab))
    offsets = torch.as_tensor(table_offsets(vocab), device=dev)
    table0 = torch.randn(total, 16, device=dev, generator=gen)
    acc0 = torch.rand(total, 16, device=dev, generator=gen)
    rng = np.random.RandomState(0)
    for kind in kinds:
        idx = draw_indices(rng, batch, vocab, kind)
        if top_rows:
            idx[0] = np.asarray(vocab) - 1
        idx2d = torch.as_tensor(idx, device=dev) + offsets
        g = 0.01 * torch.randn(batch * len(vocab), 16, device=dev, generator=gen)
        rows, seg, is_end = rowwise_segment_sum_slotwise(idx2d, g)
        lr = 0.05
        t_k, a_k = table0.clone(), acc0.clone()
        table_update.table_update_kernel(t_k, a_k, rows, seg, lr)
        t_p, a_p = table0.clone(), acc0.clone()
        table_update.table_update_plain(t_p, a_p, rows, seg, lr)
        torch.cuda.synchronize()
        touched = torch.zeros(total, dtype=torch.bool, device=dev)
        touched[rows[is_end].long()] = True
        changed = (t_k != table0).any(1) | (a_k != acc0).any(1)
        untouched_exact = not bool((changed & ~touched).any())
        te, _, _ = max_err(t_k, t_p)
        ae, _, _ = max_err(a_k, a_p)
        unique = int(is_end.sum())
        highest = int(rows.max().item())
        ok = (untouched_exact and te == 0.0 and ae == 0.0
              and (not top_rows or (highest == total - 1 and bool(changed[-1]))))
        emit({"phase": "kernels", "kernel": "table_update", "indices": kind,
              "table_rows": total, "positions": rows.numel(), "touched_rows": unique,
              "highest_row_touched": highest,
              "table_max_abs_err": te, "acc_max_abs_err": ae,
              "untouched_rows_bit_exact": untouched_exact, "ok": ok})
        if not ok:
            raise SystemExit(f"table_update ({kind}, {total} rows) disagrees with its "
                             "plain version")
        if kind == "uniform":
            check_row_offset_halves(table0, acc0, rows, seg, lr, t_k, a_k)
            r_end = rows[is_end].long()
            d = seg[is_end]
            sq = d * d
            delta = -(lr * d) / (torch.sqrt(acc0.index_select(0, r_end) + sq) + 1e-2)

            def lib_update():
                a_k.index_add_(0, r_end, sq)
                t_k.index_add_(0, r_end, delta)

            nbytes = rows.numel() * (4 + 64) + unique * 4 * 64
            rows_out[name] = kernel_row(
                name, "nasrec_tpu_torch/csrc/table_update.cu",
                "nasrec_tpu/ops/kernels/table_sweep_pallas.py:430", max(te, ae),
                lambda: table_update.table_update_kernel(t_k, a_k, rows, seg, lr),
                lambda: table_update.table_update_plain(t_p, a_p, rows, seg, lr),
                lib_update, nbytes, 6 * 16 * unique, hbm, cold=True)
        del t_k, a_k, t_p, a_p, touched, changed, idx2d, g, rows, seg, is_end
        torch.cuda.empty_cache()
    del table0, acc0
    torch.cuda.empty_cache()


def check_row_offset_halves(table0, acc0, rows, seg, lr, t_whole, a_whole) -> None:
    """Phase 10c, the sharded table update: two launches of the kernel on the
    two halves of the table (row_offset 0 and rows/2, positions of the other
    half skipped), as the model ranks of a mesh launch it, must give the
    whole-table launch's bits (`t_whole`, `a_whole`, already checked against
    the plain version).  The counterpart of tests/test_table_sweep.py ::
    test_sweep_row_offset_shards_reproduce_full_table."""
    import torch

    from nasrec_tpu_torch.ops.kernels import table_update

    half = table0.shape[0] // 2
    t_h, a_h = table0.clone(), acc0.clone()
    for lo, hi in ((0, half), (half, table0.shape[0])):
        table_update.table_update_kernel(t_h[lo:hi], a_h[lo:hi], rows, seg, lr, row_offset=lo)
    exact = torch.equal(t_h, t_whole) and torch.equal(a_h, a_whole)
    emit({"phase": "kernels", "kernel": "table_update", "check": "row_offset_halves",
          "table_rows": int(table0.shape[0]), "row_offsets": [0, half],
          "bit_exact_vs_whole_table": exact, "ok": exact})
    if not exact:
        raise SystemExit("the table update on two row_offset halves differs from the "
                         "whole-table launch")
    del t_h, a_h


SEGSUM_SOURCE = "nasrec_tpu_torch/csrc/segment_sum.cu"
# No Pallas kernel: the JAX package's segment-sum is XLA's cumsum and cummax.
SEGSUM_REPLACES = "nasrec_tpu/train/sparse_embedding.py:82 (XLA cumsum, cummax)"


def check_segment_sum(vocab, hbm, gen, rows_out, batch=BATCH, name="segment_sum",
                      candidates=1) -> None:
    """The segment-sum kernel on a batch of uniform indices over the fused
    table of `vocab` (`candidates` stacked tables: the search's whole-net
    group lays candidate k's rows of slot s in column (k, s)) against its
    plain version, the PyTorch composite it replaced: rows and is_end equal,
    seg exactly zero off the run ends and there within 2^-20 of each run's
    sum of |g| from the float64 sums, two launches with the same bits.  The
    row `name` times it; plain_ms and library_ms are both the composite."""
    import numpy as np
    import torch

    from nasrec_tpu_torch.models.embedding import table_offsets
    from nasrec_tpu_torch.ops.kernels import segment_sum

    dev = torch.device(DEVICE)
    total = int(sum(vocab))
    idx = draw_indices(np.random.RandomState(0), batch, vocab, "uniform").astype(np.int64)
    idx = idx + np.asarray(table_offsets(vocab))
    idx = np.concatenate([idx + k * total for k in range(candidates)], axis=1)
    idx2d = torch.as_tensor(idx.astype(np.int32), device=dev)
    g = 0.01 * torch.randn(idx2d.numel(), 16, device=dev, generator=gen)
    rows, seg, is_end = segment_sum.segment_sum_kernel(idx2d, g)
    again = segment_sum.segment_sum_kernel(idx2d, g)
    p_rows, p_seg, p_end = segment_sum.segment_sum_plain(idx2d, g)
    torch.cuda.synchronize()
    # float64 sums of each run, in position order.
    b, c = idx2d.shape
    _, order = torch.sort(idx2d.t(), dim=1, stable=True)
    flat = torch.take_along_dim(g.double().reshape(b, c, 16).transpose(0, 1),
                                order[:, :, None], dim=1).reshape(-1, 16)
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), is_end[:-1]])
    run = start.cumsum(0) - 1
    sums = torch.zeros(int(is_end.sum()), 16, dtype=torch.float64, device=dev)
    abs_sums = torch.zeros_like(sums).index_add_(0, run, flat.abs())
    sums.index_add_(0, run, flat)
    err = (seg[is_end].double() - sums).abs()
    plain_err = (p_seg[p_end].double() - sums).abs().max().item()
    off = seg[~is_end]
    repeat = all(torch.equal(a, w) for a, w in zip((rows, seg, is_end), again))
    ok = (torch.equal(rows, p_rows) and torch.equal(is_end, p_end) and repeat
          and bool((off == 0).all()) and not bool(torch.signbit(off).any())
          and bool((err <= 2.0 ** -20 * abs_sums).all()))
    emit({"phase": "kernels", "kernel": "segment_sum", "row": name, "batch": b, "columns": c,
          "runs": int(is_end.sum()), "longest_run": int(torch.bincount(run).max()),
          "max_abs_err_vs_float64": err.max().item(),
          "plain_max_abs_err_vs_float64": plain_err,
          "max_err_over_run_abs_sum": (err / abs_sums.clamp(min=1e-30)).max().item(),
          "bit_exact_repeat": repeat, "ok": ok})
    if not ok:
        raise SystemExit(f"segment_sum ({b} x {c}) disagrees with its plain version or the "
                         "float64 sums")
    # Bytes: g, order (int64) and the sorted rows read, seg and is_end written.
    nbytes = b * c * (64 + 8 + 4 + 64 + 1)
    rows_out[name] = kernel_row(
        name, SEGSUM_SOURCE, SEGSUM_REPLACES, err.max().item(),
        lambda: segment_sum.segment_sum_kernel(idx2d, g),
        lambda: segment_sum.segment_sum_plain(idx2d, g),
        lambda: segment_sum.segment_sum_plain(idx2d, g), nbytes, 16 * b * c, hbm,
        heavy=True, cold=True)
    del idx2d, g, rows, seg, is_end, again, p_rows, p_seg, p_end, flat, sums, abs_sums
    torch.cuda.empty_cache()


LIST_SOURCE = "nasrec_tpu_torch/csrc/dense_adagrad.cu"
# No Pallas kernel: the JAX package's clip and dense Adagrad are XLA's.
LIST_REPLACES = "nasrec_tpu/train/optim.py (XLA clip_by_global_norm, adagrad_update)"


def check_dense_adagrad(hbm, rows_out, max_norm=5.0, lr=0.16, eps=1e-2) -> None:
    """The list kernels on one criteo-kaggle/xlarge sparse step's own lists at
    batch 32768 and full vocab, caught at the step's clip: its 86 dense
    gradients (2,217,268 floats) and the table's summed gradient [B * 26, 16]
    for the norm, the dense parameters and their accumulators after the step
    for the update.  Against the plain versions: the scale within 2 ulps;
    given the kernel's scale, parameters and accumulators bit for bit; equal
    bits from two launches.  Rows "clip_scale" and "adagrad": `ms` times the
    launches alone on a pointer table packed once, `wrapper_ms` the calls
    through the wrapper, which checks and packs the table on the host at
    every call; their library calls the torch._foreach_* form
    (clip_grad_norm_'s norm, Adagrad's update)."""
    import numpy as np
    import torch

    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.models.fixed import fixed_init
    from nasrec_tpu_torch.ops.kernels import build, dense_adagrad
    from nasrec_tpu_torch.train import sparse_embedding
    from nasrec_tpu_torch.train.loop import TABLE
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    dev = torch.device(DEVICE)
    vocab = DATASETS["criteo-kaggle"].vocab_sizes(VOCAB_CAP)
    model = fixed_init(best_plan(XL, vocab), seed=0, device=dev)
    state = init_sparse_train_state(model)
    caught = []
    clip_scale = sparse_embedding.clip_scale

    def catching(grads, norm, extra=None, impl="auto"):
        caught.append((list(grads), extra))
        return clip_scale(grads, norm, extra, impl)

    sparse_embedding.clip_scale = catching       # the step's own lists
    try:
        step = make_sparse_embedding_train_step(lambda s: lr, grad_clip=max_norm)
        step(state, *device_batches(np.random.RandomState(12), 1, BATCH, vocab)[0])
    finally:
        sparse_embedding.clip_scale = clip_scale
    (grads, seg), = caught
    names = [n for n, _ in model.named_parameters() if n != TABLE]
    params = [p.detach() for n, p in model.named_parameters() if n != TABLE]
    accs = [state.opt_state[n] for n in names]
    del state, step
    scale = dense_adagrad.clip_scale(grads, max_norm, seg)
    again = dense_adagrad.clip_scale(grads, max_norm, seg)
    want = dense_adagrad.clip_scale(grads, max_norm, seg, impl="plain")
    ulps = abs(int(scale.view(torch.int32)) - int(want.view(torch.int32)))
    outs = []
    for impl in ("auto", "auto", "plain"):
        p, a = [x.clone() for x in params], [x.clone() for x in accs]
        dense_adagrad.adagrad_(p, a, grads, lr, eps, scale, impl)
        outs.append(p + a)
    same = [all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(o, outs[0]))
            for o in outs[1:]]
    n_dense, n_seg = sum(g.numel() for g in grads), seg.numel()
    ok = (ulps <= 2 and torch.equal(scale.view(torch.int32), again.view(torch.int32))
          and all(same) and len(grads) == len(params))
    emit({"phase": "kernels", "kernel": "dense_adagrad", "arch": XL, "batch": BATCH,
          "tensors": len(grads), "dense_floats": n_dense, "seg_shape": list(seg.shape),
          "scale": float(scale), "scale_plain": float(want), "scale_ulps": ulps,
          "bit_exact_repeat": same[0], "bit_exact_vs_plain": same[1], "ok": ok})
    if not ok:
        raise SystemExit("dense_adagrad disagrees with its plain version (see its 'kernels' "
                         "line)")
    lists = grads + [seg]
    p_l, a_l = [x.clone() for x in params], [x.clone() for x in accs]

    def lib_norm():
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(lists)))
        return torch.clamp(max_norm / (norm + 1e-6), max=1.0)

    def lib_update():
        gs = torch._foreach_mul(grads, scale)
        torch._foreach_addcmul_(a_l, gs, gs)
        den = torch._foreach_sqrt(a_l)
        torch._foreach_add_(den, eps)
        torch._foreach_addcdiv_(p_l, gs, den, value=-lr)

    p_k, a_k = [x.clone() for x in params], [x.clone() for x in accs]
    p_p, a_p = [x.clone() for x in params], [x.clone() for x in accs]
    # The launches alone: each pointer table packed once, as the wrapper
    # packs it (dense_adagrad._table).
    lib = build.load_library("dense_adagrad")
    c_ptrs, c_sizes = dense_adagrad._table([lists], "gradient", seg.device)
    u_ptrs, u_sizes = dense_adagrad._table([p_k, a_k, grads], "tensor", seg.device)
    chunks = int(((c_sizes + dense_adagrad.CHUNK - 1) // dense_adagrad.CHUNK).sum())
    partials = torch.empty(chunks, dtype=torch.float64, device=dev)
    c_out = torch.empty((), dtype=torch.float32, device=dev)

    def clip_launch():
        build.check(lib.nasrec_dense_clip_scale(
            c_ptrs.ctypes.data, c_sizes.ctypes.data, len(lists), partials.data_ptr(), chunks,
            float(max_norm), c_out.data_ptr(), build.current_stream()), "dense_adagrad clip_scale")

    def update_launch():
        build.check(lib.nasrec_dense_adagrad(
            u_ptrs.ctypes.data, u_sizes.ctypes.data, len(grads), scale.data_ptr(), float(lr),
            float(eps), build.current_stream()), "dense_adagrad")

    clip_launch()
    if not torch.equal(c_out.view(torch.int32), scale.view(torch.int32)):
        raise SystemExit("dense_adagrad's launch alone gives another scale than its wrapper")
    # Bytes: the norm reads every gradient and seg; the update reads p, a and
    # g and writes p and a.
    rows_out["clip_scale"] = kernel_row(
        "clip_scale", LIST_SOURCE, LIST_REPLACES, abs(float(scale) - float(want)), clip_launch,
        lambda: dense_adagrad.clip_scale(grads, max_norm, seg, impl="plain"),
        lib_norm, 4 * (n_dense + n_seg), 2 * (n_dense + n_seg), hbm)
    rows_out["clip_scale"]["wrapper_ms"] = cuda_ms(
        lambda: dense_adagrad.clip_scale(grads, max_norm, seg))
    rows_out["adagrad"] = kernel_row(
        "adagrad", LIST_SOURCE, LIST_REPLACES, 0.0, update_launch,
        lambda: dense_adagrad.adagrad_(p_p, a_p, grads, lr, eps, scale, impl="plain"),
        lib_update, 4 * 5 * n_dense, 8 * n_dense, hbm)
    rows_out["adagrad"]["wrapper_ms"] = cuda_ms(
        lambda: dense_adagrad.adagrad_(p_k, a_k, grads, lr, eps, scale))
    del model, params, accs, grads, seg, lists, outs, p_l, a_l, p_k, a_k, p_p, a_p, caught
    del partials, c_out
    torch.cuda.empty_cache()


def phase_kernels(hbm):
    """Each kernel against its plain version at the main paths' shapes."""
    import torch

    from nasrec_tpu_torch.config import DATASETS

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows_out = {}
    for slots in BODY_SLOTS:
        check_transformer_body(slots, hbm, gen, rows_out)
        check_attention(slots, hbm, gen, rows_out)
    check_fused_against_unfused(gen)
    for n in (46, 17, 40, 9, 33):
        check_dot_scores(n, hbm, gen, rows_out)
    # bf16 compute (phases 3d and 11): the body and the attention core at
    # S = 64, 48 and 16, the dot-product at n = 40, 9 (xlarge), 46, 17
    # (autoctr) and 33 (avazu/autoctr).
    for slots in BODY_SLOTS:
        check_transformer_body(slots, hbm, gen, rows_out, dtype="bfloat16")
        check_attention(slots, hbm, gen, rows_out, dtype="bfloat16")
    for n in (40, 9, 46, 17, 33):
        check_dot_scores(n, hbm, gen, rows_out, dtype="bfloat16")
    spec = DATASETS["criteo-kaggle"]
    check_table_update(spec.vocab_sizes(VOCAB_CAP), hbm, gen, rows_out)
    check_segment_sum(spec.vocab_sizes(VOCAB_CAP), hbm, gen, rows_out)
    check_dense_adagrad(hbm, rows_out)
    # Phase 11's tables: every slot's rows of avazu and kdd, the batch's
    # positions uniform over them, the highest rows among them; the
    # segment-sum over their slots.
    for dataset in DS_DATASETS:
        check_table_update(DATASETS[dataset].vocab_sizes(VOCAB_CAP), hbm, gen, rows_out,
                           name=table_row(dataset), kinds=("uniform",), top_rows=True)
        check_segment_sum(DATASETS[dataset].vocab_sizes(VOCAB_CAP), hbm, gen, rows_out,
                          name=segsum_row(table_row(dataset)))

    # The supernet's shapes: every block's transformer body at S = 64 and its
    # dot-product at n = 46, batch SN_BATCH in training (rows "_b512") and
    # SN_EVAL_BATCH in the eval forward ("_b4096"); the segment-sum and the
    # table update over the search-capped table.
    tr, ev = f"_b{SN_BATCH}", f"_b{SN_EVAL_BATCH}"
    # The search's shapes: a group's folded launches at 8 x 512 rows (a
    # fine-tune step, "_b4096") and 8 x 1024 (an eval chunk, "_b8192"); one
    # candidate's eval chunk (the one-at-a-time whole-net form, "_b1024");
    # the whole-net group's K-candidate body, 8 candidates of 512 rows in
    # training and of 1024 in an eval chunk; the table update over its 8
    # stacked tables.
    ch, st, sc = f"_b{SEARCH_CHUNK}", f"_b{SEARCH_STEP_ROWS}", f"_b{SEARCH_CHUNK_ROWS}"
    assert st == ev
    check_transformer_body(64, hbm, gen, rows_out, SN_BATCH, tr, ("fwd_train", "bwd"), True)
    check_transformer_body(64, hbm, gen, rows_out, SN_EVAL_BATCH, ev, ("fwd",), True)
    check_transformer_body(64, hbm, gen, rows_out, SEARCH_CHUNK, ch, ("fwd",), True)
    check_transformer_body(64, hbm, gen, rows_out, SEARCH_CHUNK_ROWS, sc, ("fwd",), True)
    check_transformer_body_k(hbm, gen, rows_out, SN_BATCH, ("fwd_train", "bwd"))
    check_transformer_body_k(hbm, gen, rows_out, SEARCH_CHUNK, ("fwd",))
    # The K-candidate body in bf16 (the evaluator is float32) and attention's
    # K-candidate form (the search's transformer nodes run fused): no search
    # runs them, so they are held and timed here and kept off the kernels
    # line.
    off_path = {}
    check_transformer_body_k(hbm, gen, off_path, SN_BATCH, ("fwd_train", "bwd"), "bfloat16")
    check_transformer_body_k(hbm, gen, off_path, SEARCH_CHUNK, ("fwd",), "bfloat16")
    check_attention_k(hbm, gen, off_path, SN_BATCH)
    emit({"phase": "kernels", "held_off_the_main_paths": list(off_path.values())})
    check_dot_scores(46, hbm, gen, rows_out, SN_BATCH, tr)
    check_dot_scores(46, hbm, gen, rows_out, SN_EVAL_BATCH, ev)
    check_dot_scores(46, hbm, gen, rows_out, SEARCH_CHUNK, ch, ("fwd",))
    check_dot_scores(46, hbm, gen, rows_out, SEARCH_CHUNK_ROWS, sc, ("fwd",))
    check_table_update(spec.vocab_sizes(SN_VOCAB_CAP), hbm, gen, rows_out, SN_BATCH,
                       f"table_update{tr}")
    check_table_update(spec.vocab_sizes(SN_VOCAB_CAP) * SEARCH_GROUP, hbm, gen, rows_out,
                       SN_BATCH, f"table_update_k{SEARCH_GROUP}{tr}", kinds=("uniform",))
    check_segment_sum(spec.vocab_sizes(SN_VOCAB_CAP), hbm, gen, rows_out, SN_BATCH,
                      f"segment_sum{tr}")
    check_segment_sum(spec.vocab_sizes(SN_VOCAB_CAP), hbm, gen, rows_out, SN_BATCH,
                      f"segment_sum_k{SEARCH_GROUP}{tr}", SEARCH_GROUP)
    _l2_scratch.clear()      # the main paths' peak memory is read without it
    torch.cuda.empty_cache()
    return rows_out


def best_plan(arch, vocab):
    """The 7-block plan of a published best arch, "<dataset>/<space>"."""
    from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
    from nasrec_tpu_torch.configs import get_best_arch
    from nasrec_tpu_torch.models.fixed import build_fixed_plan

    dataset, space = arch.split("/")
    spec = DATASETS[dataset]
    return build_fixed_plan(get_best_arch(dataset, space), OPS_CONFIG_LIB[space], 7,
                            spec.num_dense, spec.num_sparse, vocab)


def device_batches(rng, n, batch, vocab, num_dense=13):
    """n phase-3 batches on the card: N(0,1) dense, uniform indices, 0/1 labels."""
    import numpy as np
    import torch

    dev = torch.device(DEVICE)
    return [(torch.as_tensor(rng.randn(batch, num_dense).astype(np.float32), device=dev),
             torch.as_tensor(draw_indices(rng, batch, vocab, "uniform"), device=dev),
             torch.as_tensor(rng.randint(0, 2, size=(batch, 1)).astype(np.float32), device=dev))
            for _ in range(n)]


def run_steps(step, state, batches):
    """Each batch through `step`: (losses, seconds a step, last metrics)."""
    import torch

    losses, times = [], []
    for batch in batches:
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        state, m = step(state, *batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - s0)
        losses.append(float(m["loss"]))
    return losses, times, m


def state_diff(model_a, model_b) -> float:
    sd_a, sd_b = model_a.state_dict(), model_b.state_dict()
    return max((sd_a[k] - sd_b[k]).abs().max().item() for k in sd_a)


def table_row(dataset: str) -> str:
    """The row of the table update over a dataset's full-vocab table (each
    dataset's table is a shape of its own)."""
    return "table_update" if dataset == "criteo-kaggle" else f"table_update_{dataset}"


def segsum_row(table: str) -> str:
    """The segment-sum's row beside the table update's row `table`: the same
    batch over the same slots."""
    return table.replace("table_update", "segment_sum", 1)


def add_launches(rows_out, launches: dict, dataset: str = "criteo-kaggle") -> None:
    """Launches at batch 32768 counted in the rows of the same kernel and
    shape (the table update's and the segment-sum's in the rows of the
    dataset's table; the list clip's and update's, whatever the list, in
    their one row each, checked on the xlarge step's lists)."""
    for name, count in launches.items():
        if name == "table_update":
            name = table_row(dataset)
        elif name == "segment_sum":
            name = segsum_row(table_row(dataset))
        rows_out[name]["launches"] = rows_out[name].get("launches", 0) + count


def phase_main(arch, rows_out, phase="main"):
    """One main path at full width: <arch> ("<dataset>/<space>", a published
    best arch) at the full vocab of its dataset, kernel run (counted) against
    plain run, then one eval forward of each; for an arch with transformer
    nodes also a short run with the nodes unfused.  Returns the step's ms."""
    import numpy as np
    import torch

    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.models.fixed import fixed_init
    from nasrec_tpu_torch.ops.attention import Transformer
    from nasrec_tpu_torch.train.loop import make_eval_step
    from nasrec_tpu_torch.train.optim import make_lr_schedule
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    dev = torch.device(DEVICE)
    steps = STEPS.get(arch, DS_STEPS)
    spec = DATASETS[arch.split("/")[0]]
    vocab = spec.vocab_sizes(VOCAB_CAP)
    plan = best_plan(arch, vocab)
    t0 = time.perf_counter()
    model_k = fixed_init(plan, seed=0, device=dev)
    model_p = copy.deepcopy(model_k)
    model_u = copy.deepcopy(model_k) if ARCH_SHAPES[arch][1] else None
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batches = device_batches(np.random.RandomState(0), steps, BATCH, vocab, spec.num_dense)
    sched = make_lr_schedule("cosine", 0.16, 10_000, 1_000)

    def run(model, impl, n):
        state = init_sparse_train_state(model)
        step = make_sparse_embedding_train_step(sched, grad_clip=5.0, impl=impl)
        losses, times = [], []
        for d, c, y in batches[:n]:
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            state, m = step(state, d, c, y)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
            losses.append(float(m["loss"]))
        return losses, times, m["logits"], lambda: step(state, *batches[0])

    def evaluate(model, impl):
        with torch.no_grad():
            return make_eval_step(impl)(model, *batches[0][:2])

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses_k, times_k, logits_k, more_k = run(model_k, "auto", steps)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reset_launches()
    eval_k = evaluate(model_k, "auto")
    eval_launches = read_launches()
    torch.cuda.reset_peak_memory_stats()
    losses_p, times_p, logits_p, _ = run(model_p, "plain", steps)
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eval_p = evaluate(model_p, "plain")

    param_diff = state_diff(model_k, model_p)
    loss_diff = max(abs(a - b) for a, b in zip(losses_k, losses_p))
    logit_diff = (logits_k - logits_p).abs().max().item()
    eval_diff = (eval_k - eval_p).abs().max().item()
    step_ms = float(np.median(times_k[1:])) * 1e3
    plain_step_ms = float(np.median(times_p[1:])) * 1e3
    ok = (all(math.isfinite(x) for x in losses_k + losses_p)
          and tuple(eval_k.shape) == (BATCH, 1) and bool(torch.isfinite(eval_k).all())
          and loss_diff <= LOSS_TOL and logit_diff <= LOGIT_TOL and param_diff <= PARAM_TOL
          and eval_diff <= LOGIT_TOL
          and launches == {k: steps for k in TRAIN_STEP_KERNELS[arch]}
          and eval_launches == {k: 1 for k in EVAL_KERNELS[arch]})
    emit({"phase": phase, "arch": arch, "vocab_rows": int(sum(vocab)),
          "batch": BATCH, "steps": steps, "init_s": init_s, "losses": losses_k,
          "losses_plain": losses_p, "max_loss_diff": loss_diff,
          "max_logit_diff": logit_diff, "max_param_diff": param_diff,
          "max_eval_logit_diff": eval_diff,
          "step_ms": step_ms, "examples_per_s": BATCH / step_ms * 1e3,
          "step_ms_all": [x * 1e3 for x in times_k], "plain_step_ms": plain_step_ms,
          "peak_mem_gb": peak_gb, "plain_peak_mem_gb": plain_peak_gb,
          "plain_run": "whole batches", "launches": launches,
          "eval_launches": eval_launches, "ok": ok})
    if not ok:
        raise SystemExit(f"main path {arch} failed (see its '{phase}' line)")
    del model_p
    add_launches(rows_out, launches, spec.name)
    add_launches(rows_out, eval_launches, spec.name)

    if model_u is not None:
        # The same first steps with every transformer node in its unfused
        # form, which runs the attention kernel in the body kernels' place.
        for node in model_u.modules():
            if isinstance(node, Transformer):
                node.fused = False
        reset_launches()
        losses_u, times_u, _, _ = run(model_u, "auto", UNFUSED_STEPS)
        unfused = read_launches()
        diff_u = max(abs(a - b) for a, b in zip(losses_u, losses_k))
        ok = (diff_u <= LOSS_TOL
              and unfused == {k: UNFUSED_STEPS for k in UNFUSED_STEP_KERNELS[arch]})
        emit({"phase": phase, "arch": arch, "form": "unfused",
              "steps": UNFUSED_STEPS, "losses": losses_u, "max_loss_diff_vs_fused": diff_u,
              "step_ms_all": [x * 1e3 for x in times_u], "launches": unfused, "ok": ok})
        if not ok:
            raise SystemExit(f"main path {arch} with unfused transformer nodes failed")
        add_launches(rows_out, {k: v for k, v in unfused.items()
                                if k.startswith("tiny_head_attention")})
        del model_u

    profile_steps(arch, more_k, 3)
    del model_k, batches, more_k
    torch.cuda.empty_cache()
    return step_ms


def lockstep(step_k, state_k, step_p, state_p, batches, masks=None) -> dict:
    """Each batch through the kernel path's step (timed, its launches counted)
    and through the plain path's step from the kernel path's state before it,
    so that every comparison is of one step from one state (the bf16
    tolerances above).  Returns the losses, the kernel steps' seconds and
    launches, the plain steps' launches, the kernel steps' peak device memory
    (each read from a reset before it, so the comparison's temporaries do not
    count), and the largest differences: loss
    and logits relative to the loss and to the largest logit, parameters
    absolute, optimizer slots relative to the slot's largest element (or 1):
    an Adagrad accumulator sums squared gradients and reaches the hundreds."""
    import torch

    from nasrec_tpu_torch.train.optim import copy_state_, slot_dicts

    out = {"losses": [], "losses_plain": [], "seconds": [], "launches": [],
           "plain_launches": [], "loss_rel": 0.0, "logit_rel": 0.0, "param": 0.0, "slot": 0.0,
           "peak_gb": 0.0}
    for i, batch in enumerate(batches):
        extra = () if masks is None else (masks[i],)
        state_p.model.load_state_dict(state_k.model.state_dict())
        copy_state_(state_p.opt_state, state_k.opt_state)
        state_p.step = state_k.step
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s0 = time.perf_counter()
        state_k, mk = step_k(state_k, *batch, *extra)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - s0)
        out["peak_gb"] = max(out["peak_gb"], torch.cuda.max_memory_allocated() / 1e9)
        out["launches"].append(read_launches())
        reset_launches()
        state_p, mp = step_p(state_p, *batch, *extra)
        out["plain_launches"].append(read_launches())
        lk, lp = float(mk["loss"]), float(mp["loss"])
        out["losses"].append(lk)
        out["losses_plain"].append(lp)
        out["loss_rel"] = max(out["loss_rel"], abs(lk - lp) / max(abs(lp), 1e-30))
        scale = max(mp["logits"].abs().max().item(), 1.0)
        out["logit_rel"] = max(out["logit_rel"],
                               (mk["logits"] - mp["logits"]).abs().max().item() / scale)
        out["param"] = max(out["param"], state_diff(state_k.model, state_p.model))
        out["slot"] = max([out["slot"]] + [
            (a[k] - b[k]).abs().max().item() / max(b[k].abs().max().item(), 1.0)
            for a, b in zip(slot_dicts(state_k.opt_state), slot_dicts(state_p.opt_state))
            for k in a])
    out["logits"] = mk["logits"]
    return out


def lockstep_ok(res) -> bool:
    return (all(math.isfinite(x) for x in res["losses"] + res["losses_plain"])
            and res["loss_rel"] <= BF16_LOSS_TOL and res["logit_rel"] <= BF16_LOGIT_TOL
            and res["param"] <= PARAM_TOL and res["slot"] <= BF16_SLOT_TOL
            and not any(res["plain_launches"]))


def phase_amp(arch, rows_out, f32_step_ms: float, phase="amp") -> float:
    """Phase 3d: phase 3's main path with compute_dtype bfloat16 (the AMP leg):
    AMP_STEPS sparse steps of <arch> at full vocab and batch 32768 through the
    kernels, counted a step (the body and dot-product kernels in bf16, the
    segment-sum and the table update in f32), each against the plain versions
    from the same state,
    and an eval forward of each; for an arch with transformer nodes 2 more
    steps with the nodes unfused (the attention kernel in bf16); a profile
    line.  Returns the step's ms."""
    import numpy as np
    import torch

    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.models.fixed import fixed_init
    from nasrec_tpu_torch.ops.attention import Transformer
    from nasrec_tpu_torch.train.loop import make_eval_step
    from nasrec_tpu_torch.train.optim import make_lr_schedule
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    dev, bf = torch.device(DEVICE), torch.bfloat16
    steps = AMP_STEPS.get(arch, DS_STEPS)
    spec = DATASETS[arch.split("/")[0]]
    vocab = spec.vocab_sizes(VOCAB_CAP)
    model_k = fixed_init(best_plan(arch, vocab), seed=0, device=dev)
    model_p = copy.deepcopy(model_k)
    model_u = copy.deepcopy(model_k) if ARCH_SHAPES[arch][1] else None
    batches = device_batches(np.random.RandomState(0), steps, BATCH, vocab, spec.num_dense)
    sched = make_lr_schedule("cosine", 0.16, 10_000, 1_000)

    def make(impl):
        return make_sparse_embedding_train_step(sched, grad_clip=5.0, impl=impl,
                                                compute_dtype=bf)

    step_k, state_k = make("auto"), init_sparse_train_state(model_k)
    state_p = init_sparse_train_state(model_p)
    res = lockstep(step_k, state_k, make("plain"), state_p, batches)
    peak_gb = res["peak_gb"]
    reset_launches()
    eval_k = make_eval_step("auto", compute_dtype=bf)(model_k, *batches[0][:2])
    eval_launches = read_launches()
    model_p.load_state_dict(model_k.state_dict())
    eval_p = make_eval_step("plain", compute_dtype=bf)(model_p, *batches[0][:2])
    eval_rel = (eval_k - eval_p).abs().max().item() / max(eval_p.abs().max().item(), 1.0)
    del model_p, state_p
    step_ms = float(np.median(res["seconds"][1:])) * 1e3
    per_step = bf16_named({k: 1 for k in TRAIN_STEP_KERNELS[arch]})
    ok = (lockstep_ok(res) and eval_k.dtype == res["logits"].dtype == torch.float32
          and tuple(eval_k.shape) == (BATCH, 1) and bool(torch.isfinite(eval_k).all())
          and eval_rel <= BF16_LOGIT_TOL
          and all(p.dtype == torch.float32 for p in model_k.parameters())
          and all(c == per_step for c in res["launches"])
          and eval_launches == bf16_named({k: 1 for k in EVAL_KERNELS[arch]}))
    emit({"phase": phase, "arch": arch, "compute_dtype": "bfloat16",
          "vocab_rows": int(sum(vocab)), "batch": BATCH, "steps": steps,
          "losses": res["losses"], "losses_plain_from_the_same_state": res["losses_plain"],
          "max_loss_rel_diff": res["loss_rel"], "max_logit_rel_diff": res["logit_rel"],
          "max_param_diff": res["param"], "max_accumulator_rel_diff": res["slot"],
          "max_eval_logit_rel_diff": eval_rel,
          "step_ms": step_ms, "examples_per_s": BATCH / step_ms * 1e3,
          "step_ms_all": [x * 1e3 for x in res["seconds"]], "f32_step_ms": f32_step_ms,
          "over_f32_step": step_ms / f32_step_ms, "peak_mem_gb": peak_gb,
          "launches_per_step": res["launches"][0], "eval_launches": eval_launches, "ok": ok})
    if not ok:
        raise SystemExit(f"bf16 main path {arch} failed (see its '{phase}' line)")
    add_launches(rows_out, {k: v * steps for k, v in res["launches"][0].items()}, spec.name)
    add_launches(rows_out, eval_launches, spec.name)

    if model_u is not None:
        # The first steps again with every transformer node unfused: op by op
        # in bf16 around the attention kernel, from the same initial weights.
        for node in model_u.modules():
            if isinstance(node, Transformer):
                node.fused = False
        state_u = init_sparse_train_state(model_u)
        reset_launches()
        losses_u, times_u, _ = run_steps(make("auto"), state_u, batches[:AMP_UNFUSED_STEPS])
        unfused = read_launches()
        diff_u = max(abs(a - b) / abs(b) for a, b in zip(losses_u, res["losses"]))
        ok = (diff_u <= AMP_UNFUSED_LOSS_TOL
              and unfused == bf16_named({k: AMP_UNFUSED_STEPS
                                         for k in UNFUSED_STEP_KERNELS[arch]}))
        emit({"phase": phase, "arch": arch, "form": "unfused",
              "steps": AMP_UNFUSED_STEPS, "losses": losses_u,
              "max_loss_rel_diff_vs_fused": diff_u,
              "step_ms_all": [x * 1e3 for x in times_u], "launches": unfused, "ok": ok})
        if not ok:
            raise SystemExit(f"bf16 main path {arch} with unfused transformer nodes failed")
        add_launches(rows_out, {k: v for k, v in unfused.items()
                                if k.startswith("tiny_head_attention")})
        del model_u, state_u

    profile_steps(f"{arch} bf16", lambda: step_k(state_k, *batches[0]), 3)
    del model_k, state_k, batches
    torch.cuda.empty_cache()
    return step_ms


def phase_data(rows_out, tmp: Path, synthetic_step_ms: float):
    """Phase 3a: TSV shards through the C++ parser, the stream, the binary
    cache and the copy to the card; the CLI trained on them; the TSV-fed step
    against the synthetic one; two TSV batches through kernels and plain."""
    import os
    from collections import Counter

    import numpy as np
    import torch

    from nasrec_tpu_torch.cli import main_train
    from nasrec_tpu_torch.data import cache, pipeline, transforms
    from nasrec_tpu_torch.data.native import binding
    from nasrec_tpu_torch.data.synthetic import write_tsv_shards

    t_phase = time.perf_counter()
    root = tmp / "tsv"
    t0 = time.perf_counter()
    write_tsv_shards(str(root), 13, 26, {"trainval": TSV_TRAIN_ROWS, "test": TSV_TEST_ROWS},
                     TSV_SHARDS, seed=0)
    write_s = time.perf_counter() - t0
    transform = transforms.get_transform("criteo-kaggle", VOCAB_CAP)
    train_paths = pipeline.shard_paths(str(root), "trainval")
    text = b"".join(Path(p).read_bytes() for p in train_paths)

    # The C++ parser (built here with g++; a failed build raises) against the
    # NumPy transform on the same lines.
    t0 = time.perf_counter()
    if not binding.native_available():
        raise SystemExit(f"the C++ parser did not build: {binding.build_error()}")
    build_s = time.perf_counter() - t0
    lines = text.split(b"\n", TSV_CHECK_LINES)[:TSV_CHECK_LINES]
    native = binding.parse_ctr_buffer(b"\n".join(lines) + b"\n", 13, 26, transform.vocab,
                                      transform.zero_dense)
    numpy_ = transform([l.decode().split("\t") for l in lines])
    bit_equal = all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(native, numpy_))
    short_rows = sum(1 for l in lines if l.count(b"\t") < 13 + 26)

    def parse_rate(threads):
        best = math.inf
        for _ in range(3):
            s0 = time.perf_counter()
            binding.parse_ctr_buffer(text, 13, 26, transform.vocab, False, threads)
            best = min(best, time.perf_counter() - s0)
        return TSV_TRAIN_ROWS / best

    threads = sorted({1, binding.default_threads(), os.cpu_count() or 1})
    parser_rows_per_s = {str(t): parse_rate(t) for t in threads}

    train_fn, test_fn = pipeline.make_dataset_iterators(
        "criteo-kaggle", str(root), train_batch_size=BATCH, test_batch_size=TSV_TEST_BATCH,
        vocab_cap=VOCAB_CAP, use_native=True)
    t0 = time.perf_counter()
    stream = list(train_fn())
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_sizes = [len(b[2]) for b in test_fn()]
    test_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    prefix = cache.build_binary_cache("criteo-kaggle", str(root), "trainval",
                                      str(tmp / "cache"), vocab_cap=VOCAB_CAP,
                                      use_native=True)
    cache_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cached = list(cache.open_binary_cache(prefix, BATCH, drop_remainder=False))
    cache_read_s = time.perf_counter() - t0
    flat = list(pipeline.batch_iterator(train_paths, BATCH, transform, drop_remainder=False,
                                        interleave=False, use_native=True))
    cache_equal = all(np.array_equal(np.concatenate([b[i] for b in cached]),
                                     np.concatenate([b[i] for b in flat])) for i in range(3))
    # The stream's batches are the cache's rows, shard by shard in turn.
    rows = [np.concatenate([b[i] for b in flat]) for i in range(3)]
    per_shard = TSV_TRAIN_ROWS // TSV_SHARDS
    starts = [(k % TSV_SHARDS) * per_shard + (k // TSV_SHARDS) * BATCH
              for k in range(len(stream))]
    stream_equal = all(np.array_equal(a, r[s0:s0 + BATCH])
                       for batch, s0 in zip(stream, starts) for a, r in zip(batch, rows))
    emit({"phase": "data", "train_rows": TSV_TRAIN_ROWS, "test_rows": TSV_TEST_ROWS,
          "shards": TSV_SHARDS, "text_mb": len(text) / 1e6, "write_s": write_s,
          "parser_build_s": build_s, "parser_library": binding.library_path().name,
          "lines_checked": len(lines), "short_rows_checked": short_rows,
          "native_equal_bits_to_numpy": bit_equal, "host_cpus": os.cpu_count(),
          "parser_rows_per_s_by_threads": parser_rows_per_s,
          "stream_batches": len(stream), "stream_rows_per_s": len(stream) * BATCH / stream_s,
          "test_batch_sizes": test_sizes, "test_stream_rows_per_s": TSV_TEST_ROWS / test_s,
          "cache_build_rows_per_s": TSV_TRAIN_ROWS / cache_build_s,
          "cache_read_rows_per_s": TSV_TRAIN_ROWS / cache_read_s,
          "cache_equal_to_stream": cache_equal, "stream_interleaves_shards": stream_equal})
    if not (bit_equal and short_rows and cache_equal and stream_equal
            and len(stream) == TSV_TRAIN_BATCHES
            and sorted(test_sizes) == sorted([TSV_TEST_BATCH, TSV_TEST_ROWS // TSV_SHARDS
                                              - TSV_TEST_BATCH] * TSV_SHARDS)):
        raise SystemExit("the TSV pipeline failed its checks (see the 'data' line)")
    del stream, cached, flat, text

    # The fixed-subnet CLI on the shards: every training batch, one test pass
    # over both test batches of each shard (the short ones too).
    reset_launches()
    t0 = time.perf_counter()
    out = main_train.main([
        "--arch", "criteo-kaggle/xlarge", "--root_dir", str(root), "--device", DEVICE,
        "--train_batch_size", str(BATCH), "--test_batch_size", str(TSV_TEST_BATCH),
        "--max_train_steps", str(TSV_TRAIN_BATCHES), "--test_only_at_last_step", "1",
        "--learning_rate", "0.02", "--display_interval", "1",
    ])
    cli_s = time.perf_counter() - t0
    cli_launches = read_launches()
    want = Counter({k: TSV_TRAIN_BATCHES for k in TRAIN_STEP_KERNELS[XL]})
    want.update({k: TSV_TEST_BATCHES for k in EVAL_KERNELS[XL]})
    logs = out["logs"][0]
    ok = (len(logs["train_loss"]) == TSV_TRAIN_BATCHES
          and all(math.isfinite(x) for x in logs["train_loss"])
          and len(logs["test_loss"]) == 1 and math.isfinite(logs["test_loss"][0])
          and 0.0 <= logs["test_AUROC"][0] <= 1.0 and cli_launches == dict(want))
    emit({"phase": "data", "cli": "main_train --arch criteo-kaggle/xlarge --root_dir",
          "train_loss": logs["train_loss"], "test_loss": logs["test_loss"],
          "test_auroc": logs["test_AUROC"], "launches": cli_launches, "seconds": cli_s,
          "ok": ok})
    if not ok:
        raise SystemExit("the CLI on TSV shards failed (see the 'data' line)")
    add_launches(rows_out, cli_launches)
    del out
    torch.cuda.empty_cache()

    res = tsv_vs_plain_and_timed(XL, train_fn, TSV_TIMED_STEPS, 2, rows_out, profile=True)
    emit({"phase": "data", **res, "synthetic_step_ms_phase3": synthetic_step_ms,
          "phase_s": time.perf_counter() - t_phase})
    if not res["ok"]:
        raise SystemExit("TSV batches through the kernels failed (see the 'data' line)")


def tsv_vs_plain_and_timed(arch, train_fn, timed_steps: int, warm: int, rows_out,
                           profile: bool = False) -> dict:
    """<arch> at its dataset's full vocab fed from TSV batches (`train_fn`, as
    make_dataset_iterators gives it): two batches through the kernels and
    through the plain versions from the same weights (phase 3's tolerances);
    then, on the kernel path's model, `warm` synthetic and TSV-fed steps in
    turn, and `timed_steps` of each timed with the host's waits for the feed.
    The launches go into rows_out; returns the numbers for the caller's line,
    with "ok"."""
    import itertools

    import numpy as np
    import torch

    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.data import pipeline
    from nasrec_tpu_torch.models.fixed import fixed_init
    from nasrec_tpu_torch.train.optim import make_lr_schedule
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    dev = torch.device(DEVICE)
    spec = DATASETS[arch.split("/")[0]]
    vocab = spec.vocab_sizes(VOCAB_CAP)
    model_k = fixed_init(best_plan(arch, vocab), seed=0, device=dev)
    model_p = copy.deepcopy(model_k)
    sched = make_lr_schedule("cosine", 0.16, 10_000, 1_000)
    step_k = make_sparse_embedding_train_step(sched, grad_clip=5.0)
    step_p = make_sparse_embedding_train_step(sched, grad_clip=5.0, impl="plain")
    two = list(itertools.islice(pipeline.device_prefetch(train_fn(), dev), 2))
    reset_launches()
    state = init_sparse_train_state(model_k)
    losses_k, _, m_k = run_steps(step_k, state, two)
    launches = read_launches()
    losses_p, _, m_p = run_steps(step_p, init_sparse_train_state(model_p), two)
    loss_diff = max(abs(a - b) for a, b in zip(losses_k, losses_p))
    logit_diff = (m_k["logits"] - m_p["logits"]).abs().max().item()
    param_diff = state_diff(model_k, model_p)
    shapes = [tuple(t.shape) for t in two[0]]
    del model_p, two, m_p
    torch.cuda.empty_cache()

    def looped():
        while True:
            yield from train_fn()

    synthetic = device_batches(np.random.RandomState(0), 2 * warm, BATCH, vocab,
                               spec.num_dense)
    feed = pipeline.device_prefetch(looped(), dev)
    reset_launches()
    for i in range(warm):                                 # warm both paths
        state, _ = step_k(state, *synthetic[i])
        state, _ = step_k(state, *next(feed))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(timed_steps):
        state, _ = step_k(state, *synthetic[i % len(synthetic)])
    torch.cuda.synchronize()
    synthetic_ms = (time.perf_counter() - t0) / timed_steps * 1e3
    waits = []
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        w0 = time.perf_counter()
        batch = next(feed)
        waits.append((time.perf_counter() - w0) * 1e3)
        state, _ = step_k(state, *batch)
    torch.cuda.synchronize()
    tsv_ms = (time.perf_counter() - t0) / timed_steps * 1e3
    timed_launches = read_launches()
    kernels = TRAIN_STEP_KERNELS[arch]
    ok = (loss_diff <= LOSS_TOL and logit_diff <= LOGIT_TOL and param_diff <= PARAM_TOL
          and all(math.isfinite(x) for x in losses_k + losses_p)
          and shapes == [(BATCH, spec.num_dense), (BATCH, spec.num_sparse), (BATCH, 1)]
          and launches == {k: 2 for k in kernels}
          and timed_launches == {k: 2 * warm + 2 * timed_steps for k in kernels})
    res = {"arch": arch, "kernel_vs_plain_tsv_batches": 2, "batch_shapes": shapes,
           "losses": losses_k, "losses_plain": losses_p, "max_loss_diff": loss_diff,
           "max_logit_diff": logit_diff, "max_param_diff": param_diff,
           "synthetic_step_ms_unsynced": synthetic_ms, "tsv_step_ms_unsynced": tsv_ms,
           "tsv_over_synthetic": tsv_ms / synthetic_ms, "host_wait_ms_per_step": waits,
           "host_wait_ms_median": float(np.median(waits)),
           "tsv_examples_per_s": BATCH / tsv_ms * 1e3, "launches": launches, "ok": ok}
    if profile:
        prof = profile_steps(f"{arch}, TSV-fed", lambda: step_k(state, *next(feed)), 3)
        res["profiled_busy_share"] = prof["device_busy_share"]
    add_launches(rows_out, launches, spec.name)
    add_launches(rows_out, timed_launches, spec.name)
    del model_k, state, feed, synthetic
    torch.cuda.empty_cache()
    return res


def phase_dense(rows_out, sparse_step_ms: float):
    """Phase 3b: the dense-gradient step of criteo-kaggle/xlarge at full vocab
    and batch 32768 for each of DENSE_SETTINGS: DENSE_STEPS steps through the
    kernels alone, counted and timed, with their peak memory; then the same
    steps through the kernels, each followed by the same step through the
    plain versions from the kernel path's state, compared step by step.
    Adam's steps move each parameter by about lr whatever its gradient's size
    (its first by lr times the gradient's sign), so an element whose gradient
    has opposite signs in the two paths, or is so small that the paths'
    rounding of it moves the step (`adam_edges`), can end a step up to 2 lr
    apart in the two paths.  Such elements that differ by more than PARAM_TOL
    are counted (`sign_edge_elements`); every other element is held to
    PARAM_TOL, and Adam's moments to the gradient tolerance."""
    import numpy as np
    import torch

    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.models.fixed import fixed_init
    from nasrec_tpu_torch.train.loop import init_train_state, make_train_step
    from nasrec_tpu_torch.train.optim import (
        AdamState,
        Optimizer,
        copy_state_,
        make_optimizer,
        slot_dicts,
    )

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    vocab = DATASETS["criteo-kaggle"].vocab_sizes(VOCAB_CAP)
    plan = best_plan(XL, vocab)
    batches = device_batches(np.random.RandomState(2), DENSE_STEPS, BATCH, vocab)

    def recording(opt, log):
        """`opt`, keeping each step's gradients."""
        def update_(state, names, params, grads, lr_now, scale=None, impl="auto"):
            log.append(grads if scale is None else [g * scale for g in grads])
            opt.update_(state, names, params, grads, lr_now, scale, impl)
        return Optimizer(opt.init, update_)

    def adam_edges(g_k, g_p, mu, nu, count, lr):
        """Elements whose Adam step, lr mu_hat / (sqrt(nu_hat) + eps), the
        two paths' gradients set more than PARAM_TOL / 2 apart: gradients of
        opposite signs, or the step's slope in the gradient, |d step / d g|,
        times the gradients' difference above PARAM_TOL / 2 (tiny gradients,
        where sqrt(nu_hat) + eps is small, make the slope steep).  mu, nu: the
        plain path's moments after the step.  The gradients themselves are
        held through the moments, to the gradient tolerance."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        sv = torch.sqrt(nu / c2)
        slope = ((1.0 - b1) / c1 / (sv + eps)
                 + (mu / c1).abs() * (1.0 - b2) / c2 * g_p.abs()
                 / (sv.clamp(min=eps) * (sv + eps) ** 2))
        return (((g_k > 0) != (g_p > 0))
                | (lr * slope * (g_k - g_p).abs() > PARAM_TOL / 2))

    for name, wd, lr in DENSE_SETTINGS:
        def make(impl, log=None):
            model = fixed_init(plan, seed=0, device=dev)
            opt = make_optimizer(name)
            step = make_train_step(opt if log is None else recording(opt, log),
                                   lambda s: lr, l2_reg=wd, grad_clip=5.0, impl=impl)
            return model, init_train_state(model, opt), step

        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model, state, step = make("auto")
        reset_launches()
        _, times, _ = run_steps(step, state, batches)
        launches = read_launches()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        del model, state, step
        torch.cuda.empty_cache()

        # Each step of the plain path starts from the kernel path's state, so
        # that a step's comparison sees that step's rounding alone: an Adam
        # step that moved an element 2 lr apart would otherwise change every
        # later gradient, and Adam's normalised steps carry that on.
        log_k, log_p = [], []
        model_k, state_k, step_k = make("auto", log_k)
        model_p, state_p, step_p = make("plain", log_p)
        names = [n for n, _ in model_k.named_parameters()]
        adam = isinstance(state_k.opt_state, AdamState)
        losses_k, losses_p, times_p = [], [], []
        loss_diff = logit_diff = param_diff = slot_diff = worst_edge = 0.0
        edges, held = 0, True
        reset_launches()
        for batch in batches:
            with torch.no_grad():
                for pk, pp in zip(model_k.parameters(), model_p.parameters()):
                    pp.copy_(pk)
                copy_state_(state_p.opt_state, state_k.opt_state)
            state_k, m_k = step_k(state_k, *batch)
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            state_p, m_p = step_p(state_p, *batch)
            torch.cuda.synchronize()
            times_p.append(time.perf_counter() - s0)
            losses_k.append(float(m_k["loss"]))
            losses_p.append(float(m_p["loss"]))
            loss_diff = max(loss_diff, abs(losses_k[-1] - losses_p[-1]))
            logit_diff = max(logit_diff, (m_k["logits"] - m_p["logits"]).abs().max().item())
            slots_k, slots_p = slot_dicts(state_k.opt_state), slot_dicts(state_p.opt_state)
            for (n, pk), pp, g_k, g_p in zip(model_k.named_parameters(), model_p.parameters(),
                                             log_k.pop(), log_p.pop()):
                d = (pk - pp).detach().abs()
                if adam:
                    edge = adam_edges(g_k, g_p, slots_p[0][n], slots_p[1][n],
                                      int(state_p.opt_state.count), lr)
                    at_edge = (d > PARAM_TOL) & edge
                    edges += int(at_edge.sum())
                    if bool(at_edge.any()):
                        worst_edge = max(worst_edge, d[at_edge].max().item())
                    d = torch.where(edge, 0.0, d)
                param_diff = max(param_diff, d.max().item())
                for k_slot, p_slot in zip(slots_k, slots_p):
                    err, ok_slot = within(k_slot[n], p_slot[n], GRAD_REL_TOL)
                    slot_diff = max(slot_diff, err)
                    held = held and (ok_slot if adam else err <= PARAM_TOL)
        lockstep = read_launches()        # both paths' launches: the kernel path's alone
        step_ms = float(np.median(times[1:])) * 1e3
        plain_step_ms = float(np.median(times_p[1:])) * 1e3
        ok = (all(math.isfinite(x) for x in losses_k + losses_p)
              and loss_diff <= LOSS_TOL and logit_diff <= LOGIT_TOL and param_diff <= PARAM_TOL
              and held and (not adam or int(state_k.opt_state.count) == DENSE_STEPS)
              and launches == lockstep == {k: DENSE_STEPS for k in DENSE_STEP_KERNELS
                                           | DENSE_LIST_UPDATE[name]})
        emit({"phase": "dense", "arch": "criteo-kaggle/xlarge", "optimizer": name, "wd": wd,
              "lr": lr, "vocab_rows": int(sum(vocab)), "batch": BATCH, "steps": DENSE_STEPS,
              "losses": losses_k, "losses_plain": losses_p, "max_loss_diff": loss_diff,
              "max_logit_diff": logit_diff,
              "max_param_diff_outside_sign_edges": param_diff, "max_slot_diff": slot_diff,
              "slots_held_to": "GRAD_REL_TOL" if adam else "PARAM_TOL",
              "sign_edge_elements": edges, "max_param_diff_at_sign_edges": worst_edge,
              "step_ms": step_ms, "step_ms_all": [x * 1e3 for x in times],
              "plain_step_ms": plain_step_ms, "examples_per_s": BATCH / step_ms * 1e3,
              "sparse_step_ms_phase3": sparse_step_ms, "over_sparse_step": step_ms / sparse_step_ms,
              "peak_mem_gb": peak_gb, "launches": launches, "ok": ok})
        if not ok:
            raise SystemExit(f"the dense step with {name} failed (see the 'dense' line)")
        add_launches(rows_out, launches)
        add_launches(rows_out, lockstep)
        del model_k, model_p, state_k, state_p, slots_k, slots_p, m_k, m_p
        torch.cuda.empty_cache()
    emit({"phase": "dense", "phase_s": time.perf_counter() - t_phase})



def phase_dcnv2(hbm: float):
    """Phase 3e: DLRM-DCNv2's step through the kernels against the plain
    versions, then its two 128-wide kernels alone, timed."""
    import dataclasses

    import torch

    from nasrec_tpu_torch.configs.dcnv2 import DCNV2_CRITEO1TB, LEARNING_RATE, row_share
    from nasrec_tpu_torch.models.dcn import dcnv2_init
    from nasrec_tpu_torch.ops.kernels import segment_sum, table_update
    from nasrec_tpu_torch.train.optim import make_optimizer, slot_dicts
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    share = row_share(DCNV2_CRITEO1TB, 4)
    cfg = dataclasses.replace(share, vocab_sizes=tuple(min(v, DCN_VOCAB_CAP)
                                                       for v in share.vocab_sizes))
    gen = torch.Generator(device=dev).manual_seed(5)
    cols = torch.as_tensor([v for v, h in zip(cfg.vocab_sizes, cfg.bag_sizes)
                            for _ in range(h)], device=dev, dtype=torch.float64)
    batches = [(torch.randn(DCN_BATCH, cfg.num_dense, generator=gen, device=dev),
                (torch.rand(DCN_BATCH, cols.numel(), generator=gen, device=dev,
                            dtype=torch.float64) * cols).to(torch.int32),
                (torch.rand(DCN_BATCH, 1, generator=gen, device=dev) < 0.25).float())
               for _ in range(DCN_STEPS)]

    def run(impl):
        model = dcnv2_init(cfg, seed=0, device=dev)
        opt = make_optimizer("adagrad", DCN_EPS)
        state = init_sparse_train_state(model, opt)
        step = make_sparse_embedding_train_step(
            lambda s: LEARNING_RATE, optimizer=opt, grad_clip=None, adagrad_eps=DCN_EPS,
            impl=impl, bag_sizes=cfg.bag_sizes)
        reset_launches()
        losses, times, m = run_steps(step, state, batches)
        return model, state, losses, times, m["logits"], read_launches()

    kern, plain = run("auto"), run("plain")
    per_step = {"segment_sum128": DCN_STEPS, "table_update128": DCN_STEPS,
                "adagrad": DCN_STEPS}
    loss_diff = max(abs(a - b) for a, b in zip(kern[2], plain[2]))
    logit_diff = (kern[4] - plain[4]).abs().max().item()
    param_diff = state_diff(kern[0], plain[0])
    acc_k, acc_p = slot_dicts(kern[1].opt_state)[0], slot_dicts(plain[1].opt_state)[0]
    acc_diff = max((acc_k[k] - acc_p[k]).abs().max().item() for k in acc_k)
    # The table and its accumulator on their own (DCN_TABLE_REL_TOL above).
    t0 = dcnv2_init(cfg, seed=0, device=dev).embedding.table.detach()
    t_k, t_p = kern[0].embedding.table.detach(), plain[0].embedding.table.detach()
    moved = (t_p != t0).any(dim=1)
    same_rows_moved = torch.equal((t_k != t0).any(dim=1), moved)
    table_change = (t_p - t0).abs().max().item()
    table_rel_diff = (t_k - t_p).abs().max().item() / table_change
    a_k, a_p = acc_k["embedding.table"], acc_p["embedding.table"]
    table_acc_rel_diff = (a_k - a_p).abs().max().item() / a_p.abs().max().item()
    rows_moved = int(moved.sum())
    del t0, moved
    ok = (loss_diff <= LOSS_TOL and logit_diff <= LOGIT_TOL and param_diff <= PARAM_TOL
          and acc_diff <= PARAM_TOL and same_rows_moved and table_rel_diff <= DCN_TABLE_REL_TOL
          and table_acc_rel_diff <= DCN_TABLE_REL_TOL and kern[5] == per_step
          and plain[5] == {})

    # The two kernels alone on the first batch's lookups and a pooled gradient.
    emb = kern[0].embedding
    idx = emb.fused_index(batches[0][1]).reshape(-1)
    bag_of = emb.bag_index(DCN_BATCH)
    g = torch.randn(DCN_BATCH * len(cfg.bag_sizes), cfg.emb_dim, generator=gen, device=dev)
    rows, seg, is_end = segment_sum.segment_sum_bags(idx, bag_of, g)
    p_rows, p_seg, p_end = segment_sum.segment_sum_bags(idx, bag_of, g, impl="plain")
    seg_err = (seg - p_seg).abs().max().item()
    unique, positions, bags = int(is_end.sum()), idx.numel(), g.shape[0]
    width = cfg.emb_dim * 4
    # Each run against its float64 sum (the bound above).
    order = torch.sort(idx.long(), stable=True).indices
    g_sorted = g.index_select(0, bag_of.index_select(0, order)).double()
    start = torch.ones_like(is_end)
    start[1:] = is_end[:-1]
    run_of = start.cumsum(0) - 1
    sums = torch.zeros(unique, cfg.emb_dim, dtype=torch.float64, device=dev)
    sums.index_add_(0, run_of, g_sorted)
    tol = torch.zeros_like(sums).index_add_(0, run_of, g_sorted.abs())
    tol *= 2.0 ** -20 * (torch.bincount(run_of, minlength=unique).double() / 16).clamp(
        min=1.0).sqrt()[:, None]
    seg_over_bound = ((seg[is_end].double() - sums).abs() / tol.clamp(min=1e-300)).max().item()
    off_ends = seg[~is_end]
    seg_held = (seg_over_bound <= 1.0 and bool((off_ends == 0).all())
                and not bool(torch.signbit(off_ends).any()))
    del order, g_sorted, start, run_of, sums, tol, off_ends
    table, acc = kern[0].embedding.table.data, acc_k["embedding.table"]
    t_in, a_in = table.clone(), acc.clone()

    def update(impl):
        table.copy_(t_in)
        acc.copy_(a_in)
        table_update.table_update(table, acc, rows, seg, LEARNING_RATE, DCN_EPS, impl=impl)

    update("plain")
    t_plain, a_plain = table.clone(), acc.clone()
    update("auto")
    upd_err = max((table - t_plain).abs().max().item(), (acc - a_plain).abs().max().item())
    del t_plain, a_plain
    segsum_bytes = bags * width + positions * 4 + unique * width
    update_bytes = positions * 4 + unique * (width + 4 * width)
    timings = {
        "segment_sum128": {
            "ms": cuda_ms(lambda: segment_sum.segment_sum_bags(idx, bag_of, g)),
            "plain_ms": cuda_ms(lambda: segment_sum.segment_sum_bags(idx, bag_of, g, "plain"),
                                groups=3, per_group=3, warmup=1),
            "bound_ms": segsum_bytes / hbm * 1e3, "max_abs_err_vs_plain": seg_err,
            "max_err_over_float64_bound": seg_over_bound},
        "table_update128": {
            "ms": cuda_ms(lambda: update("auto")), "plain_ms": cuda_ms(lambda: update("plain")),
            "copies_ms": cuda_ms(lambda: (table.copy_(t_in), acc.copy_(a_in))),
            "bound_ms": update_bytes / hbm * 1e3, "max_abs_err_vs_plain": upd_err},
    }
    ok = (ok and seg_held and upd_err == 0.0 and torch.equal(rows, p_rows)
          and torch.equal(is_end, p_end))
    emit({"phase": "dcnv2", "batch": DCN_BATCH, "rows": int(table.shape[0]),
          "lookups_a_step": positions, "touched_rows": unique, "steps": DCN_STEPS,
          "losses_kernels": kern[2], "losses_plain": plain[2],
          "step_ms_kernels": [t * 1e3 for t in kern[3]],
          "step_ms_plain": [t * 1e3 for t in plain[3]],
          "max_loss_diff": loss_diff, "max_logit_diff": logit_diff,
          "max_param_diff": param_diff, "max_accumulator_diff": acc_diff,
          "table_rows_moved": rows_moved, "same_table_rows_moved": same_rows_moved,
          "table_diff_over_its_change": table_rel_diff,
          "table_accumulator_diff_over_its_max": table_acc_rel_diff,
          "launches_kernels": kern[5], "launches_plain": plain[5], "kernels": timings,
          "seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise SystemExit("DLRM-DCNv2's kernel step disagrees with the plain one (see the "
                         "'dcnv2' line)")
    del kern, plain, table, acc, t_in, a_in
    torch.cuda.empty_cache()

def phase_micro(rows_out):
    """Phase 3c: the sparse step with micro_batches = 2 against 1 from the same
    weights and batches at batch 32768 (one segment-sum and one table update a
    step, the body and
    dot-product kernels once a slice), then batch 65536 with 2 and with 1."""
    from collections import Counter

    import numpy as np
    import torch

    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.models.fixed import fixed_init
    from nasrec_tpu_torch.train.optim import make_lr_schedule, slot_dicts
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    vocab = DATASETS["criteo-kaggle"].vocab_sizes(VOCAB_CAP)
    plan = best_plan(XL, vocab)
    sched = make_lr_schedule("cosine", 0.16, 10_000, 1_000)

    def run(micro, batches):
        """(model, state, losses, step ms, last logits, launches, peak GB of
        this run alone: the memory held before it began is subtracted)."""
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = fixed_init(plan, seed=0, device=dev)
        state = init_sparse_train_state(model)
        step = make_sparse_embedding_train_step(sched, grad_clip=5.0, microbatch=micro)
        reset_launches()
        losses, times, m = run_steps(step, state, batches)
        return (model, state, losses, float(np.median(times[1:])) * 1e3, m["logits"],
                read_launches(), (torch.cuda.max_memory_allocated() - base) / 1e9)

    batches = device_batches(np.random.RandomState(3), MICRO_STEPS, BATCH, vocab)
    one = run(1, batches)
    two = run(2, batches)
    param_diff = state_diff(one[0], two[0])
    acc_1, acc_2 = slot_dicts(one[1].opt_state)[0], slot_dicts(two[1].opt_state)[0]
    acc_diff = max((acc_1[k] - acc_2[k]).abs().max().item() for k in acc_1)
    loss_diff = max(abs(a - b) for a, b in zip(one[2], two[2]))
    logit_diff = (one[4] - two[4]).abs().max().item()
    want_two = Counter({k: 2 * MICRO_STEPS for k in TRAIN_STEP_KERNELS[XL]})
    for k in TABLE_KERNELS | LIST_KERNELS:
        want_two[k] = MICRO_STEPS
    ok = (loss_diff <= LOSS_TOL and logit_diff <= LOGIT_TOL and param_diff <= PARAM_TOL
          and acc_diff <= PARAM_TOL
          and one[5] == {k: MICRO_STEPS for k in TRAIN_STEP_KERNELS[XL]}
          and two[5] == dict(want_two))
    emit({"phase": "micro", "arch": "criteo-kaggle/xlarge", "batch": BATCH,
          "steps": MICRO_STEPS, "losses_micro1": one[2], "losses_micro2": two[2],
          "max_loss_diff": loss_diff, "max_logit_diff": logit_diff,
          "max_param_diff": param_diff, "max_accumulator_diff": acc_diff,
          "step_ms_micro1": one[3], "step_ms_micro2": two[3],
          "peak_mem_gb_micro1": one[6], "peak_mem_gb_micro2": two[6],
          "launches_micro1": one[5], "launches_micro2": two[5], "ok": ok})
    if not ok:
        raise SystemExit("micro-batches disagree with one slice (see the 'micro' line)")
    add_launches(rows_out, one[5])
    add_launches(rows_out, two[5])
    del one, two, acc_1, acc_2, batches
    torch.cuda.empty_cache()

    big = device_batches(np.random.RandomState(4), 3, MICRO_BIG_BATCH, vocab)
    out = {}
    for micro in (2, 1):
        model, state, losses, step_ms, _, launches, peak_gb = run(micro, big)
        out[micro] = dict(losses=losses, step_ms=step_ms, peak_mem_gb=peak_gb,
                          examples_per_s=MICRO_BIG_BATCH / step_ms * 1e3, launches=launches)
        add_launches(rows_out, launches)
        del model, state
        torch.cuda.empty_cache()
    ok = all(math.isfinite(x) for r in out.values() for x in r["losses"])
    emit({"phase": "micro", "batch": MICRO_BIG_BATCH, "micro2": out[2], "micro1": out[1],
          "phase_s": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise SystemExit("batch 65536 failed (see the 'micro' line)")


def supernet_config(vocab):
    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.models.supernet import SuperNetConfig

    return SuperNetConfig(space=OPS_CONFIG_LIB["xlarge"], num_blocks=SN_BLOCKS, num_dense=13,
                          num_sparse=26, vocab_sizes=tuple(vocab), use_layernorm=True)


def suffixed(launches: dict, train: bool) -> dict:
    """Launch counts of the supernet drive under the names of its rows (the
    list kernels' under theirs: they take no batch)."""
    tail = f"_b{SN_BATCH}" if train else f"_b{SN_EVAL_BATCH}"
    return {k if k in LIST_KERNELS else k + tail: v for k, v in launches.items()}


def phase_supernet(rows_out, compute_dtype="float32"):
    """Supernet one-shot training at the canonical configuration: SN_STEPS
    masked train steps and one eval forward through the kernels, counted step
    by step, then the same steps from the same weights and masks through the
    plain versions, and a profile of 3 more kernel-path steps.  compute_dtype
    "bfloat16": the same steps in bf16, each plain step from the kernel path's
    state before it (`lockstep`), and no profile."""
    import numpy as np
    import torch

    from nasrec_tpu_torch.choices import choice_to_masks, full_path_choice
    from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB, SEARCH_MAX_NUM_EMBEDDINGS
    from nasrec_tpu_torch.models.supernet import supernet_init
    from nasrec_tpu_torch.sampling import ChoiceSampler, DeviceMaskBuffer
    from nasrec_tpu_torch.train.loop import make_eval_step
    from nasrec_tpu_torch.train.optim import make_lr_schedule
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
    )

    dev = torch.device(DEVICE)
    space = OPS_CONFIG_LIB["xlarge"]
    vocab = DATASETS["criteo-kaggle"].vocab_sizes(SN_VOCAB_CAP)
    cfg = supernet_config(vocab)
    t0 = time.perf_counter()
    model_k = supernet_init(cfg, seed=0, device=dev)
    model_p = copy.deepcopy(model_k)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for n, p in model_k.named_parameters() if n != "embedding.table")

    sampler = ChoiceSampler(space, SN_BLOCKS, strategy="default", anypath_choice="binomial-0.5",
                            supernet_training_steps=SN_WARMUP, seed=0)
    buffer = DeviceMaskBuffer(sampler, size=SN_STEPS, device=dev)
    masks = [buffer() for _ in range(SN_STEPS)]
    # Which subnets the steps train (read back once, outside the runs).
    act = buffer.buffer.node_act.cpu().numpy()
    full = choice_to_masks(full_path_choice(space, SN_BLOCKS), space, SN_BLOCKS)
    host = [[x.cpu().numpy() for x in buffer.buffer.select(i).astuple()] for i in range(SN_STEPS)]
    full_steps = [i for i in range(SN_STEPS)
                  if all(np.array_equal(a, b) for a, b in zip(host[i], full.astuple()))]
    tf_k, dp_k = space.node_names.index("transformer"), space.node_names.index("dot-product")
    tf_off = [i for i in range(SN_STEPS) if (act[i, :, tf_k] == 0).any()]
    dp_off = [i for i in range(SN_STEPS) if (act[i, :, dp_k] == 0).any()]

    rng = np.random.RandomState(1)
    batches = device_batches(rng, SN_STEPS, SN_BATCH, vocab)
    eval_dense = torch.as_tensor(rng.randn(SN_EVAL_BATCH, 13).astype(np.float32), device=dev)
    eval_cat = torch.as_tensor(draw_indices(rng, SN_EVAL_BATCH, vocab, "uniform"), device=dev)
    eval_masks = full.to(dev)
    sched = make_lr_schedule("cosine", 0.12, 10_000, 1_000)

    def run(model, impl):
        state = init_sparse_train_state(model)
        step = make_sparse_embedding_train_step(sched, grad_clip=5.0, impl=impl, has_masks=True)
        losses, times, per_step = [], [], []
        for (d, c, y), m in zip(batches, masks):
            reset_launches()
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            state, out = step(state, d, c, y, m)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - s0)
            per_step.append(read_launches())
            losses.append(float(out["loss"]))
        return losses, times, per_step, out["logits"], lambda: step(state, *batches[0], masks[0])

    def evaluate(model, impl, dt=torch.float32):
        return make_eval_step(impl, has_masks=True, compute_dtype=dt)(
            model, eval_dense, eval_cat, eval_masks)

    if compute_dtype == "bfloat16":
        bf = torch.bfloat16

        def make(impl):
            return make_sparse_embedding_train_step(sched, grad_clip=5.0, impl=impl,
                                                    has_masks=True, compute_dtype=bf)

        res = lockstep(make("auto"), init_sparse_train_state(model_k), make("plain"),
                       init_sparse_train_state(model_p), batches, masks)
        peak_gb = res["peak_gb"]
        reset_launches()
        eval_k = evaluate(model_k, "auto", bf)
        eval_launches = read_launches()
        model_p.load_state_dict(model_k.state_dict())
        eval_p = evaluate(model_p, "plain", bf)
        eval_rel = (eval_k - eval_p).abs().max().item() / max(eval_p.abs().max().item(), 1.0)
        step_ms = float(np.median(res["seconds"][1:])) * 1e3
        ok = (bool(full_steps and tf_off and dp_off) and lockstep_ok(res)
              and eval_k.dtype == torch.float32 and bool(torch.isfinite(eval_k).all())
              and eval_rel <= BF16_LOGIT_TOL
              and all(c == bf16_named(SN_STEP_LAUNCHES) for c in res["launches"])
              and eval_launches == bf16_named(SN_EVAL_LAUNCHES))
        emit({"phase": "supernet", "config": "criteo-kaggle xlarge supernet",
              "compute_dtype": "bfloat16", "blocks": SN_BLOCKS, "vocab_rows": int(sum(vocab)),
              "batch": SN_BATCH, "steps": SN_STEPS, "full_path_steps": full_steps,
              "steps_with_a_transformer_gate_0": tf_off,
              "steps_with_a_dot_product_gate_0": dp_off, "losses": res["losses"],
              "losses_plain_from_the_same_state": res["losses_plain"],
              "max_loss_rel_diff": res["loss_rel"], "max_logit_rel_diff": res["logit_rel"],
              "max_param_diff": res["param"], "max_accumulator_rel_diff": res["slot"],
              "max_eval_logit_rel_diff": eval_rel, "step_ms": step_ms,
              "step_ms_all": [x * 1e3 for x in res["seconds"]], "peak_mem_gb": peak_gb,
              "launches_per_step": res["launches"][0], "eval_launches": eval_launches,
              "ok": ok})
        if not ok:
            raise SystemExit("the bf16 supernet drive failed (see the 'supernet' line)")
        del model_k, model_p, batches, buffer, masks
        torch.cuda.empty_cache()
        return

    torch.cuda.reset_peak_memory_stats()
    losses_k, times_k, per_step, logits_k, more_k = run(model_k, "auto")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reset_launches()
    eval_k = evaluate(model_k, "auto")
    eval_launches = read_launches()
    torch.cuda.reset_peak_memory_stats()
    losses_p, times_p, per_step_p, logits_p, _ = run(model_p, "plain")
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    eval_p = evaluate(model_p, "plain")

    param_diff = state_diff(model_k, model_p)
    loss_diff = max(abs(a - b) for a, b in zip(losses_k, losses_p))
    logit_diff = (logits_k - logits_p).abs().max().item()
    eval_diff = (eval_k - eval_p).abs().max().item()
    step_ms = float(np.median(times_k[1:])) * 1e3
    plain_step_ms = float(np.median(times_p[1:])) * 1e3
    ok = (SEARCH_MAX_NUM_EMBEDDINGS == SN_VOCAB_CAP and int(sum(vocab)) == SN_ROWS
          and bool(full_steps and tf_off and dp_off)
          and all(math.isfinite(x) for x in losses_k + losses_p)
          and tuple(eval_k.shape) == (SN_EVAL_BATCH, 1) and bool(torch.isfinite(eval_k).all())
          and loss_diff <= LOSS_TOL and logit_diff <= LOGIT_TOL and param_diff <= PARAM_TOL
          and eval_diff <= LOGIT_TOL
          and all(c == SN_STEP_LAUNCHES for c in per_step)
          and not any(per_step_p) and eval_launches == SN_EVAL_LAUNCHES)
    emit({"phase": "supernet", "config": "criteo-kaggle xlarge supernet", "blocks": SN_BLOCKS,
          "use_layernorm": True, "vocab_rows": int(sum(vocab)), "params_outside_table": n_params,
          "batch": SN_BATCH, "eval_batch": SN_EVAL_BATCH, "steps": SN_STEPS, "init_s": init_s,
          "full_path_steps": full_steps, "steps_with_a_transformer_gate_0": tf_off,
          "steps_with_a_dot_product_gate_0": dp_off,
          "losses": losses_k, "losses_plain": losses_p, "max_loss_diff": loss_diff,
          "max_logit_diff": logit_diff, "max_param_diff": param_diff,
          "max_eval_logit_diff": eval_diff,
          "step_ms": step_ms, "examples_per_s": SN_BATCH / step_ms * 1e3,
          "step_ms_all": [x * 1e3 for x in times_k], "plain_step_ms": plain_step_ms,
          "plain_examples_per_s": SN_BATCH / plain_step_ms * 1e3,
          "plain_step_ms_all": [x * 1e3 for x in times_p],
          "peak_mem_gb": peak_gb, "plain_peak_mem_gb": plain_peak_gb,
          "launches_per_step": per_step[0], "launches_equal_every_step":
          all(c == per_step[0] for c in per_step), "eval_launches": eval_launches, "ok": ok})
    if not ok:
        raise SystemExit("the supernet drive failed (see the 'supernet' line)")
    del model_p
    totals = {k: SN_STEPS * v for k, v in per_step[0].items()}
    for name, count in [*suffixed(totals, True).items(),
                        *suffixed(eval_launches, False).items()]:
        rows_out[name]["launches"] = rows_out[name].get("launches", 0) + count
    profile_steps("criteo-kaggle xlarge supernet", more_k, 3)
    del model_k, batches, more_k, buffer, masks
    torch.cuda.empty_cache()


def phase_supernet_cli(tmp: Path) -> Path:
    """nasrec_tpu_torch.cli.train_supernet on synthetic data at 7 blocks and
    batch 512 with a logging dir, then a resume from its checkpoint; the
    resumed run's checkpoint reloads into a fresh model with equal eval
    logits.  (lr 0.02, as in phase_cli: a run this short has no warmup.)
    Writes under `tmp`; returns the resumed run's checkpoint, which phase 8
    searches."""
    import numpy as np
    import torch

    from nasrec_tpu_torch.choices import choice_to_masks, full_path_choice
    from nasrec_tpu_torch.cli import train_supernet
    from nasrec_tpu_torch.models.supernet import supernet_init
    from nasrec_tpu_torch.models.transplant import from_jax_params
    from nasrec_tpu_torch.train.checkpoint import load_any_checkpoint
    from nasrec_tpu_torch.train.loop import make_eval_step

    base = ["--data_source", "synthetic", "--device", DEVICE, "--config", "xlarge",
            "--num_blocks", str(SN_BLOCKS), "--use_layernorm", "1",
            "--train_batch_size", str(SN_BATCH), "--test_batch_size", str(SN_EVAL_BATCH),
            "--max_eval_steps", "1", "--display_interval", "1",
            "--supernet_training_steps", str(SN_WARMUP), "--learning_rate", "0.02"]
    reset_launches()
    t0 = time.perf_counter()
    first = train_supernet.main(base + [
        "--max_train_steps", str(SN_CLI_STEPS), "--test_interval", str(SN_CLI_STEPS),
        "--logging_dir", str(tmp / "first")])
    first_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    second = train_supernet.main(base + [
        "--max_train_steps", str(SN_RESUME_STEPS), "--test_interval",
        str(SN_RESUME_STEPS), "--logging_dir", str(tmp / "second"),
        "--checkpoint_path", str(tmp / "first" / "supernet_checkpoint.pkl")])
    second_s = time.perf_counter() - t0
    ckpt = load_any_checkpoint(str(tmp / "second" / "supernet_checkpoint.pkl"))
    files = sorted(p.name for p in (tmp / "first").iterdir())

    cfg = second["cfg"]
    fresh = supernet_init(cfg, seed=123, device=torch.device(DEVICE))
    fresh.load_state_dict(from_jax_params(ckpt["params"], cfg))
    rng = np.random.RandomState(2)
    dense = torch.as_tensor(rng.randn(SN_EVAL_BATCH, 13).astype(np.float32), device=DEVICE)
    cat = torch.as_tensor(rng.randint(0, cfg.vocab_sizes[0], size=(SN_EVAL_BATCH, 26))
                          .astype(np.int32), device=DEVICE)
    m = choice_to_masks(full_path_choice(cfg.space, SN_BLOCKS), cfg.space,
                        SN_BLOCKS).to(DEVICE)
    eval_step = make_eval_step(has_masks=True)
    reload_diff = (eval_step(fresh, dense, cat, m)
                   - eval_step(second["state"].model, dense, cat, m)).abs().max().item()
    logs1, logs2 = first["logs"][0], second["logs"][0]
    # Every train step launches the step's kernels, every eval forward (one
    # batch at each test point) the forward kernels.
    expected = {k: v * SN_CLI_STEPS for k, v in SN_STEP_LAUNCHES.items()}
    for k, v in SN_EVAL_LAUNCHES.items():
        expected[k] = expected.get(k, 0) + v * len(logs1["test_loss"])
    ok = (all(math.isfinite(x) for x in logs1["train_loss"] + logs2["train_loss"]
              + logs1["test_loss"] + logs2["test_loss"])
          and len(logs1["train_loss"]) == SN_CLI_STEPS
          and first["state"].step == SN_CLI_STEPS
          and second["state"].step == int(ckpt["step"]) == SN_CLI_STEPS + SN_RESUME_STEPS
          and {"configs_args.json", "metrics.jsonl", "supernet_checkpoint.pkl",
               "train_test_logs.json", "train_test_logs.pickle"} <= set(files)
          and launches == expected
          and reload_diff == 0.0)
    emit({"phase": "supernet_cli", "train_loss": logs1["train_loss"],
          "test_loss": logs1["test_loss"], "resumed_train_loss": logs2["train_loss"],
          "resumed_test_loss": logs2["test_loss"], "steps": [first["state"].step,
                                                              second["state"].step],
          "files": files, "launches": launches, "reload_max_logit_diff": reload_diff,
          "seconds": [first_s, second_s], "ok": ok})
    if not ok:
        raise SystemExit("the supernet CLI did not train, resume or reload")
    return tmp / "second" / "supernet_checkpoint.pkl"


def spearman(a, b) -> float:
    """Spearman rank correlation (ties take their average rank)."""
    import numpy as np

    def ranks(x):
        x = np.asarray(x, dtype=np.float64)
        r = np.empty(len(x))
        r[np.argsort(x, kind="mergesort")] = np.arange(len(x))
        for v in np.unique(x):
            r[x == v] = r[x == v].mean()
        return r

    return float(np.corrcoef(ranks(a), ranks(b))[0, 1])


def timed_steps(fn, n: int) -> tuple:
    """Host times (ms) of n calls of fn, each ended by a synchronize, and the
    launches of each call."""
    import torch

    times, launches = [], []
    for _ in range(n):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append(read_launches())
    return times, launches


def join_launches(rows_out, launches: dict, batch: int, hbm, gen, table=None) -> None:
    """Launches counted at one batch into the rows "<kernel>_<shape>_b<batch>";
    a row that does not exist yet is made first, its kernel checked against the
    plain version at that shape and timed (`check_dot_scores`,
    `check_transformer_body`, `check_table_update`, `check_segment_sum`).
    table: (name, vocab) of the run's table, whose update goes into the row
    "<name>_b<batch>" and whose segment-sum beside it (`segsum_row`).  The
    list clip's and update's launches, which take no batch, go into their one
    row each (`check_dense_adagrad`)."""
    suffix = f"_b{batch}"
    for name, count in launches.items():
        if name in LIST_KERNELS:
            rows_out[name]["launches"] = rows_out[name].get("launches", 0) + count
            continue
        if name in TABLE_KERNELS and table is not None:
            name = table[0] if name == "table_update" else segsum_row(table[0])
        row = name + suffix
        if row not in rows_out:
            dot = re.fullmatch(r"dot_scores_tril_(fwd|bwd)_n(\d+)", name)
            body = re.fullmatch(r"transformer_body_(fwd|fwd_train|bwd)_s(\d+)", name)
            if dot:
                check_dot_scores(int(dot[2]), hbm, gen, rows_out, batch, suffix, (dot[1],))
            elif body:
                check_transformer_body(int(body[2]), hbm, gen, rows_out, batch, suffix,
                                       (body[1],), True)
            elif table is not None and name == table[0]:
                check_table_update(table[1], hbm, gen, rows_out, batch, row,
                                   kinds=("uniform",), top_rows=True)
            elif table is not None and name == segsum_row(table[0]):
                check_segment_sum(table[1], hbm, gen, rows_out, batch, row)
            else:
                raise SystemExit(f"no row for the launches of {row}")
        rows_out[row]["launches"] = rows_out[row].get("launches", 0) + count


def launch_diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def phase_profiling(ckpt: Path, tmp: Path, rows_out, hbm) -> None:
    """The profiling layer and the latency-aware search (see the module
    docstring, phase 9)."""
    import contextlib
    import io
    import pickle

    import torch

    from nasrec_tpu_torch import profiling, workloads
    from nasrec_tpu_torch.cli import eval_subnet_from_supernet, main_train
    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.models.fixed import fixed_apply, fixed_init
    from nasrec_tpu_torch.tools import body_device_check, sweep_device_check

    t_phase = time.perf_counter()
    dev, meta = torch.device(DEVICE), torch.device("meta")
    gen = torch.Generator(device=dev).manual_seed(9)

    # The chip's peaks at the JAX package's defaults (4096, 512 MiB, 20).
    t0 = time.perf_counter()
    calib = profiling.calibrate_chip(device=DEVICE)
    emit({"phase": "profiling", "step": "calibrate_chip", "allow_tf32": False,
          "matmul_tflops_bf16": calib["matmul_flops_per_s"] / 1e12,
          "matmul_share_of_989_tflops": calib["matmul_flops_per_s"] / BF16_PEAK,
          "copy_gb_per_s": calib["copy_bytes_per_s"] / 1e9,
          "copy_share_of_hbm": calib["copy_bytes_per_s"] / hbm,
          "seconds": time.perf_counter() - t0})

    # The xlarge best arch's forward at batch 512 over the search-capped table:
    # measured through the kernels and through the plain versions, counted.
    plan = best_plan(XL, DATASETS["criteo-kaggle"].vocab_sizes(SN_VOCAB_CAP))
    model = fixed_init(plan, 0, dev)
    dense = torch.zeros(SN_BATCH, 13, device=dev)
    cat = torch.zeros(SN_BATCH, 26, dtype=torch.int32, device=dev)

    def forward(m, d, c, impl):
        with torch.no_grad():
            return fixed_apply(m, d, c, impl=impl)

    latency, fallbacks = {}, profiling.timing_fallbacks()
    for impl in ("kernel", "plain"):
        reset_launches()
        latency[impl] = profiling.measure_latency(forward, (model, dense, cat, impl))
        if impl == "kernel":
            forward_launches = read_launches()
    fallbacks = profiling.timing_fallbacks() - fallbacks
    flops = {impl: profiling.dot_flops(forward, model, dense, cat, impl)
             for impl in ("kernel", "plain")}
    estimate = profiling.estimate_latency_cost_model(
        lambda m, d, c: forward(m, d, c, "plain"),
        (fixed_init(plan, 0, meta), dense.to(meta), cat.to(meta)), calib)
    del model
    torch.cuda.empty_cache()
    join_launches(rows_out, forward_launches, SN_BATCH, hbm, gen)
    emit({"phase": "profiling", "step": "xlarge_forward_b512",
          "latency_ms_kernel": [v * 1e3 for v in latency["kernel"]],
          "latency_ms_plain": [v * 1e3 for v in latency["plain"]],
          "timing_fallbacks": fallbacks, "cost_model_ms": estimate * 1e3,
          "dot_flops_kernel": flops["kernel"], "dot_flops_plain": flops["plain"],
          "launches": forward_launches})

    # The search CLI with the latency criterion, once per estimator; the
    # launches inside measure_latency counted apart from the evaluator's.
    base = ["--data_source", "synthetic", "--device", DEVICE, "--config", "xlarge",
            "--num_blocks", str(SN_BLOCKS), "--ckpt_path", str(ckpt),
            "--method", "regularized-ea", "--group_size", str(SEARCH_GROUP),
            "--max_train_steps", str(PROF_STEPS), "--max_eval_steps", "1",
            "--train_batch_size", str(SN_BATCH), "--test_batch_size", str(SEARCH_TEST_BATCH),
            "--criterion", "test_loss_penalty_lat", "--beta", str(PROF_BETA),
            "--target_latency", repr(latency["kernel"][0]),
            "--latency_batch_size", str(SN_BATCH)]
    for k, v in PROF_EA.items():
        base += [f"--{k}", str(v)]
    inside, real_measure = [], profiling.measure_latency

    def counted_measure(*a, **kw):
        before = read_launches()
        out = real_measure(*a, **kw)
        inside.append(launch_diff(read_launches(), before))
        return out

    runs, groups = {}, PROF_CANDIDATES // SEARCH_GROUP
    chunks = SEARCH_TEST_BATCH // SEARCH_CHUNK
    evaluator_want = {k: v * groups * (PROF_STEPS + chunks) for k, v in SEARCH_STEP_LAUNCHES.items()}
    profiling.measure_latency = counted_measure
    try:
        for est in ("cost-model", "measured"):
            inside.clear()
            reset_launches()
            t0 = time.perf_counter()
            eval_subnet_from_supernet.main(base + ["--latency_estimator", est,
                                                   "--logging_dir", str(tmp / f"lat_{est}")])
            seconds = time.perf_counter() - t0
            total = read_launches()
            timed = {}
            for d in inside:
                for k, v in d.items():
                    timed[k] = timed.get(k, 0) + v
            with open(tmp / f"lat_{est}" / "all_results.pickle", "rb") as f:
                runs[est] = dict(results=pickle.load(f), seconds=seconds, timed=timed,
                                 evaluator=launch_diff(total, timed))
    finally:
        profiling.measure_latency = real_measure
    measured = runs["measured"]
    # The evaluator's group steps run at 8 x 512 rows, its eval chunks at
    # 8 x 1024.
    for run in runs.values():
        if run["evaluator"] == evaluator_want:
            for kernel, per_step in SEARCH_STEP_LAUNCHES.items():
                for batch, n in ((SEARCH_STEP_ROWS, PROF_STEPS), (SEARCH_CHUNK_ROWS, chunks)):
                    row = f"{kernel}_b{batch}"
                    rows_out[row]["launches"] = (rows_out[row].get("launches", 0)
                                                 + per_step * groups * n)
    join_launches(rows_out, measured["timed"], SN_BATCH, hbm, gen)
    # The cost model's estimate of every candidate the measured run timed,
    # with this process's calibration.
    cost_model = workloads._choice_latency_fn(
        workloads.SearchOptions(config="xlarge", num_blocks=SN_BLOCKS,
                                latency_batch_size=SN_BATCH, device=DEVICE),
        workloads.DataOptions(data_source="synthetic"))
    est_all = [cost_model(r["choice"]) for r in measured["results"]]
    meas_all = [r["latency"] for r in measured["results"]]
    shared = PROF_EA["init_population"]
    same_estimates = [r["latency"] for r in runs["cost-model"]["results"][:shared]] == \
        est_all[:shared]
    rho = spearman(est_all, meas_all)
    timed_kinds = set(measured["timed"])
    emit({"phase": "profiling", "step": "latency_search",
          "candidates": [{"estimate_ms": e * 1e3, "measured_ms": m * 1e3,
                          "test_loss": r["test_loss"]}
                         for e, m, r in zip(est_all, meas_all, measured["results"])],
          "cost_model_run_test_losses": [r["test_loss"] for r in runs["cost-model"]["results"]],
          "spearman_cost_model_vs_measured": rho,
          "seconds": {k: v["seconds"] for k, v in runs.items()},
          "measured_mode_launches": measured["timed"],
          "evaluator_launches": {k: v["evaluator"] for k, v in runs.items()}})

    # The device checks, each of which must print its OK line.
    checks = {}
    for name, tool in (("body", body_device_check), ("sweep", sweep_device_check)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tool.main()
        checks[name] = buf.getvalue().strip()
        print(checks[name], flush=True)

    # main_train with --report_flops and --profile_dir for 3 xlarge steps.
    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main_train.main([
            "--arch", "criteo-kaggle/xlarge", "--data_source", "synthetic", "--device", DEVICE,
            "--max_train_steps", str(PROF_TRAIN_STEPS), "--max_eval_steps", "1",
            "--train_batch_size", str(SN_BATCH), "--test_batch_size", str(SN_BATCH),
            "--test_interval", str(PROF_TRAIN_STEPS), "--learning_rate", "0.02",
            "--report_flops", "1", "--logging_dir", str(tmp / "flops"),
            "--profile_dir", str(tmp / "trace")])
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    join_launches(rows_out, train_launches, SN_BATCH, hbm, gen)
    flops_line = [l for l in buf.getvalue().splitlines() if l.startswith("FLOPS:")]
    trace = tmp / "trace" / "trace.json"
    trace_bytes = trace.stat().st_size if trace.is_file() else 0

    losses = [r["test_loss"] for run in runs.values() for r in run["results"]]
    ok = (flops["kernel"] == flops["plain"] > 0
          and all(math.isfinite(v) and v > 0 for v in calib.values())
          and all(math.isfinite(v[0]) and v[0] > 0 for v in latency.values())
          and all(len(run["results"]) == PROF_CANDIDATES for run in runs.values())
          and all(run["evaluator"] == evaluator_want for run in runs.values())
          and not runs["cost-model"]["timed"]
          and all(math.isfinite(x) and x < 999 for x in losses)
          and all(math.isfinite(v) and v > 0 for v in est_all + meas_all)
          and same_estimates
          and any(k.startswith("dot_scores_tril_fwd_n") for k in timed_kinds)
          and any(k.startswith("transformer_body_fwd_s") for k in timed_kinds)
          and checks["body"].startswith("BODY_DEVICE_CHECK_OK")
          and checks["sweep"].startswith("SWEEP_DEVICE_CHECK_OK")
          and len(flops_line) == 1 and trace_bytes > 0
          and out["state"].step == PROF_TRAIN_STEPS
          and (tmp / "flops" / "model_graph" / "modules.txt").is_file())
    emit({"phase": "profiling", "step": "main_train", "flops_line": flops_line,
          "trace_bytes": trace_bytes, "launches": train_launches, "seconds": train_s,
          "test_loss": out["logs"][0]["test_loss"], "device_checks": checks,
          "phase_seconds": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise SystemExit("the profiling phase failed (see the 'profiling' lines)")


def whole_states(cfg, model, picks, i, impl, batches, steps, args) -> list:
    """Candidate i's parameters (its table rows included) before each step of
    a whole-net group of `picks` and after the last, the group run through
    `impl`."""
    from nasrec_tpu_torch.search import make_candidate_evaluator

    group = make_candidate_evaluator(cfg, model, impl=impl, **args).group(picks)
    states = []
    for t in range(steps):
        states.append({n: p.clone() for n, p in group.candidate_params(i).items()})
        group.step(*batches[t], t)
    states.append({n: p.clone() for n, p in group.candidate_params(i).items()})
    return states


def relu_edge_leaves(cfg, model, picks, i, leaves, batches, steps, args) -> dict:
    """Whether a ReLU edge explains why candidate i's `leaves` end more than
    PARAM_TOL apart between the whole-net group's kernel route and its plain
    route.  Both routes are replayed, candidate i's state kept before every
    step.  At the first step after which a leaf is more than PARAM_TOL
    apart, the two states before it must be within PARAM_TOL in every
    parameter.  The ReLU inputs of that step's batch are recorded at both
    states through the plain supernet (the linear nodes' activations, and
    each transformer body's FFN input recomputed as relu_edge_rows does); the
    rows where one of them changes sign between the states sit at a ReLU
    edge.  The leaves' gradients at the two states must differ by more than
    GRAD_REL_TOL, and agree within it once those rows' loss weight is zero:
    then the whole divergence lies in rows whose ReLU input is within
    rounding of zero, and the leaves are excused."""
    import torch
    import torch.nn.functional as F

    from nasrec_tpu_torch.choices import choice_to_masks
    from nasrec_tpu_torch.ops import attention, common
    from nasrec_tpu_torch.ops.common import LN_EPS
    from nasrec_tpu_torch.ops.kernels.attention import tiny_head_attention_plain

    sk, sp = (whole_states(cfg, model, picks, i, impl, batches, steps, args)
              for impl in ("auto", "plain"))

    def gap(a, b, names):
        return max((a[n] - b[n]).abs().max().item() for n in names)

    t = next((t for t in range(steps) if gap(sk[t + 1], sp[t + 1], leaves) > PARAM_TOL), None)
    if t is None:
        return {"candidate": i, "leaves": leaves, "explained": False,
                "error": "the replays did not part as the evaluator runs did"}
    before = gap(sk[t], sp[t], sk[t])
    del sk[t + 1:], sp[t + 1:]
    net = copy.deepcopy(model).requires_grad_(True)       # the table's too
    masks = choice_to_masks(picks[i], cfg.space, cfg.num_blocks).to(net.final.weight.device)
    dense, cat, y = batches[t]
    record, labels, node = [], [], ["?"]
    relu, body = common.ACTIVATIONS["relu"], attention.transformer_body

    def recording_relu(x):
        record.append(x.detach().clone())
        labels.append(node[0])
        return relu(x)

    def recording_body(x, params, *rest, **kw):
        with torch.no_grad():
            o = tiny_head_attention_plain(F.linear(x, params[0], params[1]))
            x4 = F.layer_norm(F.linear(o, params[2], params[3]) + x, (16,), params[4],
                              params[5], LN_EPS)
            record.append(F.linear(x4, params[6], params[7]))
            labels.append(node[0] + " ffn")
        return body(x, params, *rest, **kw)

    hooks = [mod.register_forward_pre_hook(lambda m, a, name=name: node.__setitem__(0, name))
             for name, mod in net.named_modules() if re.fullmatch(r"blocks\.\d+\.nodes\.\d+", name)]

    def load(state):
        with torch.no_grad():
            for n, p in net.named_parameters():
                p.copy_(state[n])

    def relu_inputs(state):
        load(state)
        record.clear()
        labels.clear()
        common.ACTIVATIONS["relu"], attention.transformer_body = recording_relu, recording_body
        try:
            with torch.no_grad():
                net(dense, cat, masks, "plain")
        finally:
            common.ACTIVATIONS["relu"], attention.transformer_body = relu, body
        return list(record)

    def grads(state, weight):
        load(state)
        x = net(dense, cat, masks, "plain").float()
        per_row = torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-torch.abs(x)))
        named = dict(net.named_parameters())
        return torch.autograd.grad((per_row[:, 0] * weight).mean(), [named[n] for n in leaves],
                                   allow_unused=True, materialize_grads=True)

    try:
        ins_k, ins_p = relu_inputs(sk[t]), relu_inputs(sp[t])
    finally:
        for h in hooks:
            h.remove()
    rows = torch.zeros(dense.shape[0], dtype=torch.bool, device=dense.device)
    flips = []
    for label, a, b in zip(labels, ins_k, ins_p):
        side = (a > 0) != (b > 0)
        rows |= side.reshape(side.shape[0], -1).any(1)
        for j in side.flatten().nonzero()[:4, 0].tolist():
            flips.append((label, a.flatten()[j].item(), b.flatten()[j].item()))
    ones = torch.ones(dense.shape[0], device=dense.device)
    full = [within(a, b, GRAD_REL_TOL) for a, b in zip(grads(sk[t], ones), grads(sp[t], ones))]
    kept = (~rows).float()
    masked = [within(a, b, GRAD_REL_TOL) for a, b in zip(grads(sk[t], kept), grads(sp[t], kept))]
    del net, sk, sp
    torch.cuda.empty_cache()
    explained = (before <= PARAM_TOL and bool(rows.any()) and not all(ok for _, ok in full)
                 and all(ok for _, ok in masked))
    return {"candidate": i, "leaves": leaves, "step": t, "state_diff_before": before,
            "rows_at_the_edge": rows.nonzero()[:, 0].tolist(),
            "sign_changes (node, kernel route, plain route)": flips[:8],
            "grad_diff": max(e for e, _ in full),
            "grad_diff_without_those_rows": max(e for e, _ in masked), "explained": explained}


class GroupLog:
    """Per fine-tune step and per eval batch, the launches (and the step's host
    time, ended by a synchronize) of an evaluator run, read through its data
    streams: a step runs between two batches of the train stream; the first
    test batch ends a candidate's or a group's last step."""

    def __init__(self):
        self.steps, self.evals, self.t0 = [], [], None

    def _close_step(self):
        import torch

        if self.t0 is not None:
            torch.cuda.synchronize()
            self.steps.append(((time.perf_counter() - self.t0) * 1e3, read_launches()))
            self.t0 = None

    def train(self, batches):
        import torch

        def it():
            for b in batches:
                self._close_step()
                reset_launches()
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()
                yield b
        return it

    def test(self, batch):
        def it():
            self._close_step()
            reset_launches()
            yield batch
            self.evals.append(read_launches())
        return it


def add_group_launches(rows_out, launches: dict, per_candidate: int, folded: int,
                       table: str) -> None:
    """An evaluator's launches into their rows: the K-candidate body's at the
    batch a candidate (its launch keys carry "_k<K>"), every other kernel's at
    the rows it launched on, the table update's into `table` and the
    segment-sum's into the row beside it, the list kernels' into theirs.  A
    bf16 launch of another kernel at these batches has no row (phase 4
    leaves its bf16 launches out the same way)."""
    for key, count in launches.items():
        if key == "table_update":
            row = table
        elif key == "segment_sum":
            row = segsum_row(table)
        elif key in LIST_KERNELS:
            row = key
        elif re.search(r"_k\d+", key):
            row = f"{key}_b{per_candidate}"
        else:
            row = f"{key}_b{folded}"
        if row not in rows_out:
            if key.endswith("_bf16"):
                continue
            raise SystemExit(f"no row for the search's launches of {row}")
        rows_out[row]["launches"] = rows_out[row].get("launches", 0) + count


def phase_search(rows_out):
    """The weight-shared search at the canonical search configuration (see
    the module docstring, phase 6)."""
    import numpy as np
    import torch

    from nasrec_tpu_torch.config import DATASETS, OPS_CONFIG_LIB
    from nasrec_tpu_torch.models.supernet import supernet_init
    from nasrec_tpu_torch.search import SearchConfig, Searcher, Tokenizer, make_candidate_evaluator

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    space = OPS_CONFIG_LIB["xlarge"]
    vocab = DATASETS["criteo-kaggle"].vocab_sizes(SN_VOCAB_CAP)
    cfg = supernet_config(vocab)
    model = supernet_init(cfg, seed=0, device=dev)          # phase 4's weights
    rng = np.random.RandomState(3)

    def batch(n):
        return (torch.as_tensor(rng.randn(n, 13).astype(np.float32), device=dev),
                torch.as_tensor(draw_indices(rng, n, vocab, "uniform"), device=dev),
                torch.as_tensor(rng.randint(0, 2, size=(n, 1)).astype(np.float32), device=dev))

    train_batches = [batch(SN_BATCH) for _ in range(SEARCH_TRAIN_BATCHES)]
    test_batches = [batch(SEARCH_TEST_BATCH) for _ in range(SEARCH_EVAL_STEPS)]
    train_iter_fn, test_iter_fn = (lambda: iter(train_batches)), (lambda: iter(test_batches))
    args = dict(learning_rate=0.04, max_train_steps=SEARCH_STEPS,
                max_eval_steps=SEARCH_EVAL_STEPS, eval_batch_chunk=SEARCH_CHUNK)
    ev = make_candidate_evaluator(cfg, model, **args)

    # Single group steps and eval chunks: launches, times, a profile line.
    tok = Tokenizer(SN_BLOCKS, space, seed=1)
    group = ev.group([tok.generate_random_choice() for _ in range(SEARCH_GROUP)])
    step_ms, step_launches = timed_steps(lambda: group.step(*train_batches[0], 0), 6)
    d, c, _ = test_batches[0]
    chunk_ms, chunk_launches = timed_steps(
        lambda: group.logits(d[:SEARCH_CHUNK], c[:SEARCH_CHUNK]), 4)
    step_profile = profile_steps("search group step (8 candidates, batch 512)",
                                 lambda: group.step(*train_batches[0], 0), 3)
    del group

    # A short regularized EA, counted; the first group's finals kept.
    first = {}

    def eval_fn(choices):
        res = ev(choices, train_iter_fn, test_iter_fn)
        if not first:
            g = ev.last_group
            first.update(choices=choices, results=res,
                         weight=g.weight.clone(), bias=g.bias.clone())
        return res

    searcher = Searcher(eval_fn, Tokenizer(SN_BLOCKS, space, seed=0),
                        SearchConfig(group_size=SEARCH_GROUP, seed=0), log_fn=lambda m: None)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    history = searcher.regularized_evolution_from_supernet(**SEARCH_EA)
    torch.cuda.synchronize()
    ea_s = time.perf_counter() - t0
    ea_launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    explored = searcher.all_results
    groups = len(explored) // SEARCH_GROUP
    chunks = SEARCH_EVAL_STEPS * (SEARCH_TEST_BATCH // SEARCH_CHUNK)
    want_launches = {k: v * groups * (SEARCH_STEPS + chunks)
                     for k, v in SEARCH_STEP_LAUNCHES.items()}

    # The first group again: through the plain versions, and one candidate
    # at a time through the kernels.
    reset_launches()
    plain = make_candidate_evaluator(cfg, model, impl="plain", **args)
    res_p = plain(first["choices"], train_iter_fn, test_iter_fn)
    plain_launches = read_launches()
    loss_diff = max(abs(a["test_loss"] - b["test_loss"]) for a, b in zip(first["results"], res_p))
    final_diff = max((first["weight"] - plain.last_group.weight).abs().max().item(),
                     (first["bias"] - plain.last_group.bias).abs().max().item())
    del plain
    one_loss_diff = one_final_diff = 0.0
    for i, choice in enumerate(first["choices"]):
        one = ev([choice], train_iter_fn, test_iter_fn)[0]
        one_loss_diff = max(one_loss_diff, abs(one["test_loss"] - first["results"][i]["test_loss"]))
        one_final_diff = max(one_final_diff,
                             (ev.last_group.weight[0] - first["weight"][i]).abs().max().item(),
                             (ev.last_group.bias[0] - first["bias"][i]).abs().max().item())

    step_med = float(np.median(step_ms[1:]))
    chunk_med = float(np.median(chunk_ms[1:]))
    canon_steps, canon_eval = SEARCH_CANONICAL_STEPS
    s_per_cand_canonical = (canon_steps * step_med + canon_eval
                            * (SEARCH_TEST_BATCH // SEARCH_CHUNK) * chunk_med) / SEARCH_GROUP / 1e3
    ok = (len(explored) == SEARCH_EA["init_population"]
          + SEARCH_EA["n_generations"] * SEARCH_EA["n_childs"]
          and len(history) == SEARCH_EA["n_generations"] * SEARCH_EA["top_k"]
          and all(math.isfinite(r["test_loss"]) and r["test_loss"] < 999 for r in explored)
          and all(x == SEARCH_STEP_LAUNCHES for x in step_launches + chunk_launches)
          and ea_launches == want_launches and not plain_launches
          and loss_diff <= LOSS_TOL and final_diff <= PARAM_TOL
          and one_loss_diff <= LOSS_TOL and one_final_diff <= PARAM_TOL)
    emit({"phase": "search", "config": "criteo-kaggle xlarge supernet, final-only",
          "blocks": SN_BLOCKS, "vocab_rows": int(sum(vocab)), "group": SEARCH_GROUP,
          "batch": SN_BATCH, "test_batch": SEARCH_TEST_BATCH, "eval_chunk": SEARCH_CHUNK,
          "steps": SEARCH_STEPS, "eval_steps": SEARCH_EVAL_STEPS, "ea": SEARCH_EA,
          "candidates": len(explored), "groups": groups, "ea_s": ea_s,
          "s_per_candidate": ea_s / len(explored),
          "s_per_candidate_canonical_extrapolated": s_per_cand_canonical,
          "group_step_ms": step_med, "group_step_ms_all": step_ms,
          "group_step_device_busy_share": step_profile.get("device_busy_share"),
          "eval_chunk_ms": chunk_med, "eval_chunk_ms_all": chunk_ms,
          "launches_per_group_step": step_launches[0], "launches_per_eval_chunk":
          chunk_launches[0], "ea_launches": ea_launches, "peak_mem_gb": peak_gb,
          "test_losses": [r["test_loss"] for r in explored],
          "history_losses": [r["test_loss"] for r in history],
          "first_group_max_loss_diff_vs_plain": loss_diff,
          "first_group_max_final_diff_vs_plain": final_diff,
          "first_group_max_loss_diff_vs_one_at_a_time": one_loss_diff,
          "first_group_max_final_diff_vs_one_at_a_time": one_final_diff, "ok": ok})
    if not ok:
        raise SystemExit("the search drive failed (see the 'search' line)")
    for kernel, count in SEARCH_STEP_LAUNCHES.items():
        for rows, n in ((SEARCH_STEP_ROWS, SEARCH_STEPS), (SEARCH_CHUNK_ROWS, chunks)):
            row = f"{kernel}_b{rows}"
            rows_out[row]["launches"] = rows_out[row].get("launches", 0) + count * groups * n
    del ev

    # The whole-net mode on one group of 8: as one K-candidate step (the
    # default) and one candidate at a time, each step counted and timed, the
    # batched form against the plain versions and against the other form.
    whole_args = dict(args, max_train_steps=SEARCH_WHOLE_STEPS, max_eval_steps=1,
                      finetune_mode="whole")
    picks = [r["choice"] for r in explored[:SEARCH_WHOLE_CANDIDATES]]
    k = len(picks)

    def whole_run(batched, impl="auto", mode="whole"):
        log = GroupLog()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        evw = make_candidate_evaluator(cfg, model, batch_candidates=batched, impl=impl,
                                       **dict(whole_args, finetune_mode=mode))
        t0 = time.perf_counter()
        res = evw(picks, log.train(train_batches), log.test(test_batches[0]))
        torch.cuda.synchronize()
        out = dict(seconds=time.perf_counter() - t0, results=res, log=log, evaluator=evw,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   step_ms=float(np.median([t for t, _ in log.steps[1:]])))
        return out

    def params_diff(g_a, g_b) -> list:
        """Per candidate: (largest difference, its parameter, that
        parameter's largest magnitude, the parameters more than PARAM_TOL
        apart)."""
        out = []
        for i in range(k):
            pa, pb = g_a.candidate_params(i), g_b.candidate_params(i)
            diffs = {n: (pa[n] - pb[n]).abs().max().item() for n in pa}
            worst = max(diffs, key=diffs.get)
            out.append((diffs[worst], worst, pb[worst].abs().max().item(),
                        [n for n, d in diffs.items() if d > PARAM_TOL]))
        return out

    batched = whole_run(True)
    batched_p = whole_run(True, impl="plain")
    diff_plain = max(abs(a["test_loss"] - b["test_loss"])
                     for a, b in zip(batched["results"], batched_p["results"]))
    per_candidate = params_diff(batched["evaluator"].last_group,
                                batched_p["evaluator"].last_group)
    del batched_p
    batched.pop("evaluator")
    torch.cuda.empty_cache()
    edges = [relu_edge_leaves(cfg, model, picks, i, over, train_batches, SEARCH_WHOLE_STEPS,
                              whole_args)
             for i, (_, _, _, over) in enumerate(per_candidate) if over]
    seq = whole_run(False)
    seq.pop("evaluator")
    seq_p = whole_run(False, impl="plain")
    seq_p.pop("evaluator")
    seq_diff = max(abs(a["test_loss"] - b["test_loss"])
                   for a, b in zip(seq["results"], seq_p["results"]))
    forms_rel = max(abs(a["test_loss"] - b["test_loss"]) / abs(b["test_loss"])
                    for a, b in zip(seq["results"], batched["results"]))
    eval_chunks = SEARCH_TEST_BATCH // SEARCH_CHUNK
    ln = whole_run(True, mode="layernorm-calibrate")
    ln.pop("evaluator")
    ln_p = whole_run(True, impl="plain", mode="layernorm-calibrate")
    ln_p.pop("evaluator")
    ln_diff = max(abs(a["test_loss"] - b["test_loss"])
                  for a, b in zip(ln["results"], ln_p["results"]))
    torch.cuda.empty_cache()

    def finite(run):
        return all(math.isfinite(r["test_loss"]) and r["test_loss"] < 999 for r in run["results"])

    per_eval = lambda launches: {key: v * eval_chunks for key, v in launches.items()}
    ok = (all(x == WHOLE_STEP_LAUNCHES for _, x in batched["log"].steps)
          and len(batched["log"].steps) == SEARCH_WHOLE_STEPS
          and batched["log"].evals == [per_eval(WHOLE_EVAL_LAUNCHES)]
          and all(x == SN_STEP_LAUNCHES for _, x in seq["log"].steps)
          and len(seq["log"].steps) == k * SEARCH_WHOLE_STEPS
          and seq["log"].evals == [per_eval(SN_EVAL_LAUNCHES)] * k
          and all(x == LN_STEP_LAUNCHES for _, x in ln["log"].steps)
          and ln["log"].evals == [per_eval(WHOLE_EVAL_LAUNCHES)]
          and not any(x for _, x in ln_p["log"].steps) and ln_diff <= LOSS_TOL
          and finite(batched) and finite(seq) and finite(ln)
          and diff_plain <= LOSS_TOL and all(e["explained"] for e in edges)
          and seq_diff <= LOSS_TOL
          and not any(x for _, x in seq_p["log"].steps)
          and forms_rel <= WHOLE_FORMS_REL_TOL)

    def summary(run):
        return {"seconds": run["seconds"], "step_ms": run["step_ms"],
                "step_ms_all": [t for t, _ in run["log"].steps], "peak_mem_gb": run["peak_gb"],
                "launches_per_step": run["log"].steps[0][1],
                "launches_per_eval_batch": run["log"].evals[0],
                "test_losses": [r["test_loss"] for r in run["results"]]}

    emit({"phase": "search", "mode": "whole", "candidates": k, "steps": SEARCH_WHOLE_STEPS,
          "batched": summary(batched), "one_at_a_time": summary(seq),
          "batched_layernorm_calibrate": summary(ln),
          "batched_max_loss_diff_vs_plain": diff_plain,
          "batched_param_diff_vs_plain_by_candidate": [c[:3] for c in per_candidate],
          "batched_params_apart_at_a_relu_edge": edges,
          "one_at_a_time_max_loss_diff_vs_plain": seq_diff,
          "forms_max_loss_rel_diff": forms_rel,
          "layernorm_calibrate_max_loss_diff_vs_plain": ln_diff,
          "phase_s": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise SystemExit("the search's whole-net fine-tune failed (see its 'search' line)")
    tr, table = f"_b{SN_BATCH}", f"table_update_b{SN_BATCH}"
    for run, per_candidate, folded, tab in (
            (batched, SN_BATCH, SEARCH_STEP_ROWS, f"table_update_k{SEARCH_GROUP}{tr}"),
            (ln, SN_BATCH, SEARCH_STEP_ROWS, None), (seq, SN_BATCH, SN_BATCH, table)):
        for _, launches in run["log"].steps:
            add_group_launches(rows_out, launches, per_candidate, folded, tab)
    for run, per_candidate, folded in ((batched, SEARCH_CHUNK, SEARCH_CHUNK_ROWS),
                                       (ln, SEARCH_CHUNK, SEARCH_CHUNK_ROWS),
                                       (seq, SEARCH_CHUNK, SEARCH_CHUNK)):
        for launches in run["log"].evals:
            add_group_launches(rows_out, launches, per_candidate, folded, table)
    del model, train_batches, test_batches
    torch.cuda.empty_cache()


def phase_search_rank():
    """The JAX-trained proxy supernet in the port: the 24 initial candidates
    of its EA scored again with the proxy's protocol, ranked against the
    losses the TPU recorded (see the module docstring, phase 7)."""
    import pickle

    import numpy as np
    import torch

    from nasrec_tpu_torch.config import OPS_CONFIG_LIB
    from nasrec_tpu_torch.data.synthetic import SyntheticSpec, synthetic_batches
    from nasrec_tpu_torch.models.supernet import SuperNetConfig, supernet_init
    from nasrec_tpu_torch.models.transplant import from_jax_params
    from nasrec_tpu_torch.search import make_candidate_evaluator
    from nasrec_tpu_torch.train.checkpoint import load_any_checkpoint

    dev = torch.device(DEVICE)
    spec = SyntheticSpec(vocab=500, signal_scale=0.7, interaction_pairs=16,
                         interaction_scale=1.0)
    cfg = SuperNetConfig(space=OPS_CONFIG_LIB["xlarge-zeros"], num_blocks=2, num_dense=13,
                         num_sparse=26, vocab_sizes=(spec.vocab,) * 26, use_layernorm=True)
    t0 = time.perf_counter()
    model = supernet_init(cfg, seed=0, device=dev)
    ckpt = load_any_checkpoint(str(PROXY_DIR / "supernet_checkpoint.pkl"))
    model.load_state_dict(from_jax_params(ckpt["params"], cfg))
    with open(PROXY_DIR / "all_results.pickle", "rb") as f:
        records = pickle.load(f)[:RANK_CANDIDATES]
    ev = make_candidate_evaluator(cfg, model, learning_rate=0.04, max_train_steps=RANK_STEPS,
                                  max_eval_steps=RANK_EVAL_STEPS)
    train_iter_fn = lambda: synthetic_batches(1_000_000, SN_BATCH, spec, seed=303, loop=True,
                                              device=dev)
    test_iter_fn = lambda: synthetic_batches(200_000, 4096, spec, seed=1, device=dev)
    reset_launches()
    results = []
    for g in range(0, RANK_CANDIDATES, SEARCH_GROUP):
        results += ev([r["choice"] for r in records[g:g + SEARCH_GROUP]], train_iter_fn,
                      test_iter_fn)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    want = [r["test_loss"] for r in records]
    got = [r["test_loss"] for r in results]
    rho = spearman(want, got)
    ok = (all(math.isfinite(x) and x < 999 for x in got) and rho >= RANK_MIN_SPEARMAN
          and set(launches) == set(SEARCH_STEP_LAUNCHES))
    emit({"phase": "search_rank", "checkpoint": "experiments/search_quality_proxy "
          "(xlarge-zeros, 2 blocks, LayerNorm, vocab 500, trained by the JAX package)",
          "candidates": RANK_CANDIDATES, "steps": RANK_STEPS, "eval_steps": RANK_EVAL_STEPS,
          "spearman": rho, "min_spearman": RANK_MIN_SPEARMAN,
          "max_abs_diff": float(np.max(np.abs(np.subtract(want, got)))),
          "test_losses": got, "recorded_test_losses": want, "seconds": seconds,
          "launches": launches, "ok": ok})
    if not ok:
        raise SystemExit("the port's scores do not rank the proxy's candidates as recorded")
    del model, ev
    torch.cuda.empty_cache()


def phase_search_cli(ckpt: Path, tmp: Path):
    """The search and from-scratch CLIs on synthetic data (see the module
    docstring, phase 8)."""
    import pickle

    from nasrec_tpu_torch.cli import eval_subnet_from_scratch, eval_subnet_from_supernet

    base = ["--data_source", "synthetic", "--device", DEVICE, "--max_train_steps", "5",
            "--max_eval_steps", "1", "--train_batch_size", str(SN_BATCH)]
    reset_launches()
    t0 = time.perf_counter()
    top = eval_subnet_from_supernet.main(base + [
        "--method", "random", "--budget", "8", "--group_size", "8", "--config", "xlarge",
        "--num_blocks", str(SN_BLOCKS), "--ckpt_path", str(ckpt),
        "--test_batch_size", str(SEARCH_TEST_BATCH), "--logging_dir", str(tmp / "random")])
    random_s = time.perf_counter() - t0
    launches = read_launches()
    with open(tmp / "random" / "all_results.pickle", "rb") as f:
        explored = pickle.load(f)
    # One group of 8 candidates: 5 fine-tune steps and 8 eval chunks of the one
    # test batch, each launching every kernel once a block for the group.
    want = {k: v * (5 + SEARCH_TEST_BATCH // SEARCH_CHUNK) for k, v in SEARCH_STEP_LAUNCHES.items()}

    with open(PROXY_DIR / "results.pickle", "rb") as f:
        records = pickle.load(f)[:8]
    with open(tmp / "records.pickle", "wb") as f:
        pickle.dump(records, f)
    t0 = time.perf_counter()
    cached = eval_subnet_from_supernet.main(base + [
        "--method", "cached", "--choice_from_pickle_file", str(tmp / "records.pickle"),
        "--config", "xlarge-zeros", "--num_blocks", "2", "--synthetic_vocab", "500",
        "--ckpt_path", str(PROXY_DIR / "supernet_checkpoint.pkl"), "--test_batch_size", "4096",
        "--logging_dir", str(tmp / "cached")])
    cached_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    scratch = eval_subnet_from_scratch.main(base + [
        "--config", "xlarge", "--num_blocks", "7", "--num_subnets", "2",
        "--test_batch_size", "4096", "--learning_rate", "0.02", "--display_interval", "5",
        "--test_interval", "5", "--logging_dir", str(tmp / "scratch")])
    scratch_s = time.perf_counter() - t0
    losses = ([r["test_loss"] for r in explored] + [r["test_loss"] for r in cached]
              + [r["test_loss"] for r in scratch])
    ok = (len(explored) == 8 and len(top) == 2 and launches == want
          and (tmp / "random" / "results.pickle").is_file()
          and (tmp / "cached" / "results.pickle").is_file()
          and (tmp / "scratch" / "from_scratch_results.pickle").is_file()
          and [r["gt_test_loss"] for r in cached] == [r["test_loss"] for r in records]
          and len(scratch) == 2 and all(math.isfinite(x) and x < 999 for x in losses))
    emit({"phase": "search_cli", "random_test_losses": [r["test_loss"] for r in explored],
          "random_launches": launches,
          "cached_test_losses": [r["test_loss"] for r in cached],
          "cached_gt_test_losses": [r["gt_test_loss"] for r in cached],
          "scratch_test_losses": [r["test_loss"] for r in scratch],
          "seconds": [random_s, cached_s, scratch_s], "ok": ok})
    if not ok:
        raise SystemExit("a search CLI failed (see the 'search_cli' line)")


def profile_steps(arch: str, step_fn, steps: int) -> dict:
    """Where a main-path step's device time goes: torch.profiler over a few
    more kernel-path steps (after the comparison above), device time summed
    by kernel, and the device's busy share of the wall time.  Returns the
    line it prints."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # device kernels and copies only
            continue
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        rows.append((dev_us / 1e3 / steps, ev.key[:90], ev.count // steps))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    def listed(picked):
        return [{"op": k, "ms_per_step": ms, "calls_per_step": c} for ms, k, c in picked]

    # The port's own kernels wherever they rank, and the concatenations: the
    # dot-product node's [B, n, 16] operand was one (CatArrayBatchedCopy without
    # a suffix: it transposed as it copied) until the kernel took x and yt.
    own = ("dot_fwd_kernel", "dot_bwd_kernel", "table_update_kernel", "body_fwd_kernel",
           "body_bwd_kernel", "attn_fwd_kernel", "attn_bwd_kernel")
    line = {"phase": "profile", "arch": arch, "steps": steps,
            "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms * steps / wall_ms if wall_ms else None,
            "top_ops": listed(rows[:15]),
            "port_kernels": listed(r for r in rows if any(name in r[1] for name in own)),
            "cat_ops": listed(r for r in rows if "CatArray" in r[1])}
    emit(line)
    return line


def phase_cli(space, compute_dtype="float32"):
    """The CLI on synthetic data with a planted signal: 40 steps must lower
    the test loss and lift the test AUROC above chance.  (At the default
    lr 0.16 a run this short has a warmup of 0 steps and diverges, in the
    JAX package as here, so the phase trains at lr 0.02.)  compute_dtype
    "bfloat16" passes --compute_dtype bfloat16: the body and dot-product
    kernels launch in bf16, the segment-sum and the table update in f32."""
    import torch

    from nasrec_tpu_torch.cli import main_train

    reset_launches()
    t0 = time.perf_counter()
    out = main_train.main([
        "--arch", f"criteo-kaggle/{space}", "--data_source", "synthetic",
        "--device", DEVICE, "--max_train_steps", str(CLI_STEPS), "--max_eval_steps", "1",
        "--train_batch_size", "2048", "--test_batch_size", "8192",
        "--learning_rate", "0.02", "--display_interval", "10", "--test_interval", "20",
        "--compute_dtype", compute_dtype,
    ])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    logs = out["logs"][0]
    first, last = logs["test_loss"][0], logs["test_loss"][-1]
    arch = f"criteo-kaggle/{space}"
    train_k, eval_k = TRAIN_STEP_KERNELS[arch], EVAL_KERNELS[arch]
    if compute_dtype == "bfloat16":
        train_k, eval_k = bf16_named(train_k), bf16_named(eval_k)
    # Each train step launches every kernel of a train step once; the eval
    # forwards, under no_grad, launch the forward kernels.
    ok = (all(math.isfinite(x) for x in logs["train_loss"]) and math.isfinite(last)
          and last < first and logs["test_AUROC"][-1] > 0.6
          and set(launches) == train_k | eval_k
          and all(launches[k] >= CLI_STEPS for k in train_k)
          and all(launches[k] >= 1 for k in eval_k)
          and all(p.dtype == torch.float32 for p in out["state"].model.parameters()))
    emit({"phase": "cli", "arch": f"criteo-kaggle/{space}", "compute_dtype": compute_dtype,
          "train_loss": logs["train_loss"], "test_loss": logs["test_loss"],
          "test_auroc": logs["test_AUROC"], "launches": launches, "seconds": seconds, "ok": ok})
    if not ok:
        raise SystemExit(f"CLI entry point did not learn the synthetic signal ({space}, "
                         f"{compute_dtype})")


def phase_supernet_cli_bf16(tmp: Path) -> None:
    """nasrec_tpu_torch.cli.train_supernet --compute_dtype bfloat16 at 7
    blocks and batch 512 for SN_BF16_CLI_STEPS steps: finite losses, every
    step's kernels launched in bf16 (the segment-sum and the table update in
    f32), and the flag
    in configs_args.json."""
    from nasrec_tpu_torch.cli import train_supernet

    reset_launches()
    t0 = time.perf_counter()
    out = train_supernet.main([
        "--data_source", "synthetic", "--device", DEVICE, "--config", "xlarge",
        "--num_blocks", str(SN_BLOCKS), "--use_layernorm", "1",
        "--train_batch_size", str(SN_BATCH), "--test_batch_size", str(SN_EVAL_BATCH),
        "--max_eval_steps", "1", "--display_interval", "1",
        "--supernet_training_steps", str(SN_WARMUP), "--learning_rate", "0.02",
        "--compute_dtype", "bfloat16", "--max_train_steps", str(SN_BF16_CLI_STEPS),
        "--test_interval", str(SN_BF16_CLI_STEPS), "--logging_dir", str(tmp / "bf16")])
    seconds = time.perf_counter() - t0
    launches = read_launches()
    logs = out["logs"][0]
    expected = bf16_named({k: v * SN_BF16_CLI_STEPS for k, v in SN_STEP_LAUNCHES.items()})
    for k, v in bf16_named(SN_EVAL_LAUNCHES).items():
        expected[k] = expected.get(k, 0) + v * len(logs["test_loss"])
    with open(tmp / "bf16" / "configs_args.json") as f:
        flag = json.load(f)["train"]["compute_dtype"]
    ok = (all(math.isfinite(x) for x in logs["train_loss"] + logs["test_loss"])
          and out["state"].step == SN_BF16_CLI_STEPS and launches == expected
          and flag == "bfloat16")
    emit({"phase": "supernet_cli", "compute_dtype": flag, "train_loss": logs["train_loss"],
          "test_loss": logs["test_loss"], "steps": out["state"].step, "launches": launches,
          "seconds": seconds, "ok": ok})
    if not ok:
        raise SystemExit("the supernet CLI did not train in bf16")


def dense_diff(model_a, model_b) -> float:
    """Largest difference of the parameters other than the table."""
    sd_a, sd_b = model_a.state_dict(), model_b.state_dict()
    return max((sd_a[k] - sd_b[k]).abs().max().item() for k in sd_a if k != "embedding.table")


def phase_multi_device(rows_out, main_step_ms: float) -> None:
    """Phases 10a and 10b: the host-RAM table and the mesh at world size 1,
    criteo-kaggle/xlarge at full vocab and batch 32768, each against the
    one-device sparse step from the same weights and batches (see the module
    docstring)."""
    import numpy as np
    import torch

    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.models.embedding import table_offsets
    from nasrec_tpu_torch.models.fixed import fixed_init
    from nasrec_tpu_torch.parallel import distributed
    from nasrec_tpu_torch.parallel.mesh import make_mesh
    from nasrec_tpu_torch.parallel.sparse import make_parallel_sparse_train_step
    from nasrec_tpu_torch.parallel.train import shard_train_state
    from nasrec_tpu_torch.parallel.host_embedding import (
        HostEmbedding,
        detach_table,
        make_host_offload_train_step,
    )
    from nasrec_tpu_torch.tools.multihost_demo import free_port
    from nasrec_tpu_torch.train.loop import init_train_state
    from nasrec_tpu_torch.train.optim import make_lr_schedule, make_optimizer
    from nasrec_tpu_torch.train.sparse_embedding import (
        init_sparse_train_state,
        make_sparse_embedding_train_step,
        table_accumulator,
    )

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    vocab = DATASETS["criteo-kaggle"].vocab_sizes(VOCAB_CAP)
    plan = best_plan(XL, vocab)
    sched = make_lr_schedule("cosine", 0.16, 10_000, 1_000)
    batches = device_batches(np.random.RandomState(10), MD_STEPS, BATCH, vocab)
    model0 = fixed_init(plan, seed=0, device=dev)
    # The one-device sparse step: the reference of both.
    ref = copy.deepcopy(model0)
    ref_state = init_sparse_train_state(ref)
    ref_losses, ref_times, _ = run_steps(
        make_sparse_embedding_train_step(sched, grad_clip=5.0), ref_state, batches)
    touched = torch.unique(torch.cat([ref.embedding.fused_index(c).reshape(-1).long()
                                      for _, c, _ in batches]))
    ref_acc = table_accumulator(ref_state.opt_state)
    want = {k: MD_STEPS for k in TRAIN_STEP_KERNELS[XL]}

    # 10a: the table and its accumulator in host RAM.
    off = copy.deepcopy(model0)
    host = HostEmbedding(detach_table(off), table_offsets(vocab))
    torch.cuda.empty_cache()
    adagrad = make_optimizer("adagrad")
    timings = {}
    step = make_host_offload_train_step(adagrad, sched, host, grad_clip=5.0, timings=timings)
    off_state = init_train_state(off, adagrad)
    reset_launches()
    off_losses, off_times, _ = run_steps(step, off_state, batches[:1])
    timings.clear()             # the warm-up step's split is not kept
    more_losses, more_times, _ = run_steps(step, off_state, batches[1:])
    launches = read_launches()
    off_losses += more_losses
    rows_np = touched.cpu().numpy()
    table_err = float(np.abs(host.table[rows_np]
                             - ref.embedding.table[touched].cpu().numpy()).max())
    acc_err = float(np.abs(host.acc[rows_np] - ref_acc[touched].cpu().numpy()).max())
    # The reference's largest movement from the start (the accumulator starts at 0).
    table_moved = (ref.embedding.table[touched] - model0.embedding.table[touched]).abs().max().item()
    acc_moved = ref_acc[touched].abs().max().item()
    loss_err = max(abs(a - b) for a, b in zip(off_losses, ref_losses))
    param_err = dense_diff(off, ref)
    split = {k: v / (MD_STEPS - 1) * 1e3 for k, v in timings.items()}
    # The host clips: the card runs the list update alone.
    want_off = {k: MD_STEPS for k in TRAIN_STEP_KERNELS[XL] - TABLE_KERNELS - {"clip_scale"}}
    ok = (loss_err <= OFFLOAD_TOL and param_err <= OFFLOAD_TOL
          and table_err <= OFFLOAD_REL * table_moved and acc_err <= OFFLOAD_REL * acc_moved
          and table_moved > 0 and acc_moved > 0 and launches == want_off
          and all(math.isfinite(x) for x in off_losses))
    emit({"phase": "offload", "arch": "criteo-kaggle/xlarge", "vocab_rows": int(sum(vocab)),
          "batch": BATCH, "steps": MD_STEPS, "warmup_steps": 1,
          "losses": off_losses, "losses_on_device": ref_losses, "max_loss_diff": loss_err,
          "max_dense_param_diff": param_err, "touched_rows": int(touched.numel()),
          "max_touched_table_diff": table_err, "max_touched_accumulator_diff": acc_err,
          "max_touched_table_moved": table_moved, "max_touched_accumulator_moved": acc_moved,
          "touched_table_diff_rel": table_err / max(table_moved, 1e-30),
          "touched_accumulator_diff_rel": acc_err / max(acc_moved, 1e-30),
          "step_ms": float(np.mean(more_times)) * 1e3,
          "step_ms_all": [x * 1e3 for x in off_times + more_times],
          "on_device_step_ms": float(np.median(ref_times[1:])) * 1e3,
          "split_ms_per_step": split, "launches": launches, "ok": ok})
    if not ok:
        raise SystemExit("the host-offload step disagrees with the on-device step "
                         "(see the 'offload' line)")
    add_launches(rows_out, launches)
    del off, off_state, host, step
    torch.cuda.empty_cache()

    # 10b: the mesh at world size 1, over an NCCL group of one rank.
    distributed.start(f"tcp://127.0.0.1:{free_port()}", 1, 0, DEVICE)
    try:
        mesh = make_mesh(model=1)
        m_model = copy.deepcopy(model0)
        m_state = shard_train_state(init_sparse_train_state(m_model), mesh)
        step = make_parallel_sparse_train_step(sched, mesh, grad_clip=5.0)
        reset_launches()
        m_losses, m_times, _ = run_steps(step, m_state, batches)
        launches = read_launches()
        backend = torch.distributed.get_backend()
    finally:
        distributed.shutdown()
    loss_err = max(abs(a - b) for a, b in zip(m_losses, ref_losses))
    param_err = state_diff(m_model, ref)
    acc_err = (table_accumulator(m_state.opt_state) - ref_acc).abs().max().item()
    mesh_ms = float(np.median(m_times[1:])) * 1e3
    ok = (loss_err <= LOSS_TOL and param_err <= PARAM_TOL and acc_err <= PARAM_TOL
          and launches == want and backend == "nccl")
    emit({"phase": "mesh", "arch": "criteo-kaggle/xlarge", "world_size": 1, "backend": backend,
          "mesh": [mesh.data, mesh.model], "batch": BATCH, "steps": MD_STEPS,
          "losses": m_losses, "losses_one_device": ref_losses, "max_loss_diff": loss_err,
          "max_param_diff": param_err, "max_accumulator_diff": acc_err,
          "step_ms": mesh_ms, "step_ms_all": [x * 1e3 for x in m_times],
          "one_device_step_ms": float(np.median(ref_times[1:])) * 1e3,
          "phase3_step_ms": main_step_ms, "launches": launches,
          "phase_s": time.perf_counter() - t_phase, "ok": ok})
    if not ok:
        raise SystemExit("the mesh step at world size 1 disagrees with the one-device step "
                         "(see the 'mesh' line)")
    add_launches(rows_out, launches)
    del model0, ref, ref_state, m_model, m_state, batches
    torch.cuda.empty_cache()


def phase_fanout(ckpt: Path, tmp: Path) -> None:
    """Phase 10d: the search CLI in two processes on the one card against one
    process (see the module docstring)."""
    from nasrec_tpu_torch.tools import search_fanout_demo as fanout

    cli = ["-m", "nasrec_tpu_torch.cli.eval_subnet_from_supernet",
           "--data_source", "synthetic", "--max_train_steps", "5", "--max_eval_steps", "1",
           "--train_batch_size", str(SN_BATCH), "--method", "random",
           "--budget", str(FANOUT_CANDIDATES), "--group_size", str(SEARCH_GROUP),
           "--config", "xlarge", "--num_blocks", str(SN_BLOCKS), "--ckpt_path", str(ckpt),
           "--test_batch_size", str(SEARCH_TEST_BATCH)]
    single_s, single_out = fanout.run_single(cli, str(tmp / "fanout1"), DEVICE, 600)
    pair_s, pair_out = fanout.run_pair(cli, str(tmp / "fanout2"), DEVICE, 600)
    # Every process took its groups down: no abort text, no undestroyed group.
    clean_exit = not any(fanout.exit_faults(o) for o in single_out + pair_out)
    # The search's own seconds: one process's, and the longer of the pair's
    # two (each evaluates its own group at the same time as the other).
    search_s = [fanout.search_seconds(single_out[0]),
                max(fanout.search_seconds(o) for o in pair_out)]
    try:
        n = fanout.compare(str(tmp / "fanout1"), str(tmp / "fanout2"), rel_tol=FANOUT_TOL)
        ok = n == FANOUT_CANDIDATES
    except AssertionError as e:
        n, ok = repr(e)[:300], False
    emit({"phase": "fanout", "candidates": n, "processes": [1, 2],
          "wall_seconds": [single_s, pair_s],
          "wall_seconds_per_candidate": [single_s / FANOUT_CANDIDATES,
                                         pair_s / FANOUT_CANDIDATES],
          "search_seconds": search_s,
          "search_seconds_per_candidate": [x / FANOUT_CANDIDATES for x in search_s],
          "clean_exit": clean_exit, "ok": ok and clean_exit and all(x > 0 for x in search_s)})
    if not (ok and clean_exit):
        raise SystemExit("the two-process search differs from one process, or a process "
                         "left a process group up (see the 'fanout' line)")


def phase_orbax(tmp: Path) -> None:
    """Phase 10e: the supernet CLI with --ckpt_backend orbax writes the
    directory, which reloads into the run's weights bit for bit, and a run
    resumes from it at its step."""
    import torch

    from nasrec_tpu_torch.cli import train_supernet
    from nasrec_tpu_torch.models.transplant import from_jax_params
    from nasrec_tpu_torch.train.checkpoint import load_any_checkpoint

    base = ["--data_source", "synthetic", "--device", DEVICE, "--config", "xlarge",
            "--num_blocks", str(SN_BLOCKS), "--use_layernorm", "1",
            "--train_batch_size", str(SN_BATCH), "--test_batch_size", str(SN_EVAL_BATCH),
            "--max_eval_steps", "1", "--display_interval", "1",
            "--supernet_training_steps", str(SN_WARMUP), "--learning_rate", "0.02",
            "--ckpt_backend", "orbax"]
    reset_launches()
    t0 = time.perf_counter()
    first = train_supernet.main(base + [
        "--max_train_steps", str(ORBAX_STEPS), "--test_interval", str(ORBAX_STEPS),
        "--logging_dir", str(tmp / "orbax1")])
    first_s = time.perf_counter() - t0
    launches = read_launches()
    ckpt_dir = tmp / "orbax1" / "supernet_checkpoint.orbax"
    t0 = time.perf_counter()
    ckpt = load_any_checkpoint(str(ckpt_dir))
    load_s = time.perf_counter() - t0
    got = from_jax_params(ckpt["params"], first["cfg"])
    want = first["state"].model.state_dict()
    exact = all(torch.equal(got[k], want[k].cpu()) for k in want)
    second = train_supernet.main(base + [
        "--max_train_steps", "1", "--test_interval", "1",
        "--logging_dir", str(tmp / "orbax2"), "--checkpoint_path", str(ckpt_dir)])
    expected = {k: v * ORBAX_STEPS for k, v in SN_STEP_LAUNCHES.items()}
    for k, v in SN_EVAL_LAUNCHES.items():
        expected[k] = expected.get(k, 0) + v * len(first["logs"][0]["test_loss"])
    files = sorted(p.name for p in ckpt_dir.iterdir())
    ok = (files == ["arrays", "sidecar.json"] and exact and int(ckpt["step"]) == ORBAX_STEPS
          and second["state"].step == ORBAX_STEPS + 1 and launches == expected
          and all(math.isfinite(x) for x in second["logs"][0]["train_loss"]))
    emit({"phase": "orbax", "files": files, "step": int(ckpt["step"]),
          "resumed_step": second["state"].step, "reload_bit_exact": exact,
          "seconds": [first_s, load_s], "launches": launches, "ok": ok})
    if not ok:
        raise SystemExit("the directory checkpoint did not reload or resume "
                         "(see the 'orbax' line)")


def phase_datasets(rows_out, tmp: Path, hbm) -> None:
    """Phase 11: the published best archs of avazu and kdd on the card (see
    the module docstring); the xlarge two also fed from TSV shards of their
    datasets' columns, as phase 3a feeds criteo-kaggle/xlarge."""
    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.data import pipeline
    from nasrec_tpu_torch.data.synthetic import write_tsv_shards

    t_phase = time.perf_counter()
    for arch in DS_ARCHS:
        step_ms = phase_main(arch, rows_out, "datasets")
        phase_amp(arch, rows_out, step_ms, "datasets")
        if not arch.endswith("/xlarge"):
            continue
        spec = DATASETS[arch.split("/")[0]]
        root = tmp / f"tsv_{spec.name}"
        t0 = time.perf_counter()
        write_tsv_shards(str(root), spec.num_dense, spec.num_sparse,
                         {"trainval": DS_TSV_ROWS}, DS_TSV_SHARDS, seed=0)
        write_s = time.perf_counter() - t0
        train_fn, _ = pipeline.make_dataset_iterators(
            spec.name, str(root), train_batch_size=BATCH, test_batch_size=BATCH,
            vocab_cap=VOCAB_CAP, use_native=True)
        res = tsv_vs_plain_and_timed(arch, train_fn, DS_TSV_TIMED_STEPS, 1, rows_out)
        emit({"phase": "datasets", "data": "tsv", "rows": DS_TSV_ROWS,
              "shards": DS_TSV_SHARDS, "write_s": write_s, "synthetic_step_ms": step_ms,
              **res})
        if not res["ok"]:
            raise SystemExit(f"{arch} on TSV shards failed (see its 'datasets' line)")
    phase_launchers(tmp, rows_out, hbm)
    emit({"phase": "datasets", "phase_s": time.perf_counter() - t_phase})


def launches_by_batch(cli: str, args: list, launches: dict):
    """A launcher run's launches split by the batch they ran at, as
    [(batch, launches)], or None where they do not split as the CLI's steps
    say: main_train runs at one batch (its test batch set to its train
    batch); train_supernet LAUNCH_STEPS steps at its train batch (each
    SN_STEP_LAUNCHES) and eval forwards at its test batch (each
    SN_EVAL_LAUNCHES); the search LAUNCH_STEPS fine-tune steps at its train
    batch and its test batch in eval chunks of SEARCH_CHUNK, each a group
    step's launches, on one group of its candidates folded into each launch
    (K x the batch rows)."""
    def flag(name):                    # argparse keeps a flag's last value
        return int(args[len(args) - args[::-1].index(name)])

    train_b = flag("--train_batch_size")
    if cli == "main_train":
        return [(train_b, launches)]
    test_b = flag("--test_batch_size")
    if cli == "train_supernet":
        train = {k: v * LAUNCH_STEPS for k, v in SN_STEP_LAUNCHES.items()}
        if any(launches.get(k, 0) < v for k, v in train.items()):
            return None
        ev = launch_diff(launches, train)
        evals = ev.get("transformer_body_fwd_s64", 0) // SN_BLOCKS
        if not evals or ev != {k: v * evals for k, v in SN_EVAL_LAUNCHES.items()}:
            return None
        return [(train_b, train), (test_b, ev)]
    chunks = test_b // SEARCH_CHUNK
    calls = LAUNCH_STEPS + chunks
    if any(v % calls for v in launches.values()):
        return None
    group = min(flag("--group_size"), flag("--init_population"))
    return [(group * train_b, {k: v // calls * LAUNCH_STEPS for k, v in launches.items()}),
            (group * SEARCH_CHUNK, {k: v // calls * chunks for k, v in launches.items()})]


def phase_launchers(tmp: Path, rows_out, hbm) -> None:
    """Each avazu and kdd launcher of nasrec_tpu_torch/scripts/ through its
    CLI's main on the card: the flags read from the launcher file, then
    synthetic data, a few steps and the run's own directories.  Losses
    finite, the kernels of the run's model launched, the CLI's files
    written; the search runs on the checkpoint of the dataset's supernet run.
    Each run's launches go into the rows of their shapes and batches
    (`join_launches`: a shape without a row is checked and timed first); the
    table update's into the row of the run's synthetic table."""
    import importlib
    import pickle

    import torch

    from nasrec_tpu_torch.config import DATASETS
    from nasrec_tpu_torch.tools.launchers import LAUNCHER_DIR, launcher_command
    from nasrec_tpu_torch.workloads import DataOptions

    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(11)
    for dataset in DS_DATASETS:
        ckpt = None
        table = (f"table_update_{dataset}_synthetic",
                 (DataOptions.synthetic_vocab,) * DATASETS[dataset].num_sparse)
        for pattern in DS_LAUNCHERS:
            rel = pattern.format(dataset)
            module, args = launcher_command(LAUNCHER_DIR / rel)
            cli = module.rsplit(".", 1)[1]
            log_dir = tmp / "launchers" / rel.replace("/", "_").replace(".sh", "")
            extra = ["--data_source", "synthetic", "--device", DEVICE,
                     "--max_train_steps", str(LAUNCH_STEPS), "--max_eval_steps", "1",
                     "--logging_dir", str(log_dir)]
            if cli == "main_train":
                batch = args[args.index("--train_batch_size") + 1]
                extra += ["--test_batch_size", batch, "--test_interval", str(LAUNCH_STEPS)]
                arch = args[args.index("--arch") + 1]
                want = TRAIN_STEP_KERNELS[arch] | EVAL_KERNELS[arch]
            elif cli == "train_supernet":
                extra += ["--test_interval", str(LAUNCH_STEPS)]
                want = set(SN_STEP_LAUNCHES) | set(SN_EVAL_LAUNCHES)
            else:
                extra += ["--ckpt_path", str(ckpt), "--init_population", str(LAUNCH_CANDIDATES),
                          "--n_generations", "0", "--sample_size", str(LAUNCH_CANDIDATES // 2)]
                want = set(SEARCH_STEP_LAUNCHES)
            reset_launches()
            t0 = time.perf_counter()
            out = importlib.import_module(module).main(args + extra)
            seconds = time.perf_counter() - t0
            launches = read_launches()
            files = sorted(p.name for p in log_dir.iterdir())
            if cli == "eval_subnet_from_supernet":
                with open(log_dir / "all_results.pickle", "rb") as f:
                    losses = [r["test_loss"] for r in pickle.load(f)]
                ok = len(losses) == LAUNCH_CANDIDATES and all(x < 999 for x in losses)
            else:
                logs = out["logs"][0]
                losses = logs["train_loss"] + logs["test_loss"]
                ok = (out["state"].step == LAUNCH_STEPS
                      and launches.get("table_update") == LAUNCH_STEPS)
            if cli == "train_supernet":
                ckpt = log_dir / "supernet_checkpoint.pkl"
            by_batch = launches_by_batch(cli, args + extra, launches)
            ok = (ok and all(math.isfinite(x) for x in losses) and set(launches) == want
                  and LAUNCH_FILES[cli] <= set(files) and by_batch is not None)
            emit({"phase": "datasets", "launcher": f"nasrec_tpu_torch/scripts/{rel}",
                  "module": module, "overrides": extra, "losses": losses, "files": files,
                  "launches": launches, "launches_by_batch": by_batch, "seconds": seconds,
                  "ok": ok})
            if not ok:
                raise SystemExit(f"the launcher {rel} failed (see its 'datasets' line)")
            for batch, counts in by_batch:
                join_launches(rows_out, counts, batch, hbm, gen, table)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / "nasrec_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the nasrec_tpu_torch package is not next to {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nasrec_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    smi = phase_device(build)
    rows_out = phase_kernels(hbm_bytes_per_s(smi))
    step_ms = {arch: phase_main(arch, rows_out) for arch in (XL, AC)}
    for arch in (XL, AC):
        phase_amp(arch, rows_out, step_ms[arch])
    tmp = Path(tempfile.mkdtemp(prefix="nasrec_smoke_"))
    try:
        phase_data(rows_out, tmp, step_ms[XL])
        phase_dense(rows_out, step_ms[XL])
        phase_micro(rows_out)
        phase_dcnv2(hbm_bytes_per_s(smi))
        phase_supernet(rows_out)
        phase_supernet(rows_out, "bfloat16")
        for space in ("autoctr", "xlarge"):
            phase_cli(space)
        phase_cli("xlarge", "bfloat16")
        ckpt = phase_supernet_cli(tmp)
        phase_supernet_cli_bf16(tmp)
        phase_search(rows_out)
        phase_search_rank()
        phase_search_cli(ckpt, tmp)
        phase_profiling(ckpt, tmp, rows_out, hbm_bytes_per_s(smi))
        phase_multi_device(rows_out, step_ms[XL])
        phase_fanout(ckpt, tmp)
        phase_orbax(tmp)
        phase_datasets(rows_out, tmp, hbm_bytes_per_s(smi))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    idle = [name for name, row in rows_out.items() if not row.get("launches")]
    if idle:
        raise SystemExit(f"kernels that no main path launched: {idle}")
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": list(rows_out.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
