#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Each phase prints one JSON line; any failure raises and the script exits
non-zero without printing a result. Without a CUDA card, or without the
``ray_tpu_torch`` package beside it, it exits non-zero at once.

1. build: compile the flash-attention kernels (forward and backward dQ,
   dK/dV, each on the tensor cores and on the CUDA cores, the tiled f32
   forward, dQ and dK/dV up to head_dim 256, and for head_dim above 256
   the wide kernels: all three on the CUDA cores, on the tensor cores,
   and in f32) from ray_tpu_torch/ops/csrc, one nvcc per source (the two
   libraries no rule reaches with nvcc's split compilation), in parallel,
   with ptxas's registers and spills per kernel; the SASS of
   every tensor-core kernel instantiation (bf16 and f16 at head_dim 64,
   128 and 256; the wide forward, dQ and dK/dV with their rows held or
   streamed) must hold HGMMA (wgmma) and UTMALDG (TMA load)
   instructions, the wide tensor-core forward and dQ must spill nothing,
   and every
   instance of the f32 library's kernels (the wide forward, dQ and dK/dV,
   and the tiled forward, dQ and dK/dV up to head_dim 256) must hold FFMA
   and no HMMA or HGMMA (no TF32) and spill nothing. The Triton RMSNorm
   kernel compiles at its first launch.
2. kernels: the forward against its plain PyTorch version with the
   kernels' rounding points (_dense_kernel: q * scale rounded to the input
   type, f32 scores, as the reference's kernel rounds) on the card at
   the flagship's prefill widths (B=4, Hq=8, Hkv 8, 4 or 2, S
   128/512/2048, D=64, causal and not, bf16 and f32), plus S=200, Sq=77 /
   Sk=131 and one D=128 case; bf16 takes the tensor-core kernel, f32 the
   tiled f32 one (CUDA cores), and each case checks which launched; the
   earlier CUDA-core forward (flash_attention_fwd.cu, reached by no rule)
   is held against the plain version on every f32 case's inputs. Times at
   S=2048 and S=512 beside the plain version's, the earlier CUDA-core
   kernel on the same inputs, PyTorch's
   scaled_dot_product_attention (a yardstick the port never calls) and the
   card's bound. Then the
   backward kernels against the plain backward (B=4, H=8, D=64, S
   128/512/2048/200, plus D=128 at S 512/200 and Sq=77 / Sk=131), bf16 on
   the tensor cores and f32 on the tiled f32 pair (CUDA cores), each case
   checking which variant launched and reading a planted fault, and the
   earlier f32 pair (flash_attention_bwd.cu, reached by no rule) held
   against the plain backward on the same f32 inputs; at S=2048 both
   dtypes are timed through CUDA graphs beside the plain backward, SDPA's
   backward and the bound, and beside the CUDA-core kernels that the rule
   took before on the same inputs; and the RMSNorm kernel at [4*2048,
   512], timed beside
   torch.nn.functional.rms_norm. The shapes and dtypes beyond the bf16
   flagship (C1_FWD_CASES, C1_BWD_CASES): head_dim 256 in f32, bf16 and
   f16 (GQA down to one KV head), head_dim 128 in bf16 and f16 (and f32
   for the backward), head_dim 64 in f16 and head_dim 200, each checked
   at O_ROW_TOL / GRAD_ROW_TOL of its dtype with a planted fault and a
   check of the variant launched (bf16 and f16 on the tensor cores, f32
   on the CUDA cores: the tiled f32 forward, dQ and dK/dV);
   the CUDA-core kernels that took a case before are held against the
   plain version on the same inputs too; at S=2048 each is timed beside
   SDPA, the bound and those earlier kernels.
   The head dims between the tensor-core instances (ANY_DIMS: 8, 32, 80,
   96, 136, 160, 200, 248, zero-padded to the next instance) the same way,
   bf16 and f16, forward MHA and GQA (Hkv 8, 4, 1) and backward (and f32
   at ANY_F32_DIMS, 96 and 200), at S 128, 200, 2048 and
   Sq 77 / Sk 131, causal and not, launching only the kernels of the
   rule; ANY_TIMED_DIMS (32, 80, 96, 160, 200) timed (bf16 and f16) at
   S=2048 beside SDPA (its backend named), the CUDA-core kernels and the
   bound of the real head_dim's work. head_dim 12 takes the counted plain
   route: no launch, one plain_routes, the plain result; so do a query
   or key length under 8 (Sq 4 / Sk 16, Sq 16 / Sk 5; bf16, head_dim 64,
   MHA and GQA), as the reference falls back there; head_dim 264 (f32)
   through flash_attention launches the f32 wide kernel. The wide
   kernels (head_dim above 256, the head dimension of the output split
   across blocks): forward, dQ and dK/dV at head_dim 264, 512 and 1024 in
   f32, bf16 and f16, and at 1032 and 2048 (the tensor-core forward
   streams Q) in bf16 and f16, up to S=512 (phase 2b's shape), causal and
   not,
   against the plain versions with a planted fault each (the dQ kernel's
   delta against rowsum(dO * O)), launching the kernels of the rule once
   each and nothing else (bf16 and f16: the tensor-core forward, dQ and
   dK/dV; f32: those of flash_attention_wide_f32.cu), and the CUDA-core
   forward, dQ and dK/dV of flash_attention_wide.cu (the earlier design)
   on the same inputs; at B=4, H=8, S=2048, D=512, causal, in bf16, f16
   and f32 (and D=384 in bf16 and f16, and D 1032 and 2048 in bf16),
   held against the plain versions with a planted fault again and timed
   through CUDA graphs beside the CUDA-core kernels on the same inputs
   (above 1024, where each takes up to seconds, one call each by CUDA
   events), the plain versions, SDPA (with the backend it picks) and the
   bound.
2b. c1_models: nine configs the reference serves and trains, at the
   flagship's depth-2 cut: head_dim 256 (d_model 2048 over 8 heads, bf16;
   and over 8 query heads and one KV head, Gemma-2B's attention widths),
   head_dim 512 (d_model 1024 over 2 heads: the tensor-core wide forward,
   dQ and dK/dV in bf16, the f32 wide ones in f32), head_dim 1032
   (d_model 2064 over 2 heads, bf16: the tensor-core wide kernels, the
   forward streaming Q, a last chunk of 8 columns), the
   flagship in float16, head_dim 12 (d_model 384 over 32 heads, GQA 8,
   bf16), head_dim 96 (Phi-3-mini's d_model 3072 over 32 heads, bf16) and
   head_dim 80 (Phi-2's d_model 2560 over 32 heads, f16). Each serves 4
   prompts through prefill_with_cache and 8 decode_steps (prefill logits
   equal prefill_chunk's) and takes a gradient pass and 2 AdamW steps
   (finite, the tensor-core kernels at head_dim 256, 96 and 80 and in f16,
   the wide ones of the rule at 512 and 1032, launched n_layers times per
   pass and
   no other variant; head_dim 12 launches nothing and counts n_layers
   plain routes
   per forward). From here on the flagship's phases must count no plain
   route.
3. model: the flagship TransformerConfig() (and its GQA variant,
   n_kv_heads=4) serves 4 prompts through prefill_with_cache (the flash
   path) and 32 greedy decode_steps; the kernel must launch n_layers times
   per prefill (the bf16 flagship: the tensor-core variant), and
   prefill_chunk (plain paged attention) must agree, as must the
   cacheless forward at a length that is no multiple of 128.
4. engine: InferenceEngine answers 8 concurrent greedy requests equal to
   their sequential runs; in f32, its tokens equal the flash path's.
5. train: the flagship at full width and depth (and its GQA variant) on
   4 x 2048 tokens. In f32, loss_fn's gradients through the kernels equal
   those through plain attention, with and without remat, and a planted
   fault (GQA heads expanded in the wrong order) reads above the
   tolerance; each pass
   launches the tiled f32 forward n_layers times (2 * n_layers with remat)
   and each kernel of the tiled f32 backward pair n_layers times. In bf16,
   the loss
   through the kernels equals the loss through plain attention
   (TRAIN_LOSS_TOL_BF16), and a pass launches the tensor-core forward
   n_layers times (2 * n_layers with remat) and each tensor-core backward
   kernel n_layers times, never a CUDA-core kernel. Then 5
   bf16 AdamW steps
   (make_train_step) on one fixed batch: finite losses, the last below
   the first, and the step time as a smoke reading; then 2 more steps
   under torch.profiler split the step into kernel time (flash kernels
   and the rest) and the device's idle share. The flagship (MHA) then
   takes one more step under ray_tpu_torch.util.profiling.profile_trace
   inside an annotate span: the Chrome trace must hold the span and, by
   name, as many CUDA kernel events of the tensor-core forward, dQ and
   dK/dV as the launch counters say ran (one line prints the counts).
   Last, checkpoints (ray_tpu_torch.train.Checkpoint): 4 bf16 AdamW steps
   from f32 masters run through, against 2 steps, a checkpoint of the
   parameters and the AdamW state in a temporary directory, a fresh step
   built from other initial weights with both restored, and 2 more:
   losses and parameters equal bit for bit (a second uninterrupted run
   says whether an op is nondeterministic); save and load ms and the
   checkpoint's bytes are printed.
6. spec_disagg: speculative decoding and the engine side of
   disaggregated serving at the flagship's width, on phase 4's 8 prompts
   (32 new tokens, spec_k 4, 512 blocks), through the engines' paged
   attention (no kernel of phases 1-2 runs here). (a) f32 with a random
   draft (draft_config: 2 layers, d_model 256): the 8 concurrent greedy
   streams equal the vanilla engine's, the spec counters are consistent
   and no round falls back. (b) f32 self-draft: streams equal vanilla;
   with one spec round per request the acceptance is at least
   SPEC_SELF_ACCEPT_MIN_F32. (c) bf16, random draft and self-draft: each
   stream equals vanilla up to its first divergence, where vanilla's
   top-two logit gap must be below SPEC_TIE_TOL_BF16; the yardstick, the
   largest |verify_step - decode_step| logit difference on the same
   contexts, is printed beside it. (d) The shift pair (vocab = d_model =
   512, shift_params) accepts exactly 1.0 and emits k + 1 tokens a
   round, bf16 and f32. (e) KV transfer in bf16 and f32: every prompt
   held after prefill on one engine, exported, adopted on another
   (begin_adopted / adopt_kv / commit_adopted) and decoded, equal token
   for token to a colocated run; a cached-prefix adoption and a tail-only
   ship of the 570-token prompt; a stale-plan payload refused and aborted
   clean; two full ships between spec-armed engines (the draft's pool
   ships too) equal to a colocated spec engine; no block left in use.
   (f) A fully cached prompt on a spec engine copies its boundary block
   on write in both pools while the donor holds it, and both streams
   equal vanilla's. Smoke readings: tokens/s and token gaps of the bf16
   spec engines beside the vanilla engine, acceptance rates, and the
   export and graft ms, blocks and bytes of each shipped prompt.
7. moe: the flagship with num_experts=8, moe_every=2 at full width and
   depth (the reference's dense fallback: every expert on every token,
   top-1 kept). 4 prompts through prefill_with_cache (the tensor-core
   forward n_layers times) and 32 greedy decode_steps; the
   InferenceEngine's 8 concurrent greedy requests equal their sequential
   runs; in f32, loss_fn's gradients through the kernels equal those
   through plain attention (routing decisions compared first, the
   smallest top-two gap printed); 5 bf16 AdamW steps on 4 x 2048 tokens
   give finite losses, the last below the first, with the tensor-core
   kernels launched n_layers times each per pass. Step time and tokens/s
   are smoke readings, with 2 more steps under torch.profiler (kernel
   time and the device's idle share).
8. dag: the compiled-DAG wave executor (experimental_compile(
   backend="torch")) on bench.py's microbenchmark DAGs, rebuilt through
   the port's remote: chain_1k_noop (1000 tasks), fanout_10k (10 000
   noop leaves through reduce_tree(combine, arity=4), 13 334 tasks),
   elementwise_1k (payload (1024,)) and matmul_heavy (payload (64, 64)),
   width 64, depth 15, 1023 tasks each. Static and dynamic, each equal to
   a plain evaluator (topological order, each function called once):
   scalar DAGs exactly, tensor DAGs at the reference's rtol (1e-5, 1e-3).
   Readings: tasks/s over DAG_EXECS back-to-back data-dependent executes
   with one sync at the end, p50 / p99 of a synchronous execute + get,
   graph replays and host launches per execute, and under torch.profiler
   the device's busy time per execute and idle share.
9. dag_mesh: phase 8's DAGs, static and dynamic, sharded over an
   8-shard virtual mesh of the card (make_mesh over [cuda:0] * 8; the
   reference tests' 8 shards): each output equals the plain evaluator's
   and the one-device executor's (exactly, or at phase 8's rtol), the
   chain exports at most one payload a wave, and a planted fault (one
   wave's exchange zeroed, captured into the graph) must change the
   fan-out's output. Readings beside phase 8's one-device ones (smoke):
   shards, lanes per shard, export width, bytes each shard receives per
   execute, graph replays and host launches per execute, tasks/s and
   sync p50 / p99.
10. tp: the flagship (and its GQA variant, n_kv_heads=4) at full width
   and depth through the InferenceEngine on phase 4's 8 prompts (32 new
   tokens) at tp_size 1, 2 and 4 over virtual shards of the card
   (RAY_TPU_TORCH_VIRTUAL_DEVICES). In f32 every stream equals tp 1's
   token for token; in bf16 a stream may leave tp 1's only at a token
   whose tp 1 top-two logit gap is below SPEC_TIE_TOL_BF16 (printed).
   Each shard's KV pool holds 1/tp of tp 1's bytes. Tokens/s and TTFT
   per tp are smoke readings.
11. spmd_train: the manual multi-axis training step
   (make_spmd_train_step) over 8 virtual shards of the card (make_mesh
   over [cuda:0] * 8), the flagship at full width and depth on 8 x 2048
   tokens: tests/test_transformer.py's meshes dp2-tp2-sp2, dp2-fsdp2-pp2
   (2 microbatches) and MoE ep2-tp2-dp2, and the dry run's dense
   dp2-pp2-tp2 and MoE dp2-sp2-ep2 (MoE: 8 experts, every second layer).
   In f32 each mesh's SGD step equals one SGD step of the one-device
   loss_fn's gradients (every shard's every leaf to SPMD_UPDATE_TOL, the
   loss to SPMD_LOSS_TOL; MoE at capacity factor 16, nothing dropped),
   and two planted faults read above the limit: a gradient sync that
   skips dp (dp2-fsdp2-pp2, every leaf that moves) and a ring attention
   whose causal mask ignores the sp offset (dp2-tp2-sp2). Then 3 bf16
   AdamW steps on dp2-fsdp2-pp2 and ep2-tp2-dp2 (capacity factor 1.25):
   finite, falling losses, the dense mesh's first loss within
   TRAIN_LOSS_TOL_BF16 of one device's. Every run counts the K1/K3/K4
   launches of a step by variant against the port's schedule: none under
   sp > 1, the tensor cores on the bf16 dense meshes, and on the bf16 ep
   mesh the tensor cores for layer 0 and the tiled f32 kernels for layers
   1-3
   (the reference's f32 promotion, ROADMAP C.4). Smoke readings: step
   time, host launches, peak memory, device idle share, bytes per
   collective and the fraction of tokens dropped.
12. rl: the RL slice (ray_tpu_torch.rl) at the reference's defaults:
   CartPole, PPO with hidden (64, 64), 64 envs x 128 steps. A rollout
   captured as one CUDA graph equals the same rollout run eagerly from
   the same generator state (twice in a row, generators left in the same
   state), and a PPO update captured as a graph equals it run eagerly.
   IMPALA's V-trace update (ray_tpu_torch.rl.IMPALA) at its defaults (32
   envs x 64 steps) and at 64 x 128, on the runner's rollouts: as a graph
   equal to the same update run eagerly from the same state, twice in a
   row; then 5 more updates each way, finite, the graph replayed once per
   update, both timed. 10
   PPO iterations (lr 3e-3, tests/test_rl.py's learning check): the last
   episode_len_mean above 1.5x the first; then a greedy evaluate. 3 DQN
   iterations past min_buffer_size give finite losses; 3 MultiAgentPPO
   iterations on the coordination game. Smoke readings: env steps/s of
   the 64 x 128 rollout eager and as a graph, bench.py's 64 x 512 rollout
   both ways, host launches per rollout both ways, PPO update ms, IMPALA
   update ms (graph and eager), DQN
   train_many ms (one iteration of 32 steps, sampling included), and the
   device's idle share over one Algorithm.train under torch.profiler. No
   kernel of phases 1-2 runs here: the RL programs are small tensor ops.

The last lines are the kernels table, the card's name and power limit as
nvidia-smi reports them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

try:
    from ray_tpu_torch.testing import (
        GRAD_ROW_TOL,
        LSE_TOL,
        O_ROW_TOL,
        RMS_TOL,
        RMS_TOL_CAST_FIRST,
        SPEC_SELF_ACCEPT_MIN_F32,
        SPMD_LOSS_TOL,
        SPMD_UPDATE_TOL,
        SPEC_TIE_TOL_BF16,
        TRAIN_LOSS_TOL_BF16,
        delta_error,
        grad_row_error,
    )
except ImportError as exc:
    sys.exit(f"chip_smoke: the ray_tpu_torch package is missing ({exc}); "
             f"run from the repository root")

SEED = 0
BLOCK_SIZE = 16
KV_HEADS = (8, 4, 2)    # MHA flagship, its GQA variant (phase 3), group 4
H100_BF16_FLOPS = 989e12     # dense bf16 and fp16 tensor-core peak (SXM)
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores (H100 SXM)
H100_BYTES_PER_S = 3.35e12   # HBM3 bandwidth (H100 SXM)
# Kernel vs plain on the card: O_ROW_TOL, LSE_TOL, GRAD_ROW_TOL and the
# RMS limits stand with their reasons in ray_tpu_torch/testing.py, which
# tests/test_torch_kernels.py reads too.
# Flash path vs paged path logits in bf16: |logit| reaches ~5, where a
# bf16 ulp is 1/32; the two attention paths round at different places and
# that propagates through 4 layers, so they agree to a few ulps.
MODEL_LOGIT_TOL = 0.25
RAGGED_LEN = 200   # phase 3's cacheless forward: no multiple of 128
ENGINE_LENS = [16, 150, 290, 430, 570, 710, 850, 1000]   # phases 4 and 6
FWD_LENGTHS = (128, 512, 2048)   # phase 2's forward grid, D=64
# Phase 2's forward cases beyond the flagship's grid, (Hkv, Sq, Sk, D) at
# B=4, Hq=8: ragged lengths, Sq != Sk (the reference's top-left causal
# mask) and the wide head.
FWD_EXTRA_CASES = ((8, 200, 200, 64), (4, 77, 131, 64), (4, 512, 512, 128))
BWD_LENGTHS = (128, 512, 2048, 200)   # 200: ragged, no multiple of 64
# Phase 2's backward cases beyond that grid, (Sq, Sk, D) at B=4, H=8: the
# wide head (64-row query tiles in the tensor-core dK/dV kernel), ragged,
# and Sq != Sk (the reference's top-left causal mask).
BWD_EXTRA_CASES = ((512, 512, 128), (200, 200, 128), (77, 131, 64))
BWD_TIMED_LEN = 2048   # the training length, where the backward is timed
# Phase 2's cases beyond the bf16 flagship: head_dim 256 (and 200, the
# CUDA-core kernels' runtime-width instance) in each dtype, head_dim 128
# in bf16 and f16, and f16 at head_dim 64; forward (Hkv, Sq, Sk, D,
# dtypes) at B=4, Hq=8 (Hkv 1 is Gemma-2B's attention: 8 query heads over
# one KV head at head_dim 256), backward (Sq, Sk, D, dtypes) at B=4, H=8.
# bf16 and f16 take the tensor-core kernels (head_dim 200 the 256-wide
# instance, zero-padded), and the CUDA-core kernels that took them before
# are held against the plain versions on the same inputs through
# _simt_forward / _simt_backward. At S=2048 (causal) each is timed, beside
# the CUDA-core kernel where the tensor cores take the case.
_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16
C1_FWD_CASES = ((8, 512, 512, 256, (_F32, _BF16, _F16)),
                (4, 200, 200, 256, (_F32, _BF16, _F16)),
                (1, 512, 512, 256, (_F32, _BF16, _F16)),
                (1, 77, 131, 256, (_F32, _BF16, _F16)),
                (8, 2048, 2048, 256, (_F32, _BF16, _F16)),
                (8, 2048, 2048, 128, (_F32, _BF16, _F16)),
                (2, 200, 200, 128, (_F16,)),
                (8, 2048, 2048, 64, (_F16,)), (4, 77, 131, 64, (_F16,)),
                (4, 512, 512, 200, (_BF16,)))
C1_BWD_CASES = ((512, 512, 256, (_F32, _BF16, _F16)),
                (200, 200, 256, (_F32, _BF16, _F16)),
                (77, 131, 256, (_BF16, _F16)),
                (2048, 2048, 256, (_F32, _BF16, _F16)),
                (2048, 2048, 128, (_F32, _BF16, _F16)),
                (200, 200, 128, (_F16,)),
                (2048, 2048, 64, (_F16,)), (77, 131, 64, (_F16,)),
                (77, 131, 200, (_F32, _BF16)))
# Phase 2's head dims between the tensor-core instances (64, 128, 256),
# which run the next instance up, zero-padded: 8 and 32 (a 64-column box
# wider than the tensor), 80 (Phi-2, Pythia-2.8B), 96 (Phi-3-mini), 136
# (8 real columns in the third 64-column block, the fourth wholly past D),
# 160, 200 and 248. Forward at B=4, Hq=8 over (Hkv, Sq, Sk) of ANY_FWD_SHAPES
# and backward at B=4, H=8 over (Sq, Sk) of ANY_BWD_SHAPES, bf16 and f16,
# causal and not, each against the plain versions with a planted fault and
# a check that only the tensor-core kernels launched, and the CUDA-core
# kernels (the route these widths took before) against the plain versions
# on the same inputs; ANY_TIMED_DIMS are timed at S=2048, causal, MHA.
ANY_DIMS = (8, 32, 80, 96, 136, 160, 200, 248)
ANY_FWD_SHAPES = tuple((Hkv, Sq, Sk) for Hkv in (8, 4, 1)
                       for Sq, Sk in ((128, 128), (200, 200), (2048, 2048),
                                      (77, 131)))
ANY_BWD_SHAPES = ((128, 128), (200, 200), (2048, 2048), (77, 131))
ANY_TIMED_DIMS = (32, 80, 96, 160, 200)
# ANY_DIMS whose forward and backward cases run in f32 too (the tiled f32
# kernels: 96 on the 128-column instances, 32 of their columns past D; 200
# on the 256-column ones, the last 32-column box 8 columns in); f32 is
# timed at the instances' own widths (64, 128, 256) only.
ANY_F32_DIMS = (96, 200)
PLAIN_ROUTE_D = 12   # a head_dim the rule sends to the plain path
WIDE_ROUTE_D = 264   # above 256: the wide kernels, last chunk 8 columns
# Phase 2's wide kernels (head_dim above 256): every (D, dtype) on small
# shapes, forward at B=2, Hq=4, (Hkv, Sq, Sk) and backward at B=2, H=2,
# (Sq, Sk), up to S=512 (phase 2b's hd512 prefill and gradient pass); then
# checked and timed at WIDE_TIMED (B, H, S, D), causal, in bf16, f16 and
# f32, and at WIDE_TIMED_DIMS' other head_dim (384: no multiple of the
# tensor-core forward's 256-column chunk) in bf16 and f16. Above 1024 the
# tensor-core forward streams Q: WIDE_STREAMED_DIMS (1032: 8 real columns
# in the last 64-column box and the last chunk of O, dQ and dK/dV; 2048)
# in bf16 and f16 on the small shapes, and timed at WIDE_TIMED's B, H and
# S in bf16.
WIDE_DIMS = (264, 512, 1024)
WIDE_STREAMED_DIMS = (1032, 2048)
WIDE_FWD_SHAPES = ((2, 77, 131), (4, 256, 256), (4, 512, 512))
WIDE_BWD_SHAPES = ((77, 131), (256, 256), (512, 512))
WIDE_TIMED = (4, 8, 2048, 512)
WIDE_TIMED_DIMS = (512, 384)
SHORT_LENGTHS = ((4, 16), (16, 5))   # Sq, Sk under 8: the plain route
C1_DEPTH = 2         # depth of phase 2b's configs (the flagship has 4)
C1_TRAIN_BATCH, C1_TRAIN_LEN, C1_TRAIN_STEPS = 2, 512, 2
# Phase 7: the flagship with experts.
MOE_EXPERTS, MOE_EVERY = 8, 2
# Phase 8: bench.py's DAG sizes and the readings' run lengths.
DAG_CHAIN_TASKS = 1000
DAG_FANOUT_WIDTH = 10_000
DAG_TENSOR_WIDTH, DAG_TENSOR_DEPTH = 64, 15
DAG_EXECS = 300       # back-to-back executes per tasks/s reading
DAG_SYNC_EXECS = 100  # synchronous execute + get, for p50 / p99
DAG_PROFILED_EXECS = 20   # executes traced by torch.profiler
# Phase 9: the same DAGs on a virtual mesh of the card (the reference
# tests' 8 shards); fewer timed executes, since n shards launch n times
# the kernels of one device.
DAG_MESH_SHARDS = 8
DAG_MESH_EXECS = 30
DAG_MESH_SYNC_EXECS = 20
DAG_FAULT_WAVE = 1    # the fan-out wave whose exports the fault zeroes
# Phase 10: tensor-parallel serving over virtual shards of the card.
TP_SIZES = (1, 2, 4)
TP_NUM_BLOCKS = 512
# Phase 11: the manual multi-axis training step over 8 virtual shards of
# the card, on 8 x 2048 tokens, which every mesh divides. name: (MoE?,
# mesh axes, microbatches): tests/test_transformer.py's three meshes and
# __graft_entry__.py's dry run's two at n = 8.
SPMD_SHARDS = 8
SPMD_BATCH, SPMD_LEN = 8, 2048
SPMD_MESHES = {
    "dp2-tp2-sp2": (False, dict(dp=2, tp=2, sp=2), 1),
    "dp2-fsdp2-pp2": (False, dict(dp=2, fsdp=2, pp=2), 2),
    "ep2-tp2-dp2": (True, dict(ep=2, tp=2, dp=2), 1),
    "dp2-pp2-tp2": (False, dict(dp=2, pp=2, tp=2), 2),
    "dp2-sp2-ep2": (True, dict(dp=2, sp=2, ep=2), 1),
}
SPMD_SGD_LR = 0.1          # the reference tests' optax.sgd(0.1)
SPMD_PARITY_CF = 16.0      # no token dropped: the dense fallback is the oracle
SPMD_BF16_MESHES = ("dp2-fsdp2-pp2", "ep2-tp2-dp2")
SPMD_BF16_STEPS = 3
SPMD_SYNC_FAULT_MESH, SPMD_RING_FAULT_MESH = "dp2-fsdp2-pp2", "dp2-tp2-sp2"
# RMSNorm: a planted fault (one 64-row block of x zeroed in the plain
# version) reads as large as the rows themselves. RMS_CAST_FIRST_SHAPE has
# rows no multiple of the reference's 256-row block, so the reference's
# rule of shapes picks its unfused formula, which the kernel computes too.
RMS_SHAPE = (4 * 2048, 512)
RMS_CAST_FIRST_SHAPE = (4 * 2048 + 100, 512)
# Train phase: f32 gradients of loss_fn through the kernels vs through the
# plain attention, per leaf max|g - ref| over max|ref|. Both are f32 with
# TF32 off; they differ in summation order, through 4 layers and sums over
# 8192 tokens (~1e-5 expected), so 1e-3 leaves room. A planted fault, the
# GQA heads expanded with Tensor.repeat (which tiles them in another
# order) in place of repeat_interleave, must read above it.
TRAIN_GRAD_TOL = 1e-3
TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS = 4, 2048, 5
PROFILED_STEPS = 2   # bf16 steps traced by torch.profiler after the 5
# Phase 5 (d): one bf16 step traced by profile_trace must hold its
# annotate span and the tensor-core kernels that the launch counters say
# ran. (e): the flagship's AdamW steps resumed from a checkpoint taken
# after RESUME_AT of RESUME_STEPS steps must equal the uninterrupted run
# bit for bit (the same operations on the same values; the flash backward
# pair uses no atomics).
RESUME_STEPS, RESUME_AT = 4, 2
TRACE_SPAN = "chip_smoke_train_step"
TRACE_KERNELS = {"wgmma": "flash_fwd_wgmma_kernel",
                 "dq_wgmma": "flash_bwd_dq_wgmma_kernel",
                 "dkv_wgmma": "flash_bwd_dkv_wgmma_kernel"}
# Phase 6: speculative decoding and KV shipping on phase 4's prompts.
SPEC_K = 4
SPEC_NUM_BLOCKS = 512
SPEC_YARDSTICK_OFFSETS = (0, 8, 16, 24)   # rounds measured per stream
SHIP_PROMPT = 4            # the 570-token prompt: 35 full blocks + 10
SPEC_SHIP_PROMPTS = (1, 4)   # shipped again between spec-armed engines
COW_PROMPT_LEN = 128       # 8 full blocks: a fully cached prompt
# Phase 12: RL at the reference's defaults: AlgorithmConfig's 64 envs x
# 128 steps and PPOConfig's hidden (64, 64); bench.py's 64 x 512 rollout;
# tests/test_rl.py's learning check (lr 3e-3, the last of the iterations'
# episode_len_mean above 1.5x the first). Graph and eager runs of one
# program run the same kernels on the same inputs; RL_GRAPH_TOL allows
# for a library picking another algorithm under capture.
RL_ENVS, RL_ROLLOUT, RL_BENCH_ROLLOUT = 64, 128, 512
RL_PPO_ITERS, RL_PPO_LR, RL_IMPROVE = 10, 3e-3, 1.5
RL_DQN_ITERS, RL_MA_ITERS = 3, 3
RL_TIMED = 5   # samples or updates per smoke reading
RL_GRAPH_TOL = 1e-5
# IMPALA's learner at its defaults (32 envs x 64 steps, hidden (64, 64))
# and at phase 12's PPO sample size.
RL_IMPALA_SIZES = ((32, 64), (RL_ENVS, RL_ROLLOUT))


_STARTED = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended ("t_s",
    seconds since the script started), so consecutive lines give each
    phase's time."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _STARTED}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
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


def graph_ms(fn, iters: int = 24, stream=None, replays: int = 10) -> float:
    """Device time in ms of one fn(i), for a call far shorter than its
    launch cost on the host (a Triton launch costs tens of microseconds of
    Python): fn(0) .. fn(iters - 1) are captured in one CUDA graph, and
    ``replays`` replays of the graph are timed by CUDA events. ``stream``
    is the capture stream (an autograd backward must be captured on its
    forward's)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(i)
    return cuda_ms(graph.replay, iters=replays, warmup=2) / iters


# The CUDA-core kernels beside the tensor-core ones at S=2048 run for
# milliseconds each (6 ms forward, 25 ms for dQ and dK/dV at head_dim 200):
# a graph of 4 calls replayed 3 times is enough samples.
SIMT_TIMING = {"iters": 4, "replays": 3}


def attention_bound(B, Hq, Hkv, S, D, dtype, causal):
    """(bound_ms, bound_by): the larger of operations over the card's peak
    for the inputs' type (bf16 and f16: tensor cores; f32 outside them, as
    the f32 path computes) and bytes (q, k, v read once; O, LSE written once) over
    HBM bandwidth."""
    elt = torch.finfo(dtype).bits // 8
    ops = 4.0 * B * Hq * S * S * D
    if causal:
        ops *= (S + 1) / (2.0 * S)   # the pairs a causal mask keeps
    nbytes = elt * (2 * B * Hq * S * D + 2 * B * Hkv * S * D) \
        + 4 * B * Hq * S
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    t_ops, t_bytes = ops / peak, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def backward_bound(B, H, S, D, dtype, causal, kind):
    """(bound_ms, bound_by) of one backward kernel: dQ does 6 * S * S * D
    operations per (b, h), dK/dV 8 * S * S * D (halved when causal), over
    the card's peak for the inputs' type (as attention_bound); bytes are
    q, k, v, O, dO and LSE read once and dq (or dk and dv) written once,
    over HBM bandwidth."""
    elt = torch.finfo(dtype).bits // 8
    ops = (6.0 if kind == "dq" else 8.0) * B * H * S * S * D
    if causal:
        ops *= (S + 1) / (2.0 * S)
    n = B * H * S * D
    nbytes = elt * n * (5 + (1 if kind == "dq" else 2)) + 4 * B * H * S
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    t_ops, t_bytes = ops / peak, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


KERNEL_LIBRARIES = ("flash_attention_fwd_wgmma", "flash_attention_fwd",
                    "flash_attention_bwd_wgmma", "flash_attention_bwd",
                    "flash_attention_wide", "flash_attention_wide_wgmma",
                    "flash_attention_wide_f32")
WGMMA_LIBRARIES = ("flash_attention_fwd_wgmma", "flash_attention_bwd_wgmma",
                   "flash_attention_wide_wgmma")
# Kernel instantiations per tensor-core library: (bf16, f16) x head_dim
# (64, 128, 256), once for the forward and once each for dQ and dK/dV;
# above head_dim 256 (bf16, f16) x the forward with Q held (D up to 1024)
# or streamed, x dQ with Q and dO held (D up to 512) or streamed, and x
# dK/dV with K and V held or streamed.
WGMMA_INSTANCES = {"flash_attention_fwd_wgmma": 6,
                   "flash_attention_bwd_wgmma": 12,
                   "flash_attention_wide_wgmma": 12}
# Tensor-core kernels that must not spill (a spilled accumulator
# serialises the wgmma around it): the wide forward and dQ, every
# instantiation (bf16 and f16, rows held or streamed).
NO_SPILL_WGMMA = ("flash_fwd_wide_wgmma_kernel",
                  "flash_bwd_dq_wide_wgmma_kernel")
# The f32 library's kernels: f32 FMAs on the CUDA cores, never TF32. Its
# instances: the forward wide and tiled at 64, 128 and 256 columns; dQ
# wide and tiled at 64, 128 and 256 columns; dK/dV wide (which is also the
# tiled one at 256) and tiled at 64 and 128 columns.
F32_LIBRARY = "flash_attention_wide_f32"
F32_INSTANCES = 11
F32_KERNELS = ("flash_fwd_wide_f32_kernel", "flash_bwd_dq_wide_f32_kernel",
               "flash_bwd_dkv_wide_f32_kernel")
# The variants whose kernels replaced flash_attention_wide.cu's on the
# rule's path: that library's forward, dQ and dK/dV (the earlier design)
# are still held against the plain versions and timed on their inputs.
CUDA_CORE_REPLACED = ("wide_wgmma", "wide_f32")


def ptxas_summary(report: str):
    """ptxas's register and spill lines, each under the kernel it names:
    kernel<dtype, per-thread slice of D, register slice> for the CUDA-core
    kernels (16 being D = 64, 64 being D = 256; a slice of 0 is the
    runtime-width instance), kernel<dtype, D> for the tensor-core ones,
    kernel<dtype> for the wide ones (head_dim above 256),
    kernel<dtype, resident> for the tensor-core wide forward, dQ and dK/dV
    (Q, Q and dO, or K and V held in shared memory or streamed),
    kernel<rows, keys, columns, V keys> for the f32 forward
    instances and kernel<rows or keys, columns, box columns> for the f32
    dQ and dK/dV instances."""
    dtypes = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
    out, name = [], "?"
    for ln in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)"
                          r"I(13__nv_bfloat16|6__half|f)Li(\d+)ELi(\d+)E",
                          entry.group(1))
            w = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_wgmma_kernel)"
                          r"I(13__nv_bfloat16|6__half)Li(\d+)E",
                          entry.group(1))
            wide = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_wide_kernel)"
                             r"I(13__nv_bfloat16|6__half|f)E",
                             entry.group(1))
            wide_tc = re.search(
                r"(flash_(?:fwd|bwd_dq|bwd_dkv)_wide_wgmma_kernel)"
                r"I(13__nv_bfloat16|6__half)(?:Lb(\d))?E", entry.group(1))
            f32 = re.search(r"flash_(?:fwd|bwd_dq|bwd_dkv)_wide_f32_kernel",
                            entry.group(1))
            shape = re.search(r"(?:Fwd|Dkv|Dq)ShapeILi(\d+)ELi(\d+)ELi"
                              r"(\d+)E(?:Li(\d+)E)?", entry.group(1))
            if f32 and shape:
                name = (f"{f32.group(0)}<"
                        f"{', '.join(g for g in shape.groups() if g)}>")
            elif f32:
                name = f32.group(0)
            elif wide_tc:
                layout = {None: "", "1": ", resident", "0": ", streamed"}
                name = (f"{wide_tc.group(1)}<{dtypes[wide_tc.group(2)]}"
                        f"{layout[wide_tc.group(3)]}>")
            elif wide:
                name = f"{wide.group(1)}<{dtypes[wide.group(2)]}>"
            elif m:
                name = (f"{m.group(1)}<{dtypes[m.group(2)]}, "
                        f"{m.group(3)}, {m.group(4)}>")
            elif w:
                name = f"{w.group(1)}<{dtypes[w.group(2)]}, {w.group(3)}>"
            else:
                name = entry.group(1)
        elif "registers" in ln or "bytes spill" in ln:
            out.append(f"{name}: {ln.replace('ptxas info    :', '').strip()}")
    return out


def _cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy bundled with Triton."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    candidates = [Path("/usr/local/cuda/bin/cuobjdump")]
    try:
        import triton

        candidates.append(Path(triton.__file__).parent / "backends"
                          / "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("cuobjdump not found (CUDA toolkit or Triton)")


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "HMMA", "FFMA")


def sass_counts(library: Path):
    """Counts of tensor-core (HGMMA: wgmma; HMMA: mma.sync, TF32
    included), TMA load (UTMALDG) and store (UTMASTG) and f32 FMA (FFMA)
    instructions in a library's SASS: the library's totals, and per
    kernel function (``kernels``, keyed by its mangled name)."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}
    parts = re.split(r"Function : (\S+)", sass)
    counts["kernels"] = {
        name: {op: len(re.findall(rf"\b{op}\b", body)) for op in SASS_OPS}
        for name, body in zip(parts[1::2], parts[2::2])}
    return counts


def phase_build():
    from ray_tpu_torch.ops import _build

    # Built afresh, so that ptxas's report (registers, spills) is this
    # run's even where an earlier run left the libraries on disk.
    for n in KERNEL_LIBRARIES:
        _build.library_path(n).unlink(missing_ok=True)
    t0 = time.perf_counter()
    paths = _build.build_all(KERNEL_LIBRARIES)
    seconds = time.perf_counter() - t0
    # The SASS of each checked library, read by one cuobjdump each, all
    # at once.
    checked = (*WGMMA_LIBRARIES, F32_LIBRARY)
    sass = {}
    readers = [threading.Thread(target=lambda n=n: sass.__setitem__(
        n, sass_counts(paths[KERNEL_LIBRARIES.index(n)]))) for n in checked]
    for t in readers:
        t.start()
    for t in readers:
        t.join()
    if len(sass) != len(checked):
        raise RuntimeError(f"cuobjdump read {sorted(sass)} of {checked}")
    emit({"phase": "build", "libraries": [p.name for p in paths],
          "seconds": seconds,
          "nvcc_seconds": {n: _build.build_info[n][0]
                           for n in KERNEL_LIBRARIES},
          "ptxas": {n: ptxas_summary(_build.build_info[n][1])
                    for n in KERNEL_LIBRARIES},
          "sass": sass,
          "card": card_line(),
          "device_name": torch.cuda.get_device_name(0)})
    for n in WGMMA_LIBRARIES:
        counts = sass[n]
        # Every instantiation (bf16 and f16; head_dim 64, 128 and 256, or
        # the wide kernels' layouts) of every tensor-core kernel in the
        # library, each on its own.
        kernels = {k: c for k, c in counts["kernels"].items()
                   if "_wgmma_kernel" in k}
        if len(kernels) != WGMMA_INSTANCES[n] or any(
                not c["HGMMA"] or not c["UTMALDG"] for c in kernels.values()):
            raise AssertionError(f"{n}: a tensor-core kernel has no wgmma or "
                                 f"no TMA load in its SASS, or one is "
                                 f"missing: {counts}")
    wide_tc = [ln for ln in ptxas_summary(
        _build.build_info["flash_attention_wide_wgmma"][1])
        if ln.startswith(NO_SPILL_WGMMA) and "spill" in ln]
    if len(wide_tc) != 4 * len(NO_SPILL_WGMMA) or any(
            "0 bytes spill stores, 0 bytes spill loads" not in ln
            for ln in wide_tc):
        raise AssertionError(f"{NO_SPILL_WGMMA}: an instantiation is "
                             f"missing or spills: {wide_tc}")
    # Every instance of the f32 library (wide and tiled): FFMA and no
    # tensor-core instruction in its SASS, and no spill in ptxas's report.
    f32 = {k: c for k, c in sass[F32_LIBRARY]["kernels"].items()
           if any(name in k for name in F32_KERNELS)}
    spills = [ln for ln in ptxas_summary(_build.build_info[F32_LIBRARY][1])
              if "spill" in ln]
    if (len(f32) != F32_INSTANCES
            or any(not c["FFMA"] or c["HMMA"] or c["HGMMA"]
                   for c in f32.values())
            or len(spills) != F32_INSTANCES
            or any("0 bytes spill stores, 0 bytes spill loads" not in ln
                   for ln in spills)):
        raise AssertionError(f"{F32_LIBRARY}: a kernel is missing, lacks "
                             f"FFMA, holds a tensor-core instruction or "
                             f"spills: {f32} {spills}")


def compare(o, lse, ro, rlse):
    """(max abs error of O, max per-row relative error of O, max LSE
    error as a fraction of its limit) of a kernel result against the
    plain one."""
    d = (o.float() - ro.float()).abs()
    row_scale = ro.float().abs().amax(-1).clamp_min(1e-30)
    err_row = (d.amax(-1) / row_scale).max().item()
    lse_lim = LSE_TOL[o.dtype] * (rlse.abs() + 1)
    err_lse = ((lse - rlse).abs() / lse_lim).max().item()
    return d.max().item(), err_row, err_lse


def phase_kernels(dev):
    """Forward kernels vs plain (_dense_kernel) at every listed shape;
    timings at S=2048 and at the main path's S=512. Each case checks that
    the variant the wrapper's rule picks (bf16 and f16: tensor cores; f32:
    the tiled f32 kernel on the CUDA cores) is the one that launched, and
    reads a planted fault (the
    plain version with one 64-key tile of V zeroed, i.e. that tile's P.V
    dropped) through the same comparison, failing unless the check flags
    it. Then C1_FWD_CASES (head_dim 256, 128 and 200, f16; timed at
    S=2048) and the ANY_DIMS cases (timed at ANY_TIMED_DIMS, bf16 and
    f16), where a case the tensor cores take, and every f32 case, also
    holds the earlier CUDA-core kernel against the plain version on the
    same inputs; and the plain route of head_dim PLAIN_ROUTE_D."""
    fa = _flash_module()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, Hq = 4, 8
    both = (torch.bfloat16, torch.float32)
    cases = [(Hkv, S, S, 64, both, "flagship") for Hkv in KV_HEADS
             for S in FWD_LENGTHS]
    cases += [(*c, both, "flagship") for c in FWD_EXTRA_CASES]
    cases += [(*c, "c1") for c in C1_FWD_CASES]
    cases += [(Hkv, Sq, Sk, D, (_BF16, _F16) + ((_F32,) if D in ANY_F32_DIMS
                                                 else ()), "any")
              for D in ANY_DIMS for Hkv, Sq, Sk in ANY_FWD_SHAPES]
    checks = []
    timing = {}
    for Hkv, Sq, Sk, D, dtypes, kind in cases:
        for dtype in dtypes:
            q = torch.randn((B, Hq, Sq, D), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
            k = torch.randn((B, Hkv, Sk, D), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
            v = torch.randn((B, Hkv, Sk, D), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
            t0 = 64 * ((Sk // 2) // 64)
            v_fault = v.clone()
            v_fault[:, :, t0:t0 + 64] = 0
            variant = fa._forward_variant(dtype, D)
            for causal in (True, False):
                before = _variant_counts(fa)
                o, lse = fa._flash_forward(q, k, v, causal)
                launched = {n: c - before[n]
                            for n, c in _variant_counts(fa).items()}
                ro, rlse = fa._dense_kernel(q, k, v, causal, D ** -0.5)
                fo, flse = fa._dense_kernel(q, k, v_fault, causal, D ** -0.5)
                torch.cuda.synchronize()
                err_abs, err_row, err_lse = compare(o, lse, ro, rlse)
                _, fault_row, _ = compare(fo, flse, ro, rlse)
                tol = O_ROW_TOL[dtype]
                ok = (err_row <= tol and err_lse <= 1.0
                      and bool(torch.isfinite(o).all())
                      and launched == _variant_want(variant, 1))
                check = {"Hkv": Hkv, "Sq": Sq, "Sk": Sk, "D": D,
                         "dtype": str(dtype).split(".")[1],
                         "causal": causal, "variant": variant,
                         "launched": launched, "err_o_abs": err_abs,
                         "err_o_row": err_row, "tol_o_row": tol,
                         "err_lse_of_limit": err_lse,
                         "fault_o_row": fault_row}
                simt_abs = None
                if variant == "tiled_f32" or (kind != "flagship"
                                              and variant == "wgmma"):
                    so, slse = _simt_forward(fa, q, k, v, causal)
                    torch.cuda.synchronize()
                    simt_abs, simt_row, simt_lse = compare(so, slse, ro,
                                                           rlse)
                    check.update(simt_err_o_row=simt_row,
                                 simt_err_lse_of_limit=simt_lse)
                    ok = ok and simt_row <= tol and simt_lse <= 1.0 and \
                        bool(torch.isfinite(so).all())
                checks.append({**check, "ok": ok})
                if not ok or fault_row <= tol:
                    emit({"phase": "kernels", "checks": checks})
                    raise AssertionError(
                        f"flash kernel disagrees with plain, the wrong "
                        f"variant launched, or the check misses a planted "
                        f"fault: {checks[-1]}")
                if causal and Sq == Sk and (
                        (kind == "flagship" and D == 64 and Sq >= 512
                         and (dtype == torch.bfloat16 or Hkv == Hq))
                        or (kind == "c1" and Sq == 2048)
                        or (kind == "any" and Sq == 2048 and Hkv == Hq
                            and D in ANY_TIMED_DIMS and dtype != _F32)):
                    key = f"{_dtype_name(dtype)}_Hkv{Hkv}_S{Sq}"
                    timing[key + ("" if D == 64 else f"_D{D}")] = \
                        _time_kernel(fa, q, k, v, err_abs, simt_abs)
    plain_route = _plain_route_check(fa, gen, dev)
    emit({"phase": "kernels", "checks": checks, "timing": timing,
          "plain_route": plain_route})
    return timing


def _plain_route_check(fa, gen, dev):
    """head_dim PLAIN_ROUTE_D through the public wrappers on the card:
    each call takes the plain route (one plain_routes, no launch) and
    returns the plain version's result exactly. head_dim WIDE_ROUTE_D
    (f32) launches the f32 wide kernel once, with no plain route, and
    equals the plain version within O_ROW_TOL. The SHORT_LENGTHS
    (bf16, head_dim 64) take the plain route as head_dim 12 does."""
    D = PLAIN_ROUTE_D
    out = {}
    for name, Hkv in (("flash_attention", 8), ("flash_attention_grouped", 2)):
        q = torch.randn((4, 8, 128, D), generator=gen, device=dev)
        k, v = (torch.randn((4, Hkv, 128, D), generator=gen, device=dev)
                for _ in range(2))
        before = fa.launches, fa.plain_routes
        o = getattr(fa, name)(q, k, v)
        launched = fa.launches - before[0]
        routes = fa.plain_routes - before[1]
        exact = bool(torch.equal(o, fa._dense(q, k, v, True, D ** -0.5)[0]))
        out[name] = {"D": D, "launches": launched, "plain_routes": routes,
                     "equals_plain": exact}
        if launched or routes != 1 or not exact:
            raise AssertionError(f"head_dim {D} through {name}: {out[name]}")
    D = WIDE_ROUTE_D
    q, k, v = (torch.randn((1, 2, 16, D), generator=gen, device=dev)
               for _ in range(3))
    before = fa.wide_f32_launches, fa.plain_routes
    o = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ro = fa._dense_kernel(q, k, v, True, D ** -0.5)[0]
    err = ((o - ro).abs().amax(-1) / ro.abs().amax(-1)).max().item()
    out[f"D{D}"] = {"wide_f32_launches": fa.wide_f32_launches - before[0],
                    "plain_routes": fa.plain_routes - before[1],
                    "err_o_row": err}
    if (fa.wide_f32_launches - before[0],
            fa.plain_routes - before[1]) != (1, 0) \
            or not err <= O_ROW_TOL[q.dtype]:
        raise AssertionError(f"head_dim {D} through flash_attention: "
                             f"{out[f'D{D}']}")
    # A query or key length under 8 (ROADMAP C.7): the plain route on the
    # card too, as the reference falls back there, at a head_dim and dtype
    # the kernels take.
    for Sq, Sk in SHORT_LENGTHS:
        for name, Hkv in (("flash_attention", 8),
                          ("flash_attention_grouped", 2)):
            q = torch.randn((4, 8, Sq, 64), generator=gen,
                            device=dev).to(torch.bfloat16)
            k, v = (torch.randn((4, Hkv, Sk, 64), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
            before = _variant_counts(fa), fa.plain_routes
            o = getattr(fa, name)(q, k, v)
            launched = sum(c - before[0][n]
                           for n, c in _variant_counts(fa).items())
            routes = fa.plain_routes - before[1]
            exact = bool(torch.equal(o, fa._dense(q, k, v, True,
                                                  64 ** -0.5)[0]))
            key = f"{name}_Sq{Sq}_Sk{Sk}"
            out[key] = {"launches": launched, "plain_routes": routes,
                        "equals_plain": exact}
            if launched or routes != 1 or not exact:
                raise AssertionError(f"Sq {Sq}, Sk {Sk} through {name}: "
                                     f"{out[key]}")
    return out


# The kernel variants of the forward: the tensor cores and the tiled f32
# kernel up to head_dim 256 (and the earlier CUDA-core kernel, reached by
# no rule), and above it the CUDA cores, the tensor cores and the f32
# kernels.
VARIANTS = ("wgmma", "tiled_f32", "simt", "wide", "wide_wgmma", "wide_f32")


def _variant_want(variant, n):
    """Launch counts by variant when `variant` launched n times and no
    other variant launched ("plain": none at all)."""
    return {v: n if v == variant else 0 for v in VARIANTS}


_COUNTERS = ("launches", "wgmma_launches", "tiled_f32_launches",
             "simt_launches", "wide_launches",
             "wide_wgmma_launches", "wide_f32_launches", "dq_launches",
             "dkv_launches", "dq_wgmma_launches", "dkv_wgmma_launches",
             "dq_tiled_f32_launches", "dkv_tiled_f32_launches",
             "dq_simt_launches", "dkv_simt_launches", "dq_wide_launches",
             "dkv_wide_launches", "dq_wide_wgmma_launches",
             "dkv_wide_wgmma_launches", "dq_wide_f32_launches",
             "dkv_wide_f32_launches", "plain_routes")


@contextlib.contextmanager
def _counts_kept(fa):
    """Every launch count of the flash module restored on exit: timing
    launches are not the main path's."""
    saved = {n: getattr(fa, n) for n in _COUNTERS}
    try:
        yield
    finally:
        for n, c in saved.items():
            setattr(fa, n, c)


def _dtype_name(dtype):
    return str(dtype).split(".")[1]


def _variant_counts(fa):
    return {"wgmma": fa.wgmma_launches, "tiled_f32": fa.tiled_f32_launches,
            "simt": fa.simt_launches, "wide": fa.wide_launches,
            "wide_wgmma": fa.wide_wgmma_launches,
            "wide_f32": fa.wide_f32_launches}


def _simt_forward(fa, q, k, v, causal, wide=False):
    """The CUDA-core kernel (``wide``: the one for head_dim above 256)
    called straight through its C entry point on any input it takes (bf16
    and f16 included), bypassing the wrapper's rule of shapes: the earlier
    design, checked and timed beside the tensor-core or the tiled f32
    kernel on the same inputs. Counts no launch."""
    B, Hq, Sq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    library, _, suffix = fa._LIBRARIES["wide" if wide else "simt"]
    err = fa._kernel_fn(library, "flash_attention_fwd" + suffix)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Hq, k.shape[1], Sq, k.shape[2], D, D ** -0.5,
        int(bool(causal)), fa._DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd{suffix} launch failed: "
                           f"{err}")
    return o, lse


def _time_kernel(fa, q, k, v, err_o, simt_err_o=None):
    """Device times of the kernel, the earlier CUDA-core kernel on the same
    inputs where the rule picks another (the tensor cores, or the tiled f32
    kernel; ``simt_err_o``: its max abs error of O against the plain
    version) and SDPA through CUDA graphs (at S=512 the tensor-core kernel
    is shorter than the wrapper's host cost, which launch-by-launch timing
    would read); the plain version by events."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    with _counts_kept(fa):
        kernel_ms = graph_ms(lambda i: fa._flash_forward(q, k, v, True))
    simt_ms = None
    if fa._forward_variant(q.dtype, D) in ("wgmma", "tiled_f32"):
        simt_ms = graph_ms(lambda i: _simt_forward(fa, q, k, v, True),
                           **SIMT_TIMING)
    plain_ms = cuda_ms(lambda: fa._dense_kernel(q, k, v, True, D ** -0.5),
                       iters=5)
    try:
        library_ms = graph_ms(lambda i: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=Hkv != Hq))
    except TypeError:   # a PyTorch without enable_gqa: pre-expanded K/V
        ke = k.repeat_interleave(Hq // Hkv, dim=1)
        ve = v.repeat_interleave(Hq // Hkv, dim=1)
        library_ms = graph_ms(lambda i: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True))
    bound_ms, bound_by = attention_bound(B, Hq, Hkv, S, D, q.dtype, True)
    ops = 4.0 * B * Hq * S * S * D * (S + 1) / (2.0 * S)
    return {"shape": [B, Hq, Hkv, S, D], "dtype": _dtype_name(q.dtype),
            "causal": True, "variant": fa._forward_variant(q.dtype, D),
            "sdpa_backend": _sdpa_backend(q, k, v) if Hkv == Hq else None,
            "max_abs_err": err_o, "kernel_ms": kernel_ms,
            "tflops": ops / kernel_ms * 1e-9,
            "simt_kernel_ms": simt_ms, "simt_max_abs_err": simt_err_o,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_backward(dev):
    """Backward kernels vs the plain backward at every listed shape,
    causal and not, bf16 and f32, from the kernel forward's O and LSE (as
    training gives them). Each case checks that the variant of the rule
    (bf16 and f16: tensor cores; f32: the tiled f32 pair on the CUDA
    cores) launched, once per kernel, and nothing else, and reads a
    planted fault (the plain backward with one 64-row tile of dO zeroed)
    through the same check, failing unless it is flagged. Timings at the
    training shape S=2048, per dtype; then C1_BWD_CASES (head_dim 256, 128
    and 200, f16; timed at S=2048) and the ANY_DIMS cases (timed at
    ANY_TIMED_DIMS). Every f32 case, and every case of those two lists
    that the tensor cores take, also holds the CUDA-core pair that the
    rule took before (flash_attention_bwd.cu) against the plain backward
    on the same inputs."""
    fa = _flash_module()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    B, H = 4, 8
    both = (torch.bfloat16, torch.float32)
    cases = [(S, S, 64, both, "flagship") for S in BWD_LENGTHS]
    cases += [(*c, both, "flagship") for c in BWD_EXTRA_CASES]
    cases += [(*c, "c1") for c in C1_BWD_CASES]
    cases += [(Sq, Sk, D, (_BF16, _F16) + ((_F32,) if D in ANY_F32_DIMS
                                           else ()), "any")
              for D in ANY_DIMS for Sq, Sk in ANY_BWD_SHAPES]
    checks = []
    timing = {}
    for Sq, Sk, D, dtypes, kind in cases:
        scale = D ** -0.5
        for dtype in dtypes:
            q, do = (torch.randn((B, H, Sq, D), generator=gen,
                                 device=dev).to(dtype) for _ in range(2))
            k, v = (torch.randn((B, H, Sk, D), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            t0 = 64 * ((Sq // 2) // 64)
            do_fault = do.clone()
            do_fault[:, :, t0:t0 + 64] = 0
            variant = fa._forward_variant(dtype, D)
            for causal in (True, False):
                o, lse = fa._flash_forward(q, k, v, causal)
                before = _backward_counts(fa)
                dq, delta = fa._launch_dq(q, k, v, o, lse, do, causal, scale)
                dk, dv = fa._launch_dkv(q, k, v, o, lse, do, delta, causal,
                                        scale)
                launched = {n: c - before[n]
                            for n, c in _backward_counts(fa).items()}
                ref = fa._dense_backward(q, k, v, o, lse, do, causal, scale)
                fault = fa._dense_backward(q, k, v, o, lse, do_fault, causal,
                                           scale)
                torch.cuda.synchronize()
                got = (dq, dk, dv)
                errs = [grad_row_error(g, r) for g, r in zip(got, ref)]
                abs_errs = [(g.float() - r.float()).abs().max().item()
                            for g, r in zip(got, ref)]
                fault_err = max(grad_row_error(f, r)
                                for f, r in zip(fault, ref))
                tol = GRAD_ROW_TOL[dtype]
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                want = _backward_want(variant, 1)
                ok = finite and max(errs) <= tol and launched == want
                check = {"Sq": Sq, "Sk": Sk, "D": D,
                         "dtype": _dtype_name(dtype),
                         "causal": causal, "variant": variant,
                         "launched": launched,
                         "err_row": dict(zip(("dq", "dk", "dv"), errs)),
                         "max_abs": dict(zip(("dq", "dk", "dv"), abs_errs)),
                         "tol_row": tol, "fault_row": fault_err}
                simt_abs = None
                if variant == "tiled_f32" or (kind != "flagship"
                                              and variant == "wgmma"):
                    simt = (*_simt_backward(fa, "dq", q, k, v, o, lse, do,
                                            causal),
                            *_simt_backward(fa, "dkv", q, k, v, o, lse, do,
                                            causal))
                    torch.cuda.synchronize()
                    simt_errs = [grad_row_error(g, r)
                                 for g, r in zip(simt, ref)]
                    simt_abs = [(g.float() - r.float()).abs().max().item()
                                for g, r in zip(simt, ref)]
                    check["simt_err_row"] = dict(zip(("dq", "dk", "dv"),
                                                     simt_errs))
                    ok = ok and max(simt_errs) <= tol and all(
                        bool(torch.isfinite(g).all()) for g in simt)
                checks.append({**check, "ok": ok})
                if not ok or fault_err <= tol:
                    emit({"phase": "kernels_backward", "checks": checks})
                    raise AssertionError(
                        f"backward kernels disagree with plain, the wrong "
                        f"variant launched, or the check misses a planted "
                        f"fault: {checks[-1]}")
                # f32 is timed at the flagship's D=64 and at 128 and 256.
                if causal and Sq == Sk == BWD_TIMED_LEN and (
                        kind != "any" or (D in ANY_TIMED_DIMS
                                          and dtype != _F32)):
                    key = _dtype_name(dtype) + ("" if D == 64 else f"_D{D}")
                    timing[key] = _time_backward(fa, q, k, v, o, lse, do,
                                                 abs_errs, simt_abs)
    emit({"phase": "kernels_backward", "checks": checks, "timing": timing})
    return timing


def _backward_counts(fa):
    return {"dq_wgmma": fa.dq_wgmma_launches,
            "dkv_wgmma": fa.dkv_wgmma_launches,
            "dq_tiled_f32": fa.dq_tiled_f32_launches,
            "dkv_tiled_f32": fa.dkv_tiled_f32_launches,
            "dq_simt": fa.dq_simt_launches, "dkv_simt": fa.dkv_simt_launches,
            "dq_wide": fa.dq_wide_launches, "dkv_wide": fa.dkv_wide_launches,
            "dq_wide_wgmma": fa.dq_wide_wgmma_launches,
            "dkv_wide_wgmma": fa.dkv_wide_wgmma_launches,
            "dq_wide_f32": fa.dq_wide_f32_launches,
            "dkv_wide_f32": fa.dkv_wide_f32_launches}


def _backward_want(variant, n):
    """Backward launch counts when the dQ and the dK/dV kernel of the
    backward variant `variant` launched n times each and no other kernel
    did."""
    fa = _flash_module()
    want = {kind: 0 for kind in _backward_counts(fa)}
    if variant is not None:
        want[f"dq_{variant}"] += n
        want[f"dkv_{variant}"] += n
    return want


def _simt_backward(fa, kind, q, k, v, o, lse, do, causal=True, wide=False):
    """A CUDA-core backward kernel (``wide``: the one for head_dim above
    256; its dQ is given no delta buffer) called straight through its C
    entry point on any input it takes (bf16 and f16 included), bypassing
    the wrapper's rule of shapes: the earlier design, checked and timed
    beside the kernels that replaced it on the same inputs. Counts no
    launch."""
    B, H, Sq, D = q.shape
    outs = [torch.empty_like(q)] if kind == "dq" else [torch.empty_like(k),
                                                       torch.empty_like(v)]
    _, library, suffix = fa._LIBRARIES["wide" if wide else "simt"]
    name = f"flash_attention_bwd_{kind}{suffix}"
    no_delta = (None,) if wide and kind == "dq" else ()
    err = fa._kernel_fn(library, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), *[t.data_ptr() for t in outs],
        *no_delta, B * H, Sq, k.shape[2], D, D ** -0.5, int(bool(causal)),
        fa._DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {err}")
    return outs


def _sdpa_backward_ms(q, k, v, do, iters=24, replays=10):
    """SDPA's backward (dq, dk and dv in one call) through a CUDA graph:
    the forward runs on the capture stream, so that autograd puts the
    backward there."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    return graph_ms(lambda i: torch.autograd.grad(out, leaves, do,
                                                  retain_graph=True),
                    iters=iters, stream=side, replays=replays)


def _time_backward(fa, q, k, v, o, lse, do, abs_errs, simt_abs=None):
    """Device times through CUDA graphs of the dQ and dK/dV kernels of the
    rule, of the CUDA-core pair of flash_attention_bwd.cu on the same
    inputs where the rule picks another pair (the tensor cores, or the
    tiled f32 pair; ``simt_abs``: its max abs errors of dq, dk and dv
    against the plain backward), and of SDPA's backward; the plain
    backward by events."""
    B, H, S, D = q.shape
    scale = D ** -0.5
    variant = fa._forward_variant(q.dtype, D)
    with _counts_kept(fa):
        delta = fa._launch_dq(q, k, v, o, lse, do, True, scale)[1]
        dq_ms = graph_ms(lambda i: fa._launch_dq(q, k, v, o, lse, do, True,
                                                 scale))
        dkv_ms = graph_ms(lambda i: fa._launch_dkv(q, k, v, o, lse, do,
                                                   delta, True, scale))
    simt_ms = {"dq": None, "dkv": None}
    if variant in ("wgmma", "tiled_f32"):
        simt_ms = {kind: graph_ms(lambda i, kind=kind: _simt_backward(
            fa, kind, q, k, v, o, lse, do), **SIMT_TIMING)
            for kind in ("dq", "dkv")}
    plain_ms = cuda_ms(lambda: fa._dense_backward(q, k, v, o, lse, do, True,
                                                  scale), iters=5)
    library_ms = _sdpa_backward_ms(q, k, v, do)
    result = {"shape": [B, H, S, D], "dtype": _dtype_name(q.dtype),
              "causal": True, "variant": variant,
              "sdpa_backend": _sdpa_backend(q, k, v),
              "plain_ms": plain_ms, "library_ms": library_ms,
              "library": "scaled_dot_product_attention backward (dq, dk "
                         "and dv in one call, CUDA graph; compare with the "
                         "pair's sum)",
              "plain": "_dense_backward (dq, dk and dv in one call)"}
    for kind, ms, err in (("dq", dq_ms, abs_errs[0]),
                          ("dkv", dkv_ms, max(abs_errs[1:]))):
        bound_ms, bound_by = backward_bound(B, H, S, D, q.dtype, True, kind)
        ops = ((6.0 if kind == "dq" else 8.0) * B * H * S * S * D
               * (S + 1) / (2.0 * S))
        result[kind] = {"kernel_ms": ms, "simt_kernel_ms": simt_ms[kind],
                        "tflops": ops / ms * 1e-9, "max_abs_err": err,
                        "bound_ms": bound_ms, "bound_by": bound_by}
        if simt_abs is not None:
            result[kind]["simt_max_abs_err"] = (
                simt_abs[0] if kind == "dq" else max(simt_abs[1:]))
    return result


def _sdpa_backend(q, k, v):
    """The backend scaled_dot_product_attention picks for a causal call on
    these inputs (MATH: no fused backend took the shape)."""
    from torch.nn.attention import SDPBackend

    choice = int(torch._fused_sdp_choice(q, k, v, is_causal=True))
    for name, member in SDPBackend.__members__.items():
        if int(member.value) == choice:
            return name
    return f"backend {choice}"


def phase_wide(dev):
    """Phase 2's wide kernels (head_dim above 256, the head dimension of
    the output split across blocks): forward and backward at every
    WIDE_DIMS x (f32, bf16, f16) and WIDE_STREAMED_DIMS x (bf16, f16) on
    small shapes, causal and not, against
    the plain versions at O_ROW_TOL / LSE_TOL / GRAD_ROW_TOL (the dQ
    kernel's delta against rowsum(dO * O) at testing.delta_error's
    limit), each case launching the kernels of the rule once each and no
    other (bf16 and f16: the tensor-core forward, dQ and dK/dV; f32: the
    f32 ones), with no plain route, and a planted fault (32 keys of V, or
    32 rows of dO, zeroed in the plain version) flagged. The CUDA-core
    forward, dQ and dK/dV of flash_attention_wide.cu (the earlier design)
    are held against the plain versions on the same inputs too. Then the
    three kernels checked the same way at WIDE_TIMED in bf16, f16 and f32
    (and head_dim 384 in bf16 and f16, and WIDE_STREAMED_DIMS in bf16),
    and timed there beside the plain versions, the CUDA-core kernels, SDPA
    (its backend named) and the bound."""
    fa = _flash_module()
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    checks = []

    def fail(check):
        emit({"phase": "kernels_wide", "checks": checks})
        raise AssertionError(f"wide kernel disagrees with plain, the wrong "
                             f"variant launched, or the check misses a "
                             f"planted fault: {check}")

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = [(D, (torch.float32, torch.bfloat16, torch.float16))
             for D in WIDE_DIMS]
    cases += [(D, (torch.bfloat16, torch.float16))
              for D in WIDE_STREAMED_DIMS]
    for D, dtypes in cases:
        scale = D ** -0.5
        for dtype in dtypes:
            variant = fa._forward_variant(dtype, D)
            # The earlier CUDA-core kernels on the same inputs.
            earlier = variant in CUDA_CORE_REPLACED
            for Hkv, Sq, Sk in WIDE_FWD_SHAPES:
                q = randn((2, 4, Sq, D), dtype)
                k, v = randn((2, Hkv, Sk, D), dtype), randn((2, Hkv, Sk, D),
                                                           dtype)
                v_fault = v.clone()
                v_fault[:, :, Sk // 2:Sk // 2 + 32] = 0
                for causal in (True, False):
                    before, routes = _variant_counts(fa), fa.plain_routes
                    o, lse = fa._flash_forward(q, k, v, causal)
                    launched = {n: c - before[n]
                                for n, c in _variant_counts(fa).items()}
                    ro, rlse = fa._dense_kernel(q, k, v, causal, scale)
                    fo, flse = fa._dense_kernel(q, k, v_fault, causal, scale)
                    torch.cuda.synchronize()
                    err_abs, err_row, err_lse = compare(o, lse, ro, rlse)
                    fault_row = compare(fo, flse, ro, rlse)[1]
                    tol = O_ROW_TOL[dtype]
                    ok = (err_row <= tol and err_lse <= 1.0
                          and bool(torch.isfinite(o).all())
                          and launched == _variant_want(variant, 1)
                          and fa.plain_routes == routes)
                    check = {"kind": "fwd", "D": D, "Hkv": Hkv, "Sq": Sq,
                             "Sk": Sk, "dtype": _dtype_name(dtype),
                             "causal": causal, "variant": variant,
                             "launched": launched, "err_o_abs": err_abs,
                             "err_o_row": err_row, "tol_o_row": tol,
                             "err_lse_of_limit": err_lse,
                             "fault_o_row": fault_row}
                    if earlier:
                        so, slse = _simt_forward(fa, q, k, v, causal,
                                                 wide=True)
                        torch.cuda.synchronize()
                        _, s_row, s_lse = compare(so, slse, ro, rlse)
                        check["cuda_core"] = {"err_o_row": s_row,
                                              "err_lse_of_limit": s_lse}
                        ok = ok and s_row <= tol and s_lse <= 1.0 and bool(
                            torch.isfinite(so).all())
                    checks.append({**check, "ok": ok})
                    if not ok or fault_row <= tol:
                        fail(checks[-1])
            for Sq, Sk in WIDE_BWD_SHAPES:
                q, do = randn((2, 2, Sq, D), dtype), randn((2, 2, Sq, D),
                                                           dtype)
                k, v = randn((2, 2, Sk, D), dtype), randn((2, 2, Sk, D),
                                                          dtype)
                do_fault = do.clone()
                do_fault[:, :, Sq // 2:Sq // 2 + 32] = 0
                for causal in (True, False):
                    o, lse = fa._flash_forward(q, k, v, causal)
                    before = _backward_counts(fa)
                    dq, delta = fa._launch_dq(q, k, v, o, lse, do, causal,
                                              scale)
                    dk, dv = fa._launch_dkv(q, k, v, o, lse, do, delta,
                                            causal, scale)
                    launched = {n: c - before[n]
                                for n, c in _backward_counts(fa).items()}
                    ref = fa._dense_backward(q, k, v, o, lse, do, causal,
                                             scale)
                    fault = fa._dense_backward(q, k, v, o, lse, do_fault,
                                               causal, scale)
                    torch.cuda.synchronize()
                    got = (dq, dk, dv)
                    errs = [grad_row_error(g, r) for g, r in zip(got, ref)]
                    fault_err = max(grad_row_error(f, r)
                                    for f, r in zip(fault, ref))
                    tol = GRAD_ROW_TOL[dtype]
                    err_delta = delta_error(delta, do, o)
                    ok = (all(bool(torch.isfinite(g).all()) for g in got)
                          and max(errs) <= tol and err_delta <= 1.0
                          and launched == _backward_want(variant, 1))
                    check = {"kind": "bwd", "D": D, "Sq": Sq, "Sk": Sk,
                             "dtype": _dtype_name(dtype), "causal": causal,
                             "variant": variant, "launched": launched,
                             "err_row": dict(zip(("dq", "dk", "dv"), errs)),
                             "tol_row": tol, "fault_row": fault_err,
                             "err_delta_of_limit": err_delta}
                    if earlier:
                        cc = (*_simt_backward(fa, "dq", q, k, v, o, lse, do,
                                              causal, wide=True),
                              *_simt_backward(fa, "dkv", q, k, v, o, lse,
                                              do, causal, wide=True))
                        torch.cuda.synchronize()
                        s_errs = [grad_row_error(g, r)
                                  for g, r in zip(cc, ref)]
                        check["cuda_core_err_row"] = dict(zip(
                            ("dq", "dk", "dv"), s_errs))
                        ok = ok and max(s_errs) <= tol and all(
                            bool(torch.isfinite(g).all()) for g in cc)
                    checks.append({**check, "ok": ok})
                    if not ok or fault_err <= tol:
                        fail(checks[-1])
    timing = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for D in WIDE_TIMED_DIMS:
            if D != WIDE_TIMED[3] and dtype == torch.float32:
                continue
            key = _dtype_name(dtype) + ("" if D == WIDE_TIMED[3]
                                        else f"_D{D}")
            timing[key] = _time_wide(fa, gen, dev, dtype, D)
    for D in WIDE_STREAMED_DIMS:
        timing[f"bfloat16_D{D}"] = _time_wide(fa, gen, dev, torch.bfloat16,
                                              D)
    emit({"phase": "kernels_wide", "checks": checks, "timing": timing})
    return timing


def _time_wide(fa, gen, dev, dtype, D):
    """The wide forward, dQ and dK/dV of the rule at WIDE_TIMED's (B, H,
    S) and head_dim D (causal) through CUDA graphs, held against the plain
    versions there at O_ROW_TOL / LSE_TOL / GRAD_ROW_TOL (the dQ kernel's
    delta at testing.delta_error's limit) with a planted fault (32 keys
    of V, or 32 rows of dO, zeroed in the plain version) that must read
    above the limit; where the rule takes the tensor-core or the f32
    kernels, the CUDA-core forward, dQ and dK/dV of
    flash_attention_wide.cu on the same inputs, held and timed the same
    way (few replays: a CUDA-core call takes tens of ms; at
    WIDE_STREAMED_DIMS, where it takes up to seconds, the check's call
    warms it and one more call is timed by CUDA events, and the rule's
    kernels get few replays too); the plain versions by events, and SDPA's
    forward and backward through CUDA graphs with the backend it picks."""
    B, H, S, _ = WIDE_TIMED
    scale = D ** -0.5
    variant = fa._forward_variant(dtype, D)
    cuda_core = variant in CUDA_CORE_REPLACED
    q, k, v, do = (torch.randn((B, H, S, D), generator=gen,
                               device=dev).to(dtype) for _ in range(4))
    few = {"iters": 2, "replays": 3}
    streamed = D in WIDE_STREAMED_DIMS
    with _counts_kept(fa):
        o, lse = fa._flash_forward(q, k, v, True)
        dq, delta = fa._launch_dq(q, k, v, o, lse, do, True, scale)
        dk, dv = fa._launch_dkv(q, k, v, o, lse, do, delta, True, scale)
        many = few if not cuda_core or streamed else {}
        ms = {"fwd": graph_ms(lambda i: fa._flash_forward(q, k, v, True),
                              **many),
              "dq": graph_ms(lambda i: fa._launch_dq(
                  q, k, v, o, lse, do, True, scale), **many),
              "dkv": graph_ms(lambda i: fa._launch_dkv(
                  q, k, v, o, lse, do, delta, True, scale), **many)}
    if cuda_core:
        so, slse = _simt_forward(fa, q, k, v, True, wide=True)
        sdq, = _simt_backward(fa, "dq", q, k, v, o, lse, do, True,
                              wide=True)
        sdk, sdv = _simt_backward(fa, "dkv", q, k, v, o, lse, do, True,
                                  wide=True)
        cc_calls = {"fwd": lambda: _simt_forward(fa, q, k, v, True,
                                                 wide=True)}
        for kind in ("dq", "dkv"):
            cc_calls[kind] = lambda kind=kind: _simt_backward(
                fa, kind, q, k, v, o, lse, do, True, wide=True)
        cc_ms = {kind: cuda_ms(fn, iters=1, warmup=0) if streamed
                 else graph_ms(lambda i, fn=fn: fn(), **few)
                 for kind, fn in cc_calls.items()}
    ro, rlse = fa._dense_kernel(q, k, v, True, scale)
    v_fault = v.clone()
    v_fault[:, :, S // 2:S // 2 + 32] = 0
    fo, flse = fa._dense_kernel(q, k, v_fault, True, scale)
    err_o_abs, err_o_row, err_lse = compare(o, lse, ro, rlse)
    fault_o_row = compare(fo, flse, ro, rlse)[1]
    check = {}
    if cuda_core:
        _, s_row, s_lse = compare(so, slse, ro, rlse)
        check["cuda_core_fwd"] = {"err_o_row": s_row,
                                  "err_lse_of_limit": s_lse,
                                  "max_abs_err": (so.float() - ro.float())
                                  .abs().max().item()}
    del ro, rlse, fo, flse, v_fault
    ref = fa._dense_backward(q, k, v, o, lse, do, True, scale)
    got = (dq, dk, dv)
    errs = {"fwd": err_o_abs,
            "dq": (dq.float() - ref[0].float()).abs().max().item(),
            "dkv": max((g.float() - r.float()).abs().max().item()
                       for g, r in zip((dk, dv), ref[1:]))}
    err_row = dict(zip(("dq", "dk", "dv"),
                       (grad_row_error(g, r) for g, r in zip(got, ref))))
    err_delta = delta_error(delta, do, o)
    if cuda_core:
        check["cuda_core_dq"] = {
            "err_row": grad_row_error(sdq, ref[0]),
            "max_abs_err": (sdq.float() - ref[0].float()).abs().max().item()}
        check["cuda_core_dkv"] = {
            "err_row": dict(zip(("dk", "dv"), (grad_row_error(g, r) for g, r
                                               in zip((sdk, sdv), ref[1:])))),
            "max_abs_err": max((g.float() - r.float()).abs().max().item()
                               for g, r in zip((sdk, sdv), ref[1:]))}
    do_fault = do.clone()
    do_fault[:, :, S // 2:S // 2 + 32] = 0
    fault = fa._dense_backward(q, k, v, o, lse, do_fault, True, scale)
    fault_row = max(grad_row_error(f, r) for f, r in zip(fault, ref))
    del fault, ref, do_fault
    check.update({"err_o_row": err_o_row, "tol_o_row": O_ROW_TOL[dtype],
                  "err_lse_of_limit": err_lse, "fault_o_row": fault_o_row,
                  "err_row": err_row, "tol_row": GRAD_ROW_TOL[dtype],
                  "err_delta_of_limit": err_delta, "fault_row": fault_row})
    outs = (o, *got) + ((so, sdq, sdk, sdv) if cuda_core else ())
    finite = all(bool(torch.isfinite(t).all()) for t in outs)
    cc_ok = not cuda_core or (
        check["cuda_core_fwd"]["err_o_row"] <= O_ROW_TOL[dtype]
        and check["cuda_core_fwd"]["err_lse_of_limit"] <= 1.0
        and check["cuda_core_dq"]["err_row"] <= GRAD_ROW_TOL[dtype]
        and max(check["cuda_core_dkv"]["err_row"].values())
        <= GRAD_ROW_TOL[dtype])
    if not (finite and cc_ok and err_o_row <= O_ROW_TOL[dtype]
            and err_lse <= 1.0 and err_delta <= 1.0
            and max(err_row.values()) <= GRAD_ROW_TOL[dtype]
            and fault_o_row > O_ROW_TOL[dtype]
            and fault_row > GRAD_ROW_TOL[dtype]):
        raise AssertionError(
            f"wide kernels at {[B, H, S, D]} {_dtype_name(dtype)} "
            f"disagree with plain (finite {finite}), or the check misses a "
            f"planted fault: {check}")
    plain_fwd = cuda_ms(lambda: fa._dense_kernel(q, k, v, True, scale),
                        iters=3, warmup=1)
    plain_bwd = cuda_ms(lambda: fa._dense_backward(q, k, v, o, lse, do,
                                                   True, scale),
                        iters=3, warmup=1)
    backend = _sdpa_backend(q, k, v)
    try:
        sdpa_fwd = graph_ms(lambda i: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=2, replays=3)
        sdpa_bwd = _sdpa_backward_ms(q, k, v, do, iters=2, replays=3)
    except RuntimeError as e:   # no backend took the shape
        sdpa_fwd = sdpa_bwd = None
        backend = f"none took the shape: {str(e)[:160]}"
    torch.cuda.empty_cache()
    out = {"shape": [B, H, S, D], "dtype": _dtype_name(dtype),
           "causal": True, "variant": variant, "check": check,
           "sdpa_backend": backend, "plain_bwd_ms": plain_bwd,
           "sdpa_bwd_ms": sdpa_bwd,
           "plain": "_dense_kernel / _dense_backward (dq, dk and dv in "
                    "one call)",
           "library": "scaled_dot_product_attention (backward: dq, dk and "
                      "dv in one call)"}
    for kind in ("fwd", "dq", "dkv"):
        bound_ms, bound_by = (
            attention_bound(B, H, H, S, D, dtype, True) if kind == "fwd"
            else backward_bound(B, H, S, D, dtype, True, kind))
        ops = ({"fwd": 4.0, "dq": 6.0, "dkv": 8.0}[kind] * B * H * S * S * D
               * (S + 1) / (2.0 * S))
        out[kind] = {"kernel_ms": ms[kind], "max_abs_err": errs[kind],
                     "variant": variant,
                     "tflops": ops / ms[kind] * 1e-9,
                     "cuda_core_ms": (cc_ms.get(kind) if cuda_core
                                      else None),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "plain_ms": plain_fwd if kind == "fwd" else plain_bwd,
                     "library_ms": sdpa_fwd if kind == "fwd" else sdpa_bwd}
    return out


def _rms_check(fused, gen, dev, shape, dtype, plain, tol):
    """One RMSNorm kernel launch against ``plain`` on the same inputs, and
    a planted fault (one 64-row block of x zeroed in the plain version)
    read through the same check; raises unless the kernel agrees and the
    fault is flagged."""
    rows, D = shape
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    w = 1 + 0.5 * torch.randn((D,), generator=gen, device=dev)
    out = fused.rms_norm_fused(x, w)
    ref = plain(x, w, 1e-6)
    x_fault = x.clone()
    x_fault[rows // 2:rows // 2 + 64] = 0
    fault = plain(x_fault, w, 1e-6)
    torch.cuda.synchronize()

    def of_limit(a):
        lim = tol[dtype] * (ref.float().abs() + 1)
        return ((a.float() - ref.float()).abs() / lim).max().item()

    err, fault_err = of_limit(out), of_limit(fault)
    max_abs = (out.float() - ref.float()).abs().max().item()
    ok = err <= 1.0 and bool(torch.isfinite(out).all())
    check = {"shape": list(shape), "dtype": str(dtype).split(".")[1],
             "formula": plain.__name__, "err_of_limit": err,
             "max_abs": max_abs, "tol": tol[dtype],
             "fault_of_limit": fault_err, "ok": ok}
    if not ok or fault_err <= 1.0:
        emit({"phase": "kernels_rms", "check": check})
        raise AssertionError(f"RMSNorm kernel disagrees with plain, or the "
                             f"check misses a planted fault: {check}")
    return x, w, max_abs, check


def phase_rms(dev):
    """The Triton RMSNorm kernel vs its plain version at [4*2048, 512] in
    bf16 and f32, with a planted fault, timed beside F.rms_norm (each
    timed as device time through a CUDA graph); and at a row count where
    the reference's rule of shapes picks its unfused formula, against
    that formula."""
    from ray_tpu_torch.ops import fused

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows, D = RMS_SHAPE
    checks = []
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        checks.append(_rms_check(fused, gen, dev, RMS_CAST_FIRST_SHAPE,
                                 dtype, fused._rms_unfused,
                                 RMS_TOL_CAST_FIRST)[3])
        x, w, max_abs, check = _rms_check(fused, gen, dev, RMS_SHAPE, dtype,
                                          fused._rms_plain, RMS_TOL)
        checks.append(check)
        # Each timed call reads one of 8 copies of x (67 MB in bf16, more
        # than the 50 MB L2), so it finds its input in device memory, as
        # the bytes bound assumes, not in L2 from the call before.
        xs = [x.clone() for _ in range(8)]
        n = fused.launches
        kernel_ms = graph_ms(lambda i: fused.rms_norm_fused(xs[i % 8], w))
        fused.launches = n   # timing launches are not the main path's
        plain_ms = graph_ms(lambda i: fused._rms_plain(xs[i % 8], w, 1e-6))
        library_ms = None
        if hasattr(F, "rms_norm"):
            wl = w.to(dtype)
            library_ms = graph_ms(
                lambda i: F.rms_norm(xs[i % 8], (D,), wl, 1e-6))
        del xs
        elt = torch.finfo(dtype).bits // 8
        nbytes = 2 * elt * rows * D + 4 * D   # x read, out written, w read
        timing[str(dtype).split(".")[1]] = {
            "shape": [rows, D], "max_abs_err": max_abs,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
    emit({"phase": "kernels_rms", "checks": checks, "timing": timing})
    return timing


def _flash_module():
    # ray_tpu_torch.ops re-exports the function under the module's name.
    return importlib.import_module("ray_tpu_torch.ops.flash_attention")


def _prompts(rng, lens, vocab):
    return [rng.integers(1, vocab, n).tolist() for n in lens]


def _tables(rng, n_seqs, blocks_each):
    perm = rng.permutation(np.arange(1, n_seqs * blocks_each + 1))
    return perm.reshape(n_seqs, blocks_each).astype(np.int64)


def flash_path(cfg, params, prompts, pad_to, decode_steps, dev):
    """prefill_with_cache on right-padded prompts, then greedy
    decode_steps, with the flash launch counts set to 0 just before.
    Returns (prefill logits, greedy tokens per prompt, launches after the
    prefill, launches after the decodes, tables, tokens, prompt lens,
    launches per forward variant after the prefill)."""
    from ray_tpu_torch import models as tm

    fa = _flash_module()
    B = len(prompts)
    blocks_each = -(-(pad_to + decode_steps + 1) // BLOCK_SIZE)
    tables = _tables(np.random.default_rng(SEED + 1), B, blocks_each)
    cache = tm.init_kv_cache(cfg, B * blocks_each + 1, BLOCK_SIZE,
                             device=dev)
    toks = np.zeros((B, pad_to), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    bt = torch.from_numpy(tables).to(dev)
    tok_t = torch.from_numpy(toks).to(dev)
    fa.launches = fa.wgmma_launches = fa.tiled_f32_launches = 0
    fa.simt_launches = 0
    fa.wide_launches = fa.wide_wgmma_launches = fa.wide_f32_launches = 0
    logits, cache = tm.prefill_with_cache(cfg, params, cache, tok_t, lens,
                                          bt)
    torch.cuda.synchronize()
    after_prefill = fa.launches
    variants = _variant_counts(fa)
    nxt = torch.argmax(logits, dim=-1)
    out = [[int(t)] for t in nxt.tolist()]
    pos = lens.clone()
    for _ in range(decode_steps):
        lg, cache = tm.decode_step(cfg, params, cache, nxt, pos, bt)
        nxt = torch.argmax(lg, dim=-1)
        pos = pos + 1
        for i, t in enumerate(nxt.tolist()):
            out[i].append(int(t))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits")
    return (logits, out, after_prefill, fa.launches, bt, tok_t, lens,
            variants)


def phase_model(dev, base, lens, pad_to, decode_steps):
    from ray_tpu_torch import models as tm

    fa = _flash_module()
    results = {}
    for name, cfg in (("mha", base),
                      ("gqa", dataclasses.replace(base, n_kv_heads=4))):
        params = tm.serving_params(tm.init_params(cfg, SEED, device=dev),
                                   cfg, dev)
        prompts = _prompts(np.random.default_rng(SEED), lens,
                           cfg.vocab_size)
        (logits, out, after_prefill, after_all, bt, toks, plens,
         variants) = flash_path(cfg, params, prompts, pad_to, decode_steps,
                                dev)
        variant = fa._forward_variant(cfg.dtype, cfg.head_dim)
        want_variants = _variant_want(variant, cfg.n_layers)
        if (after_prefill != cfg.n_layers or after_all != cfg.n_layers
                or variants != want_variants):
            raise AssertionError(
                f"{name}: flash kernel launched {after_prefill} times in "
                f"prefill_with_cache ({variants} by variant) and "
                f"{after_all} in all, expected {cfg.n_layers} of variant "
                f"{variant} (one per layer, none in decode)")
        # The same prompts through prefill_chunk (plain paged attention)
        # into a fresh cache: the last-position logits must agree.
        cache2 = tm.init_kv_cache(cfg, int(bt.max()) + 1, BLOCK_SIZE,
                                  device=dev)
        logits2, _ = tm.prefill_chunk(cfg, params, cache2, toks,
                                      torch.zeros_like(plens), plens, bt)
        diff = (logits - logits2).abs().max().item()
        top1 = int((logits.argmax(-1) == logits2.argmax(-1)).sum())
        # The cacheless forward at a length that is no multiple of 128
        # (the kernel masks ragged lengths): one launch per layer, and
        # the shortest prompt's last logits equal the padded prefill's.
        n = fa.launches
        ragged = tm.forward(cfg, params, toks[:, :RAGGED_LEN])
        ragged_launches = fa.launches - n
        short = int(plens.argmin())
        diff_ragged = (ragged[short, int(plens[short]) - 1]
                       - logits[short]).abs().max().item()
        if ragged_launches != cfg.n_layers:
            raise AssertionError(
                f"{name}: forward at S={RAGGED_LEN} launched the flash "
                f"kernel {ragged_launches} times, expected {cfg.n_layers}")
        diff = max(diff, diff_ragged)
        results[name] = {"n_kv_heads": cfg.n_kv_heads,
                         "launches": after_all,
                         "launches_per_prefill": after_prefill,
                         "launches_per_prefill_by_variant": variants,
                         "forward_len": RAGGED_LEN,
                         "forward_launches": ragged_launches,
                         "forward_vs_prefill_max_abs": diff_ragged,
                         "flash_vs_paged_max_abs": diff,
                         "tol": MODEL_LOGIT_TOL, "top1_agree": top1,
                         "decoded": [len(o) for o in out]}
        if diff > MODEL_LOGIT_TOL:
            emit({"phase": "model", "results": results})
            raise AssertionError(f"{name}: flash path and paged path "
                                 f"logits differ by {diff}")
    emit({"phase": "model", "results": results})
    return results


def _run_concurrent(engine, prompts, new_tokens):
    """All prompts at once, one consumer thread each. Returns (streams,
    times to first token, gaps between a stream's tokens, wall seconds)."""
    outs = [None] * len(prompts)
    ttft = [None] * len(prompts)
    gaps = [[] for _ in prompts]

    def consume(i):
        t0 = last = time.perf_counter()
        toks = []
        for tok in engine.generate(prompts[i], max_new_tokens=new_tokens):
            now = time.perf_counter()
            if toks:
                gaps[i].append(now - last)
            else:
                ttft[i] = now - t0
            last = now
            toks.append(tok)
        outs[i] = toks

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or any(o is None for o in outs):
        raise AssertionError("concurrent requests did not complete")
    return outs, ttft, [g for row in gaps for g in row], wall


def _concurrent_equals_sequential(make_engine, prompts, new_tokens):
    """Each request alone, then all at once on a fresh engine with the
    same weights (a fresh prefix cache, so the concurrent run prefills
    every prompt in shared batches rather than hitting the sequential
    run's cached blocks); raises unless the streams are equal. Returns
    the concurrent run's (streams, ttft, gaps, wall, stats)."""
    engine = make_engine()
    try:
        sequential = []
        for p in prompts:
            sequential.append(list(engine.generate(
                p, max_new_tokens=new_tokens)))
            if not engine.wait_idle(120):
                raise AssertionError("engine did not go idle")
    finally:
        engine.shutdown()
    engine = make_engine()
    try:
        concurrent, ttft, gaps, wall = _run_concurrent(engine, prompts,
                                                       new_tokens)
        st = engine.stats()
    finally:
        engine.shutdown()
    if concurrent != sequential:
        bad = [i for i, (a, b) in enumerate(zip(concurrent, sequential))
               if a != b]
        raise AssertionError(f"concurrent streams {bad} differ from their "
                             f"sequential runs")
    return concurrent, ttft, gaps, wall, st


def phase_engine(dev, card, cfg, lens, model_lens, pad_to, new_tokens):
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine

    fa = _flash_module()
    prompts = _prompts(np.random.default_rng(SEED + 2), lens,
                       cfg.vocab_size)

    def make_engine():
        return InferenceEngine(EngineConfig(
            model=cfg, num_blocks=512, block_size=BLOCK_SIZE,
            device=str(dev)))

    fa.launches = 0
    concurrent, ttft, gaps, wall, st = _concurrent_equals_sequential(
        make_engine, prompts, new_tokens)
    generated = sum(len(o) for o in concurrent)
    ttft_sorted = sorted(ttft)
    gaps_sorted = sorted(gaps)
    bf16 = {"requests": len(prompts), "prompt_lens": lens,
            "new_tokens": new_tokens, "concurrent_equals_sequential": True,
            "tokens_per_s": generated / wall, "wall_s": wall,
            "ttft_p50_s": ttft_sorted[len(ttft) // 2],
            "ttft_max_s": ttft_sorted[-1],
            "token_gap_p50_s": gaps_sorted[len(gaps) // 2],
            "token_gap_max_s": gaps_sorted[-1],
            "flash_launches": fa.launches,
            "prefix_cache_hits": st["prefix_cache_hits"],
            "engine_steps": st["steps"],
            "max_prefill_tokens_per_step": st["max_prefill_tokens_per_step"],
            "card": card}

    # Cross-path check in f32: the engine's greedy tokens equal the flash
    # path's for phase 3's prompts.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = tm.init_params(cfg32, SEED, device=dev)
    prompts3 = _prompts(np.random.default_rng(SEED), model_lens,
                        cfg32.vocab_size)
    flash_tokens = flash_path(
        cfg32, params32, prompts3, pad_to, new_tokens - 1, dev)[1]
    engine32 = InferenceEngine(EngineConfig(
        model=cfg32, num_blocks=512, block_size=BLOCK_SIZE,
        device=str(dev)), params=params32)
    try:
        engine_tokens = _run_concurrent(engine32, prompts3, new_tokens)[0]
    finally:
        engine32.shutdown()
    if engine_tokens != flash_tokens:
        bad = [i for i, (a, b) in enumerate(zip(engine_tokens, flash_tokens))
               if a != b]
        raise AssertionError(f"f32 engine tokens differ from the flash "
                             f"path's for prompts {bad}")
    emit({"phase": "engine", "bf16": bf16,
          "f32_engine_equals_flash_path": True})
    return bf16


def _named_leaves(params):
    out = [(n, params[n]) for n in ("embed", "final_norm", "lm_head")]
    out += [(f"layers.{n}", t) for n, t in sorted(params["layers"].items())]
    return out


def _counts():
    from ray_tpu_torch.ops import fused

    fa = _flash_module()
    return {"fwd": fa.launches, **_variant_counts(fa), "dq": fa.dq_launches,
            "dkv": fa.dkv_launches, **_backward_counts(fa),
            "rms": fused.launches}


def _want_counts(variant, fwd, bwd):
    """_counts() of a run that launched the forward `fwd` times and each
    backward kernel `bwd` times, all of kernel variant `variant`, and no
    RMSNorm."""
    return {"fwd": fwd, **_variant_want(variant, fwd), "dq": bwd,
            "dkv": bwd, **_backward_want(variant, bwd), "rms": 0}


def _zero_counts():
    from ray_tpu_torch.ops import fused

    fa = _flash_module()
    for name in _COUNTERS:
        if name != "plain_routes":
            setattr(fa, name, 0)
    fused.launches = 0


@contextlib.contextmanager
def _attention_swapped(kind):
    """The model's attention swapped, so the same loss_fn runs another way
    on the card. ``plain``: the plain einsum (the CPU path), no kernels.
    ``heads_tiled``: a planted fault, the GQA heads expanded with
    Tensor.repeat (query head h reads KV head h % n_kv_heads, where the
    reference's jnp.repeat gives h // group), then the same kernels."""
    from ray_tpu_torch.models import transformer as tt

    def plain(q, k, v, causal=True, grad=True):
        return tt._attention_einsum(q, k, v, causal)

    def heads_tiled(q, k, v, causal=True, grad=True):
        group = q.shape[2] // k.shape[2]
        return tt._attention_flash(q, k.repeat(1, 1, group, 1),
                                   v.repeat(1, 1, group, 1), causal, grad)

    kernel_path = tt._attention_dense
    tt._attention_dense = {"plain": plain, "heads_tiled": heads_tiled}[kind]
    try:
        yield
    finally:
        tt._attention_dense = kernel_path


def _loss_and_grads(cfg, params, tokens, targets):
    from ray_tpu_torch import models as tm

    named = _named_leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    loss = tm.loss_fn(cfg, params, tokens, targets)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    torch.cuda.synchronize()
    return loss.item(), dict(zip([n for n, _ in named], grads))


def _grad_errors(grads, ref):
    return {n: ((grads[n] - ref[n]).abs().max()
                / ref[n].abs().max().clamp_min(1e-30)).item() for n in ref}


def _profile_steps(step, inputs, targets, steps=PROFILED_STEPS):
    """``steps`` more bf16 steps under torch.profiler (device
    activity only, to keep host overhead out of the wall time): per step,
    the wall time, the device's kernel time (all kernels, the flash
    kernels, the rest), the device's idle share of the wall time, and the
    kernels that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(inputs, targets)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"wall_ms_per_step": wall_ms,
                "device_busy_ms_per_step": "not measured: the profiler "
                                           "recorded no device events"}
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3 / steps)
    busy = sum(by_name.values())
    flash = sum(ms for n, ms in by_name.items() if "flash_" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy,
            "flash_kernels_ms_per_step": flash,
            "other_kernels_ms_per_step": busy - flash,
            "device_idle_share": 1 - busy / wall_ms,
            "kernels_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": [[n[:80], ms] for n, ms in top]}


def _resumed_steps(cfg, dev, inputs, targets):
    """Phase 5 (e): RESUME_STEPS bf16 AdamW steps (make_train_step, f32
    masters) run through, against RESUME_AT steps, a checkpoint of the
    parameters and the optimizer's state in a temporary directory, a
    fresh step built from other initial weights with both restored, and
    the remaining steps. A second uninterrupted run tells a
    nondeterministic op apart from a faulty checkpoint."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.train import Checkpoint

    def steps(step, n):
        return [step(inputs, targets).item() for _ in range(n)]

    runs = []
    for _ in range(2):
        params = tm.init_params(cfg, SEED, device=dev)
        runs.append((steps(tm.make_train_step(cfg, params), RESUME_STEPS),
                     params))
    (want, ref), (again, ref_again) = runs
    first = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, first)
    got = steps(step, RESUME_AT)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck = Checkpoint.from_pytree(
            {"params": first, "opt": step.optimizer.state_dict()},
            os.path.join(tmp, "ck"))
        save_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(f.stat().st_size
                     for f in Path(ck.as_directory()).rglob("*"))
        del first, step
        fresh = tm.init_params(cfg, SEED + 1, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = ck.to_pytree(device=dev)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
    src = dict(_named_leaves(restored["params"]))
    with torch.no_grad():
        for name, t in _named_leaves(fresh):
            t.copy_(src[name])
    step = tm.make_train_step(cfg, fresh)
    step.optimizer.load_state_dict(restored["opt"])
    got += steps(step, RESUME_STEPS - RESUME_AT)
    diff = {n: (t - r).abs().max().item() for (n, t), (_, r) in zip(
        _named_leaves(fresh), _named_leaves(ref))}
    diff_again = {n: (t - r).abs().max().item() for (n, t), (_, r) in zip(
        _named_leaves(ref_again), _named_leaves(ref))}
    ok = got == want and not any(diff.values())
    return ok, {"steps": RESUME_STEPS, "checkpoint_after": RESUME_AT,
                "losses_uninterrupted": want, "losses_resumed": got,
                "param_max_abs_diff": max(diff.values()),
                "leaves_differing": [n for n, d in diff.items() if d],
                "uninterrupted_repeat_equal": again == want and not any(
                    diff_again.values()),
                "save_ms": save_ms, "load_ms": load_ms,
                "checkpoint_bytes": nbytes}


def _traced_step(dev, step, inputs, targets):
    """Phase 5 (d): one bf16 step under profile_trace inside an annotate
    span; the trace's CUDA kernel events by TRACE_KERNELS name, its span
    events, and the launch counters over the same step."""
    from ray_tpu_torch.util import profiling

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        _zero_counts()
        with profiling.profile_trace(tmp, device=dev):
            with profiling.annotate(TRACE_SPAN):
                step(inputs, targets)
            torch.cuda.synchronize()
        counters = _counts()
        (path,) = profiling.trace_files(tmp)
        trace_bytes = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    in_trace = {c: sum(name in e.get("name", "") for e in kernels)
                for c, name in TRACE_KERNELS.items()}
    spans = sum(e.get("name") == TRACE_SPAN for e in events)
    launched = {c: counters[c] for c in TRACE_KERNELS}
    ok = spans >= 1 and in_trace == launched and all(launched.values())
    return ok, {"span_events": spans, "kernel_events": len(kernels),
                "flash_kernel_events": in_trace,
                "launch_counters": launched, "trace_bytes": trace_bytes}


def phase_train(dev, card, base):
    from ray_tpu_torch import models as tm

    results = {}
    for name, cfg in (("mha", base),
                      ("gqa", dataclasses.replace(base, n_kv_heads=4))):
        L = cfg.n_layers
        rng = np.random.default_rng(SEED + 5)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_LEN + 1))).to(dev)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]

        # (a) f32 gradients: kernels (with and without remat) vs plain.
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        params = tm.init_params(cfg32, SEED, device=dev)
        _zero_counts()
        loss_k, grads_k = _loss_and_grads(cfg32, params, inputs, targets)
        counts = _counts()
        _zero_counts()
        loss_r, grads_r = _loss_and_grads(
            dataclasses.replace(cfg32, remat=True), params, inputs, targets)
        counts_remat = _counts()
        _zero_counts()
        with _attention_swapped("plain"):
            loss_p, grads_p = _loss_and_grads(cfg32, params, inputs,
                                              targets)
        counts_plain = _counts()
        # The planted fault (GQA only: with one KV head per query head the
        # two orders agree) must read above the tolerance in every leaf.
        err_fault = None
        if cfg.n_kv_heads != cfg.n_heads:
            with _attention_swapped("heads_tiled"):
                grads_f = _loss_and_grads(cfg32, params, inputs, targets)[1]
            err_fault = _grad_errors(grads_f, grads_p)
            del grads_f
        want = _want_counts("tiled_f32", L, L)
        want_remat = _want_counts("tiled_f32", 2 * L, L)
        err_plain = _grad_errors(grads_k, grads_p)
        err_remat = _grad_errors(grads_r, grads_k)
        res = {"n_kv_heads": cfg.n_kv_heads, "f32_loss_kernels": loss_k,
               "f32_loss_plain": loss_p, "f32_loss_remat": loss_r,
               "launches_per_pass": counts,
               "launches_per_pass_remat": counts_remat,
               "grad_err_vs_plain": err_plain,
               "grad_err_remat_vs_no_remat": err_remat,
               "grad_err_planted_fault_vs_plain": err_fault,
               "tol": TRAIN_GRAD_TOL}
        results[name] = res
        del params, grads_k, grads_r, grads_p
        torch.cuda.empty_cache()
        bad = [n for n, e in {**err_plain, **err_remat}.items()
               if not e <= TRAIN_GRAD_TOL]
        missed = err_fault is not None and not min(
            err_fault.values()) > TRAIN_GRAD_TOL
        if (counts != want or counts_remat != want_remat
                or any(counts_plain.values()) or bad or missed):
            emit({"phase": "train", "results": results})
            raise AssertionError(
                f"{name}: kernel gradients or launch counts wrong, or the "
                f"check misses the planted fault (leaves {bad}; fault "
                f"missed {missed}; launches {counts}, remat "
                f"{counts_remat}, plain {counts_plain})")

        # (b) bf16, the main path's type: the loss of the first step
        # through the kernels against plain attention, and one pass's
        # launches by forward variant, without and with remat.
        params = tm.init_params(cfg, SEED, device=dev)
        _zero_counts()
        loss_kb = _loss_and_grads(cfg, params, inputs, targets)[0]
        counts_b = _counts()
        _zero_counts()
        _loss_and_grads(dataclasses.replace(cfg, remat=True), params,
                        inputs, targets)
        counts_b_remat = _counts()
        with _attention_swapped("plain"):
            loss_pb = _loss_and_grads(cfg, params, inputs, targets)[0]
        err_loss = abs(loss_kb - loss_pb) / abs(loss_pb)
        want_b = _want_counts("wgmma", L, L)
        want_b_remat = _want_counts("wgmma", 2 * L, L)
        res.update({"bf16_loss_kernels": loss_kb, "bf16_loss_plain": loss_pb,
                    "bf16_loss_err_vs_plain": err_loss,
                    "bf16_loss_tol": TRAIN_LOSS_TOL_BF16,
                    "bf16_launches_per_pass": counts_b,
                    "bf16_launches_per_pass_remat": counts_b_remat})
        torch.cuda.empty_cache()
        if (not err_loss <= TRAIN_LOSS_TOL_BF16 or counts_b != want_b
                or counts_b_remat != want_b_remat):
            emit({"phase": "train", "results": results})
            raise AssertionError(
                f"{name}: bf16 loss through the kernels {loss_kb} against "
                f"{loss_pb} through plain attention, or launches per pass "
                f"{counts_b} (remat {counts_b_remat}), expected {want_b} "
                f"(remat {want_b_remat})")

        # (c) bf16 AdamW steps on one fixed batch: the main path.
        step = tm.make_train_step(cfg, params)
        losses, step_s = [], []
        _zero_counts()
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss = step(inputs, targets).item()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
        counts = _counts()
        n = TRAIN_STEPS
        want = _want_counts("wgmma", n * L, n * L)
        res.update({"bf16_losses": losses, "bf16_launches": counts,
                    "bf16_step_s": step_s,
                    "bf16_step_profile": _profile_steps(step, inputs,
                                                        targets)})
        if name == "mha":   # (d) one more step, traced
            traced_ok, res["traced_step"] = _traced_step(dev, step, inputs,
                                                         targets)
        del params, step
        torch.cuda.empty_cache()
        if (counts != want or not all(np.isfinite(losses))
                or not losses[-1] < losses[0]):
            emit({"phase": "train", "results": results})
            raise AssertionError(f"{name}: bf16 steps gave losses {losses} "
                                 f"and launches {counts}, expected finite, "
                                 f"falling losses and {want}")
        if name != "mha":
            continue
        emit({"train_trace": res["traced_step"], "card": card})
        if not traced_ok:
            emit({"phase": "train", "results": results})
            raise AssertionError(
                f"the profiled step's trace lacks its span or disagrees "
                f"with the launch counters: {res['traced_step']}")
        # (e) The flagship's steps resumed from a checkpoint.
        resume_ok, res["resume"] = _resumed_steps(cfg, dev, inputs, targets)
        torch.cuda.empty_cache()
        emit({"train_resume": res["resume"], "card": card})
        if not resume_ok:
            emit({"phase": "train", "results": results})
            raise AssertionError(f"the resumed steps differ from the "
                                 f"uninterrupted run: {res['resume']}")
    emit({"phase": "train", "results": results})
    for name, res in results.items():
        later = sorted(res["bf16_step_s"][1:])
        emit({"train_step_smoke_reading": name,
              "tokens_per_step": TRAIN_BATCH * TRAIN_LEN,
              "step_ms_median_of_steps_2_to_5": later[len(later) // 2] * 1e3,
              "first_step_ms": res["bf16_step_s"][0] * 1e3,
              "profiled_steps": res["bf16_step_profile"], "card": card})
    return results


# ----------------------------------------------------- phase 6: spec_disagg
def _run_batch(engine, prompts, new_tokens):
    """All prompts submitted under the engine's lock, so the first step
    admits every one and the schedule does not depend on thread timing.
    Returns (streams, gaps between a stream's tokens, wall seconds)."""
    with engine._lock:
        reqs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
    t0 = time.perf_counter()
    stamps = [[] for _ in reqs]
    errors = []

    def consume(i):
        while True:
            item = reqs[i].output_queue.get(timeout=600)
            if isinstance(item, tuple):
                if item[0] != "__done__":
                    errors.append(item[1])
                return
            stamps[i].append(time.perf_counter())

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"requests did not complete: {errors}")
    outs = [list(r.out_tokens) for r in reqs]
    if any(len(o) != new_tokens for o in outs):
        raise AssertionError(f"stream lengths {[len(o) for o in outs]}, "
                             f"expected {new_tokens}")
    gaps = [b - a for row in stamps for a, b in zip(row, row[1:])]
    return outs, gaps, wall


def _serve(make, prompts, new_tokens):
    """One engine from ``make()``, the prompts as one batch, shut down
    with no block left in use. Returns (streams, stats, gaps, wall)."""
    engine = make()
    try:
        outs, gaps, wall = _run_batch(engine, prompts, new_tokens)
        if not engine.wait_idle(120):
            raise AssertionError("engine did not go idle")
        st = engine.stats()
    finally:
        engine.shutdown()
    if st["blocks_in_use"]:
        raise AssertionError(f"{st['blocks_in_use']} blocks leaked")
    return outs, st, gaps, wall


def _reading(outs, gaps, wall):
    gaps = sorted(gaps)
    return {"tokens_per_s": sum(len(o) for o in outs) / wall, "wall_s": wall,
            "token_gap_p50_s": gaps[len(gaps) // 2],
            "token_gap_max_s": gaps[-1]}


def _check_spec_counters(name, spec, batch):
    if not (spec["rounds"] <= spec["emitted"]
            <= spec["accepted"] + spec["rounds"] * batch):
        raise AssertionError(f"{name}: inconsistent spec counters {spec}")
    if spec["fallback_rounds"]:
        raise AssertionError(f"{name}: {spec['fallback_rounds']} rounds fell "
                             f"back to vanilla decode")


def _verify_vs_decode(cfg, params, prompts, streams, k, dev):
    """Yardstick for SPEC_TIE_TOL_BF16: on the vanilla streams' own
    contexts, the largest |verify_step - decode_step| logit difference
    over one round of k + 1 tokens, padded as the engine pads them (every
    row in one batch, the verify columns to a power of two)."""
    from ray_tpu_torch import models as tm

    b = len(prompts)
    c_pad = 1 << (k).bit_length()          # _pow2_at_least(k + 1)
    worst = 0.0
    for offset in SPEC_YARDSTICK_OFFSETS:
        ctxs = [p + s[:offset + 1] for p, s in zip(prompts, streams)]
        lens = [len(c) - 1 for c in ctxs]    # the last token is not cached
        pad = 1 << (max(lens) - 1).bit_length()
        # Every padded position has a table column: nothing clamps.
        blocks_each = -(-(pad + c_pad + 1) // BLOCK_SIZE)
        tables = torch.arange(1, b * blocks_each + 1, device=dev).reshape(
            b, blocks_each)
        cache = tm.init_kv_cache(cfg, b * blocks_each + 1, BLOCK_SIZE,
                                 device=dev)
        toks = np.zeros((b, pad), np.int64)
        vtok = np.zeros((b, c_pad), np.int64)
        for i, (c, s) in enumerate(zip(ctxs, streams)):
            toks[i, :lens[i]] = c[:-1]
            vtok[i, :k + 1] = [c[-1]] + s[offset + 1:offset + 1 + k]
        toks, vtok = (torch.from_numpy(a).to(dev) for a in (toks, vtok))
        start = torch.tensor(lens, device=dev)
        tm.prefill_chunk(cfg, params, cache, toks, torch.zeros_like(start),
                         start, tables)
        seq = {n: t.clone() for n, t in cache.items()}
        vl, _ = tm.verify_step(cfg, params, cache, vtok, start, tables)
        for j in range(k + 1):
            dl, seq = tm.decode_step(cfg, params, seq, vtok[:, j], start + j,
                                     tables)
            worst = max(worst, (vl[:, j] - dl).abs().max().item())
    return worst


def _first_divergence(got, want):
    return next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                None)


def _ship(pre, dec, prompt, new_tokens, reference, tail_only=False,
          shipped=None):
    """One disaggregated hop: hold ``prompt``'s prefill on ``pre`` and
    export it (from block 0, or with ``tail_only`` from the decode side's
    cached boundary), or reuse ``shipped`` = (held, first token, payload)
    from an earlier hop; adopt on ``dec`` and decode. The continuation
    must equal ``reference``. Returns (held, first token, payload,
    reading)."""
    if shipped is None:
        held = pre.submit(prompt, max_new_tokens=1, hold_after_prefill=True)
        first = _drain(held)[0]
    else:
        held, first, payload = shipped
    areq = dec.begin_adopted(prompt, max_new_tokens=new_tokens)
    if areq is None:
        raise AssertionError("begin_adopted found no room")
    t0 = time.perf_counter()
    if shipped is None:
        start = (areq.cached_prompt_tokens // dec.cache.block_size
                 if tail_only else 0)
        payload = pre.cache.export_blocks(held.seq_id, start)
    t1 = time.perf_counter()
    if not dec.adopt_kv(areq, payload):
        raise AssertionError("adopt_kv refused a fresh payload")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dec.commit_adopted(areq, first)
    out = _drain(areq)
    if out != reference:
        j = _first_divergence(out, reference)
        raise AssertionError(f"adopted continuation differs from the "
                             f"colocated run at token {j}")
    blocks, nbytes = areq.kv_ship
    return held, first, payload, {
        "prompt_len": len(prompt), "start_block": payload["start_block"],
        "cached_prompt_tokens": areq.cached_prompt_tokens,
        "blocks": blocks, "bytes": nbytes,
        "export_ms": (t1 - t0) * 1e3 if shipped is None else None,
        "graft_ms": (t2 - t1) * 1e3}


def _drain(req, timeout_s=600):
    out = []
    while True:
        item = req.output_queue.get(timeout=timeout_s)
        if isinstance(item, tuple):
            if item != ("__done__", "FINISHED"):
                raise AssertionError(f"request ended with {item}")
            return out
        out.append(item)


def phase_spec_disagg(dev, card, cfg, lens, new_tokens):
    """Phase 6 (see the module docstring): speculative decoding and the
    engine side of disaggregated serving at the flagship's width."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine

    k = SPEC_K
    prompts = _prompts(np.random.default_rng(SEED + 2), lens,
                       cfg.vocab_size)
    n = len(prompts)

    def make(model, params, draft=None, draft_params=None, cls=None,
             **over):
        spec = dict(spec_k=k, draft_model=draft) if draft else {}
        return (cls or InferenceEngine)(EngineConfig(
            model=model, num_blocks=SPEC_NUM_BLOCKS, block_size=BLOCK_SIZE,
            device=str(dev), **spec, **over), params=params,
            draft_params=draft_params)

    results = {}
    readings = {}
    # (a), (b): f32, random draft and self-draft, streams equal vanilla.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = tm.init_params(cfg32, SEED, device=dev)
    d32 = tm.draft_config(cfg32)
    dp32 = tm.init_params(d32, SEED + 1, device=dev)
    vanilla32, _, _, _ = _serve(lambda: make(cfg32, p32), prompts,
                                new_tokens)
    f32 = {}
    for name, draft, dparams in (("random_draft", d32, dp32),
                                 ("self_draft", cfg32, p32)):
        outs, st, _, _ = _serve(lambda: make(cfg32, p32, draft, dparams),
                                prompts, new_tokens)
        bad = [i for i in range(n) if outs[i] != vanilla32[i]]
        f32[name] = {"streams_equal_vanilla": not bad, "spec": st["spec"]}
        if bad:
            results["f32"] = f32
            emit({"phase": "spec_disagg", "results": results})
            raise AssertionError(f"f32 {name}: streams {bad} differ from "
                                 f"vanilla")
        _check_spec_counters(f"f32 {name}", st["spec"], n)
    # (b) one round per request: the self-draft's cache is the prefill's.
    outs, st, _, _ = _serve(lambda: make(cfg32, p32, cfg32, p32), prompts,
                            k + 2)
    rate = st["spec"]["acceptance_rate"]
    f32["self_draft_one_round"] = {"acceptance_rate": rate,
                                   "min": SPEC_SELF_ACCEPT_MIN_F32,
                                   "spec": st["spec"]}
    if rate < SPEC_SELF_ACCEPT_MIN_F32 or \
            any(o != v[:k + 2] for o, v in zip(outs, vanilla32)):
        results["f32"] = f32
        emit({"phase": "spec_disagg", "results": results})
        raise AssertionError(f"f32 self-draft, one round: acceptance {rate}"
                             f" (limit {SPEC_SELF_ACCEPT_MIN_F32}) or "
                             f"streams differ from vanilla")
    results["f32"] = f32

    # (c) bf16, random draft and self-draft: equal to vanilla up to the
    # first divergence, which must be a near-tie of vanilla's logits.
    p16 = tm.init_params(cfg, SEED, device=dev)
    d16 = tm.draft_config(cfg)
    dp16 = tm.init_params(d16, SEED + 1, device=dev)
    gaps = {}

    class GapEngine(InferenceEngine):
        """Vanilla engine that records each emitted token's top-two logit
        gap (for the near-tie check; not timed)."""

        def _emit(self, reqs, logits):
            top2 = np.sort(np.partition(logits, -2, axis=-1)[:, -2:], -1)
            for i, req in enumerate(reqs):
                gaps.setdefault(tuple(req.prompt), []).append(
                    float(top2[i, 1] - top2[i, 0]))
            super()._emit(reqs, logits)

    vanilla16, _, vgaps, vwall = _serve(lambda: make(cfg, p16), prompts,
                                        new_tokens)
    readings["vanilla"] = _reading(vanilla16, vgaps, vwall)
    recorded, _, _, _ = _serve(lambda: make(cfg, p16, cls=GapEngine),
                               prompts, new_tokens)
    if recorded != vanilla16:
        raise AssertionError("two vanilla bf16 runs of one batch differ")
    yardstick = _verify_vs_decode(cfg, tm.serving_params(p16, cfg, dev),
                                  prompts, vanilla16, k, dev)
    bf16 = {"tie_tol": SPEC_TIE_TOL_BF16,
            "verify_vs_decode_max_abs": yardstick}
    for name, draft, dparams in (("random_draft", d16, dp16),
                                 ("self_draft", cfg, p16)):
        outs, st, sgaps, swall = _serve(
            lambda: make(cfg, p16, draft, dparams), prompts, new_tokens)
        readings[name] = dict(_reading(outs, sgaps, swall),
                              acceptance_rate=st["spec"]["acceptance_rate"])
        diverged = []
        for i in range(n):
            j = _first_divergence(outs[i], vanilla16[i])
            if j is not None:
                diverged.append({"stream": i, "token": j,
                                 "vanilla_top2_gap":
                                     gaps[tuple(prompts[i])][j]})
        bf16[name] = {"diverging_streams": len(diverged),
                      "divergences": diverged, "spec": st["spec"]}
        _check_spec_counters(f"bf16 {name}", st["spec"], n)
        clear = [d for d in diverged
                 if d["vanilla_top2_gap"] >= SPEC_TIE_TOL_BF16]
        if clear:
            results["bf16"] = bf16
            emit({"phase": "spec_disagg", "results": results})
            raise AssertionError(f"bf16 {name}: divergences with a clear "
                                 f"margin {clear}")
    results["bf16"] = bf16

    # (d) the shift pair: acceptance exactly 1.0, k + 1 tokens a round.
    shift_cfg = dataclasses.replace(cfg, vocab_size=cfg.d_model)
    shift_prompts = _prompts(np.random.default_rng(SEED + 2), lens,
                             shift_cfg.vocab_size)
    shift_new = 1 + 6 * (k + 1)   # the prefill's token, then 6 full rounds
    shift = {}
    for dt in (torch.bfloat16, torch.float32):
        sc = dataclasses.replace(shift_cfg, dtype=dt)
        sd = tm.draft_config(sc, d_model=sc.d_model)
        outs, st, _, _ = _serve(lambda: make(
            sc, tm.shift_params(sc, 1, device=dev), sd,
            tm.shift_params(sd, 1, device=dev)), shift_prompts, shift_new)
        spec = st["spec"]
        want = [[(p[-1] + 1 + i) % sc.vocab_size for i in range(shift_new)]
                for p in shift_prompts]
        shift[_dtype_name(dt)] = spec
        if (outs != want or spec["acceptance_rate"] != 1.0
                or spec["emitted"] != spec["proposed"] // k * (k + 1)
                or spec["fallback_rounds"]):
            results["shift_pair"] = shift
            emit({"phase": "spec_disagg", "results": results})
            raise AssertionError(f"shift pair {_dtype_name(dt)}: {spec}")
    results["shift_pair"] = shift

    # (e) KV transfer, exact in bf16 and f32, and (f) COW with an aux pool.
    transfer = {}
    for dt in (torch.bfloat16, torch.float32):
        mc = dataclasses.replace(cfg, dtype=dt)
        p = tm.init_params(mc, SEED, device=dev)
        dc = tm.draft_config(mc)
        dp = tm.init_params(dc, SEED + 1, device=dev)
        transfer[_dtype_name(dt)] = _transfer_checks(
            make, mc, p, dc, dp, prompts, new_tokens)
    results["transfer"] = {d: {key: v for key, v in t.items()
                               if key != "ships"}
                           for d, t in transfer.items()}
    results["cow_with_aux"] = _cow_check(make, cfg32, p32, d32, dp32,
                                         new_tokens)
    emit({"phase": "spec_disagg", "results": results})
    for name, r in readings.items():
        emit({"spec_smoke_reading": name, "requests": n,
              "new_tokens": new_tokens, "spec_k": k if name != "vanilla"
              else 0, "dtype": "bfloat16", **r, "card": card})
    for dt, t in transfer.items():
        emit({"kv_transfer_smoke_reading": dt, "ships": t["ships"],
              "card": card})
    return results


def _transfer_checks(make, mc, p, dc, dp, prompts, new_tokens):
    """(e): every prompt shipped in full from a prefill engine to a decode
    engine, one at a time, each continuation equal to a colocated run of
    the same request; then a cached-prefix adoption, a tail-only ship and
    a stale plan on prompt SHIP_PROMPT; then a full ship between
    spec-armed engines (the draft pool ships too) against a colocated spec
    engine. No block stays in use on either side."""
    colo = make(mc, p)
    try:
        refs = [_drain(colo.submit(q, max_new_tokens=new_tokens))
                for q in prompts]
        # The same prompt again hits the colocated prefix cache: the
        # tail-only ship's prefill has this run's shapes.
        ref_cached = _drain(colo.submit(prompts[SHIP_PROMPT],
                                        max_new_tokens=new_tokens))
    finally:
        colo.shutdown()
    pre, dec = make(mc, p), make(mc, p)
    out = {}
    try:
        ships, helds = [], []
        for i, (q, ref) in enumerate(zip(prompts, refs)):
            held, first, payload, r = _ship(pre, dec, q, new_tokens, ref)
            helds.append(held)
            ships.append(r)
            if i == SHIP_PROMPT:
                shipped = (held, first, payload)
        # The same payload again: the decode side now caches the prompt's
        # full blocks, so the graft writes only the rest.
        q = prompts[SHIP_PROMPT]
        cached = _ship(pre, dec, q, new_tokens, refs[SHIP_PROMPT],
                       shipped=shipped)[3]
        if cached["cached_prompt_tokens"] == 0:
            raise AssertionError("cached-prefix adoption found no prefix")
        # A second prefill of the prompt hits the prefill side's cache
        # too, as the colocated run's second request did.
        held, _, _, tail = _ship(pre, dec, q, new_tokens, ref_cached,
                                 tail_only=True)
        helds.append(held)
        if not 0 < tail["blocks"] < ships[SHIP_PROMPT]["blocks"]:
            raise AssertionError(f"tail-only ship carried {tail['blocks']} "
                                 f"blocks")
        # A stale plan: exported past the decode side's boundary (it
        # caches nothing of this prompt) is refused and aborted clean.
        stale_prompt = [t % (mc.vocab_size - 1) + 1 for t in q[::-1]]
        held = pre.submit(stale_prompt, max_new_tokens=1,
                          hold_after_prefill=True)
        _drain(held)
        helds.append(held)
        in_use = dec.cache.stats()["blocks_in_use"]
        areq = dec.begin_adopted(stale_prompt, max_new_tokens=new_tokens)
        if dec.adopt_kv(areq, pre.cache.export_blocks(held.seq_id, 1)):
            raise AssertionError("adopt_kv took a stale-plan payload")
        dec.abort_adopted(areq)
        if dec.cache.stats()["blocks_in_use"] != in_use:
            raise AssertionError("abort_adopted leaked blocks")
        for h in helds:
            pre.release_held(h.seq_id)
        if not dec.wait_idle(120):
            raise AssertionError("decode engine did not go idle")
        out.update(full_ships=len(ships), cached_prefix=cached,
                   tail_only=tail, stale_plan_refused=True,
                   blocks_exported=pre.cache.stats()["blocks_exported"],
                   blocks_grafted=dec.cache.stats()["blocks_grafted"])
        leaked = (pre.cache.stats()["blocks_in_use"],
                  dec.cache.stats()["blocks_in_use"])
    finally:
        pre.shutdown()
        dec.shutdown()
    if any(leaked):
        raise AssertionError(f"blocks left in use (prefill, decode): "
                             f"{leaked}")
    # The same full ship between spec-armed engines.
    spec_refs = []
    colo = make(mc, p, dc, dp)
    try:
        for i in SPEC_SHIP_PROMPTS:
            spec_refs.append(_drain(colo.submit(
                prompts[i], max_new_tokens=new_tokens)))
    finally:
        colo.shutdown()
    pre, dec = make(mc, p, dc, dp), make(mc, p, dc, dp)
    try:
        spec_ships = []
        for i, ref in zip(SPEC_SHIP_PROMPTS, spec_refs):
            held, _, payload, r = _ship(pre, dec, prompts[i], new_tokens,
                                        ref)
            if set(payload["aux"]) != {"draft"}:
                raise AssertionError("the draft pool did not ship")
            pre.release_held(held.seq_id)
            spec_ships.append(r)
        if not dec.wait_idle(120):
            raise AssertionError("decode engine did not go idle")
        leaked = (pre.cache.stats()["blocks_in_use"],
                  dec.cache.stats()["blocks_in_use"])
        spec = dec.stats()["spec"]
    finally:
        pre.shutdown()
        dec.shutdown()
    if any(leaked):
        raise AssertionError(f"spec ship left blocks in use: {leaked}")
    if spec["rounds"] == 0:
        raise AssertionError("the spec-armed decode engine ran no round")
    out.update(spec_armed_ships=spec_ships, spec_armed_decode=spec,
               continuations_equal_colocated=True, ships=ships)
    return out


def _cow_check(make, cfg32, p, draft, dp, new_tokens):
    """(f): a fully cached prompt on a spec engine copies its boundary
    block on write while the donor holds it; the copy covers the draft's
    aux pool, and both streams equal vanilla's."""
    prompt = _prompts(np.random.default_rng(SEED + 3), [COW_PROMPT_LEN],
                      cfg32.vocab_size)[0]
    vanilla = make(cfg32, p)
    try:
        # The second run hits the prefix cache (fully cached prompt) as
        # the spec engine's second request does.
        want = [_drain(vanilla.submit(prompt, max_new_tokens=new_tokens))
                for _ in range(2)]
    finally:
        vanilla.shutdown()
    engine = make(cfg32, p, draft, dp)
    try:
        with engine._lock:
            donor = engine.submit(prompt, max_new_tokens=new_tokens)
            if not engine.step() or len(donor.out_tokens) != 1:
                raise AssertionError("donor prefill did not complete")
            second = engine.submit(prompt, max_new_tokens=new_tokens)
            engine.step()
            idx = COW_PROMPT_LEN // BLOCK_SIZE - 1
            src = engine.cache.table(donor.seq_id)[idx]
            dst = engine.cache.table(second.seq_id)[idx]
            copied = src != dst
            for pool in (engine.cache.data, engine.cache.aux_data("draft")):
                for name in ("k", "v"):
                    a = pool[name][:, dst, :BLOCK_SIZE - 1]
                    b = pool[name][:, src, :BLOCK_SIZE - 1]
                    copied = copied and bool(torch.equal(a, b))
        got = [_drain(donor), _drain(second)]
        if not engine.wait_idle(120):
            raise AssertionError("engine did not go idle")
        st = engine.stats()
    finally:
        engine.shutdown()
    if not copied or st["cow_copies"] < 1:
        raise AssertionError(f"no copy on write of both pools (copied "
                             f"{copied}, cow_copies {st['cow_copies']})")
    if got != want:
        raise AssertionError("COW streams differ from vanilla")
    return {"prompt_len": COW_PROMPT_LEN, "cow_copies": st["cow_copies"],
            "aux_block_copied": True, "streams_equal_vanilla": True,
            "spec": st["spec"]}


# ------------------------------------------- phase 2b: C.1's model configs
def _c1_configs(base):
    """The configs of phase 2b: (name, config, forward variant or "plain")."""
    cut = dict(n_layers=C1_DEPTH)
    return (("hd256_bf16", dataclasses.replace(
                base, d_model=2048, n_heads=8, n_kv_heads=8, **cut), "wgmma"),
            # Gemma-2B's attention widths: 8 query heads over one KV head.
            ("hd256_gqa1_bf16", dataclasses.replace(
                base, d_model=2048, n_heads=8, n_kv_heads=1, **cut),
             "wgmma"),
            ("hd512_bf16", dataclasses.replace(
                base, d_model=1024, n_heads=2, n_kv_heads=2, **cut),
             "wide_wgmma"),
            # The same widths in f32: the f32 wide forward, dQ and dK/dV.
            ("hd512_f32", dataclasses.replace(
                base, d_model=1024, n_heads=2, n_kv_heads=2,
                dtype=torch.float32, **cut), "wide_f32"),
            # head_dim 1032 (d_model 2064 over 2 heads): the tensor-core
            # wide kernels past 1024, the forward streaming Q, the last
            # chunk of O, dQ and dK/dV 8 columns wide.
            ("hd1032_bf16", dataclasses.replace(
                base, d_model=2064, n_heads=2, n_kv_heads=2, **cut),
             "wide_wgmma"),
            ("f16", dataclasses.replace(base, dtype=torch.float16, **cut),
             "wgmma"),
            ("hd12_bf16", dataclasses.replace(
                base, d_model=384, n_heads=32, n_kv_heads=8, **cut),
             "plain"),
            # Phi-3-mini's attention widths: d_model 3072 over 32 heads
            # (head_dim 96), 32 KV heads.
            ("hd96_bf16", dataclasses.replace(
                base, d_model=3072, n_heads=32, n_kv_heads=32, **cut),
             "wgmma"),
            # Phi-2's (and Pythia-2.8B's): d_model 2560 over 32 heads
            # (head_dim 80), in float16.
            ("hd80_f16", dataclasses.replace(
                base, d_model=2560, n_heads=32, n_kv_heads=32,
                dtype=torch.float16, **cut), "wgmma"))


def phase_c1_models(dev, base, model_lens):
    """Phase 2b (see the module docstring): configs beyond the bf16
    flagship serve and train through the kernels of the rule (the tensor
    cores at head_dim 256 and in f16; at head_dim 512 the tensor-core wide
    kernels in bf16, the f32 wide kernels in f32; at head_dim 1032 the
    tensor-core wide kernels, the forward streaming Q) or through the
    counted plain route."""
    from ray_tpu_torch import models as tm

    fa = _flash_module()
    results = {}
    for name, cfg, route in _c1_configs(base):
        L = cfg.n_layers
        params = tm.serving_params(tm.init_params(cfg, SEED, device=dev),
                                   cfg, dev)
        prompts = _prompts(np.random.default_rng(SEED), model_lens,
                           cfg.vocab_size)
        fa.plain_routes = 0
        (logits, out, after_prefill, _, bt, toks, plens,
         variants) = flash_path(cfg, params, prompts, 512, 8, dev)
        routes = fa.plain_routes
        cache2 = tm.init_kv_cache(cfg, int(bt.max()) + 1, BLOCK_SIZE,
                                  device=dev)
        logits2, _ = tm.prefill_chunk(cfg, params, cache2, toks,
                                      torch.zeros_like(plens), plens, bt)
        diff = (logits - logits2).abs().max().item()
        del params, cache2
        want_prefill = _variant_want(route, L)
        want_routes = L if route == "plain" else 0
        # A gradient pass and AdamW steps on f32 masters.
        master = tm.init_params(cfg, SEED, device=dev)
        rng = np.random.default_rng(SEED + 6)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (C1_TRAIN_BATCH, C1_TRAIN_LEN + 1))).to(dev)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        _zero_counts()
        fa.plain_routes = 0
        loss0, grads = _loss_and_grads(cfg, master, inputs, targets)
        pass_counts = _counts()
        pass_routes = fa.plain_routes
        finite_grads = all(bool(torch.isfinite(g).all())
                           for g in grads.values())
        del grads
        step = tm.make_train_step(cfg, master)
        losses = [step(inputs, targets).item()
                  for _ in range(C1_TRAIN_STEPS)]
        torch.cuda.synchronize()
        del master, step
        torch.cuda.empty_cache()
        want_pass = (_want_counts(None, 0, 0) if route == "plain"
                     else _want_counts(route, L, L))
        res = {"head_dim": cfg.head_dim, "dtype": _dtype_name(cfg.dtype),
               "n_layers": L, "route": route,
               "launches_per_prefill_by_variant": variants,
               "plain_routes_per_prefill": routes,
               "flash_vs_paged_max_abs": diff, "tol": MODEL_LOGIT_TOL,
               "decoded": [len(o) for o in out],
               "launches_per_pass": pass_counts,
               "plain_routes_per_pass": pass_routes,
               "loss": loss0, "losses": losses}
        results[name] = res
        ok = (variants == want_prefill and after_prefill == sum(
            want_prefill.values()) and routes == want_routes
              and diff <= MODEL_LOGIT_TOL and pass_counts == want_pass
              and pass_routes == want_routes and finite_grads
              and all(np.isfinite([loss0, *losses])))
        if not ok:
            emit({"phase": "c1_models", "results": results})
            raise AssertionError(
                f"{name}: wrong route or launches, non-finite results, or "
                f"flash and paged logits apart: {res}")
    emit({"phase": "c1_models", "results": results})
    return results


# ---------------------------------------------------------------- phase 12: rl
_HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                      "cudaMemcpyAsync", "cudaMemsetAsync")


def _host_launches(fn):
    """Runtime calls that put work on the device during one fn(), by name
    (kernel launches, graph launches, async copies and sets), from
    torch.profiler's host-side trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.name in _HOST_LAUNCH_CALLS:
            counts[e.name] = counts.get(e.name, 0) + 1
    return {"total": sum(counts.values()), **counts}


def _device_share(fn):
    """One fn() under torch.profiler (device activity only): its wall
    time, the device's busy time (kernels and copies) and idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured: the "
                "profiler recorded no device events"}
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_events": len(events),
            "device_idle_share": 1 - busy / wall_ms}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _steps_per_s(runner, params, dev, n=RL_TIMED):
    runner.sample(params)   # warm (captures the graph on the card)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        runner.sample(params)
    _sync(dev)
    return runner.steps_per_sample() * n / (time.perf_counter() - t0)


def _impala_updates(env, dev, graph):
    """Phase 12 (c'): IMPALA's update at RL_IMPALA_SIZES on the runner's
    rollouts. A learner whose update is a graph against one that runs
    the same update eagerly from the same state, twice in a row; then
    RL_TIMED updates each way, timed (one host sync each, as ``update``
    reads its loss), with finite losses and the graph replayed once per
    update."""
    from ray_tpu_torch import rl
    from ray_tpu_torch.rl.ppo import leaves

    out, ok = {}, True
    for envs, T in RL_IMPALA_SIZES:
        runner = rl.EnvRunner(env, envs, T, seed=SEED, device=dev)
        graphed, eager = (rl.IMPALA(env, num_envs=envs, rollout_len=T,
                                    seed=SEED, device=dev)
                          for _ in range(2))
        diff = {"loss": 0.0, "params": 0.0}
        for _ in range(2):
            ro = runner.sample(graphed.get_weights())
            loss_g, loss_e = graphed.update(ro), float(eager._update(ro))
            diff["loss"] = max(diff["loss"], abs(loss_g - loss_e))
            diff["params"] = max(diff["params"], *(
                (x - y).abs().max().item() for x, y in zip(
                    leaves(graphed.params), leaves(eager.params))))
        ro = runner.sample(graphed.get_weights())
        ms, losses = {}, {}
        for way, update in (("graph", graphed.update),
                            ("eager", lambda r: float(eager._update(r)))):
            _sync(dev)
            t0 = time.perf_counter()
            losses[way] = [update(ro) for _ in range(RL_TIMED)]
            _sync(dev)
            ms[way] = (time.perf_counter() - t0) * 1e3 / RL_TIMED
        (_, program), = graphed._programs.values()
        replays_want = 2 + RL_TIMED if graph else 0
        out[f"{envs}x{T}"] = {
            "transitions": envs * T, "graph_vs_eager_max_diff": diff,
            "tol": RL_GRAPH_TOL, "losses": losses,
            "graph_replays": program.replays, "update_ms": ms}
        ok = ok and (max(diff.values()) <= RL_GRAPH_TOL
                     and all(np.isfinite(losses["graph"]))
                     and program.replays == replays_want)
    return out, ok


def phase_rl(dev, card):
    """Phase 12 (see the module docstring): the RL slice at the
    reference's defaults."""
    from ray_tpu_torch import rl
    from ray_tpu_torch.rl import bench as rl_bench
    from ray_tpu_torch.rl.ppo import Rollout, leaves

    graph = dev.type == "cuda"
    env = rl.CartPole()
    learner = rl.PPOLearner(env, device=dev)
    params = learner.get_weights()

    def eager_runner(rollout_len, seed=0):
        """A runner whose program runs eagerly: the graph's twin."""
        runner = rl.EnvRunner(env, RL_ENVS, rollout_len, seed=seed,
                              device=dev)
        runner._impl._program.graph = False
        return runner

    # (a) The graph rollout against the eager one from the same generator
    # state (both runners seeded alike), twice in a row.
    eager = eager_runner(RL_ROLLOUT, SEED)
    graphed = rl.EnvRunner(env, RL_ENVS, RL_ROLLOUT, seed=SEED, device=dev)
    rollout_diff = {}
    for i in range(2):
        a, b = eager.sample(params), graphed.sample(params)
        for name, x, y in zip(Rollout._fields, a, b):
            if x.dtype.is_floating_point:
                d = (x - y).abs().max().item()
            else:
                d = int((x != y).sum())
            rollout_diff[name] = max(rollout_diff.get(name, 0), d)
    same_gen = bool(torch.equal(eager._impl.generator.get_state(),
                                graphed._impl.generator.get_state()))
    rollout_ok = same_gen and all(v <= RL_GRAPH_TOL
                                  for v in rollout_diff.values())
    dones = int(a.dones.sum())
    # (b) Readings: env steps/s eager and graph, host launches per
    # rollout, bench.py's 64 x 512 rollout (config #5) both ways.
    readings = {
        "rollout_steps_per_s": {
            "eager": _steps_per_s(eager, params, dev),
            "graph": _steps_per_s(graphed, params, dev)},
        "bench_64x512": {
            "graph": rl_bench.rollout_throughput(
                RL_ENVS, RL_BENCH_ROLLOUT, RL_TIMED, dev)["env_steps_per_sec"],
            "eager": _steps_per_s(eager_runner(RL_BENCH_ROLLOUT), params,
                                  dev, 2)}}
    if graph:
        readings["host_launches_per_rollout"] = {
            "eager": _host_launches(lambda: eager.sample(params)),
            "graph": _host_launches(lambda: graphed.sample(params))}
    # (c) The PPO update: graph against eager from the same state and
    # generator, then its time.
    ro = graphed.sample(params)
    upd_g = rl.PPOLearner(env, seed=SEED, device=dev)
    upd_e = rl.PPOLearner(env, seed=SEED, device=dev)
    loss_g = upd_g.update(ro)
    loss_e = float(upd_e._update(ro, upd_e._draw_perms(ro.actions.numel())))
    update_diff = max((x - y).abs().max().item() for x, y in zip(
        leaves(upd_g.params), leaves(upd_e.params)))
    update_ok = update_diff <= RL_GRAPH_TOL and abs(loss_g - loss_e) <= \
        RL_GRAPH_TOL
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(RL_TIMED):
        upd_g.update(ro)
    readings["ppo_update_ms"] = (time.perf_counter() - t0) * 1e3 / RL_TIMED
    impala, impala_ok = _impala_updates(env, dev, graph)
    # (d) PPO training at the defaults (tests/test_rl.py's lr).
    algo = (rl.AlgorithmConfig("PPO", device=dev)
            .env_runners(num_envs_per_env_runner=RL_ENVS,
                         rollout_fragment_length=RL_ROLLOUT)
            .training(lr=RL_PPO_LR).debugging(seed=SEED).build())
    ppo = [algo.train() for _ in range(RL_PPO_ITERS)]
    lens = [r["episode_len_mean"] for r in ppo]
    readings["ppo_train_iteration"] = _device_share(algo.train)
    readings["ppo_iteration_ms"] = [r["time_total_s"] * 1e3 for r in ppo]
    readings["ppo_env_steps_per_s"] = [r["env_steps_per_sec"] for r in ppo]
    greedy = algo.evaluate()["episode_return_mean"]
    # (e) DQN: RL_DQN_ITERS iterations past min_buffer_size.
    dqn = (rl.AlgorithmConfig("DQN", device=dev)
           .env_runners(num_envs_per_env_runner=RL_ENVS,
                        rollout_fragment_length=RL_ROLLOUT)
           .debugging(seed=SEED).build())
    dqn_losses = []
    while len(dqn_losses) < RL_DQN_ITERS:
        loss = dqn.train()["loss"]
        if len(dqn.learner._buffer) >= dqn.config.train_config.min_buffer_size:
            dqn_losses.append(loss)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(RL_TIMED):
        dqn.learner.train_from_buffer()
    readings["dqn_train_many_ms"] = (time.perf_counter() - t0) * 1e3 / \
        RL_TIMED
    # (f) Multi-agent PPO at its defaults.
    ma = rl.MultiAgentPPO(rl.CoordinationGame(), device=dev, seed=SEED)
    ma_out = [ma.train() for _ in range(RL_MA_ITERS)]
    result = {
        "config": {"env": "CartPole-v1", "hidden": list(learner.config.hidden),
                   "num_envs": RL_ENVS, "rollout_len": RL_ROLLOUT,
                   "ppo_lr": RL_PPO_LR, "graph": graph},
        "rollout_graph_vs_eager": {"max_diff": rollout_diff,
                                   "tol": RL_GRAPH_TOL,
                                   "generator_states_equal": same_gen,
                                   "dones_in_rollout": dones},
        "update_graph_vs_eager": {"max_param_diff": update_diff,
                                  "loss": [loss_g, loss_e],
                                  "tol": RL_GRAPH_TOL},
        "impala": impala,
        "ppo_episode_len_mean": lens, "ppo_greedy_return": greedy,
        "ppo_losses": [r["loss"] for r in ppo],
        "dqn_losses": dqn_losses,
        "multi_agent": [{"mean_step_reward": r["mean_step_reward"],
                         "losses": r["losses"]} for r in ma_out],
        "readings": readings, "card": card}
    emit({"phase": "rl", **result})
    ok = (rollout_ok and dones > 0 and update_ok and impala_ok
          and lens[-1] > RL_IMPROVE * lens[0]
          and all(np.isfinite(dqn_losses))
          and all(np.isfinite(list(r["losses"].values())).all()
                  for r in ma_out))
    if not ok:
        raise AssertionError(
            f"rl: graph and eager apart, PPO did not improve past "
            f"{RL_IMPROVE}x, or a non-finite loss: {result}")
    return result


# --------------------------------------------------------------- phase 7: moe
@contextlib.contextmanager
def _routes_recorded(seen):
    """Appends each MoE layer's (top-1 choices, top-two gaps) to seen."""
    from ray_tpu_torch.models import transformer as tt

    route = tt._moe_route

    def recording(cfg, lp, h):
        probs, top = route(cfg, lp, h)
        top2 = probs.detach().topk(2, dim=-1).values
        seen.append((top.detach().clone(), top2[:, 0] - top2[:, 1]))
        return probs, top

    tt._moe_route = recording
    try:
        yield
    finally:
        tt._moe_route = route


def phase_moe(dev, card, base, model_lens, lens, new_tokens):
    """Phase 7 (see the module docstring): the flagship with experts."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine

    fa = _flash_module()
    cfg = dataclasses.replace(base, num_experts=MOE_EXPERTS,
                              moe_every=MOE_EVERY)
    L = cfg.n_layers
    res = {"num_experts": cfg.num_experts, "moe_every": cfg.moe_every,
           "n_layers": L}
    # (a) serving through the flash path.
    params = tm.serving_params(tm.init_params(cfg, SEED, device=dev), cfg,
                               dev)
    prompts = _prompts(np.random.default_rng(SEED), model_lens,
                       cfg.vocab_size)
    (logits, out, after_prefill, after_all, _, _, _,
     variants) = flash_path(cfg, params, prompts, 512, new_tokens, dev)
    res.update({"launches_per_prefill_by_variant": variants,
                "launches_after_decode": after_all,
                "decoded": [len(o) for o in out]})
    if (variants != _variant_want("wgmma", L) or after_all != L
            or any(len(o) != new_tokens + 1 for o in out)):
        emit({"phase": "moe", "results": res})
        raise AssertionError(f"MoE serving: launches {variants}, "
                             f"{after_all} in all, expected {L} wgmma")
    # (b) the engine: concurrent streams equal sequential ones.
    eprompts = _prompts(np.random.default_rng(SEED + 2), lens,
                        cfg.vocab_size)

    def make_engine():
        return InferenceEngine(EngineConfig(
            model=cfg, num_blocks=512, block_size=BLOCK_SIZE,
            device=str(dev)), params=params)

    streams, _, gaps, wall, _ = _concurrent_equals_sequential(
        make_engine, eprompts, new_tokens)
    res["engine"] = {"requests": len(eprompts),
                     "concurrent_equals_sequential": True,
                     **_reading(streams, gaps, wall)}
    del params
    torch.cuda.empty_cache()
    # (c) f32 gradients through the kernels against plain attention, with
    # the routing of both runs compared first.
    rng = np.random.default_rng(SEED + 5)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_LEN + 1))).to(dev)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = tm.init_params(cfg32, SEED, device=dev)
    seen_k, seen_p = [], []
    _zero_counts()
    with _routes_recorded(seen_k):
        loss_k, grads_k = _loss_and_grads(cfg32, params, inputs, targets)
    counts32 = _counts()
    with _routes_recorded(seen_p), _attention_swapped("plain"):
        loss_p, grads_p = _loss_and_grads(cfg32, params, inputs, targets)
    flips = [int((a[0] != b[0]).sum()) for a, b in zip(seen_k, seen_p)]
    min_gap = min(float(g[1].min()) for g in seen_p)
    err = _grad_errors(grads_k, grads_p)
    res["f32"] = {"loss_kernels": loss_k, "loss_plain": loss_p,
                  "routing_flips_per_moe_layer": flips,
                  "smallest_top2_gap": min_gap,
                  "launches_per_pass": counts32, "grad_err_vs_plain": err,
                  "tol": TRAIN_GRAD_TOL}
    del params, grads_k, grads_p
    torch.cuda.empty_cache()
    bad = [n for n, e in err.items() if not e <= TRAIN_GRAD_TOL]
    if any(flips):
        emit({"phase": "moe", "results": res})
        raise AssertionError(f"MoE f32: routing flips {flips} between the "
                             f"kernel and plain passes (smallest top-two "
                             f"gap {min_gap})")
    if bad or counts32 != _want_counts("tiled_f32", L, L):
        emit({"phase": "moe", "results": res})
        raise AssertionError(f"MoE f32 gradients through the kernels differ "
                             f"from plain attention in {bad}, or launches "
                             f"{counts32}")
    # (d) bf16 AdamW steps on one fixed batch.
    params = tm.init_params(cfg, SEED, device=dev)
    step = tm.make_train_step(cfg, params)
    losses, step_s = [], []
    _zero_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(inputs, targets).item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = _counts()
    want = _want_counts("wgmma", TRAIN_STEPS * L,
                        TRAIN_STEPS * L)
    later = sorted(step_s[1:])
    res["bf16"] = {"losses": losses, "launches": counts, "step_s": step_s,
                   "profile": _profile_steps(step, inputs, targets)}
    del params, step
    torch.cuda.empty_cache()
    if (counts != want or not all(np.isfinite(losses))
            or not losses[-1] < losses[0]):
        emit({"phase": "moe", "results": res})
        raise AssertionError(f"MoE bf16 steps gave losses {losses} and "
                             f"launches {counts}, expected finite, falling "
                             f"losses and {want}")
    emit({"phase": "moe", "results": res})
    med = later[len(later) // 2]
    emit({"moe_train_step_smoke_reading": "bf16",
          "tokens_per_step": TRAIN_BATCH * TRAIN_LEN,
          "step_ms_median_of_steps_2_to_5": med * 1e3,
          "tokens_per_s": TRAIN_BATCH * TRAIN_LEN / med,
          "first_step_ms": step_s[0] * 1e3,
          "profiled_steps": res["bf16"]["profile"], "card": card})
    return res


# --------------------------------------------------------------- phase 8: dag
def _bench_dags():
    """bench.py's microbenchmark DAGs, rebuilt through the port's remote:
    name -> (build(), payload shape, input, rtol; None for exact)."""
    from ray_tpu_torch.dag import InputNode, reduce_tree
    from ray_tpu_torch.remote_function import remote

    @remote
    def noop(x):
        return x

    @remote
    def combine(*xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

    @remote
    def scale(x):
        return x * 1.001 + 0.5

    @remote
    def matsq(x):
        return x @ x * 0.01 + x

    @remote
    def merge(a, b):
        return a + b

    def chain():
        with InputNode() as inp:
            node = inp
            for _ in range(DAG_CHAIN_TASKS):
                node = noop.bind(node)
        return node

    def fanout():
        with InputNode() as inp:
            leaves = [noop.bind(inp) for _ in range(DAG_FANOUT_WIDTH)]
            return reduce_tree(combine, leaves, arity=4)

    def tensor_dag(op):
        def build():
            with InputNode() as inp:
                chains = []
                for _ in range(DAG_TENSOR_WIDTH):
                    node = inp
                    for _ in range(DAG_TENSOR_DEPTH):
                        node = op.bind(node)
                    chains.append(node)
                while len(chains) > 1:
                    chains = [merge.bind(chains[i], chains[i + 1])
                              for i in range(0, len(chains), 2)]
                return chains[0]
        return build

    return {
        "chain_1k_noop": (chain, (), 1.0, None),
        "fanout_10k": (fanout, (), 1.0, None),
        "elementwise_1k": (tensor_dag(scale), (1024,),
                           np.linspace(0.0, 1.0, 1024, dtype=np.float32),
                           1e-5),
        "matmul_heavy": (tensor_dag(matsq), (64, 64),
                         np.linspace(0.0, 0.1, 4096, dtype=np.float32)
                         .reshape(64, 64), 1e-3),
    }


def _plain_eval(leaf, x):
    """The DAG evaluated without the wave machinery: nodes in topological
    order, each function called once on tensors."""
    from ray_tpu_torch.dag import FunctionNode, InputNode

    vals = {}
    for node in leaf.topological_order():
        if isinstance(node, InputNode):
            vals[id(node)] = x
        elif isinstance(node, FunctionNode):
            vals[id(node)] = node.function(
                *[vals[id(a)] for a in node._bound_args])
        else:
            raise TypeError(f"unexpected node {type(node).__name__}")
    return vals[id(leaf)]


def _dag_readings(compiled, x, execs=DAG_EXECS, sync_execs=DAG_SYNC_EXECS):
    """tasks/s over ``execs`` back-to-back executes, each fed the previous
    output (one sync at the end), p50 / p99 of a synchronous execute +
    get, and graph replays and host launches per execute."""
    ref = compiled.execute(x)
    torch.cuda.synchronize()
    replays, launches = compiled.graph_replays, compiled.host_launches
    t0 = time.perf_counter()
    for _ in range(execs):
        ref = compiled.execute(ref.device_value())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_exec = {"graph_replays": (compiled.graph_replays - replays) / execs,
                "host_launches": (compiled.host_launches - launches)
                / execs}
    lat = []
    for _ in range(sync_execs):
        t0 = time.perf_counter()
        compiled.execute(x).get()
        lat.append(time.perf_counter() - t0)
    lat.sort()
    return {"tasks_per_s": execs * compiled.num_tasks / wall,
            "exec_us": wall / execs * 1e6,
            "task_latency_us": wall / execs / compiled.num_tasks * 1e6,
            "sync_exec_p50_us": lat[len(lat) // 2] * 1e6,
            "sync_exec_p99_us": lat[min(len(lat) - 1,
                                        int(0.99 * len(lat)))] * 1e6,
            "per_execute": per_exec, "execs": execs,
            "sync_execs": sync_execs}


def _dag_device_time(compiled, x):
    """DAG_PROFILED_EXECS back-to-back executes under torch.profiler
    (device activity only): device busy time and kernels per execute, and
    the device's idle share of the profiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ref = compiled.execute(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DAG_PROFILED_EXECS):
            ref = compiled.execute(ref.device_value())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"device_busy_us_per_execute": "not measured: the profiler "
                                              "recorded no device events"}
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return {"profiled_execs": DAG_PROFILED_EXECS,
            "wall_us_per_execute": wall_us / DAG_PROFILED_EXECS,
            "device_busy_us_per_execute": busy_us / DAG_PROFILED_EXECS,
            "device_events_per_execute": len(kernels) / DAG_PROFILED_EXECS,
            "device_idle_share": 1 - busy_us / wall_us}


def phase_dag(dev, card):
    """Phase 8 (see the module docstring): the wave executor on bench.py's
    DAGs, static and dynamic, against a plain evaluator."""
    results = {}
    for name, (build, payload, x, rtol) in _bench_dags().items():
        leaf = build()
        xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
        want = _plain_eval(leaf, xt)
        for dynamic in (False, True):
            t0 = time.perf_counter()
            compiled = leaf.experimental_compile(
                backend="torch", payload_shape=payload, dynamic=dynamic,
                device=str(dev))
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            first = compiled.execute(x).device_value()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            again = compiled.execute(x).device_value()
            if rtol is None:
                ok = bool(torch.equal(first, want)) and bool(
                    torch.equal(again, want))
            else:
                ok = all(bool(torch.allclose(v, want, rtol=rtol, atol=0))
                         for v in (first, again))
            key = f"{name}[{'dynamic' if dynamic else 'static'}]"
            res = {"num_tasks": compiled.num_tasks,
                   "num_compiled_tasks": compiled.num_compiled_tasks,
                   "num_waves": compiled.num_waves,
                   "wave_width": compiled.wave_width,
                   "payload": list(payload), "equals_plain": ok,
                   "rtol": rtol, "compile_s": compile_s,
                   "first_execute_s": first_s}
            results[key] = res
            if not ok:
                emit({"phase": "dag", "results": results})
                raise AssertionError(f"{key}: the executor's output differs "
                                     f"from the plain evaluator's")
            res.update(_dag_readings(compiled, x))
            res["profile"] = _dag_device_time(compiled, x)
            del compiled
    emit({"phase": "dag", "results": results, "card": card})
    return results


# ---------------------------------------------------------- phase 9: dag_mesh
def _exchange_bytes(compiled):
    """Bytes each shard receives per execute through the exchanges: the
    static waves' tiled allgathers (n_sh * X_max payloads a wave, every
    wave once X_max > 0), or the dynamic frontier's fired ids (int64) and,
    when an edge crosses shards, payloads (n_sh * F a iteration, as many
    iterations as one execute runs)."""
    n = compiled.num_shards
    payload = int(np.prod(compiled.payload_shape, dtype=np.int64)) \
        * torch.empty((), dtype=compiled.dtype).element_size()
    if not compiled.dynamic:
        return compiled.num_waves * n * compiled.export_width * payload
    per_iter = n * compiled._F * (8 + (payload if compiled.export_width
                                       else 0))
    return compiled._chunk * per_iter


def phase_dag_mesh(dev, card, one_device):
    """Phase 9 (see the module docstring): phase 8's DAGs sharded over
    DAG_MESH_SHARDS virtual shards of the card."""
    from ray_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[dev] * DAG_MESH_SHARDS)   # dp = 8
    results = {}
    dags = _bench_dags()
    for name, (build, payload, x, rtol) in dags.items():
        leaf = build()
        xt = torch.as_tensor(x, dtype=torch.float32, device=dev)
        want = _plain_eval(leaf, xt)
        for dynamic in (False, True):
            key = f"{name}[{'dynamic' if dynamic else 'static'}]"
            single = leaf.experimental_compile(
                backend="torch", payload_shape=payload, dynamic=dynamic,
                device=str(dev)).execute(x).device_value()
            t0 = time.perf_counter()
            compiled = leaf.experimental_compile(
                backend="torch", payload_shape=payload, dynamic=dynamic,
                mesh=mesh)
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            first = compiled.execute(x).device_value()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            again = compiled.execute(x).device_value()
            if rtol is None:
                ok = all(bool(torch.equal(v, w)) for v in (first, again)
                         for w in (want, single))
            else:
                ok = all(bool(torch.allclose(v, w, rtol=rtol, atol=0))
                         for v in (first, again) for w in (want, single))
            res = {"num_shards": compiled.num_shards,
                   "mesh_axis": compiled.mesh_axis,
                   "lanes_per_shard": compiled.lanes_per_shard,
                   "export_width": compiled.export_width,
                   "wave_width": compiled.wave_width,
                   "num_waves": compiled.num_waves,
                   "num_compiled_tasks": compiled.num_compiled_tasks,
                   "equals_plain_and_one_device": ok, "rtol": rtol,
                   "compile_s": compile_s, "first_execute_s": first_s}
            results[key] = res
            if not ok:
                emit({"phase": "dag_mesh", "results": results})
                raise AssertionError(f"{key}: the sharded executor's output "
                                     f"differs from the plain evaluator's "
                                     f"or the one-device executor's")
            if name == "chain_1k_noop" and not dynamic and \
                    compiled.export_width > 1:
                raise AssertionError(f"the chain exports "
                                     f"{compiled.export_width} payloads a "
                                     f"wave, expected at most 1")
            res["exchange_bytes_per_shard_per_execute"] = \
                _exchange_bytes(compiled)
            if dynamic:
                res["iterations_per_execute"] = compiled._chunk
            res.update(_dag_readings(compiled, x, DAG_MESH_EXECS,
                                     DAG_MESH_SYNC_EXECS))
            one = one_device[key]
            res["one_device"] = {k: one[k] for k in (
                "tasks_per_s", "sync_exec_p50_us", "sync_exec_p99_us")}
            del compiled
    # A planted fault: the fan-out's exports zeroed in one wave (captured
    # into the graph) must change its output.
    build, payload, x, _ = dags["fanout_10k"]
    leaf = build()
    want = _plain_eval(leaf, torch.as_tensor(x, dtype=torch.float32,
                                             device=dev))
    faulty = leaf.experimental_compile(backend="torch", payload_shape=payload,
                                       mesh=mesh)
    real = faulty._exchange

    def zeroed(packed, wave=None):
        got = real(packed, wave)
        return ([torch.zeros_like(g) for g in got]
                if wave == DAG_FAULT_WAVE else got)

    faulty._exchange = zeroed
    outs = [faulty.execute(x).device_value() for _ in range(2)]
    caught = all(not bool(torch.equal(o, want)) for o in outs)
    results["planted_fault"] = {
        "dag": "fanout_10k[static]", "zeroed_wave": DAG_FAULT_WAVE,
        "output": [float(o) for o in outs], "plain": float(want),
        "caught": caught}
    emit({"phase": "dag_mesh", "results": results,
          "seconds": time.perf_counter() - t_phase, "card": card})
    if not caught:
        raise AssertionError("zeroing one wave's exchange left the fan-out "
                             "output unchanged")
    return results


# ----------------------------------------------------------------- phase 10: tp
def phase_tp(dev, card, base, lens, new_tokens):
    """Phase 10 (see the module docstring): the flagship served
    tensor-parallel over virtual shards of the card."""
    import os

    from ray_tpu_torch import models as tm
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine
    from ray_tpu_torch.parallel.mesh import VIRTUAL_DEVICES_ENV

    t_phase = time.perf_counter()
    os.environ[VIRTUAL_DEVICES_ENV] = str(max(TP_SIZES))
    gaps = {}

    class GapEngine(InferenceEngine):
        """Records each emitted token's top-two logit gap (not timed)."""

        def _emit(self, reqs, logits):
            top2 = np.sort(np.partition(logits, -2, axis=-1)[:, -2:], -1)
            for i, req in enumerate(reqs):
                gaps.setdefault(tuple(req.prompt), []).append(
                    float(top2[i, 1] - top2[i, 0]))
            super()._emit(reqs, logits)

    results = {}
    try:
        for name, cfg0 in (("mha", base),
                           ("gqa", dataclasses.replace(base, n_kv_heads=4))):
            params = tm.init_params(cfg0, SEED, device=dev)
            prompts = _prompts(np.random.default_rng(SEED + 2), lens,
                               cfg0.vocab_size)
            for dtype in (torch.float32, torch.bfloat16):
                cfg = dataclasses.replace(cfg0, dtype=dtype)
                key = f"{name}_{_dtype_name(dtype)}"
                gaps.clear()
                runs, streams = {}, {}
                pool_bytes = {}
                for tp in TP_SIZES:
                    cls = GapEngine if tp == 1 else InferenceEngine
                    engines = []

                    def make():
                        e = cls(EngineConfig(
                            model=cfg, num_blocks=TP_NUM_BLOCKS,
                            block_size=BLOCK_SIZE, tp_size=tp,
                            device=str(dev)), params=params)
                        engines.append(e)
                        return e

                    outs, st, tgaps, wall = _serve(make, prompts, new_tokens)
                    pools = (engines[0].cache.data if tp > 1
                             else [engines[0].cache.data])
                    pool_bytes[tp] = [sum(t.numel() * t.element_size()
                                          for t in p.values())
                                      for p in pools]
                    del engines
                    streams[tp] = outs
                    runs[tp] = dict(
                        _reading(outs, tgaps, wall), tp_size=st["tp_size"],
                        ttft_p50_s=st["ttft_decomposition"]["ttft_p50_s"],
                        ttft_p99_s=st["ttft_decomposition"]["ttft_p99_s"],
                        kv_pool_bytes_per_shard=pool_bytes[tp])
                res = {"runs": runs, "requests": len(prompts),
                       "prompt_lens": lens, "new_tokens": new_tokens}
                results[key] = res
                whole = pool_bytes[1][0]
                for tp in TP_SIZES:
                    if len(pool_bytes[tp]) != tp or any(
                            b * tp != whole for b in pool_bytes[tp]):
                        emit({"phase": "tp", "results": results})
                        raise AssertionError(
                            f"{key} tp {tp}: KV pool bytes per shard "
                            f"{pool_bytes[tp]}, expected {whole} / {tp}")
                diverged = []
                for tp in TP_SIZES[1:]:
                    for i, (got, ref) in enumerate(zip(streams[tp],
                                                       streams[1])):
                        j = _first_divergence(got, ref)
                        if j is not None:
                            diverged.append({
                                "tp": tp, "stream": i, "token": j,
                                "tp1_top2_gap": gaps[tuple(prompts[i])][j]})
                res["divergences"] = diverged
                if dtype == torch.float32:
                    res["f32_streams_equal_tp1"] = not diverged
                    if diverged:
                        emit({"phase": "tp", "results": results})
                        raise AssertionError(f"{key}: f32 tensor-parallel "
                                             f"streams differ from tp 1: "
                                             f"{diverged}")
                else:
                    res["tie_tol"] = SPEC_TIE_TOL_BF16
                    clear = [d for d in diverged
                             if d["tp1_top2_gap"] >= SPEC_TIE_TOL_BF16]
                    if clear:
                        emit({"phase": "tp", "results": results})
                        raise AssertionError(f"{key}: bf16 divergences with "
                                             f"a clear margin {clear}")
    finally:
        os.environ.pop(VIRTUAL_DEVICES_ENV, None)
    emit({"phase": "tp", "results": results,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return results


# ------------------------------------------------------- phase 11: spmd_train
def _spmd_config(base, moe, dtype, capacity_factor=None):
    cfg = dataclasses.replace(base, dtype=dtype)
    if not moe:
        return cfg
    return dataclasses.replace(
        cfg, num_experts=MOE_EXPERTS, moe_every=MOE_EVERY,
        capacity_factor=capacity_factor or cfg.capacity_factor)


def _spmd_want(cfg, axes, mb):
    """(_counts() of one sharded step in the port's schedule, forward
    launches of the same step in the reference's). Under sp > 1 ring
    attention is plain: no launch. Otherwise each shard runs each of its
    stage's layers once per microbatch (pp > 1) or once; the layer's
    variant follows its input's type: f32 takes the CUDA cores (the tiled
    f32 forward, dQ and dK/dV), bf16 the tensor cores,
    and under ep a bf16 model's residual stream is f32 from layer 1 on
    (ROADMAP C.4). The reference runs every stage on each of its pp + M - 1
    ticks."""
    pp, L = axes.get("pp", 1), cfg.n_layers
    runs = mb if pp > 1 else 1
    n = _variant_want(None, 0)
    reference = 0
    if axes.get("sp", 1) == 1:
        for i in range(L):
            promoted = bool(cfg.num_experts) and axes.get("ep", 1) > 1 and i
            variant = ("wgmma" if cfg.dtype == torch.bfloat16
                       and not promoted else "tiled_f32")
            n[variant] += (SPMD_SHARDS // pp) * runs
        reference = SPMD_SHARDS * (L // pp) * (pp + mb - 1 if pp > 1 else 1)
    total = n["wgmma"] + n["tiled_f32"]
    want_bwd = _backward_want(None, 0)
    for v, c in n.items():
        for key, count in _backward_want(v, c).items():
            want_bwd[key] += count
    return ({"fwd": total, **n, "dq": total, "dkv": total, **want_bwd,
             "rms": 0}, reference)


def _spmd_tokens(cfg, dev):
    rng = np.random.default_rng(SEED + 11)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SPMD_BATCH, SPMD_LEN + 1))).to(dev)
    return tokens[:, :-1], tokens[:, 1:]


def _spmd_one_device(cfg, dev, inputs, targets):
    """The oracle: one SGD step of the one-device loss_fn's gradients.
    Returns (loss, min top-two router gap or None, p0, p_ref)."""
    from ray_tpu_torch import models as tm

    params = tm.init_params(cfg, SEED, device=dev)
    seen = []
    with _routes_recorded(seen):
        loss, grads = _loss_and_grads(cfg, params, inputs, targets)
    gap = min(float(g.min()) for _, g in seen) if seen else None
    with torch.no_grad():
        p0 = tm.init_params(cfg, SEED, device=dev)
        p_ref = tm.init_params(cfg, SEED, device=dev)
        for n, t in _named_leaves(p_ref):
            t.sub_(SPMD_SGD_LR * grads[n])
    del params, grads
    torch.cuda.empty_cache()
    return loss, gap, p0, p_ref


def _spmd_errors(mesh, pspec, shards, p0, p_ref):
    """Per leaf, the largest over shards of max(|p - p_ref| - ulp(p_ref))
    over the largest move max|p_ref - p0| of that shard's block (each side
    rounds p0 + its move to f32 once, so the two may land one ulp of the
    parameter apart whatever their moves); the same without the ulp; and
    per leaf the largest move."""
    from ray_tpu_torch.parallel import shard_tensor

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k in tree for x in flat(tree[k], f"{prefix}{k}.")]
        return [(prefix[:-1], tree)]

    def leaf(tree, path):
        for k in path.split("."):
            tree = tree[k]
        return tree

    errs, raw, moves = {}, {}, {}
    with torch.no_grad():
        for path, spec in flat(pspec):
            refs = shard_tensor(leaf(p_ref, path), mesh, spec)
            bases = shard_tensor(leaf(p0, path), mesh, spec)
            e, r_, m_ = [], [], []
            for sh, r, b in zip(shards, refs, bases):
                diff = (leaf(sh, path) - r).abs()
                ulp = torch.nextafter(r.abs(), torch.full_like(r, np.inf)) \
                    - r.abs()
                move = (r - b).abs().max().clamp_min(1e-30)
                e.append(((diff - ulp).clamp_min(0).max() / move).item())
                r_.append((diff.max() / move).item())
                m_.append(move.item())
            errs[path], raw[path], moves[path] = max(e), max(r_), max(m_)
    return errs, raw, moves


@contextlib.contextmanager
def _patched(target, name, value):
    kept = getattr(target, name)
    setattr(target, name, value)
    try:
        yield
    finally:
        setattr(target, name, kept)


def _spmd_fault(kind):
    """A planted fault. ``sync``: the gradient sync skips the dp axis.
    ``ring``: ring attention's causal mask ignores each shard's sequence
    offset (every block masked as the diagonal one)."""
    import functools

    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.parallel.mesh import AXES

    if kind == "sync":
        return _patched(tt, "_sync_grads", functools.partial(
            tt._sync_grads, axes=tuple(a for a in AXES if a != "dp")))
    # The package exports the function under the module's name.
    ra = importlib.import_module("ray_tpu_torch.parallel.ring_attention")
    bias = ra._causal_bias
    return _patched(ra, "_causal_bias",
                    lambda q, my, kv_shard, s_local: bias(q, 0, 0, s_local))


def _spmd_parity(dev, cfg, name, oracle, inputs, targets, fault=None):
    """One f32 SGD step of the sharded step on mesh ``name`` against the
    oracle's: loss error, per-leaf errors, launches, peak memory."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.parallel import make_mesh, MeshConfig

    _, axes, mb = SPMD_MESHES[name]
    loss_ref, _, p0, p_ref = oracle
    mesh = make_mesh(MeshConfig(**axes), devices=[dev] * SPMD_SHARDS)
    torch.cuda.reset_peak_memory_stats()
    step, pspec, shards = tm.make_spmd_train_step(
        cfg, mesh, p0, optimizer=lambda ls: torch.optim.SGD(
            ls, lr=SPMD_SGD_LR), n_microbatches=mb)
    _zero_counts()
    with _spmd_fault(fault) if fault else contextlib.nullcontext():
        loss = step(inputs, targets).item()
    torch.cuda.synchronize()
    counts = _counts()
    errs, raw, moves = _spmd_errors(mesh, pspec, shards, p0, p_ref)
    res = {"loss": loss, "loss_one_device": loss_ref,
           "loss_err": abs(loss - loss_ref) / abs(loss_ref),
           "update_err_by_leaf": errs, "update_err_raw_by_leaf": raw,
           "update_by_leaf": moves,
           "launches_per_step": counts,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    del step, shards
    torch.cuda.empty_cache()
    return res


def _spmd_drops(dropped):
    """The model's moe_dispatch_combine, adding (tokens over their
    expert's capacity, tokens routed) of every shard to ``dropped``."""
    from ray_tpu_torch.models import transformer as tt

    dispatch = tt.moe_dispatch_combine

    def counting(xs, logits, expert_fn, **kw):
        T, E = logits[0].shape
        cap = max(1, int(kw["capacity_factor"] * T / E))
        for lg in logits:
            per_expert = torch.bincount(lg.argmax(-1), minlength=E)
            dropped[0] += int((per_expert - cap).clamp(min=0).sum())
            dropped[1] += T
        return dispatch(xs, logits, expert_fn, **kw)

    return counting


@contextlib.contextmanager
def _collective_bytes(tally):
    """Adds the bytes each collective delivers (its per-shard outputs) to
    tally[op] while it runs: the forward's exchanges (the backward's
    transposes move as much again)."""
    from ray_tpu_torch.collective import ops as cops

    def wrap(op):
        fn = getattr(cops, op)

        def counted(xs, *a, **k):
            out = fn(xs, *a, **k)
            tally[op] = tally.get(op, 0) + sum(
                o.numel() * o.element_size() for o in out)
            return out
        return counted

    with contextlib.ExitStack() as stack:
        for op in ("allreduce", "permute", "all_to_all"):
            stack.enter_context(_patched(cops, op, wrap(op)))
        yield tally


def _spmd_bf16(dev, base, name, inputs, targets):
    """SPMD_BF16_STEPS AdamW steps of the bf16 flagship on mesh ``name``
    (the default capacity factor): losses, launches per step, the
    fraction of tokens dropped, and smoke readings."""
    from ray_tpu_torch import models as tm
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.parallel import make_mesh, MeshConfig

    moe, axes, mb = SPMD_MESHES[name]
    cfg = _spmd_config(base, moe, torch.bfloat16)
    mesh = make_mesh(MeshConfig(**axes), devices=[dev] * SPMD_SHARDS)
    params = tm.init_params(cfg, SEED, device=dev)
    with torch.no_grad():
        one_device = tm.loss_fn(cfg, params, inputs, targets).item()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, pspec, shards = tm.make_spmd_train_step(cfg, mesh, params,
                                                  n_microbatches=mb)
    del params
    dropped = [0, 0]
    losses, step_s = [], []
    _zero_counts()
    with _patched(tt, "moe_dispatch_combine", _spmd_drops(dropped)):
        for _ in range(SPMD_BF16_STEPS):
            t0 = time.perf_counter()
            losses.append(step(inputs, targets).item())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    tally = {}
    with _collective_bytes(tally):
        step(inputs, targets)
    torch.cuda.synchronize()
    profile = _profile_steps(step, inputs, targets, steps=1)
    x_bytes = 2   # the bf16 residual stream of a dense pipeline
    hop = (SPMD_BATCH // (axes.get("dp", 1) * axes.get("fsdp", 1)) // mb
           * (SPMD_LEN // axes.get("sp", 1)) * cfg.d_model * x_bytes)
    pp = axes.get("pp", 1)
    if pp > 1:
        groups = SPMD_SHARDS // pp
        tally["pipeline_hops"] = groups * (pp - 1) * mb * hop
        tally["pipeline_broadcast"] = groups * pp * mb * hop
    per_step = {k: v // SPMD_BF16_STEPS for k, v in counts.items()}
    res = {"losses": losses, "loss_one_device": one_device,
           "first_loss_err": abs(losses[0] - one_device) / abs(one_device),
           "step_s": step_s,
           "step_ms_median": sorted(step_s)[len(step_s) // 2] * 1e3,
           "launches_per_step": per_step,
           "max_memory_allocated_bytes": peak,
           "collective_bytes_per_step_forward": tally,
           "profiled_step": profile,
           "capacity_factor": cfg.capacity_factor if moe else None,
           "dropped_fraction": (dropped[0] / dropped[1] if dropped[1]
                                else None)}
    del step, shards
    torch.cuda.empty_cache()
    return res, counts


def phase_spmd_train(dev, card, base):
    """Phase 11 (see the module docstring): the manual multi-axis step
    over 8 virtual shards of the card."""
    t_phase = time.perf_counter()
    results = {"shards": SPMD_SHARDS, "tokens": [SPMD_BATCH, SPMD_LEN],
               "meshes": {}, "tol": SPMD_UPDATE_TOL,
               "loss_tol": SPMD_LOSS_TOL}
    fails = []
    # (a) f32 parity: each mesh's SGD step against one device's.
    for moe in (False, True):
        cfg = _spmd_config(base, moe, torch.float32, SPMD_PARITY_CF)
        inputs, targets = _spmd_tokens(cfg, dev)
        oracle = _spmd_one_device(cfg, dev, inputs, targets)
        for name, (is_moe, axes, mb) in SPMD_MESHES.items():
            if is_moe != moe:
                continue
            res = _spmd_parity(dev, cfg, name, oracle, inputs, targets)
            want, ref_sched = _spmd_want(cfg, axes, mb)
            res.update({"launches_want": want,
                        "fwd_launches_reference_schedule": ref_sched,
                        "smallest_top2_gap_one_device": oracle[1]})
            results["meshes"][name] = {"f32": res}
            bad = [n for n, e in res["update_err_by_leaf"].items()
                   if not e <= SPMD_UPDATE_TOL]
            if (bad or not res["loss_err"] <= SPMD_LOSS_TOL
                    or res["launches_per_step"] != want):
                fails.append(f"{name} f32: leaves {bad}, loss err "
                             f"{res['loss_err']}, launches "
                             f"{res['launches_per_step']} != {want}")
            for fault, mesh_name in (("sync", SPMD_SYNC_FAULT_MESH),
                                     ("ring", SPMD_RING_FAULT_MESH)):
                if mesh_name != name:
                    continue
                f = _spmd_parity(dev, cfg, name, oracle, inputs, targets,
                                 fault=fault)
                errs = f["update_err_by_leaf"]
                moved = [n for n, m in res["update_by_leaf"].items()
                         if m > 1e-30]
                missed = (not max(errs.values()) > SPMD_UPDATE_TOL
                          or (fault == "sync" and not min(
                              errs[n] for n in moved) > SPMD_UPDATE_TOL))
                results["meshes"][name][f"planted_{fault}_fault"] = {
                    "update_err_by_leaf": errs, "loss_err": f["loss_err"],
                    "leaves_above_tol": sum(
                        e > SPMD_UPDATE_TOL for e in errs.values()),
                    "missed": missed}
                if missed:
                    fails.append(f"{name}: the planted {fault} fault reads "
                                 f"{errs}")
        del oracle
        torch.cuda.empty_cache()
        if fails:
            emit({"phase": "spmd_train", "results": results})
            raise AssertionError(f"sharded f32 steps: {fails}")
    # (b) bf16 AdamW steps, the main path's type.
    all_counts = {}
    for name in SPMD_BF16_MESHES:
        moe, axes, mb = SPMD_MESHES[name]
        cfg = _spmd_config(base, moe, torch.bfloat16)
        inputs, targets = _spmd_tokens(cfg, dev)
        res, counts = _spmd_bf16(dev, base, name, inputs, targets)
        want, ref_sched = _spmd_want(cfg, axes, mb)
        res.update({"launches_want": want,
                    "fwd_launches_reference_schedule": ref_sched})
        results["meshes"][name]["bf16"] = res
        all_counts[name] = counts
        losses = res["losses"]
        if (not all(np.isfinite(losses)) or not losses[-1] < losses[0]
                or res["launches_per_step"] != want
                or any(v % SPMD_BF16_STEPS for v in counts.values())
                or (not moe
                    and not res["first_loss_err"] <= TRAIN_LOSS_TOL_BF16)):
            fails.append(f"{name} bf16: losses {losses} (one device "
                         f"{res['loss_one_device']}), launches "
                         f"{res['launches_per_step']} != {want}")
    emit({"phase": "spmd_train", "results": results,
          "seconds": time.perf_counter() - t_phase, "card": card})
    if fails:
        raise AssertionError(f"sharded bf16 steps: {fails}")
    for name in SPMD_BF16_MESHES:
        r = results["meshes"][name]["bf16"]
        emit({"spmd_train_step_smoke_reading": name,
              "tokens_per_step": SPMD_BATCH * SPMD_LEN,
              "step_ms_median_of_3": r["step_ms_median"],
              "host_launches_per_step": r["profiled_step"].get(
                  "kernels_per_step"),
              "device_idle_share": r["profiled_step"].get(
                  "device_idle_share"),
              "max_memory_allocated_bytes": r["max_memory_allocated_bytes"],
              "collective_bytes_per_step_forward":
                  r["collective_bytes_per_step_forward"],
              "dropped_fraction": r["dropped_fraction"], "card": card})
    return results


def _fwd_brief(t):
    """A forward timing of phase 2, as a sub-row of the kernels line."""
    return {k: t[k] for k in ("kernel_ms", "simt_kernel_ms", "plain_ms",
                              "library_ms", "sdpa_backend", "bound_ms",
                              "bound_by", "max_abs_err", "tflops", "shape",
                              "dtype")}


def _bwd_brief(tb, kind):
    """One backward kernel's timing of phase 2 (its plain and library
    times are one call for dq, dk and dv), as a sub-row."""
    t = tb[kind]
    return {**{k: t[k] for k in ("kernel_ms", "simt_kernel_ms", "bound_ms",
                                 "bound_by", "max_abs_err")},
            "plain_ms": tb["plain_ms"], "library_ms": tb["library_ms"],
            "sdpa_backend": tb["sdpa_backend"], "shape": tb["shape"],
            "dtype": tb["dtype"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()

    from ray_tpu_torch.models import TransformerConfig

    flagship = TransformerConfig()
    model_lens = [512, 431, 260, 129]     # right-padded to 512
    phase_build()
    timing = phase_kernels(dev)
    bwd = phase_backward(dev)
    wide = phase_wide(dev)
    rms = phase_rms(dev)
    c1 = phase_c1_models(dev, flagship, model_lens)
    fa = _flash_module()
    fa.plain_routes = 0
    model = phase_model(dev, flagship, model_lens, 512, 32)
    phase_engine(dev, card, flagship, ENGINE_LENS, model_lens, 512, 32)
    train = phase_train(dev, card, flagship)
    phase_spec_disagg(dev, card, flagship, ENGINE_LENS, 32)
    phase_moe(dev, card, flagship, model_lens, ENGINE_LENS, 32)
    # The flagship (head_dim 64) never takes the plain route: phases 3-7.
    emit({"phase": "plain_routes", "flagship_phases_3_to_7":
          fa.plain_routes})
    if fa.plain_routes:
        raise AssertionError(f"the flagship took the plain attention route "
                             f"{fa.plain_routes} times")
    one_device_dag = phase_dag(dev, card)
    phase_dag_mesh(dev, card, one_device_dag)
    phase_tp(dev, card, flagship, ENGINE_LENS, 32)
    spmd = phase_spmd_train(dev, card, flagship)
    phase_rl(dev, card)
    # K1/K3/K4 launches per sharded step by variant (phase 11), per mesh
    # and dtype.
    launches_spmd = {kind: {} for kind in ("fwd", "dq", "dkv")}
    for name, runs in spmd["meshes"].items():
        for dtype, run in runs.items():
            if dtype not in ("f32", "bf16"):
                continue
            c = run["launches_per_step"]
            for kind, prefix, variants in (
                    ("fwd", "", ("wgmma", "tiled_f32")),
                    ("dq", "dq_", ("wgmma", "tiled_f32")),
                    ("dkv", "dkv_", ("wgmma", "tiled_f32"))):
                launches_spmd[kind][f"{name} {dtype}"] = {
                    v: c[prefix + v] for v in variants}

    replaces = {
        "mha": "ray_tpu/ops/flash_attention.py:341 (_attn_kernel via "
               "_flash_forward)",
        "gqa": "ray_tpu/ops/flash_attention.py:306 (_attn_kernel via "
               "_flash_forward_grouped)",
        "dq": "ray_tpu/ops/flash_attention.py:400 (_attn_bwd_dq_kernel via "
              "_flash_bwd_rule)",
        "dkv": "ray_tpu/ops/flash_attention.py:419 (_attn_bwd_dkv_kernel "
               "via _flash_bwd_rule)",
        "rms": "ray_tpu/ops/fused.py:47 (_rms_kernel via rms_norm_fused)",
    }
    kernels = []
    wgmma_source = "ray_tpu_torch/ops/csrc/flash_attention_fwd_wgmma.cu"
    f32_source = "ray_tpu_torch/ops/csrc/flash_attention_wide_f32.cu"
    for name, Hkv in (("mha", model["mha"]["n_kv_heads"]),
                      ("gqa", model["gqa"]["n_kv_heads"])):
        t = timing[f"bfloat16_Hkv{Hkv}_S2048"]
        t512 = timing[f"bfloat16_Hkv{Hkv}_S512"]
        kernels.append({
            "name": f"flash_attention_fwd[{name}]",
            "route": "cuda", "variant": "wgmma", "source": wgmma_source,
            "replaces": replaces[name],
            "launches": model[name]["launches_per_prefill_by_variant"][
                "wgmma"],
            "launches_train": train[name]["bf16_launches"]["wgmma"],
            "launches_spmd": launches_spmd["fwd"],
            "max_abs_err": t["max_abs_err"],
            "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
            "tflops": t["tflops"],
            "simt_kernel_ms": t["simt_kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"],
            "S512": {k: t512[k] for k in (
                "kernel_ms", "simt_kernel_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "shape")},
            "D128": {dt: _fwd_brief(timing[f"{dt}_Hkv8_S2048_D128"])
                     for dt in ("bfloat16", "float16")},
            "card": card})
    # The tiled f32 forward on the main path: f32 (phase 5's f32 gradient
    # passes, phase 4's f32 engine check), timed on f32 inputs at D=64 (128
    # and 256 beside it), the earlier CUDA-core forward on the same inputs
    # (simt_kernel_ms).
    t = timing["float32_Hkv8_S2048"]
    kernels.append({
        "name": "flash_attention_fwd[f32]",
        "route": "cuda", "variant": "tiled_f32", "source": f32_source,
        "replaces": replaces["mha"],
        "launches": train["mha"]["launches_per_pass"]["tiled_f32"],
        "launches_spmd": launches_spmd["fwd"],
        "max_abs_err": t["max_abs_err"],
        "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
        "tflops": t["tflops"], "simt_kernel_ms": t["simt_kernel_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": t["shape"], "dtype": "float32",
        **{f"D{D}": _fwd_brief(timing[f"float32_Hkv8_S2048_D{D}"])
           for D in (128, 256)},
        "card": card})
    # The CUDA-core f32 forward that the tiled one replaced (no main-path
    # launch left), held and timed on the same f32 inputs.
    kernels.append({
        "name": "flash_attention_fwd[f32-simt]",
        "route": "cuda", "variant": "simt",
        "source": "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": replaces["mha"],
        "launches": train["mha"]["launches_per_pass"]["simt"],
        "launches_from": "phase 5's f32 pass (reached by no rule)",
        "max_abs_err": t["simt_max_abs_err"],
        "ms": t["simt_kernel_ms"], "kernel_ms": t["simt_kernel_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": t["shape"], "dtype": "float32",
        **{f"D{D}_ms": timing[f"float32_Hkv8_S2048_D{D}"]["simt_kernel_ms"]
           for D in (128, 256)},
        "card": card})
    # The backward pair: bf16 on the tensor cores (the train steps), f32 on
    # the tiled f32 pair (phase 5's f32 gradient passes; D=128 and 256
    # beside it), the CUDA-core pair it replaced timed on the same inputs
    # (simt_kernel_ms).
    for dtype, suffix, variant, source, launches_of in (
            ("bfloat16", "", "wgmma",
             "ray_tpu_torch/ops/csrc/flash_attention_bwd_wgmma.cu",
             train["mha"]["bf16_launches"]),
            ("float32", "[f32]", "tiled_f32", f32_source,
             train["mha"]["launches_per_pass"])):
        tb = bwd[dtype]
        for kind in ("dq", "dkv"):
            t = tb[kind]
            kernels.append({
                "name": f"flash_attention_bwd_{kind}{suffix}",
                "route": "cuda", "variant": variant, "source": source,
                "replaces": replaces[kind],
                "launches": launches_of[f"{kind}_{variant}"],
                "launches_spmd": launches_spmd[kind],
                "max_abs_err": t["max_abs_err"],
                "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
                "tflops": t["tflops"], "simt_kernel_ms": t["simt_kernel_ms"],
                "plain_ms": tb["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": tb["library_ms"],
                "plain": tb["plain"], "library": tb["library"],
                "shape": tb["shape"], "dtype": dtype, "card": card})
        if variant == "wgmma":
            kernels[-2]["D128"] = {dt: _bwd_brief(bwd[f"{dt}_D128"], "dq")
                                   for dt in ("bfloat16", "float16")}
            kernels[-1]["D128"] = {dt: _bwd_brief(bwd[f"{dt}_D128"], "dkv")
                                   for dt in ("bfloat16", "float16")}
        else:
            for i, kind in ((-2, "dq"), (-1, "dkv")):
                kernels[i].update({f"D{D}": _bwd_brief(
                    bwd[f"float32_D{D}"], kind) for D in (128, 256)})
    # The CUDA-core f32 pair that the tiled one replaced (no main-path
    # launch left), timed and held on the same f32 inputs at S=2048.
    tb = bwd["float32"]
    for kind in ("dq", "dkv"):
        t = tb[kind]
        kernels.append({
            "name": f"flash_attention_bwd_{kind}[f32-simt]",
            "route": "cuda", "variant": "simt",
            "source": "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "replaces": replaces[kind],
            "launches": train["mha"]["launches_per_pass"][f"{kind}_simt"],
            "launches_from": "phase 5's f32 pass (reached by no rule)",
            "max_abs_err": t["simt_max_abs_err"],
            "ms": t["simt_kernel_ms"], "kernel_ms": t["simt_kernel_ms"],
            "plain_ms": tb["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": tb["library_ms"],
            "plain": tb["plain"], "library": tb["library"],
            "shape": tb["shape"], "dtype": "float32",
            **{f"D{D}_ms": bwd[f"float32_D{D}"][kind]["simt_kernel_ms"]
               for D in (128, 256)},
            "card": card})
    # The tensor-core kernels on the shapes that the CUDA-core ones took
    # before (phase 2b's configs give the launches): head_dim 256 in bf16
    # (f16 beside it), the flagship in f16, and the padded widths of
    # Phi-3-mini (head_dim 96, bf16; every ANY_TIMED_DIMS width and dtype
    # beside it) and Phi-2 (head_dim 80, f16), timed at S=2048 (phase 2)
    # beside the CUDA-core kernels on the same inputs (simt_kernel_ms).
    bwd_wgmma_source = "ray_tpu_torch/ops/csrc/flash_attention_bwd_wgmma.cu"
    any_widths = [(dt, D) for D in ANY_TIMED_DIMS
                  for dt in ("bfloat16", "float16")]
    for cfg_name, suffix, fwd_key, bwd_key in (
            ("hd256_bf16", "[D256-bf16]", "bfloat16_Hkv8_S2048_D256",
             "bfloat16_D256"),
            ("f16", "[f16]", "float16_Hkv8_S2048", "float16"),
            ("hd96_bf16", "[D96-bf16]", "bfloat16_Hkv8_S2048_D96",
             "bfloat16_D96"),
            ("hd80_f16", "[D80-f16]", "float16_Hkv8_S2048_D80",
             "float16_D80")):
        served = c1[cfg_name]
        t = timing[fwd_key]
        row = {
            "name": f"flash_attention_fwd{suffix}",
            "route": "cuda", "variant": "wgmma", "source": wgmma_source,
            "replaces": replaces["mha"],
            "launches": served["launches_per_prefill_by_variant"]["wgmma"],
            "launches_train": served["launches_per_pass"]["wgmma"],
            "launches_from": f"phase 2b {cfg_name}: one prefill_with_cache "
                             f"and one gradient pass",
            "max_abs_err": t["max_abs_err"],
            "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
            "tflops": t["tflops"], "simt_kernel_ms": t["simt_kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "dtype": t["dtype"], "card": card}
        if cfg_name == "hd256_bf16":
            row["float16"] = _fwd_brief(timing["float16_Hkv8_S2048_D256"])
            row["launches_gqa1"] = c1["hd256_gqa1_bf16"][
                "launches_per_prefill_by_variant"]["wgmma"]
        if cfg_name == "hd96_bf16":
            row["widths"] = {f"{dt}_D{D}": _fwd_brief(
                timing[f"{dt}_Hkv8_S2048_D{D}"]) for dt, D in any_widths}
        kernels.append(row)
        tb = bwd[bwd_key]
        for kind in ("dq", "dkv"):
            t = tb[kind]
            row = {
                "name": f"flash_attention_bwd_{kind}{suffix}",
                "route": "cuda", "variant": "wgmma",
                "source": bwd_wgmma_source,
                "replaces": replaces[kind],
                "launches": served["launches_per_pass"][f"{kind}_wgmma"],
                "launches_from": f"phase 2b {cfg_name}: one gradient pass",
                "max_abs_err": t["max_abs_err"],
                "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
                "tflops": t["tflops"], "simt_kernel_ms": t["simt_kernel_ms"],
                "plain_ms": tb["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": tb["library_ms"],
                "plain": tb["plain"], "library": tb["library"],
                "shape": tb["shape"], "dtype": tb["dtype"], "card": card}
            if cfg_name == "hd256_bf16":
                row["float16"] = _bwd_brief(bwd["float16_D256"], kind)
            if cfg_name == "hd96_bf16":
                row["widths"] = {f"{dt}_D{D}": _bwd_brief(
                    bwd[f"{dt}_D{D}"], kind) for dt, D in any_widths}
            kernels.append(row)
    # The wide kernels (head_dim above 256), times at WIDE_TIMED. bf16 on
    # the tensor cores (the forward, dQ and dK/dV): launches from phase
    # 2b's hd512_bf16 (one prefill_with_cache and one gradient pass), f16
    # and head_dim 384 beside them, and the CUDA-core kernels on the same
    # inputs (cuda_core_ms). f32: the f32 forward, dQ and dK/dV, launches
    # from hd512_f32, the CUDA-core kernels on the same inputs. The
    # CUDA-core dQ keeps its row (no main-path launch left: bf16 and f16
    # above head_dim 1024 only), timed on both dtypes' inputs.
    served, served32 = c1["hd512_bf16"], c1["hd512_f32"]
    wide_tc_source = "ray_tpu_torch/ops/csrc/flash_attention_wide_wgmma.cu"
    wide_source = "ray_tpu_torch/ops/csrc/flash_attention_wide.cu"
    wide_f32_source = "ray_tpu_torch/ops/csrc/flash_attention_wide_f32.cu"

    def wide_row(name, kind, variant, source, t, launches, launches_train,
                 launches_from, dtype, **beside):
        r = t[kind]
        return {
            "name": name, "route": "cuda", "variant": variant,
            "source": source,
            "replaces": replaces["mha" if kind == "fwd" else kind],
            "launches": launches, "launches_train": launches_train,
            "launches_from": launches_from,
            "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
            "tflops": r["tflops"], "cuda_core_ms": r["cuda_core_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": f"scaled_dot_product_attention "
                       f"({t['sdpa_backend']})",
            "shape": t["shape"], "dtype": dtype, "card": card, **beside}

    def brief(t, kind):
        return {k: t[kind][k] for k in (
            "kernel_ms", "cuda_core_ms", "plain_ms", "library_ms",
            "bound_ms", "max_abs_err")} | {
            "sdpa_backend": t["sdpa_backend"], "shape": t["shape"]}

    from_bf16 = ("phase 2b hd512_bf16: one prefill_with_cache and one "
                 "gradient pass")
    from_f32 = ("phase 2b hd512_f32: one prefill_with_cache and one "
                "gradient pass")
    beside_tc = {"float16": None, "bfloat16_D384": None,
                 "float16_D384": None}
    for kind, name in (("fwd", "flash_attention_fwd[wide-wgmma]"),
                       ("dq", "flash_attention_bwd_dq[wide-wgmma]"),
                       ("dkv", "flash_attention_bwd_dkv[wide-wgmma]")):
        launches = (served["launches_per_prefill_by_variant"]["wide_wgmma"]
                    if kind == "fwd"
                    else served["launches_per_pass"][f"{kind}_wide_wgmma"])
        train_launches = (served["launches_per_pass"]["wide_wgmma"]
                          if kind == "fwd" else None)
        kernels.append(wide_row(
            name, kind, "wide_wgmma", wide_tc_source, wide["bfloat16"],
            launches, train_launches, from_bf16, "bfloat16",
            **{k: brief(wide[k], kind) for k in beside_tc}))
    for kind, name in (("fwd", "flash_attention_fwd[wide-f32]"),
                       ("dq", "flash_attention_bwd_dq[wide-f32]"),
                       ("dkv", "flash_attention_bwd_dkv[wide-f32]")):
        launches = (served32["launches_per_prefill_by_variant"]["wide_f32"]
                    if kind == "fwd"
                    else served32["launches_per_pass"][f"{kind}_wide_f32"])
        train_launches = (served32["launches_per_pass"]["wide_f32"]
                          if kind == "fwd" else None)
        kernels.append(wide_row(
            name, kind, "wide_f32", wide_f32_source, wide["float32"],
            launches, train_launches, from_f32, "float32"))
    # The tensor-core wide kernels past head_dim 1024 (the forward
    # streaming Q): launches from phase 2b's hd1032_bf16, times at
    # WIDE_TIMED's B, H and S at head_dim 1032 (2048 beside them), the
    # CUDA-core kernels they replaced on the same inputs (cuda_core_ms).
    wide1032 = c1["hd1032_bf16"]
    from_1032 = ("phase 2b hd1032_bf16: one prefill_with_cache and one "
                 "gradient pass")
    for kind, name in (
            ("fwd", "flash_attention_fwd[wide-wgmma-streamed-q]"),
            ("dq", "flash_attention_bwd_dq[wide-wgmma-D1032]"),
            ("dkv", "flash_attention_bwd_dkv[wide-wgmma-D1032]")):
        launches = (wide1032["launches_per_prefill_by_variant"]["wide_wgmma"]
                    if kind == "fwd"
                    else wide1032["launches_per_pass"][f"{kind}_wide_wgmma"])
        train_launches = (wide1032["launches_per_pass"]["wide_wgmma"]
                          if kind == "fwd" else None)
        kernels.append(wide_row(
            name, kind, "wide_wgmma", wide_tc_source, wide["bfloat16_D1032"],
            launches, train_launches, from_1032, "bfloat16",
            bfloat16_D2048=brief(wide["bfloat16_D2048"], kind)))
    # The CUDA-core dQ, timed and held on the bf16 inputs of WIDE_TIMED
    # beside the tensor-core dQ (its error from the same check).
    t = wide["bfloat16"]
    kernels.append({
        **wide_row("flash_attention_bwd_dq[wide]", "dq", "wide",
                   wide_source, t, served["launches_per_pass"]["dq_wide"],
                   None, from_bf16, "bfloat16"),
        "max_abs_err": t["check"]["cuda_core_dq"]["max_abs_err"],
        "ms": t["dq"]["cuda_core_ms"], "kernel_ms": t["dq"]["cuda_core_ms"],
        "tflops": t["dq"]["tflops"] * t["dq"]["kernel_ms"]
        / t["dq"]["cuda_core_ms"], "cuda_core_ms": None,
        "launches_f32": served32["launches_per_pass"]["dq_wide"],
        "float32_ms": wide["float32"]["dq"]["cuda_core_ms"],
        "float16_ms": wide["float16"]["dq"]["cuda_core_ms"]})
    t = rms["bfloat16"]
    kernels.append({
        "name": "rms_norm_fused", "route": "triton",
        "source": "ray_tpu_torch/ops/fused.py",
        "replaces": replaces["rms"],
        "launches": train["mha"]["bf16_launches"]["rms"],
        "max_abs_err": t["max_abs_err"],
        "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": t["shape"], "card": card})
    emit({"seconds_total": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
